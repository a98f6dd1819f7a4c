"""Testing utilities of the port (counterpart of ``mxnet_tpu/test_utils.py``,
the reference's ``python/mxnet/test_utils.py``): ``numeric_grad`` (central
finite differences), ``check_numeric_gradient``,
``check_symbolic_forward`` / ``check_symbolic_backward``, and
``check_consistency``, the cross-context harness: the same symbol on every
context of a list, from the same inputs, outputs and gradients
cross-checked. On the card it compares ``gpu(0)`` with ``cpu(0)``; on the
host the logical ``cpu(i)`` and dtypes (f32 against f64).
"""
import os

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod
from .context import Context, current_context
from .executor import Executor
from .ndarray import NDArray

def default_context():
    return current_context()


def set_default_context(ctx):
    Context._default_ctx.value = ctx


def default_dtype():
    return np.float32


def default_numerical_threshold():
    return 1e-6


def random_arrays(*shapes):
    arrays = [np.random.randn(*s).astype(default_dtype()) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def rand_ndarray(shape, ctx=None):
    return nd.array(np.random.uniform(-1, 1, shape), ctx=ctx)


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Parity test_utils.py — reduce helper for reduce-op tests."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def same(a, b):
    return np.array_equal(a, b)


def reldiff(a, b):
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + np.sum(np.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg="%s vs %s" % names)


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    return np.allclose(a, b, rtol=rtol, atol=atol)


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Feed inputs by name, return output numpy (parity test_utils.py)."""
    ctx = ctx or default_context()
    inputs = {k: nd.array(v) for k, v in inputs.items()}
    exe = sym.bind(ctx, args=inputs)
    exe.forward(is_train=is_train)
    outputs = [o.asnumpy() for o in exe.outputs]
    if len(outputs) == 1:
        outputs = outputs[0]
    return outputs


def _parse_location(sym, location, ctx):
    assert isinstance(location, (dict, list, tuple))
    if isinstance(location, dict):
        if set(location.keys()) != set(sym.list_arguments()):
            raise ValueError(
                "Symbol arguments and keys of the given location do not match."
                "symbol args:%s, location.keys():%s"
                % (str(set(sym.list_arguments())), str(set(location.keys())))
            )
    else:
        location = {k: v for k, v in zip(sym.list_arguments(), location)}
    location = {
        k: nd.array(v) if isinstance(v, np.ndarray) else v
        for k, v in location.items()
    }
    return location


def _parse_aux_states(sym, aux_states, ctx):
    if aux_states is not None:
        if isinstance(aux_states, dict):
            if set(aux_states.keys()) != set(sym.list_auxiliary_states()):
                raise ValueError("Symbol aux_states names and given aux_states do not match.")
        elif isinstance(aux_states, (list, tuple)):
            aux_names = sym.list_auxiliary_states()
            aux_states = {k: v for k, v in zip(aux_names, aux_states)}
        aux_states = {k: nd.array(v) for k, v in aux_states.items()}
    return aux_states


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central finite differences (parity test_utils.py:300)."""
    approx_grads = {k: np.zeros(v.shape, dtype=np.float32)
                    for k, v in location.items()}
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    for k in location:
        v = location[k]
        v = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
        location[k] = np.array(v)  # writable copy (asnumpy views are RO)
    for k, v in location.items():
        old_value = v.copy()
        for i in range(int(np.prod(v.shape))):
            # inplace update
            v.ravel()[i] = old_value.ravel()[i] + eps / 2.0
            executor.arg_dict[k][:] = v
            if aux_states is not None:
                for key, val in aux_states.items():
                    executor.aux_dict[key][:] = val
            executor.forward(is_train=use_forward_train)
            f_peps = executor.outputs[0].asnumpy()

            v.ravel()[i] = old_value.ravel()[i] - eps / 2.0
            executor.arg_dict[k][:] = v
            if aux_states is not None:
                for key, val in aux_states.items():
                    executor.aux_dict[key][:] = val
            executor.forward(is_train=use_forward_train)
            f_neps = executor.outputs[0].asnumpy()

            approx_grads[k].ravel()[i] = (f_peps - f_neps).sum() / eps
            v.ravel()[i] = old_value.ravel()[i]
        location[k] = old_value
        # restore the executor's copy too: the loop's last write left the
        # final element at -eps/2, which would perturb every later key's
        # finite differences
        executor.arg_dict[k][:] = old_value
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """Finite-difference vs symbolic gradients on a random projection
    (parity test_utils.py:538)."""
    ctx = ctx or default_context()
    # a call-local generator: the projection does not depend on what other
    # calls drew before
    rng = np.random.RandomState(1234)

    def random_projection(shape):
        plain = rng.rand(*shape) + 0.1
        return plain

    location = _parse_location(sym=sym, location=location, ctx=ctx)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    if aux_states is not None:
        aux_states_npy = {k: v.asnumpy() for k, v in aux_states.items()}
    else:
        aux_states_npy = None
    if grad_nodes is None:
        grad_nodes = sym.list_arguments()
        grad_req = {k: "write" for k in grad_nodes}
    elif isinstance(grad_nodes, (list, tuple)):
        grad_nodes = list(grad_nodes)
        grad_req = {k: "write" for k in grad_nodes}
    elif isinstance(grad_nodes, dict):
        grad_req = grad_nodes.copy()
        grad_nodes = grad_nodes.keys()
    else:
        raise ValueError

    input_shape = {k: v.shape for k, v in location.items()}
    _, out_shape, _ = sym.infer_shape(**input_shape)
    proj = sym_mod.Variable("__random_proj")
    out = sym_mod.sum(sym * proj)
    out = sym_mod.MakeLoss(out)

    location = dict(location)
    location["__random_proj"] = nd.array(random_projection(out_shape[0]))
    args_grad_npy = {
        k: rng.normal(0, 0.01, size=location[k].shape) for k in grad_nodes
    }
    args_grad = {k: nd.array(v) for k, v in args_grad_npy.items()}

    executor = out.bind(
        ctx, grad_req=grad_req, args=location, args_grad=args_grad,
        aux_states=aux_states
    )
    inps = executor.arg_arrays
    executor.forward(is_train=True)
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}

    numeric_gradients = numeric_grad(
        executor, location_npy, aux_states_npy, eps=numeric_eps,
        use_forward_train=use_forward_train
    )
    for name in grad_nodes:
        fd_grad = numeric_gradients[name]
        orig_grad = args_grad_npy[name]
        sym_grad = symbolic_grads[name]
        if grad_req[name] == "write":
            assert_almost_equal(
                fd_grad, sym_grad, rtol, atol or 1e-4,
                ("NUMERICAL_%s" % name, "BACKWARD_%s" % name)
            )
        elif grad_req[name] == "add":
            assert_almost_equal(
                fd_grad, sym_grad - orig_grad, rtol, atol or 1e-4,
                ("NUMERICAL_%s" % name, "BACKWARD_%s" % name)
            )
        elif grad_req[name] == "null":
            assert_almost_equal(
                orig_grad, sym_grad, rtol, atol or 1e-4,
                ("NUMERICAL_%s" % name, "BACKWARD_%s" % name)
            )
        else:
            raise ValueError


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None):
    """Forward vs expected numpy outputs (parity test_utils.py:360)."""
    ctx = ctx or default_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    args_grad_data = {
        k: nd.zeros(v.shape) for k, v in location.items()
    }
    executor = sym.bind(
        ctx, args=location, args_grad=args_grad_data, aux_states=aux_states
    )
    executor.forward(is_train=False)
    outputs = [x.asnumpy() for x in executor.outputs]
    for output_name, expect, output in zip(sym.list_outputs(), expected, outputs):
        assert_almost_equal(
            expect, output, rtol, atol or 1e-20,
            ("EXPECTED_%s" % output_name, "FORWARD_%s" % output_name)
        )


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """Backward vs expected numpy gradients (parity test_utils.py:473)."""
    ctx = ctx or default_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    if isinstance(expected, (list, tuple)):
        expected = {k: v for k, v in zip(sym.list_arguments(), expected)}
    # call-local, as in check_numeric_gradient
    _local_rng = np.random.RandomState(1234)
    args_grad_npy = {
        k: _local_rng.normal(size=location[k].shape) for k in expected
    }
    args_grad_data = {k: nd.array(v) for k, v in args_grad_npy.items()}
    if isinstance(grad_req, str):
        grad_req = {k: grad_req for k in sym.list_arguments()}
    elif isinstance(grad_req, (list, tuple)):
        grad_req = {k: v for k, v in zip(sym.list_arguments(), grad_req)}
    executor = sym.bind(
        ctx, args=location, args_grad=args_grad_data,
        aux_states=aux_states, grad_req=grad_req
    )
    executor.forward(is_train=True)
    if isinstance(out_grads, (tuple, list)):
        out_grads = [nd.array(v) for v in out_grads]
    elif isinstance(out_grads, (dict)):
        out_grads = {k: nd.array(v) for k, v in out_grads.items()}
        out_grads = [out_grads[k] for k in sym.list_outputs()]
    elif out_grads is None:
        pass
    else:
        raise ValueError
    executor.backward(out_grads)
    grads = {k: v.asnumpy() for k, v in executor.grad_dict.items() if v is not None}
    for name in expected:
        if grad_req[name] == "write":
            assert_almost_equal(
                expected[name], grads[name], rtol, atol or 1e-20,
                ("EXPECTED_%s" % name, "BACKWARD_%s" % name)
            )
        elif grad_req[name] == "add":
            assert_almost_equal(
                expected[name], grads[name] - args_grad_npy[name], rtol,
                atol or 1e-20,
                ("EXPECTED_%s" % name, "BACKWARD_%s" % name)
            )
        elif grad_req[name] == "null":
            assert_almost_equal(
                args_grad_npy[name], grads[name], rtol, atol or 1e-20,
                ("EXPECTED_%s" % name, "BACKWARD_%s" % name)
            )
        else:
            raise ValueError


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True):
    """Cross-context equivalence: run the same symbol with identical inputs
    on every context of ``ctx_list`` (``gpu(0)`` against ``cpu(0)`` on the
    card) and cross-check outputs and gradients against the widest output
    dtype's run."""
    if tol is None:
        tol = {
            np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
            np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
            np.dtype(np.int32): 0,
        }
    elif isinstance(tol, float):
        tol = {
            np.dtype(np.float16): tol, np.dtype(np.float32): tol,
            np.dtype(np.float64): tol, np.dtype(np.uint8): 0,
            np.dtype(np.int32): 0,
        }
    assert len(ctx_list) > 1
    if isinstance(sym, sym_mod.Symbol):
        sym = [sym] * len(ctx_list)
    else:
        assert len(sym) == len(ctx_list)
    output_names = sym[0].list_outputs()
    arg_names = sym[0].list_arguments()
    exe_list = []
    for s, ctx in zip(sym, ctx_list):
        assert s.list_arguments() == arg_names
        assert s.list_outputs() == output_names
        exe_list.append(
            Executor.simple_bind(s, ctx["ctx"], grad_req=grad_req,
                                 type_dict=ctx.get("type_dict"),
                                 **{k: v for k, v in ctx.items()
                                    if k not in ("ctx", "type_dict")})
        )
    arg_params = {} if arg_params is None else arg_params
    aux_params = {} if aux_params is None else aux_params
    for n, arr in exe_list[0].arg_dict.items():
        if n not in arg_params:
            arg_params[n] = np.random.normal(
                size=arr.shape, scale=scale
            ).astype(arr.dtype)
    for n, arr in exe_list[0].aux_dict.items():
        if n not in aux_params:
            aux_params[n] = 0
    for exe in exe_list:
        for name, arr in exe.arg_dict.items():
            arr[:] = arg_params[name].astype(arr.dtype)
        for name, arr in exe.aux_dict.items():
            arr[:] = aux_params[name]

    # forward; the output dtypes are read after the first run
    for exe in exe_list:
        exe.forward(is_train=False)
    dtypes = [np.dtype(exe.outputs[0].dtype) for exe in exe_list]
    # ground truth = widest output dtype (argmax over np.dtype objects
    # is not a defined ordering; itemsize is)
    max_idx = int(np.argmax([dt.itemsize for dt in dtypes]))
    outputs = [[o.asnumpy() for o in exe.outputs] for exe in exe_list]
    gt = outputs[max_idx]
    for i, exe in enumerate(exe_list):
        if i == max_idx:
            continue
        rtol = tol[dtypes[i]]
        atol = rtol
        for name, arr, gtarr in zip(output_names, outputs[i], gt):
            try:
                assert_almost_equal(arr, gtarr, rtol=rtol, atol=atol)
            except AssertionError as e:
                print("Predict Err: ctx %d vs ctx %d at %s" % (i, max_idx, name))
                print(str(e))
                if raise_on_err:
                    raise

    # train (forward+backward)
    if grad_req != "null":
        for i, exe in enumerate(exe_list):
            exe.forward(is_train=True)
            # head grads on this executor's device, in its output dtype
            # (the ground truth comes from the widest context)
            ctx_i = ctx_list[i]["ctx"]
            exe.backward([
                # explicit dtype: nd.array's default casts f64 to f32
                nd.array(np.asarray(g, dtype=mine.dtype), ctx=ctx_i,
                         dtype=mine.dtype)
                for g, mine in zip(gt[: len(exe.outputs)], outputs[i])
            ])
        grads = [
            {k: v.asnumpy() for k, v in exe.grad_dict.items() if v is not None}
            for exe in exe_list
        ]
        gt_grad = grads[max_idx]
        for i, exe in enumerate(exe_list):
            if i == max_idx:
                continue
            rtol = tol[dtypes[i]]
            atol = rtol
            for name in gt_grad:
                try:
                    assert_almost_equal(grads[i][name], gt_grad[name],
                                        rtol=rtol, atol=atol)
                except AssertionError as e:
                    print("Train Err: ctx %d vs ctx %d at %s" % (i, max_idx, name))
                    print(str(e))
                    if raise_on_err:
                        raise
    return gt


def download(url, fname=None, dirname=None, overwrite=False):
    """The reference's download helper, without a network: returns the file
    when it already exists locally, else raises."""
    import os

    fname = fname or url.split("/")[-1]
    if dirname:
        fname = os.path.join(dirname, fname)
    if os.path.exists(fname) and not overwrite:
        return fname
    raise RuntimeError(
        "download(%s): network egress unavailable; place the file at %s"
        % (url, fname)
    )
