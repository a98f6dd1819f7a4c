"""The custom-operator host of the port (counterpart of
``mxnet_tpu/operator.py``, the reference's ``python/mxnet/operator.py``):
``CustomOp``, ``CustomOpProp``, ``register`` / ``get_registered``, the
legacy ``PythonOp`` / ``NumpyOp`` / ``NDArrayOp`` shims and the ``Custom``
operator that runs a registered op inside a graph.

A ``Custom`` node is a ``torch.autograd.Function``: its forward calls the
user's ``forward`` and its backward the user's ``backward``, with NDArrays
on the graph's own device (a host copy happens only where the user's code
calls ``asnumpy``). The rest of the graph stays on the device around it.

The user's ``forward`` runs once per distinct input (a memo on the
inputs' bits and the training flag, as the JAX package's digest memo,
``mxnet_tpu/operator.py:247-277``): a mirrored region's recompute or an
autograd replay then reads the outputs of the first run, so a stochastic
op (R-CNN's ``proposal_target`` samples its rois) gives the backward the
forward it saw.

Python code cannot be captured into a CUDA graph, nor can an operator
that reads the host at each call (``ROIPooling`` sizes its windows from the
rois). The capture paths (``predict.Predictor`` on the card, the grouped
steps of ``fit`` under ``MXNET_FIT_MULTISTEP=K``) refuse a graph that holds
a ``Custom`` or ``ROIPooling`` node with an :class:`MXNetError` naming it
(:func:`refuse_capture`); ``MXNET_FIT_MULTISTEP=auto`` keeps such a fit at
one step.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from .base import MXNetError
from .ops.registry import OpDef, register as _register_opdef

__all__ = [
    "CustomOp",
    "CustomOpProp",
    "register",
    "get_registered",
    "PythonOp",
    "NumpyOp",
    "NDArrayOp",
]


class CustomOp(object):
    """Base class of the operator a :class:`CustomOpProp` creates: the
    reference's ``forward`` / ``backward`` / ``assign`` contract;
    ``in_data`` / ``out_data`` are NDArrays on the graph's device."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write src to dst as the grad_req says."""
        if req in ("null", 0):
            return
        if req in ("write", "inplace", 1, 2):
            dst[:] = src
        elif req in ("add", 3):
            dst[:] = dst[:] + src
        else:
            raise MXNetError("unknown req %r" % (req,))


class CustomOpProp(object):
    """Base class of a custom operator's metadata. Subclass it, register it
    with ``mx.operator.register("name")`` and build symbols with
    ``mx.sym.Custom(..., op_type="name")``. Constructor kwargs arrive as
    strings, as in the reference."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        """Default: every argument and the single output take in_shape[0]."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        t = in_type[0] if in_type and in_type[0] is not None else np.float32
        completed = [t if x is None else x for x in in_type]
        return (completed, [t] * len(self.list_outputs()),
                [t] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError()


_custom_registry: dict[str, type] = {}


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``reg_name``; the
    ``Custom`` operator reaches it through ``op_type``."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register(%s): expected a CustomOpProp subclass" % reg_name)
        _custom_registry[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_registered(reg_name):
    cls = _custom_registry.get(reg_name)
    if cls is None:
        raise MXNetError("custom op type %r is not registered (use mx.operator.register)"
                         % (reg_name,))
    return cls


# ---------------------------------------------------------------------------
# the "Custom" OpDef: dispatches on attrs["op_type"]
# ---------------------------------------------------------------------------
_INTERNAL_ATTRS = ("op_type", "__rng__")


def _prop_key(attrs):
    items = tuple(sorted((k, str(v)) for k, v in attrs.items()
                         if k not in _INTERNAL_ATTRS and not k.startswith("__")))
    return (attrs["op_type"], items)


_prop_cache: dict[tuple, CustomOpProp] = {}
# (prop key, program uid, node name, signature, device) -> CustomOp; bounded,
# so that long bucketing runs do not keep dead executors' instances
_op_cache: "collections.OrderedDict[tuple, CustomOp]" = collections.OrderedDict()
_OP_CACHE_MAX = 256


def _get_prop(attrs) -> CustomOpProp:
    if "op_type" not in attrs:
        raise MXNetError("Custom op requires an op_type attr")
    key = _prop_key(attrs)
    prop = _prop_cache.get(key)
    if prop is None:
        cls = get_registered(attrs["op_type"])
        kwargs = {k: str(v) for k, v in attrs.items()
                  if k not in _INTERNAL_ATTRS and not k.startswith("__")}
        prop = cls(**kwargs)
        _prop_cache[key] = prop
    return prop


def _get_op(attrs, prop, in_shapes, in_dtypes, device) -> CustomOp:
    """One CustomOp instance per (bind, node, signature): the executor puts
    ``__program_id__`` / ``__node_name__`` into a Custom node's attrs, so
    two executors never share a stateful instance (the reference makes one
    CustomOp a bind); imperative calls share one per signature."""
    key = (_prop_key(attrs), attrs.get("__program_id__"), attrs.get("__node_name__"),
           tuple(in_shapes), tuple(str(d) for d in in_dtypes), str(device))
    op = _op_cache.get(key)
    if op is None:
        from .context import Context

        op = prop.create_operator(Context(device), list(in_shapes), list(in_dtypes))
        _op_cache[key] = op
        while len(_op_cache) > _OP_CACHE_MAX:
            _op_cache.popitem(last=False)
    else:
        _op_cache.move_to_end(key)
    return op


def _np_dtype(t):
    return np.dtype(t if t is not None else np.float32)


def _bits(t):
    """A tensor's bytes as a flat uint8 tensor (on its device): what the
    forward memo compares, so NaNs and signed zeros count as themselves."""
    t = t.detach().contiguous()
    return t.reshape(-1).view(torch.uint8) if t.numel() else t.reshape(-1)


def _memo_hit(memo, train_flag, inputs):
    if memo is None or memo[0] != train_flag or len(memo[1]) != len(inputs):
        return False
    for old, new in zip(memo[1], inputs):
        if (old.shape != new.shape or old.dtype != new.dtype or old.device != new.device
                or not torch.equal(_bits(old), _bits(new))):
            return False
    return True


class _CustomFunction(torch.autograd.Function):
    """The user's forward and backward as one autograd node; ``host`` holds
    the op, its shapes and dtypes (see :func:`_custom_fcompute`)."""

    @staticmethod
    def forward(ctx, host, *inputs):
        # the user's code is opaque to dispatch modes: a mirrored region's
        # selective checkpoint then sees the same ops in its recompute (which
        # reads the memo) as in its forward
        with _disable_current_modes():
            outs = host.forward(inputs)
        ctx.host = host
        ctx.save_for_backward(*inputs, *outs)
        ctx.mark_non_differentiable(*outs[host.n_outs:])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        host = ctx.host
        saved = ctx.saved_tensors
        ins, outs = saved[:len(saved) - len(cots)], saved[len(saved) - len(cots):]
        grads = host.backward(ins, outs[:host.n_outs], cots[:host.n_outs])
        return (None,) + tuple(grads) + (None,) * (len(ins) - host.n_args)


class _Host(object):
    """One call's view of a CustomOp: runs its forward (through the memo)
    and backward on NDArrays over the graph's tensors."""

    def __init__(self, op, train_flag, n_args, out_shapes, out_dtypes, in_dtypes):
        self.op, self.train_flag, self.n_args = op, train_flag, n_args
        self.n_outs = len(out_shapes)
        self.out_shapes, self.out_dtypes, self.in_dtypes = out_shapes, out_dtypes, in_dtypes

    def forward(self, inputs):
        from .base import torch_dtype
        from .ndarray import NDArray

        memo = getattr(self.op, "_mxtt_fwd_memo", None)
        # an op whose result depends on more than its inputs (a wrapped torch
        # module's parameters) names that state in ``memo_key()``
        extra = self.op.memo_key() if hasattr(self.op, "memo_key") else None
        if _memo_hit(memo, self.train_flag, inputs) and memo[3] == extra:
            return [o.clone() for o in memo[2]]
        dev = inputs[0].device if inputs else torch.device("cpu")
        in_data = [NDArray(x.detach().clone()) for x in inputs[:self.n_args]]
        aux = [NDArray(x.detach().clone()) for x in inputs[self.n_args:]]
        out_data = [NDArray(torch.zeros(s, dtype=torch_dtype(d), device=dev))
                    for s, d in zip(self.out_shapes, self.out_dtypes)]
        self.op.forward(self.train_flag, ["write"] * self.n_outs, in_data, out_data, aux)
        outs = [o._data for o in out_data] + [a._data for a in aux]
        self.op._mxtt_fwd_memo = (self.train_flag, [x.detach().clone() for x in inputs],
                                  [o.clone() for o in outs], extra)
        return outs

    def backward(self, ins, outs, cots):
        from .base import torch_dtype
        from .ndarray import NDArray

        dev = ins[0].device
        in_data = [NDArray(x) for x in ins[:self.n_args]]
        aux = [NDArray(x.clone()) for x in ins[self.n_args:]]
        out_data = [NDArray(x) for x in outs]
        out_grad = [NDArray(torch.zeros(o.shape, dtype=o.dtype, device=dev) if g is None
                            else g.contiguous()) for g, o in zip(cots, outs)]
        in_grad = [NDArray(torch.zeros(x.shape, dtype=torch_dtype(d), device=dev))
                   for x, d in zip(ins[:self.n_args], self.in_dtypes)]
        self.op.backward(["write"] * self.n_args, out_grad, in_data, out_data, in_grad, aux)
        return [g._data for g in in_grad]


def _custom_fcompute(attrs, inputs, is_train):
    prop = _get_prop(attrs)
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(inputs) != n_args + n_aux:
        raise MXNetError("Custom(%s): expected %d args + %d aux, got %d inputs"
                         % (attrs["op_type"], n_args, n_aux, len(inputs)))
    in_shapes = [tuple(int(d) for d in v.shape) for v in inputs[:n_args]]
    in_dtypes = [_np_dtype_of_tensor(v) for v in inputs[:n_args]]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    _, out_types, _ = prop.infer_type(list(in_dtypes))
    out_shapes = [tuple(int(d) for d in s) for s in out_shapes]
    out_dtypes = [_np_dtype(t) for t in out_types]
    device = inputs[0].device if inputs else torch.device("cpu")
    op = _get_op(attrs, prop, in_shapes, in_dtypes, device)
    host = _Host(op, bool(is_train), n_args, out_shapes, out_dtypes, in_dtypes)
    return list(_CustomFunction.apply(host, *inputs))


def _np_dtype_of_tensor(t):
    from .ndarray import _np_dtype_of

    return np.dtype(_np_dtype_of(t.dtype))


class _CustomOpDef(OpDef):
    """OpDef whose arity and inference dispatch to the registered
    CustomOpProp."""

    def __init__(self):
        OpDef.__init__(self, "Custom", _custom_fcompute, arguments=("data",), defaults={},
                       open_attrs=True)  # kwargs flow to the user's CustomOpProp

    def canon_attrs(self, raw_attrs):
        # kwargs reach CustomOpProp as raw strings, unparsed
        return {k: v for k, v in (raw_attrs or {}).items() if not k.startswith("__")}

    def num_inputs(self, attrs):
        return len(_get_prop(attrs).list_arguments())

    def list_arguments(self, attrs=None):
        if attrs is None or "op_type" not in attrs:
            return ["data"]
        return list(_get_prop(attrs).list_arguments())

    def list_outputs(self, attrs=None):
        if attrs is None or "op_type" not in attrs:
            return ["output"]
        return list(_get_prop(attrs).list_outputs())

    def list_auxiliary_states(self, attrs=None):
        if attrs is None or "op_type" not in attrs:
            return []
        return list(_get_prop(attrs).list_auxiliary_states())

    def infer_shape(self, attrs, in_shapes):
        prop = _get_prop(attrs)
        in_sh, out_sh, aux_sh = prop.infer_shape(
            [None if s is None else list(s) for s in in_shapes])

        def tup(ss):
            return [None if s is None else tuple(s) for s in ss]

        return tup(in_sh), tup(out_sh), tup(aux_sh)

    def infer_type(self, attrs, in_types):
        prop = _get_prop(attrs)
        in_t, out_t, aux_t = prop.infer_type(list(in_types))
        return ([_np_dtype(t) for t in in_t], [_np_dtype(t) for t in out_t],
                [_np_dtype(t) for t in aux_t])


_register_opdef(_CustomOpDef())


# the operators whose forward reads the host at each call, so that a CUDA
# graph cannot hold them, each with the reason
_HOST_BOUND = {
    "Custom": "whose Python forward and backward run on the host at each call",
    "ROIPooling": "whose window size is read from the rois on the host at each call",
}


def uncapturable_nodes(symbol_or_nodes):
    """The nodes of a symbol (or of a list of graph nodes) that a CUDA graph
    cannot hold, in topological order, each named with its operator (a
    Custom node with its op type) and the reason."""
    nodes = getattr(symbol_or_nodes, "nodes", None)
    if nodes is None:
        from .symbol import _topo_order

        nodes = _topo_order([n for n, _ in symbol_or_nodes._outputs])
    found = []
    for n in nodes:
        if n.is_variable or n.op.name not in _HOST_BOUND:
            continue
        name = n.name
        if n.op.name == "Custom":
            name += " (op_type %s)" % n.attrs.get("op_type")
        found.append("the %s node %s, %s" % (n.op.name, name, _HOST_BOUND[n.op.name]))
    return found


def refuse_capture(symbol_or_nodes, what):
    """Raise :class:`MXNetError` when the graph holds a node that a CUDA graph
    cannot hold (:func:`uncapturable_nodes`), naming each such node."""
    found = uncapturable_nodes(symbol_or_nodes)
    if found:
        raise MXNetError("%s cannot be captured into a CUDA graph: the graph holds %s"
                         % (what, "; ".join(found)))


def _refresh_frontends():
    """Expose the Custom operator (and the ops registered after the
    frontends were built) through ``mx.sym`` and ``mx.nd``."""
    from . import symbol as _sym_mod

    _sym_mod._init_symbol_module()
    from . import ndarray as _nd_mod

    _nd_mod._init_ndarray_module()


_refresh_frontends()


# ---------------------------------------------------------------------------
# legacy shims: PythonOp / NumpyOp / NDArrayOp
# ---------------------------------------------------------------------------
class PythonOp(object):
    """Base of the deprecated interface before CustomOp: ``get_symbol(*args)``
    builds a Symbol running this op through the Custom host."""

    _seq = [0]

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = need_top_grad

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def _make_shim_op(self):
        """CustomOp adapter calling this PythonOp with numpy arrays."""
        pyop = self

        class _ShimOp(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                pyop.forward(in_data=[x.asnumpy() for x in in_data], out_data=out_data)

            def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                pyop.backward(out_grad=[x.asnumpy() for x in out_grad],
                              in_data=[x.asnumpy() for x in in_data],
                              out_data=[x.asnumpy() for x in out_data], in_grad=in_grad)

        return _ShimOp()

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym_mod

        pyop = self

        class _ShimProp(CustomOpProp):
            def __init__(self):
                CustomOpProp.__init__(self, pyop.need_top_grad())

            def list_arguments(self):
                return pyop.list_arguments()

            def list_outputs(self):
                return pyop.list_outputs()

            def infer_shape(self, in_shape):
                res = pyop.infer_shape(in_shape)
                if len(res) == 2:
                    return res[0], res[1], []
                return res

            def create_operator(self, ctx, in_shapes, in_dtypes):
                return pyop._make_shim_op()

        PythonOp._seq[0] += 1
        reg_name = "_pythonop_%s_%d" % (type(self).__name__, PythonOp._seq[0])
        register(reg_name)(_ShimProp)
        return sym_mod.Custom(*args, op_type=reg_name, **kwargs)


class NumpyOp(PythonOp):
    """Numpy-callback op: forward / backward get numpy arrays and write
    their outputs through ``out_data[i][:] = value``."""


class NDArrayOp(PythonOp):
    """NDArray-callback op: the callbacks get the NDArrays themselves."""

    def _make_shim_op(self):
        pyop = self

        class _ShimOp(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                pyop.forward(in_data=in_data, out_data=out_data)

            def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                pyop.backward(out_grad=out_grad, in_data=in_data, out_data=out_data,
                              in_grad=in_grad)

        return _ShimOp()
