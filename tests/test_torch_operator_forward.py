"""Every operator of the port's imperative op modules (elemwise,
broadcast_reduce, matrix, init_ops, indexing, optimizer_ops; the samplers
in test_torch_random.py) held against the JAX package through ``mx.nd`` in
both, on the same numpy inputs: forward at 1e-5 in float32, exact for
integer results, 1e-12 in float64; backward through ``mx.autograd`` at
1e-5 where the op has a gradient. Also: the registry metadata (aliases,
defaults, arguments, mutate_inputs) equals the JAX package's, and the
numpy closed forms of tests/test_operator_forward.py hold."""
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

PORTED = ("elemwise", "broadcast_reduce", "matrix", "init_ops", "indexing", "sample",
          "optimizer_ops")
SAMPLERS = {"_sample_uniform", "_sample_normal", "_sample_gamma", "_sample_exponential",
            "_sample_poisson", "_sample_negbinomial", "_sample_gennegbinomial"}

_rng = np.random.RandomState(11)


def _a(shape=(3, 4), lo=-2.0, hi=2.0, dtype=np.float32):
    return _rng.uniform(lo, hi, shape).astype(dtype)


X, Y, P, P2 = _a(), _a(), _a(lo=0.4, hi=2.5), _a(lo=0.4, hi=2.5)
U, G = _a(lo=-0.8, hi=0.8), _a(lo=1.2, hi=3.0)
ROW, COL = _a((1, 4)), _a((3, 1))
X4 = _a((2, 3, 4, 5))
SPREAD = _rng.permutation(np.linspace(-2, 2, 24).astype(np.float32)).reshape(2, 3, 4)
XEQ = np.where(_rng.rand(3, 4) > 0.5, X, Y).astype(np.float32)
I = _rng.randint(-5, 6, (3, 4)).astype(np.int32)
J = _rng.randint(1, 6, (3, 4)).astype(np.int32)
D = _a(dtype=np.float64)
IDX = np.array([0, 4, 2, 2, 7, -1], np.float32)

# (op, inputs, attrs, marked input positions for the backward check)
CASES = {}


def case(cid, op, inputs, attrs=None, grad=()):
    CASES[cid] = (op, inputs, attrs or {}, tuple(grad))


for _op in ("relu", "sigmoid", "_copy", "BlockGrad", "make_loss", "negative", "abs", "sign",
            "round", "rint", "ceil", "floor", "trunc", "fix", "square", "cbrt", "exp", "expm1",
            "sin", "cos", "sinh", "cosh", "tanh", "arctan", "arcsinh", "degrees", "radians",
            "erf", "softsign", "smooth_l1"):
    case(_op, _op, [X], grad=(0,) if _op not in ("sign", "round", "rint", "ceil", "floor",
                                                "trunc", "fix") else ())
for _op in ("sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p", "reciprocal", "gamma",
            "gammaln"):
    case(_op, _op, [P], grad=(0,))
for _op in ("tan", "arcsin", "arccos", "arctanh"):
    case(_op, _op, [U], grad=(0,))
case("arccosh", "arccosh", [G], grad=(0,))
case("smooth_l1_sigma", "smooth_l1", [X], {"scalar": 2.0}, grad=(0,))
for _dt in ("int32", "float64", "float16", "bfloat16"):
    case("Cast_" + _dt, "Cast", [X * 3], {"dtype": _dt})
case("Cast_grad", "Cast", [X], {"dtype": "float64"}, grad=(0,))

for _op, _ins in (("elemwise_add", [X, Y]), ("elemwise_sub", [X, Y]), ("elemwise_mul", [X, Y]),
                  ("elemwise_div", [X, P]), ("_mod", [P * 3, P2]), ("_power", [P, X]),
                  ("_maximum", [X, Y]), ("_minimum", [X, Y]), ("_hypot", [X, Y])):
    case(_op, _op, _ins, grad=(0, 1) if _op != "_mod" else ())
for _op in ("_equal", "_not_equal", "_greater", "_greater_equal", "_lesser", "_lesser_equal"):
    case(_op, _op, [X, XEQ])
for _op in ("_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar", "_div_scalar",
            "_maximum_scalar", "_minimum_scalar", "_hypot_scalar", "_equal_scalar",
            "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
            "_lesser_equal_scalar", "_mod_scalar"):
    case(_op, _op, [X], {"scalar": 0.75}, grad=(0,) if "equal" not in _op and "ter" not in _op
         and "ser" not in _op and "mod" not in _op else ())
for _op in ("_rdiv_scalar", "_power_scalar", "_rpower_scalar", "_rmod_scalar"):
    case(_op, _op, [P], {"scalar": 1.5}, grad=(0,) if "mod" not in _op else ())
for _op in ("broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_maximum",
            "broadcast_minimum", "broadcast_hypot", "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal"):
    case(_op, _op, [COL, ROW], grad=(0, 1) if "equal" not in _op and "ter" not in _op
         and "ser" not in _op else ())
case("broadcast_div", "broadcast_div", [COL, _a((1, 4), 0.4, 2.5)], grad=(0, 1))
case("broadcast_mod", "broadcast_mod", [P, _a((1, 4), 0.4, 2.5)])
case("broadcast_power", "broadcast_power", [P, ROW], grad=(0, 1))
case("broadcast_equal", "broadcast_equal", [X, XEQ])
case("add_n", "add_n", [X, Y, P], {"num_args": 3}, grad=(0, 1, 2))

for _cid, _attrs in (("", {}), ("_axis0", {"axis": 0}), ("_keep", {"axis": 1, "keepdims": True}),
                     ("_exclude", {"axis": (0, 2), "exclude": True})):
    for _op in ("sum", "mean", "max", "min", "nansum"):
        case(_op + _cid, _op, [SPREAD], _attrs, grad=(0,) if _op != "nansum" else ())
case("prod", "prod", [_a((3, 4), 0.5, 1.5)], {"axis": 1}, grad=(0,))
case("nanprod", "nanprod", [np.where(P > 2.0, np.nan, P).astype(np.float32)], {"axis": 1})
case("nansum_nan", "nansum", [np.where(X > 1.0, np.nan, X).astype(np.float32)], {"axis": 1})
case("norm", "norm", [X], grad=(0,))
for _op in ("argmax", "argmin"):
    case(_op, _op, [SPREAD], {"axis": 2})
    case(_op + "_flat", _op, [SPREAD])
    case(_op + "_keep", _op, [SPREAD], {"axis": 1, "keepdims": True})
case("argmax_channel", "argmax_channel", [SPREAD])
case("broadcast_to", "broadcast_to", [ROW], {"shape": (3, 4)}, grad=(0,))
case("broadcast_to_zero", "broadcast_to", [COL], {"shape": (0, 5)}, grad=(0,))
case("broadcast_axis", "broadcast_axis", [_a((2, 1, 3))], {"axis": 1, "size": 4}, grad=(0,))

case("Reshape", "Reshape", [SPREAD], {"shape": (4, -1)}, grad=(0,))
for _i, _shape in enumerate([(0, -1), (-2,), (-3, 4), (-4, 1, 2, 0, 0), (2, -4, -1, 3, 4)]):
    case("Reshape_code%d" % _i, "Reshape", [SPREAD], {"shape": _shape})
case("Flatten", "Flatten", [SPREAD], grad=(0,))
case("transpose", "transpose", [X], grad=(0,))
case("transpose_axes", "transpose", [SPREAD], {"axes": (1, 2, 0)}, grad=(0,))
case("expand_dims", "expand_dims", [X], {"axis": -1}, grad=(0,))
case("SwapAxis", "SwapAxis", [SPREAD], {"dim1": 0, "dim2": 2}, grad=(0,))
case("dot", "dot", [_a((3, 4)), _a((4, 5))], grad=(0, 1))
case("dot_t", "dot", [_a((4, 3)), _a((5, 4))], {"transpose_a": True, "transpose_b": True},
     grad=(0, 1))
case("dot_1d", "dot", [_a((4,)), _a((4,))], grad=(0, 1))
case("batch_dot", "batch_dot", [_a((2, 3, 4)), _a((2, 4, 5))], grad=(0, 1))
case("batch_dot_t", "batch_dot", [_a((2, 3, 4)), _a((2, 5, 4))], {"transpose_b": True},
     grad=(0, 1))
case("slice", "slice", [SPREAD], {"begin": (1, 0, -3), "end": (2, None, 4)}, grad=(0,))
case("slice_axis", "slice_axis", [SPREAD], {"axis": 2, "begin": 1, "end": -1}, grad=(0,))
case("clip", "clip", [X], {"a_min": -1.0, "a_max": 1.0}, grad=(0,))
case("repeat", "repeat", [X], {"repeats": 2, "axis": 1}, grad=(0,))
case("repeat_flat", "repeat", [X], {"repeats": 3})
case("tile", "tile", [X], {"reps": (2, 1, 3)}, grad=(0,))
case("reverse", "reverse", [SPREAD], {"axis": (0, 2)}, grad=(0,))
case("Concat", "Concat", [X, Y, P], {"dim": 0}, grad=(0, 1, 2))
case("SliceChannel", "SliceChannel", [SPREAD], {"num_outputs": 3, "axis": 1}, grad=(0,))
case("SliceChannel_squeeze", "SliceChannel", [SPREAD],
     {"num_outputs": 2, "axis": 0, "squeeze_axis": True})
case("Pad", "Pad", [X4], {"mode": "constant", "constant_value": 5.0,
                          "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}, grad=(0,))
case("Pad_edge", "Pad", [X4], {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)})
case("Pad_reflect", "Pad", [X4], {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)})
case("where", "where", [(X > 0).astype(np.float32), Y, P], grad=(1, 2))
case("where_rows", "where", [np.array([1, 0, 1], np.float32), Y, P])

case("_zeros", "_zeros", [], {"shape": (2, 3)})
case("_ones_f64", "_ones", [], {"shape": (4,), "dtype": "float64"})
case("_arange", "_arange", [], {"start": 1.0, "stop": 6.0, "step": 0.5, "repeat": 2})
case("zeros_like", "zeros_like", [X])
case("ones_like", "ones_like", [I])

case("take", "take", [_a((5, 3)), IDX], grad=(0,))
case("take_wrap", "take", [_a((5, 3)), IDX], {"mode": "wrap"})
case("take_axis1", "take", [_a((3, 5)), np.array([[0, 4], [2, 1]], np.float32)], {"axis": 1})
case("batch_take", "batch_take", [_a((3, 4)), np.array([1, 3, 0], np.float32)], grad=(0,))
case("Embedding", "Embedding", [np.array([[1, 3], [0, 4]], np.float32), _a((5, 3))],
     {"input_dim": 5, "output_dim": 3}, grad=(1,))
case("one_hot", "one_hot", [np.array([0, 3, 4, 1, 7, -1], np.float32)], {"depth": 5})
case("one_hot_values", "one_hot", [np.array([[0, 2], [1, 1]], np.float32)],
     {"depth": 3, "on_value": 2.5, "off_value": -1.0, "dtype": "float64"})
case("pick", "pick", [_a((3, 4)), np.array([1, 3, 0], np.float32)], grad=(0,))
case("pick_keep", "pick", [_a((3, 4)), np.array([2, 0, 1, 1], np.float32)],
     {"axis": 0, "keepdims": True}, grad=(0,))
case("sort", "sort", [SPREAD[1]])
case("sort_desc_flat", "sort", [SPREAD], {"is_ascend": False, "axis": None})
case("argsort", "argsort", [SPREAD], {"axis": 1})
case("argsort_desc", "argsort", [SPREAD[1]], {"is_ascend": False})
case("topk", "topk", [SPREAD[1]], {"k": 2})
case("topk_value", "topk", [SPREAD], {"k": 2, "axis": 1, "ret_typ": "value"})
case("topk_both", "topk", [SPREAD[1]], {"k": 3, "ret_typ": "both", "is_ascend": True})
case("topk_mask", "topk", [SPREAD[1]], {"k": 2, "ret_typ": "mask"})

_OPT = dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.6)
case("sgd_update", "sgd_update", [X, Y], _OPT)
case("sgd_mom_update", "sgd_mom_update", [X, Y, P], dict(_OPT, momentum=0.9))
case("adam_update", "adam_update", [X, Y, U, P], dict(_OPT, beta1=0.8))
case("rmsprop_update", "rmsprop_update", [X, Y, P], dict(_OPT, clip_weights=1.5))
case("rmspropalex_update", "rmspropalex_update", [X, Y, P * 4, U * 0.1, U],
     dict(_OPT, gamma2=0.8))

# integer inputs: results held exactly (integer division and float
# functions of integers are float64, as under the JAX package's x64)
for _op, _ins, _attrs in (
        ("negative", [I], {}), ("abs", [I], {}), ("sign", [I], {}), ("square", [I], {}),
        ("relu", [I], {}), ("sqrt", [J], {}), ("exp", [I], {}), ("elemwise_add", [I, J], {}),
        ("elemwise_sub", [I, J], {}), ("elemwise_mul", [I, J], {}),
        ("elemwise_div", [I, J], {}), ("_mod", [I, J], {}), ("_maximum", [I, J], {}),
        ("_minimum", [I, J], {}), ("_greater", [I, J], {}), ("_equal", [I, I], {}),
        ("_plus_scalar", [I], {"scalar": 2}), ("_mul_scalar", [I], {"scalar": 1.5}),
        ("_div_scalar", [I], {"scalar": 2}), ("broadcast_add", [I, J[:1]], {}),
        ("broadcast_mul", [I[:, :1], J], {}), ("sum", [I], {}), ("sum", [I], {"axis": 1}),
        ("prod", [J], {"axis": 0}), ("max", [I], {"axis": 1}), ("min", [I], {}),
        ("mean", [I], {"axis": 0}), ("argmax", [I], {"axis": 1}), ("transpose", [I], {}),
        ("Reshape", [I], {"shape": (2, -1)}), ("slice", [I], {"begin": (1, 1), "end": (3, 3)}),
        ("take", [I, IDX], {}), ("sort", [I], {}), ("argsort", [I], {"axis": 0}),
        ("topk", [I], {"k": 2, "ret_typ": "both"}), ("Concat", [I, J], {"dim": 1}),
        ("tile", [I], {"reps": (2,)}), ("repeat", [I], {"repeats": 2}),
        ("reverse", [I], {"axis": 1}), ("Cast", [I], {"dtype": "float32"}),
        ("one_hot", [I], {"depth": 4, "dtype": "int32"})):
    case("int_%s_%d" % (_op, len([c for c in CASES if c.startswith("int_" + _op)])), _op, _ins,
         _attrs)
for _op, _ins in (("exp", [D]), ("sqrt", [np.abs(D)]), ("elemwise_mul", [D, D]), ("sum", [D]),
                  ("dot", [D, D.T.copy()]), ("broadcast_add", [D, D[:1]])):
    case("f64_" + _op, _op, _ins)


def _run(pkg, op, inputs, attrs, grad=(), out_grads=None):
    """Forward (and with ``grad``, the gradients of the marked inputs for
    ``out_grads``) of ``mx.nd.<op>`` in one package, as numpy."""
    nd, ag = pkg.nd, pkg.autograd
    arrays = [nd.array(x, dtype=x.dtype) for x in inputs]
    kwargs = dict(attrs)
    if not inputs:
        kwargs["ctx"] = pkg.cpu()
    marked = [arrays[i] for i in grad]
    grads = [nd.zeros(a.shape, dtype=a.dtype) for a in marked]
    if grad:
        ag.mark_variables(marked, grads)
        with ag.train_section():
            out = getattr(nd, op)(*arrays, **kwargs)
        outs = out if isinstance(out, list) else [out]
        ag.backward(outs, out_grads=[nd.array(g, dtype=g.dtype) for g in out_grads(outs)])
    else:
        out = getattr(nd, op)(*arrays, **kwargs)
        outs = out if isinstance(out, list) else [out]
    return ([o.asnumpy() for o in outs], [a.asnumpy() for a in arrays],
            [g.asnumpy() for g in grads])


def _assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif want.dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=1e-5, atol=1e-5, equal_nan=True, err_msg=what)


@pytest.fixture(autouse=True)
def _host():
    for pkg in (jmx, tmx):  # marked variables persist by design; start each case clean
        st = pkg.autograd._st()
        st.marked.clear()
        st.grad_reqs.clear()
        st.tape = []
    with tmx.cpu():
        yield


@pytest.mark.parametrize("cid", sorted(CASES))
def test_op_matches_jax(cid):
    """Forward outputs (and states written back in place) equal the JAX
    package's; where inputs are marked, the gradients for random head
    gradients too."""
    op, inputs, attrs, grad = CASES[cid]
    head = np.random.RandomState(5)

    def out_grads(outs):
        return [head.uniform(-1, 1, o.shape).astype(o.dtype) for o in outs]

    head.seed(5)
    want_outs, want_ins, want_g = _run(jmx, op, inputs, attrs, grad, out_grads)
    head.seed(5)
    got_outs, got_ins, got_g = _run(tmx, op, inputs, attrs, grad, out_grads)
    assert len(got_outs) == len(want_outs)
    for i, (g, w) in enumerate(zip(got_outs + got_ins, want_outs + want_ins)):
        _assert_same(g, w, "%s output/state %d" % (cid, i))
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _assert_same(g, w, "%s gradient %d" % (cid, i))


def _ported_primaries(registry):
    return {op.name: op for op in registry.primary_ops()
            if op.fcompute.__module__.rsplit(".", 1)[-1] in PORTED}


def test_every_ported_operator_has_a_case_and_the_jax_metadata():
    jops, tops = _ported_primaries(jreg), _ported_primaries(treg)
    assert set(tops) == set(jops)
    assert {op for op, *_ in CASES.values()} | SAMPLERS == set(tops)
    for name, j in jops.items():
        t = tops[name]
        assert sorted(t.aliases) == sorted(j.aliases), name
        assert t.defaults == j.defaults, name
        assert t.list_arguments() == j.list_arguments(), name
        assert t.list_outputs() == j.list_outputs(), name
        assert (t.mutate_inputs, t.key_var_num_args, t.needs_rng) == (
            j.mutate_inputs, j.key_var_num_args, j.needs_rng), name
        for alias in j.aliases:
            assert treg.get(alias) is t


@pytest.mark.parametrize("cid", ["sum_keep", "dot_t", "Reshape_code3", "topk_both", "Pad",
                                 "SliceChannel_squeeze", "Embedding", "broadcast_to_zero"])
def test_shape_inference_matches_jax(cid):
    op, inputs, attrs, _ = CASES[cid]
    j, t = jreg.get(op), treg.get(op)
    shapes = [x.shape for x in inputs]
    assert t.infer_shape(t.canon_attrs(attrs), shapes) == j.infer_shape(j.canon_attrs(attrs),
                                                                         shapes)


@pytest.mark.parametrize("attrs,shape", [
    ({"pool_type": "avg", "global_pool": True, "kernel": (1, 1)}, (2, 3, 7, 7)),
    ({"pool_type": "avg", "kernel": (3, 3), "pad": (1, 1)}, (2, 3, 14, 14)),
], ids=["global_avg_7x7", "avg_3x3_pad1"])
def test_pooling_bf16_sums_in_f32(attrs, shape):
    """A deliberate difference (ROADMAP): bf16 avg Pooling. JAX sums each
    window in bf16 (XLA's order); the port sums in f32. The port is held to
    the exact mean of the bf16 inputs rounded to bf16, within one bf16 ulp;
    JAX sits up to 7.1e-3 from the exact mean here, and the port is held to
    JAX within 8e-3."""
    import torch
    import torch.nn.functional as F

    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16().double()
    if attrs.get("global_pool"):
        exact = xb.mean(dim=(2, 3), keepdim=True)
    else:
        exact = F.avg_pool2d(xb, 3, stride=1, padding=1, count_include_pad=True)
    exact = exact.numpy()
    rounded = torch.from_numpy(exact).bfloat16().double().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(rounded))) - 7)
    got, want = (np.asarray(pkg.nd.Pooling(pkg.nd.array(x, dtype="bfloat16"), **attrs).asnumpy(),
                            np.float64) for pkg in (tmx, jmx))
    assert got.shape == want.shape == exact.shape
    assert (np.abs(got - rounded) <= ulp).all()
    assert np.abs(want - exact).max() <= 8e-3
    assert np.abs(got - want).max() <= 8e-3


def test_numpy_closed_forms():
    """A few of tests/test_operator_forward.py's numpy assertions."""
    x = tmx.nd.array(X)
    np.testing.assert_allclose(tmx.nd.erf(x).asnumpy(),
                               np.vectorize(math.erf)(X).astype(np.float32), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmx.nd.gamma(tmx.nd.array(P)).asnumpy(),
                               np.vectorize(math.gamma)(P).astype(np.float32), rtol=1e-5)
    np.testing.assert_allclose((1.5 - x).asnumpy(), 1.5 - X, rtol=1e-6)
    np.testing.assert_allclose((2.0 / (x + 4.0)).asnumpy(), 2.0 / (X + 4.0), rtol=1e-6)
    np.testing.assert_allclose((x > 0).asnumpy(), (X > 0).astype(np.float32))
    parts = tmx.nd.split(tmx.nd.array(X4[0, 0]), num_outputs=5, axis=1)
    assert len(parts) == 5
    np.testing.assert_allclose(tmx.nd.concat(*parts, dim=1).asnumpy(), X4[0, 0])
    np.testing.assert_allclose(
        tmx.nd.Pad(tmx.nd.array(X4), mode="constant", constant_value=5.0,
                   pad_width=(0, 0, 0, 0, 1, 1, 2, 2)).asnumpy(),
        np.pad(X4, ((0, 0), (0, 0), (1, 1), (2, 2)), constant_values=5.0))
