"""The layer operators of the port's ``ops/nn.py`` that the ResNet slice
left out, held against the JAX package on the CPU: LeakyReLU,
Deconvolution, Pooling over 1 and 3 spatial dims, InstanceNorm,
L2Normalization, LRN, Dropout, softmax, log_softmax, SoftmaxActivation,
the loss heads (Linear/Logistic/MAE RegressionOutput, SVMOutput, MakeLoss,
softmax_cross_entropy), UpSampling, SequenceLast/Mask/Reverse and Crop.
Each case feeds the same numpy inputs to each package's ``fcompute``:
outputs within 1e-5 and the gradients against one random cotangent (the
loss heads ignore it in both) within 1e-4, each of its max. Dropout's and
rrelu's draws cannot match JAX's threefry bits: they are held by moments,
by equality at p = 0 and at inference, and by repeats from one seed. The
registry names the operators the port still lacks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

# the JAX package's operators the port does not register yet (ROADMAP,
# Queue 1): its ops/spatial.py, contrib/ops.py and Custom
STILL_MISSING = {
    "BilinearSampler", "Correlation", "GridGenerator", "SpatialTransformer",
    "IdentityAttachKLSparseReg",
    "CTCLoss", "ROIPooling", "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
    "_contrib_MultiBoxTarget", "_contrib_Proposal",
    "count_sketch", "fft", "ifft", "quantize", "dequantize",
    "Custom",
}
# the operators of this file, all from mxnet_tpu/ops/nn.py
NN_OPS = (
    "LeakyReLU", "Deconvolution", "InstanceNorm", "L2Normalization", "LRN", "Dropout",
    "softmax", "log_softmax", "SoftmaxActivation", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput", "MakeLoss",
    "softmax_cross_entropy", "UpSampling", "SequenceLast", "SequenceMask", "SequenceReverse",
    "Crop",
)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _randn(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _uniform(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _run_op(name, attrs, inputs, n_diff, is_train=True, seed=0):
    """All outputs, and the gradients of the first ``n_diff`` inputs against
    one random cotangent of output 0, of op ``name`` in each package:
    ((jax outs, jax grads), (port outs, port grads))."""
    jop, top = jreg.get(name), treg.get(name)
    jattrs, tattrs = jop.canon_attrs(attrs), top.canon_attrs(attrs)
    jin = [jnp.asarray(x) for x in inputs]

    def first(*diff):
        return jop.fcompute(jattrs, list(diff) + jin[n_diff:], is_train)[0]

    jouts = jop.fcompute(jattrs, jin, is_train)
    cot = np.random.RandomState(seed + 1).randn(*jouts[0].shape).astype(np.float32)
    jgrads = ()
    if n_diff:
        _, vjp = jax.vjp(first, *jin[:n_diff])
        jgrads = vjp(jnp.asarray(cot, jouts[0].dtype))
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs[:n_diff]]
    rest = [torch.from_numpy(np.array(x)) for x in inputs[n_diff:]]
    touts = top.fcompute(tattrs, leaves + rest, is_train)
    tgrads = []
    if n_diff:
        got = torch.autograd.grad(touts[0], leaves, torch.from_numpy(cot).to(touts[0].dtype),
                                  allow_unused=True)
        tgrads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)]
    return ((jouts, jgrads), ([o.detach().numpy() for o in touts],
                              [g.numpy() for g in tgrads]))


# (op, attrs, inputs, differentiable inputs, is_train)
CASES = {}


def case(cid, op, inputs, attrs=None, n_diff=1, is_train=True):
    CASES[cid] = (op, attrs or {}, inputs, n_diff, is_train)


X4 = _randn(2, 3, 4, 5, seed=1)
POS = _uniform(1, 4, 3, 3, seed=2, lo=0.2, hi=1.5)
# the JAX test's LeakyReLU and elu, prelu's per-channel slope, rrelu's mean slope
case("leaky", "LeakyReLU", [X4], {"act_type": "leaky", "slope": 0.1})
case("leaky_default", "LeakyReLU", [_randn(4, 4, seed=3)])
case("elu", "LeakyReLU", [X4], {"act_type": "elu", "slope": 1.0})
case("prelu", "LeakyReLU", [X4, _uniform(3, seed=4, lo=0.05, hi=0.5)], {"act_type": "prelu"},
     n_diff=2)
case("rrelu_inference", "LeakyReLU", [X4], {"act_type": "rrelu"}, is_train=False)
# Deconvolution: test_op_gradients' 2x2 case, stride/pad/adj with a bias,
# groups, dilation, 1-D and 3-D
case("deconv_2x2", "Deconvolution", [_randn(1, 2, 3, 3, seed=5), _randn(2, 2, 2, 2, seed=6)],
     {"kernel": (2, 2), "num_filter": 2, "no_bias": True}, n_diff=2)
case("deconv_stride_adj_bias", "Deconvolution",
     [_randn(2, 4, 5, 4, seed=7), _randn(4, 3, 3, 3, seed=8, scale=0.3), _randn(3, seed=9)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1), "num_filter": 3,
      "no_bias": False}, n_diff=3)
case("deconv_groups_dilate", "Deconvolution",
     [_randn(1, 4, 5, 5, seed=10), _randn(4, 3, 3, 3, seed=11, scale=0.3)],
     {"kernel": (3, 3), "dilate": (2, 2), "num_group": 2, "num_filter": 6}, n_diff=2)
case("deconv_1d", "Deconvolution", [_randn(2, 3, 7, seed=12), _randn(3, 2, 4, seed=13)],
     {"kernel": (4,), "stride": (2,), "pad": (1,), "num_filter": 2}, n_diff=2)
case("deconv_3d", "Deconvolution", [_randn(1, 2, 3, 4, 3, seed=14),
                                    _randn(2, 2, 2, 2, 2, seed=15)],
     {"kernel": (2, 2, 2), "stride": (2, 1, 2), "num_filter": 2}, n_diff=2)
# Pooling over 1 and 3 spatial dims: max, avg and sum, valid and full
for _nd, _shape, _k, _s, _p in ((1, (2, 3, 11), (3,), (2,), (1,)),
                                (3, (1, 2, 7, 6, 8), (3, 2, 3), (2, 2, 2), (1, 0, 1))):
    for _ptype in ("max", "avg", "sum"):
        for _conv in ("valid", "full"):
            case("pool%dd_%s_%s" % (_nd, _ptype, _conv), "Pooling",
                 [_randn(*_shape, seed=16 + _nd)],
                 {"kernel": _k, "stride": _s, "pad": _p, "pool_type": _ptype,
                  "pooling_convention": _conv})
    case("pool%dd_global_avg" % _nd, "Pooling", [_randn(*_shape, seed=18)],
         {"kernel": _k, "global_pool": True, "pool_type": "avg"})
case("pool3d_max_nopad", "Pooling", [_randn(1, 2, 4, 4, 4, seed=19)],
     {"kernel": (2, 2, 2), "stride": (2, 2, 2), "pool_type": "max"})
# the norms
case("instance_norm_3d", "InstanceNorm",
     [_randn(2, 3, 4, seed=20), _uniform(3, seed=21, lo=0.5, hi=1.5), _randn(3, seed=22)],
     n_diff=3)
case("instance_norm_4d", "InstanceNorm",
     [_randn(2, 3, 4, 5, seed=23, shift=0.5), _uniform(3, seed=24, lo=0.5, hi=1.5),
      _randn(3, seed=25)], {"eps": 1e-5}, n_diff=3)
for _mode in ("instance", "channel", "spatial"):
    case("l2norm_" + _mode, "L2Normalization", [_uniform(2, 3, 4, 5, seed=26, lo=0.1, hi=1.0)],
         {"mode": _mode})
case("lrn_3", "LRN", [POS], {"nsize": 3})
case("lrn_alexnet", "LRN", [_uniform(2, 8, 5, 5, seed=27, lo=0.0, hi=4.0)],
     {"alpha": 1e-4, "beta": 0.75, "knorm": 2, "nsize": 5})
case("lrn_2d", "LRN", [_uniform(3, 7, seed=28, lo=0.1, hi=2.0)], {"nsize": 5, "alpha": 0.5})
# Dropout where it is the identity in JAX: p = 0 and inference
case("dropout_p0", "Dropout", [X4], {"p": 0.0})
case("dropout_inference", "Dropout", [X4], {"p": 0.5}, is_train=False)
# softmax family
case("softmax", "softmax", [X4])
case("softmax_axis1", "softmax", [X4], {"axis": 1})
case("log_softmax", "log_softmax", [X4])
case("log_softmax_axis0", "log_softmax", [X4], {"axis": 0})
case("softmax_activation", "SoftmaxActivation", [X4])
case("softmax_activation_channel", "SoftmaxActivation", [X4], {"mode": "channel"})
# loss heads: the backward ignores the cotangent in both packages
_X43, _Y43 = _uniform(4, 3, seed=29), _uniform(4, 3, seed=30)
case("linear_regression", "LinearRegressionOutput", [_X43, _Y43])
case("linear_regression_scale", "LinearRegressionOutput",
     [_randn(2, 3, 4, seed=31), _randn(2, 12, seed=32)], {"grad_scale": 0.5})
case("logistic_regression", "LogisticRegressionOutput", [_randn(4, 3, seed=33),
                                                         np.round(_Y43)])
case("mae_regression", "MAERegressionOutput", [_randn(5, seed=34), _randn(5, seed=35)],
     {"grad_scale": 2.0})
_LABEL = np.array([0, 2, 4, 2, 1], np.float32)
case("svm_l2", "SVMOutput", [_randn(5, 5, seed=36), _LABEL])
case("svm_l1_margin", "SVMOutput", [_randn(5, 5, seed=37), _LABEL],
     {"use_linear": True, "margin": 0.5, "regularization_coefficient": 0.3})
case("make_loss", "MakeLoss", [X4])
case("make_loss_batch", "MakeLoss", [X4], {"grad_scale": 3.0, "normalization": "batch"})
case("softmax_cross_entropy", "softmax_cross_entropy", [_randn(5, 5, seed=38), _LABEL])
# UpSampling: the JAX test's nearest case, several inputs, bilinear
case("upsampling_nearest", "UpSampling", [_uniform(1, 2, 3, 3, seed=39)],
     {"scale": 2, "sample_type": "nearest"})
case("upsampling_nearest_concat", "UpSampling",
     [_randn(1, 2, 3, 3, seed=40), _randn(1, 3, 6, 6, seed=41)],
     {"scale": 2, "sample_type": "nearest", "num_args": 2}, n_diff=2)
case("upsampling_bilinear", "UpSampling",
     [_randn(2, 2, 4, 3, seed=42), _randn(2, 1, 4, 4, seed=43)],
     {"scale": 2, "sample_type": "bilinear", "num_args": 2})
case("upsampling_bilinear_x3", "UpSampling",
     [_randn(1, 3, 3, 5, seed=44), _randn(3, 1, 5, 5, seed=45)],
     {"scale": 3, "sample_type": "bilinear", "num_args": 2})
# Sequence ops over (T, N, C): the JAX test's lengths, full lengths, a 0
_SEQ = _uniform(4, 3, 2, seed=46)
_LENS = np.array([2, 3, 4], np.float32)
case("sequence_last", "SequenceLast", [_SEQ])
case("sequence_last_lengths", "SequenceLast", [_SEQ, _LENS], {"use_sequence_length": True})
case("sequence_mask_lengths", "SequenceMask", [_SEQ, _LENS],
     {"use_sequence_length": True, "value": -1.0})
case("sequence_mask_zero", "SequenceMask", [_randn(5, 2, 3, 2, seed=47),
                                           np.array([0, 3], np.float32)],
     {"use_sequence_length": True})
case("sequence_reverse", "SequenceReverse", [_SEQ])
case("sequence_reverse_lengths", "SequenceReverse", [_randn(5, 3, 2, 2, seed=48),
                                                     np.array([5, 1, 3], np.float32)],
     {"use_sequence_length": True})
# Crop: an offset, centred, to a second input's size
case("crop_offset", "Crop", [_randn(2, 3, 7, 8, seed=49)], {"h_w": (4, 5), "offset": (2, 1)})
case("crop_center", "Crop", [_randn(2, 3, 7, 8, seed=50)], {"h_w": (3, 4), "center_crop": True})
case("crop_like", "Crop", [_randn(1, 2, 9, 9, seed=51), _randn(1, 5, 6, 4, seed=52)],
     {"num_args": 2, "center_crop": True})


@pytest.mark.parametrize("cid", sorted(CASES))
def test_forward_and_gradients_match_jax(cid):
    """Outputs within 1e-5 and gradients within 1e-4 of their max."""
    op, attrs, inputs, n_diff, is_train = CASES[cid]
    (jouts, jgrads), (touts, tgrads) = _run_op(op, attrs, inputs, n_diff, is_train)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, FWD_TOL, "%s output %d" % (cid, i))
    assert len(tgrads) == len(jgrads)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _close(t, j, GRAD_TOL, "%s grad of input %d" % (cid, i))


@pytest.mark.parametrize("cid", sorted(CASES))
def test_shape_inference_matches_jax(cid):
    op, attrs, inputs, _, _ = CASES[cid]
    j, t = jreg.get(op), treg.get(op)
    shapes = [x.shape for x in inputs]
    assert t.infer_shape(t.canon_attrs(attrs), shapes) == j.infer_shape(j.canon_attrs(attrs),
                                                                         shapes)


def test_registry_is_jax_minus_the_operators_still_missing():
    """The port registers every primary operator of the JAX package but the
    17 of spatial.py, contrib/ops.py and Custom, and the 20 of this
    file carry JAX's metadata."""
    jops = {op.name: op for op in jreg.primary_ops()}
    tops = {op.name: op for op in treg.primary_ops()}
    assert STILL_MISSING <= set(jops)
    assert set(tops) == set(jops) - STILL_MISSING
    assert len(set(NN_OPS)) == 20 and set(NN_OPS) <= set(tops)
    for name in NN_OPS + ("Pooling",):
        j, t = jops[name], tops[name]
        assert sorted(t.aliases) == sorted(j.aliases), name
        assert t.defaults == j.defaults, name
        assert t.list_outputs() == j.list_outputs(), name
        assert (t.key_var_num_args, t.needs_rng, t.need_top_grad) == (
            j.key_var_num_args, j.needs_rng, j.need_top_grad), name
        for attrs in (None, {}, {"act_type": "prelu"}, {"no_bias": False},
                      {"use_sequence_length": True}, {"num_args": 2}):
            assert t.list_arguments(attrs) == j.list_arguments(attrs), (name, attrs)
    assert {case[0] for case in CASES.values()} == set(NN_OPS) | {"Pooling"}


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_lrn_bf16_matches_jax_within_bf16_rounding():
    """bf16 LRN computes its window, its power and its product in bf16 in
    both packages, with its constants rounded to bf16 first: the port
    within one bf16 ulp of JAX, element by
    element."""
    x = _uniform(2, 8, 5, 5, seed=53, lo=0.0, hi=4.0)
    attrs = {"alpha": 1e-2, "beta": 0.75, "knorm": 2, "nsize": 5}
    xb = torch.from_numpy(x).bfloat16()
    got = treg.get("LRN").fcompute(treg.get("LRN").canon_attrs(attrs), [xb], True)[0]
    assert got.dtype == torch.bfloat16
    want = np.asarray(jreg.get("LRN").fcompute(
        jreg.get("LRN").canon_attrs(attrs), [jnp.asarray(xb.float().numpy(), jnp.bfloat16)],
        True)[0], np.float32)
    got = got.float().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def _dropout(x, p, seed, is_train=True):
    op = treg.get("Dropout")
    attrs = dict(op.canon_attrs({"p": p}), __rng__=torch.Generator().manual_seed(seed))
    return op.fcompute(attrs, [x], is_train)[0]


@pytest.mark.parametrize("p", [0.5, 0.2])
def test_dropout_keep_rate_and_scaling_by_moments(p):
    """A 200 x 200 ones input: the kept share is 1 − p within 4 standard
    deviations, every kept value is 1/(1 − p) and the rest 0, so the mean
    is 1; the gradient is the mask over 1 − p."""
    x = torch.ones(200, 200, requires_grad=True)
    y = _dropout(x, p, seed=7)
    keep = 1.0 - p
    kept = (y != 0).double().mean().item()
    assert abs(kept - keep) <= 4 * np.sqrt(keep * p / y.numel())
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0 / keep}
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0 / keep))
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, (y != 0).float() / keep)


def test_dropout_is_repeatable_from_one_seed_and_differs_across_seeds():
    x = torch.from_numpy(_randn(50, 40, seed=54))
    assert torch.equal(_dropout(x, 0.5, seed=3), _dropout(x, 0.5, seed=3))
    assert not torch.equal(_dropout(x, 0.5, seed=3), _dropout(x, 0.5, seed=4))


def test_dropout_bf16_divides_in_bf16_as_jax_does():
    """Kept bf16 values are x / keep rounded once to bf16, the bits JAX's
    ``ins[0] / keep`` gives on the same values."""
    x = torch.from_numpy(_randn(64, 64, seed=55)).bfloat16()
    y = _dropout(x, 0.3, seed=1)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.7, np.float32)
    kept = (y != 0).numpy()
    assert np.array_equal(y.float().numpy()[kept], want[kept])


def test_rrelu_training_slopes_by_moments():
    """rrelu in training: positive inputs pass; each negative one is scaled
    by a slope in [lower, upper) whose mean is their midpoint (4 standard
    deviations of a uniform); the same seed gives the same slopes."""
    op = treg.get("LeakyReLU")
    x = -torch.from_numpy(_uniform(100, 100, seed=56, lo=0.5, hi=2.0))
    x[:10] = 1.0
    lo, up = 0.125, 0.334

    def run(seed):
        attrs = dict(op.canon_attrs({"act_type": "rrelu"}),
                     __rng__=torch.Generator().manual_seed(seed))
        return op.fcompute(attrs, [x], True)[0]

    y = run(9)
    assert torch.equal(y[:10], x[:10])
    slope = (y[10:] / x[10:]).double()
    assert slope.min() >= lo - 1e-6 and slope.max() < up + 1e-6
    sd = (up - lo) / np.sqrt(12 * slope.numel())
    assert abs(slope.mean().item() - (lo + up) / 2) <= 4 * sd
    assert torch.equal(run(9), y)
