"""The contrib operators of the port's ``contrib/ops.py`` held against the
JAX package's on the CPU: MultiBoxPrior, MultiBoxTarget, MultiBoxDetection,
Proposal, ROIPooling, CTCLoss, fft, ifft, quantize, dequantize and
count_sketch. Each case feeds the same numpy inputs to each package's
``fcompute``: outputs within 1e-5 of their max and the gradients against
one random cotangent within 1e-4; the detection operators' decisions are
equal, ties included: the classes MultiBoxDetection keeps and
MultiBoxTarget's matches bit for bit, Proposal's rois row for row (the
coordinates within 1e-5: XLA contracts the box decode into FMAs, which
moves a coordinate by an ulp). The NMS kernel's plain version is held
to a direct transcription of JAX's two suppression loops. The cases of
``tests/test_contrib_ops.py`` run on the port's ``mx.contrib.nd``."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.contrib import ndarray as cnd
from mxnet_tpu_torch.contrib import ops as tops
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.test_utils import check_numeric_gradient
from test_torch_nn_ops import _close, _run_op

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _boxes(rng, n, lo=0.0, hi=1.0, min_side=0.05):
    xy = rng.uniform(lo, hi - min_side, (n, 2))
    wh = rng.uniform(min_side, (hi - lo) / 2, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, hi)], axis=1).astype(np.float32)


def _anchors(rng, n):
    return _boxes(rng, n)[None]


def _labels(rng, b, m, n_real):
    lab = -np.ones((b, m, 5), np.float32)
    for i in range(b):
        k = n_real[i]
        lab[i, :k, 0] = rng.randint(0, 3, k)
        lab[i, :k, 1:] = _boxes(rng, k, min_side=0.1)
    return lab


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


_R = np.random.RandomState(0)
CASES = {}


def case(cid, op, inputs, attrs=None, n_diff=1, is_train=True, exact=()):
    """``exact``: output indices (or (index, column)) that must be equal."""
    CASES[cid] = (op, attrs or {}, inputs, n_diff, is_train, exact)


# MultiBoxPrior: sizes and ratios, explicit steps and offsets
_FEAT = _R.randn(2, 3, 5, 4).astype(np.float32)
case("prior", "_contrib_MultiBoxPrior", [_FEAT], {"sizes": (0.2, 0.3), "ratios": (1, 2, 0.5)},
     n_diff=0)
case("prior_steps", "_contrib_MultiBoxPrior", [_FEAT],
     {"sizes": (0.5,), "ratios": (1, 3), "steps": (0.25, 0.2), "offsets": (0.3, 0.6)}, n_diff=0)
case("prior_ssd_fc7", "_contrib_MultiBoxPrior", [np.zeros((1, 2, 19, 19), np.float32)],
     {"sizes": (0.2, 0.272), "ratios": (1, 2, 0.5, 3, 1.0 / 3)}, n_diff=0)
# MultiBoxTarget: random gts beside padding rows
_ANC = _anchors(_R, 60)
case("target", "_contrib_MultiBoxTarget",
     [_ANC, _labels(_R, 3, 4, [2, 1, 4]), np.zeros((3, 4, 60), np.float32)], n_diff=0,
     exact=(1, 2))
case("target_thresh", "_contrib_MultiBoxTarget",
     [_ANC, _labels(_R, 2, 3, [3, 2]), np.zeros((2, 4, 60), np.float32)],
     {"overlap_threshold": 0.3, "variances": (0.2, 0.1, 0.3, 0.4)}, n_diff=0, exact=(1, 2))
# the forced match when a real box's best anchor is anchor 0 and the padding
# rows (whose best anchor is anchor 0 too) follow it: JAX's scatter keeps the
# last write
_FORCED_ANC = np.array([[[0.0, 0.0, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9], [0.2, 0.6, 0.4, 0.9]]],
                       np.float32)
_FORCED_LAB = -np.ones((2, 3, 5), np.float32)
_FORCED_LAB[0, 0] = [1, 0.0, 0.0, 0.1, 0.1]  # IoU 0.11 with anchor 0: forced only
_FORCED_LAB[1, 2] = [2, 0.0, 0.0, 0.1, 0.1]  # the real row last: its write wins
case("target_forced_anchor0", "_contrib_MultiBoxTarget",
     [_FORCED_ANC, _FORCED_LAB, np.zeros((2, 4, 3), np.float32)], n_diff=0, exact=(1, 2))


def _det_inputs(rng, b, a_n, c_n, ties=False):
    logits = rng.randn(b, c_n, a_n).astype(np.float32) * 2
    if ties:
        # whole groups of anchors with the same scores, and boxes that overlap
        logits[:, :, 1::3] = logits[:, :, 0:-1:3][:, :, :logits[:, :, 1::3].shape[2]]
    prob = _softmax(logits, 1)
    anc = _anchors(rng, a_n)
    if ties:
        anc[0, 1::3] = anc[0, 0:-1:3][:anc[0, 1::3].shape[0]] + 0.01
    loc = (rng.randn(b, a_n * 4) * 0.2).astype(np.float32)
    return [prob, loc, anc]


case("detection", "_contrib_MultiBoxDetection", _det_inputs(_R, 3, 90, 4), n_diff=0,
     exact=((0, 0),))
case("detection_ties", "_contrib_MultiBoxDetection", _det_inputs(_R, 2, 90, 3, ties=True),
     {"nms_threshold": 0.3}, n_diff=0, exact=((0, 0),))
case("detection_topk_noclip", "_contrib_MultiBoxDetection", _det_inputs(_R, 2, 80, 3),
     {"nms_topk": 20, "clip": False, "threshold": 0.2, "nms_threshold": 0.4}, n_diff=0,
     exact=((0, 0),))


def _proposal_inputs(rng, a_n, h, w, fs, ties=False):
    score = rng.rand(1, a_n, h, w).astype(np.float32)
    if ties:
        score[:, :, ::2] = 0.5  # half the foreground scores equal
    cls_prob = np.concatenate([1 - score, score], axis=1)
    bbox = (rng.randn(1, 4 * a_n, h, w) * 0.3).astype(np.float32)
    return [cls_prob, bbox, np.array([[h * fs, w * fs, 1.0]], np.float32)]


_PROP = {"feature_stride": 4, "scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
         "rpn_pre_nms_top_n": 100, "rpn_post_nms_top_n": 20, "rpn_min_size": 4}
case("proposal", "_contrib_Proposal", _proposal_inputs(_R, 6, 6, 7, 4), _PROP, n_diff=0)
# many boxes under rpn_min_size score -1 (ties among them), and equal scores
case("proposal_ties", "_contrib_Proposal", _proposal_inputs(_R, 6, 8, 8, 4, ties=True),
     dict(_PROP, rpn_min_size=9, threshold=0.5, rpn_post_nms_top_n=60), n_diff=0)
case("proposal_score", "_contrib_Proposal", _proposal_inputs(_R, 6, 5, 5, 4),
     dict(_PROP, output_score=True, rpn_pre_nms_top_n=40), n_diff=0)
# ROIPooling: rois inside, across and outside the map, a second image, empty bins
_ROIS = np.array([[0, 1, 1, 9, 9], [1, 0, 2, 15, 7], [0, 6, 3, 8, 4], [1, -4, -4, 30, 40],
                  [0, 14, 14, 20, 20], [1, 3, 5, 3, 5]], np.float32)
case("roi_pool", "ROIPooling", [_R.randn(2, 3, 8, 9).astype(np.float32), _ROIS],
     {"pooled_size": (3, 2), "spatial_scale": 0.5})
case("roi_pool_7x7", "ROIPooling", [_R.randn(2, 4, 6, 7).astype(np.float32),
                                     _ROIS * np.array([1, 2, 2, 2, 2], np.float32)],
     {"pooled_size": (7, 7), "spatial_scale": 0.25})
# CTCLoss: padding, repeats, a blank-only label, a label out of range (+inf)
_CTC = _R.randn(6, 4, 5).astype(np.float32)
case("ctc", "CTCLoss", [_CTC, np.array([[1, 2, 2], [3, 0, 0], [4, 1, 0], [0, 0, 0]],
                                        np.float32)])
case("ctc_oob", "CTCLoss", [_CTC[:, :2], np.array([[1, 7], [2, 3]], np.float32)], n_diff=0)
case("fft", "fft", [_R.randn(3, 8).astype(np.float32)])
case("fft_3d", "fft", [_R.randn(2, 3, 5).astype(np.float32)])
case("ifft", "ifft", [_R.randn(3, 16).astype(np.float32)])
case("quantize", "quantize", [_R.uniform(-1, 1, (4, 5)).astype(np.float32),
                              np.array([-1.0], np.float32), np.array([1.0], np.float32)],
     n_diff=0, exact=(0,))
case("quantize_narrow", "quantize", [_R.uniform(-2, 2, (3, 6)).astype(np.float32),
                                     np.array([-0.5, -1.0], np.float32),
                                     np.array([0.7], np.float32)], n_diff=0, exact=(0,))
case("dequantize", "dequantize", [_R.randint(0, 256, (4, 5)).astype(np.uint8),
                                  np.array([-1.0], np.float32), np.array([2.0], np.float32)],
     n_diff=0)
case("count_sketch", "count_sketch",
     [_R.randn(3, 10).astype(np.float32), _R.randint(0, 6, (1, 10)).astype(np.float32),
      (_R.randint(0, 2, (1, 10)) * 2 - 1).astype(np.float32)], {"out_dim": 6})


def _exact(outs, spec):
    for e in spec:
        yield (e, outs[e]) if isinstance(e, int) else (e, outs[e[0]][..., e[1]])


@pytest.mark.parametrize("cid", sorted(CASES))
def test_forward_and_gradients_match_jax(cid):
    op, attrs, inputs, n_diff, is_train, exact = CASES[cid]
    (jouts, jgrads), (touts, tgrads) = _run_op(op, attrs, inputs, n_diff, is_train)
    jouts = [np.asarray(j) for j in jouts]
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.dtype == (np.uint8 if j.dtype == np.uint8 else np.float32), (cid, i, t.dtype)
        if np.isinf(j).any():
            np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
            t, j = np.where(np.isinf(t), 0, t), np.where(np.isinf(j), 0, j)
        _close(t, j, FWD_TOL, "%s output %d" % (cid, i))
    for e, (t, j) in zip(exact, zip(_exact(touts, exact), _exact(jouts, exact))):
        np.testing.assert_array_equal(t[1], j[1].astype(t[1].dtype), err_msg="%s %s" % (cid, e))
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _close(t, j, GRAD_TOL, "%s grad of input %d" % (cid, i))


@pytest.mark.parametrize("cid", sorted(CASES))
def test_shape_inference_matches_jax(cid):
    op, attrs, inputs, _, _, _ = CASES[cid]
    j, t = jreg.get(op), treg.get(op)
    shapes = [x.shape for x in inputs]
    assert t.infer_shape(t.canon_attrs(attrs), shapes) == j.infer_shape(j.canon_attrs(attrs),
                                                                         shapes)


@pytest.mark.parametrize("name", ["_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
                                  "_contrib_MultiBoxDetection", "_contrib_Proposal",
                                  "ROIPooling", "CTCLoss", "fft", "ifft", "quantize",
                                  "dequantize", "count_sketch"])
def test_metadata_matches_jax(name):
    j, t = jreg.get(name), treg.get(name)
    assert sorted(t.aliases) == sorted(j.aliases)
    assert t.defaults == j.defaults
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs({}) == j.list_outputs({})
    assert t.need_top_grad == j.need_top_grad


def test_proposal_outputs_with_score():
    j, t = jreg.get("_contrib_Proposal"), treg.get("_contrib_Proposal")
    assert t.list_outputs({"output_score": True}) == j.list_outputs({"output_score": True})


def test_contrib_namespaces_export_every_operator():
    for name in tops.CONTRIB_OP_EXPORTS:
        assert callable(getattr(cnd, name)), name
        assert callable(getattr(tmx.contrib.symbol, name)), name


# -- the NMS kernel's plain version against JAX's two loops, transcribed ----
def _jax_detection_loop(iou, cls_id, order, thr, max_iter):
    a_n = len(cls_id)
    sup = np.zeros(a_n, bool)
    for i in range(max_iter):
        idx = order[i]
        valid = cls_id[idx] >= 0 and not sup[idx]
        sup |= valid & (cls_id == cls_id[idx]) & (iou[idx] > thr) & (np.arange(a_n) != idx)
    return sup


def _jax_proposal_loop(iou, scores, thr):
    k = len(scores)
    sup = np.zeros(k, bool)
    for i in range(k):
        valid = (not sup[i]) and scores[i] > 0
        sup |= valid & (iou[i] > thr) & (np.arange(k) > i)
    return sup


@pytest.mark.parametrize("seed", range(4))
def test_nms_reference_matches_the_jax_loops(seed):
    rng = np.random.RandomState(seed)
    b_n, a_n = 3, 70
    boxes = np.stack([_boxes(rng, a_n, min_side=0.1) for _ in range(b_n)])
    cls_id = rng.randint(-1, 3, (b_n, a_n)).astype(np.float32)
    score = rng.rand(b_n, a_n).astype(np.float32)
    score[:, ::4] = 0.25  # ties
    order = torch.argsort(-torch.from_numpy(score), dim=1, stable=True)
    for max_iter in (a_n, 25):
        mask, o, act = tops.detection_nms_inputs(torch.from_numpy(boxes),
                                                 torch.from_numpy(cls_id),
                                                 order[:, :max_iter], 0.45)
        got = kernels.nms_suppress(mask, o, act).numpy()
        for b in range(b_n):
            iou = kernels.box_iou(torch.from_numpy(boxes[b]), torch.from_numpy(boxes[b]))
            want = _jax_detection_loop(iou.numpy(), cls_id[b], np.argsort(-score[b],
                                                                         kind="stable"),
                                       0.45, max_iter)
            np.testing.assert_array_equal(got[b], want)
    top = torch.from_numpy(boxes[0] * 50)
    sc = torch.from_numpy(np.where(rng.rand(a_n) < 0.2, -1.0, score[0]).astype(np.float32))
    got = kernels.nms_suppress(*tops.proposal_nms_inputs(top, sc, 0.6))[0].numpy()
    want = _jax_proposal_loop(kernels.box_iou(top, top).numpy(), sc.numpy(), 0.6)
    np.testing.assert_array_equal(got, want)


def test_box_iou_matches_jax():
    from mxnet_tpu.contrib.ops import _iou

    rng = np.random.RandomState(5)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[3] = a[3, [2, 3, 0, 1]]  # an inverted box: zero area
    got = kernels.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


def test_nms_suppress_checks_its_arguments():
    mask = torch.zeros((1, 2, 3), dtype=torch.bool)
    with pytest.raises(tmx.MXNetError, match="order"):
        kernels.nms_suppress(mask, torch.zeros((1, 3), dtype=torch.int64),
                             torch.zeros((1, 3), dtype=torch.bool))
    with pytest.raises(tmx.MXNetError, match="bool"):
        kernels.nms_suppress(mask.float(), torch.zeros((1, 2), dtype=torch.int64),
                             torch.zeros((1, 3), dtype=torch.bool))


# -- the cases of tests/test_contrib_ops.py on the port --------------------
def _brute_force_ctc(logits, label):
    t_len, c_n = logits.shape
    p = _softmax(logits, 1).astype(np.float64)
    target = [lab for lab in label if lab > 0]

    def collapse(path):
        out, prev = [], None
        for s in path:
            if s != prev and s != 0:
                out.append(s)
            prev = s
        return out

    total = sum(np.prod([p[t, s] for t, s in enumerate(path)])
                for path in itertools.product(range(c_n), repeat=t_len)
                if collapse(path) == target)
    return -np.log(total)


def test_ctc_loss_vs_brute_force():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 3, 3).astype(np.float32)
    labels = np.array([[1, 2], [2, 0], [1, 1]], np.float32)
    loss = cnd.CTCLoss(tmx.nd.array(logits), tmx.nd.array(labels)).asnumpy()
    for b in range(3):
        np.testing.assert_allclose(loss[b], _brute_force_ctc(logits[:, b], labels[b].astype(int)),
                                   rtol=1e-4, atol=1e-5)


def test_ctc_loss_grad_and_symbol():
    rng = np.random.RandomState(1)
    out = tmx.contrib.symbol.CTCLoss(tmx.sym.Variable("data"), tmx.sym.Variable("label"))
    x = rng.randn(5, 2, 4).astype(np.float32)
    lab = np.array([[1, 3], [2, 0]], np.float32)
    _, out_shapes, _ = out.infer_shape(data=x.shape, label=lab.shape)
    assert out_shapes[0] == (2,)
    check_numeric_gradient(out, {"data": x, "label": lab}, grad_nodes=["data"],
                           numeric_eps=1e-2, rtol=0.1, atol=1e-2)


def test_fft_ifft_round_trip():
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    f = cnd.fft(tmx.nd.array(x)).asnumpy()
    spec = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(f[:, 0::2], spec.real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f[:, 1::2], spec.imag, rtol=1e-4, atol=1e-4)
    back = cnd.ifft(tmx.nd.array(f)).asnumpy()  # unnormalised: n * x
    np.testing.assert_allclose(back, x * 8, rtol=1e-4, atol=1e-4)


def test_quantize_dequantize_round_trip():
    x = np.random.RandomState(3).uniform(-1, 1, (4, 5)).astype(np.float32)
    q, qlo, qhi = cnd.quantize(tmx.nd.array(x), tmx.nd.array([-1.0]), tmx.nd.array([1.0]))
    assert q.asnumpy().dtype == np.uint8
    assert float(qlo.asnumpy()[0]) == -1.0
    back = cnd.dequantize(q, qlo, qhi).asnumpy()
    assert np.abs(back - x).max() <= 2.0 / 255.0


def test_count_sketch():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 10).astype(np.float32)
    h = rng.randint(0, 6, (1, 10)).astype(np.float32)
    s = (rng.randint(0, 2, (1, 10)) * 2 - 1).astype(np.float32)
    out = cnd.count_sketch(tmx.nd.array(x), tmx.nd.array(h), tmx.nd.array(s), out_dim=6).asnumpy()
    expect = np.zeros((3, 6), np.float32)
    for i in range(10):
        expect[:, int(h[0, i])] += s[0, i] * x[:, i]
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)
