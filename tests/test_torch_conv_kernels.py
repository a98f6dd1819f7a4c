"""The PyTorch port's conv-backward pair (K2 ``conv_bwd_filter``, K3
``conv_bwd_input``) held against the JAX package on the CPU: the port's
plain versions against the Pallas kernels in interpret mode
(``MXTPU_CONV_KERNEL=pallas``, as ``tests/test_conv_kernels.py`` runs
them), the shape envelope against ``conv_bwd_plan`` over a grid and over
ResNet-50's 53 convolutions, and the autograd Function's gradients against
``_conv2d_pallas_bwd``'s ``custom_vjp``. The kernels themselves run only on
the card (``tests/test_torch_cuda_kernels.py``)."""
import importlib
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import name as jname
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import _build, kernels

# mxnet_tpu.models re-exports a function named resnet over the module
jresnet = importlib.import_module("mxnet_tpu.models.resnet")

# tests/test_conv_kernels.py's CASES: 1x1/3x3/5x5, 'same' and 'valid',
# non-square spatial
CASES = [
    ((2, 8, 10, 10), (16, 8, 3, 3), (1, 1)),
    ((4, 16, 7, 9), (8, 16, 1, 1), (0, 0)),
    ((2, 8, 9, 11), (8, 8, 3, 3), (0, 0)),
    ((3, 8, 8, 8), (8, 8, 5, 5), (2, 2)),
]


@pytest.fixture(autouse=True)
def _pallas_on(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_KERNEL", "pallas")
    pk._conv_plan_cache.clear()
    yield
    pk._conv_plan_cache.clear()


def _inputs(dshape, wshape, pad, seed=0):
    """f32 numpy x, w and a cotangent g of the conv's output shape."""
    rng = np.random.RandomState(seed)
    n, _, h, w = dshape
    o, _, kh, kw = wshape
    oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
    x = rng.randn(*dshape).astype(np.float32)
    wt = (rng.randn(*wshape) * 0.1).astype(np.float32)
    g = rng.randn(*oshape).astype(np.float32)
    return x, wt, g


@pytest.mark.parametrize("dshape,wshape,pad", CASES)
def test_plain_pair_matches_pallas_f32(dshape, wshape, pad):
    x, w, g = _inputs(dshape, wshape, pad)
    want_w = np.asarray(pk.conv_bwd_filter(jnp.asarray(x), jnp.asarray(g), wshape, pad))
    want_x = np.asarray(pk.conv_bwd_input(jnp.asarray(g), jnp.asarray(w), dshape, pad))
    got_w = kernels.conv_bwd_filter(torch.from_numpy(x), torch.from_numpy(g), wshape, pad)
    got_x = kernels.conv_bwd_input(torch.from_numpy(g), torch.from_numpy(w), dshape, pad)
    assert got_w.dtype == torch.float32 and got_x.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dshape,wshape,pad", CASES[:2])
def test_plain_pair_matches_pallas_bf16_f32_accumulation(dshape, wshape, pad):
    # the same bf16-rounded inputs on both sides; both accumulate in f32
    x, w, g = _inputs(dshape, wshape, pad, seed=1)
    jx, jw, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    tx, tw, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, g))
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    want_w = np.asarray(pk.conv_bwd_filter(jx, jg, wshape, pad))
    want_x = np.asarray(pk.conv_bwd_input(jg, jw, dshape, pad))
    got_w = kernels.conv_bwd_filter(tx, tg, wshape, pad)
    got_x = kernels.conv_bwd_input(tg, tw, dshape, pad)
    assert got_w.dtype == torch.float32 and got_x.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-4, atol=1e-3)


def test_envelope_matches_jax_over_a_grid():
    seen = {True: 0, False: 0}
    for (n, c, hw, o, k, pad, stride, dil, dtype) in itertools.product(
            (1, 2), (3, 8, 16, 64), (1, 7, 56), (8, 12, 256), (1, 3, 5, 7), (0, 1, 2, 3),
            (1, 2), (1, 2), ("float32", "bfloat16", "float16")):
        args = ((n, c, hw, hw), (o, c, k, k), (stride, stride), (pad, pad), (dil, dil), dtype)
        want = pk.conv_bwd_plan(*args) is not None
        assert kernels.conv_bwd_plan(*args) is want, args
        seen[want] += 1
    # grouped weights (C/g != C) and the VMEM term reject in both
    for args in (((2, 16, 8, 8), (16, 8, 3, 3), (1, 1), (1, 1), (1, 1), "float32"),
                 ((1, 512, 224, 224), (64, 512, 3, 3), (1, 1), (1, 1), (1, 1), "float32")):
        assert pk.conv_bwd_plan(*args) is None
        assert kernels.conv_bwd_plan(*args) is False
    assert seen[True] > 100 and seen[False] > 1000, seen
    assert kernels.conv_bwd_plan((2, 8, 9, 9), (8, 8, 3, 3), (1, 1), (1, 1), (1, 1),
                                 torch.bfloat16)


def _jax_conv_layers(symbol, data_shape):
    known = symbol._infer_shape_impl(
        False, data=data_shape, softmax_label=(data_shape[0],))[3]
    out = []
    for node in symbol._nodes():
        if node.is_variable or node.op.name != "Convolution":
            continue
        _, stride, dilate, pad = jnn._conv_dims(node.canon_attrs())
        (d, di), (w, wi) = node.inputs[0], node.inputs[1]
        out.append((node.name, known[(id(d), di)], known[(id(w), wi)], stride, pad, dilate))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_convs_in_the_envelope_match_jax(dtype):
    shape = (32, 3, 224, 224)
    with jname.NameManager():
        jlayers = _jax_conv_layers(jresnet.get_symbol(), shape)
    with tname.NameManager():
        tlayers = tresnet.conv_layers(tresnet.get_symbol(), shape)
    assert len(jlayers) == len(tlayers) == 53
    jin, tin = [], []
    for (name, d, w, s, p, dl), layer in zip(jlayers, tlayers):
        assert (name, tuple(d), tuple(w), s, p, dl) == (
            layer["name"], layer["data"], layer["weight"], layer["stride"], layer["pad"],
            layer["dilate"])
        if pk.conv_bwd_plan(d, w, s, p, dl, dtype) is not None:
            jin.append(name)
        if kernels.conv_bwd_plan(d, w, s, p, dl, dtype):
            tin.append(name)
    assert jin == tin and len(tin) == 46
    outside = sorted(set(layer["name"] for layer in tlayers) - set(tin))
    assert outside == ["conv0", "stage2_unit1_conv2", "stage2_unit1_sc", "stage3_unit1_conv2",
                       "stage3_unit1_sc", "stage4_unit1_conv2", "stage4_unit1_sc"]


@pytest.mark.parametrize("dshape,wshape,pad", CASES)
def test_autograd_function_matches_pallas_custom_vjp(dshape, wshape, pad):
    """conv2d_kernel_bwd's forward and both gradients (the plain versions on
    the CPU) against jax.vjp of _conv2d_pallas_bwd (the Pallas pair in
    interpret mode)."""
    x, w, g = _inputs(dshape, wshape, pad, seed=2)
    y, vjp = jax.vjp(lambda d, k: jnn._conv2d_pallas_bwd(d, k, pad),
                     jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = kernels.conv2d_kernel_bwd(tx, tw, pad)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-5)


# the kernels' products of one k step, (plane of A, plane of B) in their
# order: bf16 a·b; split f32 a_hi·b_lo, a_lo·b_hi, a_hi·b_hi
_PRODUCTS = {torch.bfloat16: ((0, 0),), torch.float32: ((0, 1), (1, 0), (0, 0))}
# ResNet-50's headline 3x3 and 1x1 convolutions at batch 2, and ragged
# ones: 136 channels (a partial 128-channel tile), 7 x 7, 40 o
HEADLINE = [
    ((2, 256, 14, 14), (256, 256, 3, 3), (1, 1)),
    ((2, 64, 56, 56), (256, 64, 1, 1), (0, 0)),
]
# the image-classification zoo's new ground (inception-v3, googlenet): 1 x 7
# with pad (0, 3) and 7 x 1 with pad (3, 0) on 17 x 17, 1 x 3 and 3 x 1 on
# 8 x 8, 24 channels under a 5 x 5 kernel and 24 o from a 1 x 1, and a 1 x 1
# at 17 x 17 (OH·OW not a multiple of 8: K2's flat mode in bf16 too)
ZOO_CASES = [
    ((1, 8, 17, 17), (16, 8, 1, 7), (0, 3)),
    ((1, 8, 17, 17), (16, 8, 7, 1), (3, 0)),
    ((2, 16, 8, 8), (8, 16, 1, 3), (0, 1)),
    ((2, 16, 8, 8), (8, 16, 3, 1), (1, 0)),
    ((1, 24, 9, 9), (64, 24, 5, 5), (2, 2)),
    ((2, 72, 7, 7), (24, 72, 1, 1), (0, 0)),
    ((2, 16, 17, 17), (24, 16, 1, 1), (0, 0)),
]
# the f32 limit of the emulated split against the plain version and JAX's,
# as a share of max|plain|, the card's limit for f32 K2 and K3
F32_LIMIT = 1e-4
# bf16 and split f32: the k steps whose products the kernels sum in a second
# accumulator before adding it into the first (conv_bwd.cu's kPromoteSteps)
PROMOTE_STEPS = int(re.search(r"constexpr int kPromoteSteps = (\d+);",
                              (_build.CSRC / "conv_bwd.cu").read_text()).group(1))


class _Accumulator:
    """A kernel's sums of one output tile: the products of a k step go into
    ``part``, which is added into ``acc`` after every ``PROMOTE_STEPS``
    steps and after the last (bf16 and split f32 alike)."""

    def __init__(self, shape):
        self.acc, self.part = torch.zeros(shape), torch.zeros(shape)
        self.steps = 0

    def step(self, products):
        for prod in products:
            self.part += prod
        self.steps += 1
        if self.steps % PROMOTE_STEPS == 0:
            self.total()

    def total(self):
        self.acc += self.part
        self.part.zero_()
        return self.acc


def _planes(t):
    """A layout copy as (planes, ...) f32: bf16 one plane, f32's two."""
    return t.float() if t.dim() == 5 else t.float()[None]


def _emulate_dgrad_sm90(grad, weight, dshape, pad):
    """What the K3 kernel computes, in plain torch on the copies
    ``conv_dgrad_layout`` makes (bf16 one plane, f32 its hi and lo
    planes): an output tile is an 8 x 8 patch of one image's positions by
    64 (C <= 64) or 128 channels; its k steps run tap by tap (i major, j
    minor), 64 o a step; each step's A is the box (y 8, x 8, o 64) of
    channels-last g at (y0 + ph - i, x0 + pw - j, o0), zero outside
    OH x OW and past O, and its B the box (c kN, o 64) of the (C, kh, kw,
    O) weight at (c0, i, j, o0), zero past C and O, multiplied plane by
    plane in the kernel's order (``_PRODUCTS``) and summed as the kernel
    sums them (``_Accumulator``); the f32 sum lands on the
    positions inside H x W and the channels below C."""
    g_cl, w_t = (_planes(t) for t in kernels.conv_dgrad_layout(grad, weight))
    products = _PRODUCTS[grad.dtype]
    n, c, h, w = dshape
    planes, _, kh, kw, o = w_t.shape
    oh, ow = g_cl.shape[2:4]
    kn = 64 if c <= 64 else 128
    chunks = -(-o // 64)
    # zeros around OH x OW and up to a whole number of o chunks and c tiles
    m = 8 + max(kh, kw)
    gp = torch.zeros(planes, n, oh + 2 * m, ow + 2 * m, 64 * chunks)
    gp[:, :, m:m + oh, m:m + ow, :o] = g_cl
    wp = torch.zeros(planes, kn * -(-c // kn), kh, kw, 64 * chunks)
    wp[:, :c, :, :, :o] = w_t
    dx = torch.full((n, c, h, w), float("nan"))
    for img in range(n):
        for y0 in range(0, h, 8):
            for x0 in range(0, w, 8):
                for c0 in range(0, c, kn):
                    sums = _Accumulator((64, kn))
                    for tap in range(kh * kw):
                        i, j = divmod(tap, kw)
                        ys, xs = m + y0 + pad[0] - i, m + x0 + pad[1] - j
                        for o0 in range(0, o, 64):
                            a = gp[:, img, ys:ys + 8, xs:xs + 8, o0:o0 + 64].reshape(planes, 64, 64)
                            b = wp[:, c0:c0 + kn, i, j, o0:o0 + 64]
                            sums.step(a[pa] @ b[pb].T for pa, pb in products)
                    acc = sums.total().reshape(8, 8, kn).permute(2, 0, 1)
                    ye, xe, ce = min(8, h - y0), min(8, w - x0), min(kn, c - c0)
                    dx[img, c0:c0 + ce, y0:y0 + ye, x0:x0 + xe] = acc[:ce, :ye, :xe]
    return dx


def _tiling_inputs(dtype, *arrays):
    """bf16: the arrays rounded to bf16 (whose products are exact in f32,
    so the emulation matches to 1e-5 of max); f32: the arrays as they are
    (the split's three products, held to the f32 limit)."""
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _hold(got, plain, jax_out, dtype):
    """got within the dtype's limit of max|plain| of the plain version and
    of JAX's Pallas kernel."""
    worst = max(np.abs(got - want).max() for want in (plain, jax_out)) / np.abs(plain).max()
    assert worst <= (1e-5 if dtype == "bfloat16" else F32_LIMIT), worst


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dshape,wshape,pad", CASES + HEADLINE + ZOO_CASES + [
    ((2, 16, 7, 7), (40, 16, 3, 3), (1, 1)),
    ((1, 136, 7, 7), (72, 136, 3, 3), (1, 1)),  # the 128-channel tile, two o chunks
])
def test_dgrad_tiling_matches_plain_and_pallas(dshape, wshape, pad, dtype):
    """The K3 kernel's tiling and layouts, emulated on the CPU: bf16 on
    bf16-valued inputs within 1e-5 of max against the plain version and
    against JAX's conv_bwd_input (Pallas, interpret mode); f32 on f32
    inputs, as its hi and lo planes and three bf16 products, within the
    f32 limit, 1e-4 of max (the worst case found is 5.8e-6 of max: a
    margin of 17x). Index errors of the card's kernel show here first."""
    _, w, g = _inputs(dshape, wshape, pad, seed=3)
    tw, tg = _tiling_inputs(dtype, w, g)
    got = _emulate_dgrad_sm90(tg, tw, dshape, pad)
    plain = kernels.conv_bwd_input_reference(tg, tw, dshape, pad)
    jax_dx = np.asarray(pk.conv_bwd_input(jnp.asarray(tg.float().numpy()),
                                          jnp.asarray(tw.float().numpy()), dshape, pad))
    _hold(got.numpy(), plain.numpy(), jax_dx, dtype)


def _emulate_wgrad_sm90(data, grad, wshape, pad, sm_count=132):
    """What the K2 kernel computes, in plain torch on the copies
    ``conv_wgrad_layout`` makes (bf16 one plane, f32 its hi and lo
    planes): per tap (i major, j minor) an (o x c) GEMM over k steps of 64
    positions, cut into CTA tiles of 128 o (two warpgroups, each its own
    64 o: A box 0 or 1) where O > 64, else 64, by kN channels (kN = 64
    when C <= 64, else 128: two 64-channel boxes), in the mode
    ``wgrad_plan_sm90`` picks for these tensors, each step's boxes
    multiplied plane by plane in the kernel's order (``_PRODUCTS``) and
    summed as the kernel sums them (``_Accumulator``). A
    step is an 8 x 8 patch of one image (image major, then y, then x): A
    the box (y 8, x 8, o 64) of channels-last g at (y0, x0, o0), zero past
    OH x OW and O, B the box (y 8, x 8, c kN) of channels-last x at (y0 +
    i - ph, x0 + j - pw, c0), zero outside H x W and past C; for a 1 x 1
    kernel with no padding, 64 consecutive positions of one image's OH·OW
    in NCHW where OH·OW·2 bytes is a multiple of 16 (bf16 only; zero past
    each image's end), else of the N·OH·OW rows (zero past the end).
    ``wgrad_plan_sm90`` cuts the steps into splits; each writes its f32
    partial of the tiles' o < O, c < C, and the partials are summed over
    the splits in order into (O, C, kh, kw)."""
    x_cl, g_cl = (_planes(t) for t in kernels.conv_wgrad_layout(data, grad))
    products = _PRODUCTS[data.dtype]
    planes, n, h, w, c = x_cl.shape
    _, _, oh, ow, o = g_cl.shape
    _, _, kh, kw = wshape
    ph, pw = pad
    kn = 64 if c <= 64 else 128
    o_tile = 128 if o > 64 else 64
    mode, splits, per = kernels.wgrad_plan_sm90(data, grad, wshape, pad, sm_count)
    steps = kernels.wgrad_steps_sm90(mode, n, oh, ow)
    co, cc = o_tile * -(-o // o_tile), kn * -(-c // kn)
    if mode == "nchw":
        runs = -(-oh * ow // 64)
        gp = torch.zeros(n, co, 64 * runs)
        gp[:, :o, :oh * ow] = grad.float().reshape(n, o, -1)
        xp = torch.zeros(n, cc, 64 * runs)
        xp[:, :c, :h * w] = data.float().reshape(n, c, -1)

        def boxes(step, i, j):
            img, r = divmod(step, runs)
            return (gp[None, img, :, 64 * r:64 * r + 64].mT, xp[None, img, :, 64 * r:64 * r + 64].mT)
    elif mode == "flat":
        gp = torch.zeros(planes, 64 * steps, co)
        gp[:, :n * oh * ow, :o] = g_cl.reshape(planes, -1, o)
        xp = torch.zeros(planes, 64 * steps, cc)
        xp[:, :n * h * w, :c] = x_cl.reshape(planes, -1, c)

        def boxes(step, i, j):
            return gp[:, 64 * step:64 * step + 64], xp[:, 64 * step:64 * step + 64]
    else:
        ty, tx = -(-oh // 8), -(-ow // 8)
        gp = torch.zeros(planes, n, 8 * ty, 8 * tx, co)
        gp[:, :, :oh, :ow, :o] = g_cl
        m = 8 + max(kh, kw)
        xp = torch.zeros(planes, n, h + 2 * m, w + 2 * m, cc)
        xp[:, :, m:m + h, m:m + w, :c] = x_cl

        def boxes(step, i, j):
            img, r = divmod(step, ty * tx)
            y0, x0 = 8 * (r // tx), 8 * (r % tx)
            ys, xs = m + y0 + i - ph, m + x0 + j - pw
            return (gp[:, img, y0:y0 + 8, x0:x0 + 8].reshape(planes, 64, co),
                    xp[:, img, ys:ys + 8, xs:xs + 8].reshape(planes, 64, cc))
    ws = torch.full((splits, kh * kw, o, c), float("nan"))
    for tap in range(kh * kw):
        i, j = divmod(tap, kw)
        for split in range(splits):
            for o0 in range(0, o, o_tile):
                for c0 in range(0, c, kn):
                    for wg in range(o_tile // 64):
                        ow0 = o0 + 64 * wg
                        sums = _Accumulator((64, kn))
                        for step in range(split * per, min(split * per + per, steps)):
                            a, b = boxes(step, i, j)
                            sums.step(a[pa, :, ow0:ow0 + 64].T @ b[pb, :, c0:c0 + kn]
                                      for pa, pb in products)
                        acc = sums.total()
                        oe, ce = min(64, o - ow0), min(kn, c - c0)
                        if oe > 0:
                            ws[split, tap, ow0:ow0 + oe, c0:c0 + ce] = acc[:oe, :ce]
    total = ws[0]
    for split in range(1, splits):
        total = total + ws[split]
    return total.permute(1, 2, 0).reshape(o, c, kh, kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dshape,wshape,pad", CASES + HEADLINE + ZOO_CASES + [
    ((1, 136, 7, 7), (16, 136, 3, 3), (1, 1)),  # two c boxes, a partial 128-channel tile
    ((2, 16, 7, 7), (72, 16, 3, 3), (1, 1)),  # a partial o tile: 8 o of the second warpgroup
    ((2, 16, 7, 7), (136, 16, 3, 3), (1, 1)),  # two CTAs of 128 o, one warpgroup empty
    ((2, 16, 9, 11), (72, 16, 1, 1), (0, 0)),  # the same on the flat 1x1 path
    ((3, 24, 9, 11), (40, 24, 5, 5), (2, 2)),  # the ragged 5x5 pad-2 case of chip_smoke
    ((8, 8, 16, 16), (8, 8, 3, 3), (1, 1)),  # four splits of 8 patches
    ((8, 16, 9, 15), (8, 16, 1, 1), (0, 0)),  # two splits of flat steps
    ((4, 16, 16, 16), (8, 16, 1, 1), (0, 0)),  # bf16 NCHW in place, two splits of 8 steps
    ((6, 16, 12, 12), (24, 16, 1, 1), (0, 0)),  # bf16 NCHW in place, a partial last run
])
def test_wgrad_tiling_matches_plain_and_pallas(dshape, wshape, pad, dtype):
    """The K2 kernel's tiling, layouts and split, emulated on the CPU: bf16
    on bf16-valued inputs within 1e-5 of max against the plain version and
    against JAX's conv_bwd_filter (Pallas, interpret mode); f32 on f32
    inputs, as its hi and lo planes and three bf16 products (the
    channels-last copies at every 1 x 1 shape, a split sized by the f32
    ring's CTAs an SM), within the f32 limit, 1e-4 of max (the worst case
    found is 7.0e-6 of max, at 1 x 136 x 7 x 7 -> 16: a margin of 14x).
    Index errors of the card's kernel show here first."""
    x, _, g = _inputs(dshape, wshape, pad, seed=4)
    tx, tg = _tiling_inputs(dtype, x, g)
    got = _emulate_wgrad_sm90(tx, tg, wshape, pad)
    plain = kernels.conv_bwd_filter_reference(tx, tg, wshape, pad)
    jax_gw = np.asarray(pk.conv_bwd_filter(jnp.asarray(tx.float().numpy()),
                                           jnp.asarray(tg.float().numpy()), wshape, pad))
    _hold(got.numpy(), plain.numpy(), jax_gw, dtype)


def _truncating_sum(a, b, every):
    """a.T @ b ((64 * steps) x m each, f32) as the split f32 kernels sum it,
    with a model of the tensor cores' accumulation: each k16 wgmma adds its
    16 products to its f32 accumulator and rounds the sum toward zero.
    Per k step (64 rows), four k16 steps of hi·lo, lo·hi, hi·hi into
    ``part``, which is added into ``acc`` (f32, rounded to nearest) after
    every ``every`` k steps (None: once, after the last)."""
    def rz(v):
        f = v.astype(np.float32)
        over = np.abs(f.astype(np.float64)) > np.abs(v)
        f[over] = np.nextafter(f[over], np.float32(0))
        return f

    m = a.shape[1]
    (a_hi, a_lo), (b_hi, b_lo) = (
        [p.double().numpy().reshape(-1, 16, m) for p in kernels.split_bf16(torch.from_numpy(t))]
        for t in (a, b))
    sums = [np.einsum("tki,tkj->tij", x, y) for x, y in ((a_hi, b_lo), (a_lo, b_hi), (a_hi, b_hi))]
    acc, part = np.zeros((m, m), np.float32), np.zeros((m, m), np.float32)
    for t in range(len(sums[0])):
        for s in sums:
            part = rz(part.astype(np.float64) + s[t])
        if every and (t // 4 + 1) % every == 0 and t % 4 == 3:
            acc, part = acc + part, np.zeros_like(part)
    return acc + part


def test_promotion_bounds_a_truncating_accumulator():
    """K2's sums at batch 32 and 256 (112 and 896 k steps a split at
    ResNet-50's 56 x 56 3 x 3) under a model of the tensor cores that
    rounds each wgmma's f32 sum toward zero: one accumulator gives 3.4e-5
    and 2.9e-4 of max|exact|, the second over the f32 limit (the card
    measured 2.5e-5 and 2.1e-4); adding a second accumulator into the
    first every PROMOTE_STEPS (conv_bwd.cu's kPromoteSteps) k steps holds
    2e-5 at both (7.8e-6 and 6.6e-6 found: 13x inside the limit)."""
    rng = np.random.default_rng(12)
    err = {}
    for steps in (112, 896):
        a, b = (rng.standard_normal((64 * steps, 8)).astype(np.float32) for _ in range(2))
        exact = a.astype(np.float64).T @ b.astype(np.float64)
        for every in (None, PROMOTE_STEPS):
            got = _truncating_sum(a, b, every)
            err[steps, every] = np.abs(got - exact).max() / np.abs(exact).max()
    assert err[112, PROMOTE_STEPS] <= 2e-5 and err[896, PROMOTE_STEPS] <= 2e-5, err
    assert err[896, None] > F32_LIMIT, err


def test_split_bf16_reproduces_every_f32_input():
    """hi + lo of split_bf16 is every f32 input to within 2^-16 of |v|
    wherever lo is a normal bf16 (|v| >= 2^-118), zeros and both signs
    included, and to within 2^-134 below; hi and lo are v and v - hi
    rounded to nearest even (torch's f32 -> bf16 cast, the kernels'
    __float2bfloat16_rn)."""
    rng = np.random.RandomState(8)
    mags = np.exp2(rng.uniform(-118, 126, 200000)).astype(np.float32)
    signs = np.where(rng.rand(mags.size) < 0.5, -1.0, 1.0).astype(np.float32)
    v = torch.from_numpy(np.concatenate([mags * signs, np.float32([0.0, -0.0, 1.0, -3.0]),
                                         rng.randn(50000).astype(np.float32)]))
    hi, lo = kernels.split_bf16(v)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == v.shape
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= v.double().abs() * 2.0 ** -16).all())
    assert bool((hi[v == 0] == 0).all() and (lo[v == 0] == 0).all())
    # lo is v - hi (exact in f32) rounded to nearest, not truncated
    np.testing.assert_array_equal(hi.float().numpy(), v.bfloat16().float().numpy())
    np.testing.assert_array_equal(lo.float().numpy(),
                                  (v - hi.float()).bfloat16().float().numpy())
    # below 2^-118, lo is subnormal: the error is absolute
    tiny = torch.from_numpy(np.exp2(rng.uniform(-149, -118, 10000)).astype(np.float32))
    t_hi, t_lo = kernels.split_bf16(tiny)
    assert float((t_hi.double() + t_lo.double() - tiny.double()).abs().max()) <= 2.0 ** -134


def test_f32_ring_fits_shared_memory():
    """A f32 stage holds the hi and lo planes of A and B, twice a bf16
    stage: the ring keeps 4 stages wherever they fit a CTA's 227 KB, 3
    for K2's CTA of 128 o by 128 channels, and one f32 CTA fits an SM;
    the split counts those CTAs, and f32 never reads NCHW in place."""
    stages = {(o_tile, c_tile, planes): kernels.sm90_stages(
        planes * (o_tile + c_tile) // 64 * 8192)
        for o_tile in (64, 128) for c_tile in (64, 128) for planes in (1, 2)}
    assert stages == {**dict.fromkeys(stages, 4), (128, 128, 2): 3}
    for o_tile in (64, 128):
        for c_tile in (64, 128):
            assert kernels.wgrad_ctas_per_sm90(o_tile, c_tile, planes=2) == 1
    assert kernels.wgrad_ctas_per_sm90(64, 64, stages=3, planes=2) == 2
    # ResNet-50 at batch 32 on 132 SMs: one f32 CTA an SM, so fewer splits
    # where a bf16 CTA of 64 o or 64 channels fits two or three times
    assert kernels.wgrad_splits_sm90(256, 256, 9, 128, 132, planes=2) == (3, 43)
    assert kernels.wgrad_splits_sm90(64, 64, 9, 1568, 132) == (44, 36)
    assert kernels.wgrad_splits_sm90(64, 64, 9, 1568, 132, planes=2) == (14, 112)
    assert kernels.wgrad_splits_sm90(256, 64, 1, 1568, 132, planes=2) == (66, 24)
    x = torch.zeros(4, 16, 16, 16)
    g = torch.zeros(4, 8, 16, 16)
    mode, splits, per = kernels.wgrad_plan_sm90(x, g, (8, 16, 1, 1), (0, 0), 132)
    assert mode == "flat" and x.data_ptr() % 16 == 0
    assert (splits, per) == kernels.wgrad_splits_sm90(8, 16, 1, 16, 132, planes=2)


def test_wgrad_splits_sm90_cover_every_step_once():
    """bf16 K2's split depends only on the shape and the SM count, leaves no
    split empty and covers every k step exactly once; more than one split
    keeps the (o, c, tap, split) CTAs within one wave of the card (by
    shared memory three an SM of 64 o and 64 channels, two of 128 o or 128
    channels, one of both; with a 3-stage ring three and two), each at
    least 8 steps."""
    per_sm = {(64, 64): 3, (64, 128): 2, (128, 64): 2, (128, 128): 1}
    for (o_tile, c_tile), fit in per_sm.items():
        assert kernels.wgrad_ctas_per_sm90(o_tile, c_tile) == fit
    assert kernels.wgrad_ctas_per_sm90(128, 64, stages=3) == 3
    assert kernels.wgrad_ctas_per_sm90(128, 128, stages=3) == 2
    n_shapes = 0
    for o, c, taps, steps, sms in itertools.product((8, 64, 72, 512), (8, 64, 136, 2048),
                                                   (1, 9, 25), (1, 3, 25, 128, 1568), (8, 132)):
        splits, per = kernels.wgrad_splits_sm90(o, c, taps, steps, sms)
        assert (splits, per) == kernels.wgrad_splits_sm90(o, c, taps, steps, sms)
        covered = [s for split in range(splits) for s in range(split * per,
                                                                 min(split * per + per, steps))]
        assert covered == list(range(steps)) and (splits - 1) * per < steps
        o_tile, c_tile = (64 if o <= 64 else 128), (64 if c <= 64 else 128)
        tiles = -(-o // o_tile) * -(-c // c_tile) * taps
        assert splits == 1 or (tiles * splits <= sms * per_sm[o_tile, c_tile] and per >= 8)
        n_shapes += 1
    assert n_shapes == 480
    # ResNet-50 at batch 32 on 132 SMs: 32x256x14x14 3x3, 32x64x56x56 1x1 -> 256
    assert kernels.wgrad_steps_sm90("patch", 32, 14, 14) == 128
    assert kernels.wgrad_splits_sm90(256, 256, 9, 128, 132) == (3, 43)
    assert kernels.wgrad_steps_sm90("nchw", 32, 56, 56) == 1568  # 49 an image
    assert kernels.wgrad_steps_sm90("flat", 32, 14, 14) == 98
    assert kernels.wgrad_steps_sm90("nchw", 3, 12, 12) == 9  # 3 an image
    assert kernels.wgrad_splits_sm90(256, 64, 1, 1568, 132) == (131, 12)
    assert kernels.wgrad_splits_sm90(256, 64, 1, 1568, 132, o_tile=64) == (98, 16)
    assert kernels.wgrad_splits_sm90(64, 256, 1, 1568, 132) == (131, 12)
    assert kernels.wgrad_splits_sm90(512, 512, 9, 32, 132) == (1, 32)


@pytest.mark.parametrize("offset", [(0, 0), (1, 0), (0, 1), (4, 0), (0, 8)])
def test_wgrad_plan_sm90_reads_in_place_only_from_aligned_tensors(offset):
    """bf16 K2 reads a 1 x 1 conv's NCHW data and grad in place only where
    both start on a 16-byte boundary, as TMA wants a tensor's base; a
    contiguous view at another storage offset goes the channels-last
    (flat) route, whose copies the wrapper allocates, and the emulated
    kernel on those views still matches the plain version."""
    dshape, wshape, pad = (4, 16, 16, 16), (8, 16, 1, 1), (0, 0)
    x, _, g = _inputs(dshape, wshape, pad, seed=6)

    def at(a, skip):  # a's values in a contiguous bf16 view `skip` elements into its storage
        flat = torch.zeros(a.size + 8, dtype=torch.bfloat16)
        view = flat[skip:skip + a.size].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    tx, tg = at(x, offset[0]), at(g, offset[1])
    assert tx.is_contiguous() and tg.is_contiguous()
    mode, splits, per = kernels.wgrad_plan_sm90(tx, tg, wshape, pad, 132)
    aligned = all(k * 2 % 16 == 0 for k in offset)
    assert mode == ("nchw" if aligned else "flat")
    assert (splits, per) == kernels.wgrad_splits_sm90(
        8, 16, 1, kernels.wgrad_steps_sm90(mode, 4, 16, 16), 132)
    got = _emulate_wgrad_sm90(tx, tg, wshape, pad)
    want = kernels.conv_bwd_filter_reference(tx, tg, wshape, pad)
    assert torch.abs(got - want).max() <= 1e-5 * torch.abs(want).max()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Outside the envelope, or on the CPU asked for a kernel launch, the
    wrappers raise rather than fall back (checked before any launch)."""
    x = torch.zeros(2, 8, 9, 9)
    g = torch.zeros(2, 8, 9, 9)
    meta = torch.device("meta")
    with pytest.raises(MXNetError):  # not on a CUDA device
        kernels._check_conv_args("conv_bwd_filter", x.to(meta), g.to(meta), (2, 8, 9, 9),
                                 (8, 8, 3, 3), (1, 1))
    with pytest.raises(MXNetError):  # f16 is outside the envelope
        kernels._check_conv_args("conv_bwd_input", g.half(), x.half(), (2, 8, 9, 9),
                                 (8, 8, 3, 3), (1, 1))
    with pytest.raises(MXNetError):  # the layout kernel takes bf16 only
        kernels.conv_grad_channels_last(g.to(meta))
    with pytest.raises(MXNetError):  # a g_cl that is not grad's channels-last copy
        kernels._grad_cl("conv_bwd_filter", g.bfloat16(), torch.zeros(2, 9, 8, 9).bfloat16())
    with pytest.raises(MXNetError):  # grad's channels-last copy off a 16-byte boundary
        kernels._grad_cl("conv_bwd_filter", g.bfloat16(),
                         torch.zeros(2 * 9 * 9 * 8 + 1).bfloat16()[1:].view(2, 9, 9, 8))
    np.testing.assert_array_equal(kernels.conv_grad_channels_last(g.bfloat16()).float().numpy(),
                                  g.permute(0, 2, 3, 1).numpy())
    # f32: the hi and lo planes of the channels-last copy
    torch.testing.assert_close(kernels.conv_grad_channels_last(g),
                               kernels.split_bf16(g.permute(0, 2, 3, 1).contiguous()),
                               rtol=0, atol=0)
    with pytest.raises(MXNetError):  # an f32 grad's g_cl is its two bf16 planes
        kernels._grad_cl("conv_bwd_input", g, torch.zeros(2, 9, 9, 8).bfloat16())
