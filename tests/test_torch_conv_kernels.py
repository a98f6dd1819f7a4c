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
from mxnet_tpu_torch.ops import kernels

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
    assert kernels.wgrad_splits(64, 64, 1, 32 * 56 * 56, 132) == (523, 12)
    assert kernels.wgrad_splits(512, 512, 9, 32 * 7 * 7, 132) == (1, 98)
