"""The PyTorch port's flash-attention backward (mxnet_tpu_torch/ops/kernels.py)
held against the JAX package's on the CPU: the plain version of the dq and
dk/dv kernels against the Pallas ``_bwd_call`` (interpret mode) on the same
q, k, v, dO, lse and delta, and gradients through the port's autograd
Function against ``jax.grad`` through the Pallas flash kernel, f32 at
rtol = atol = 1e-5. The CUDA kernels themselves are held against the plain
version on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels
from test_torch_flash_attention import CASES


def _inputs(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _pallas_bwd(q, k, v, do, causal):
    """JAX's forward and backward Pallas kernels in interpret mode, as
    ``_flash_bwd`` runs them: ((dq, dk, dv) as [B, T, H, D], lse, delta as
    [B, H, T])."""
    b, t, h, d = q.shape
    blk = 32 if t >= 32 else max(8, 1 << (t - 1).bit_length())
    to3 = lambda a: jpk._pad_to(  # noqa: E731
        jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, t, d)), 1, blk)[0]
    q3, k3, v3, do3 = (to3(a) for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(d)
    out3, lse3 = jpk._fwd_call(q3, k3, v3, t, scale, causal, blk, blk, True)
    delta3 = jnp.sum(do3 * out3.astype(jnp.float32), axis=-1, keepdims=True)
    grads = jpk._bwd_call(q3, k3, v3, do3, lse3, delta3, t, scale, causal, blk, blk, True)
    back = lambda a: np.array(a)[:, :t].reshape(b, h, t, d).transpose(0, 2, 1, 3)  # noqa: E731
    stat = lambda a: np.array(a)[:, :t, 0].reshape(b, h, t)  # noqa: E731
    return [back(g) for g in grads], stat(lse3), stat(delta3)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("b,t,h,d,causal", CASES)
def test_reference_bwd_matches_pallas_bwd(b, t, h, d, causal):
    q, k, v, do = _inputs(b, t, h, d, seed=7)
    want, lse, delta = _pallas_bwd(q, k, v, do, causal)
    got = kernels.reference_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, do, lse, delta)), causal=causal)
    # the kernels' wrappers take the plain version on CPU tensors
    args = [torch.from_numpy(a) for a in (q, k, v, do, lse, delta)]
    wrapped = (kernels.flash_attention_dq(*args, causal=causal),
               *kernels.flash_attention_dkv(*args, causal=causal))
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, wrapped):
        assert g.dtype == torch.float32 and g.shape == (b, t, h, d), name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
        assert torch.equal(g, g2), name


def _grads(fn, arrays, dtype, causal):
    """(dq, dk, dv) of sum(fn(q, k, v) * w) through torch autograd."""
    q, k, v, w = (torch.from_numpy(a).to(dtype) for a in arrays)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, causal=causal)
    assert out.grad_fn is not None
    (out.float() * w.float()).sum().backward()
    return [x.grad for x in leaves]


def _jax_grads(arrays, dtype, causal):
    q, k, v, w = (jnp.asarray(a, dtype) for a in arrays)

    def loss(q, k, v):
        out = jpk.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
        return jnp.sum(out.astype(jnp.float32) * w.astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("b,t,h,d,causal", CASES)
def test_flash_attention_grads_match_jax(b, t, h, d, causal):
    arrays = _inputs(b, t, h, d, seed=8)
    got = _grads(kernels.flash_attention, arrays, torch.float32, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          _jax_grads(arrays, jnp.float32, causal)):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.timeout(120)
def test_flash_attention_grads_bf16_within_one_ulp_of_jax():
    """bf16: each gradient within one bf16 ulp of its largest element of
    the Pallas gradient (2^(e-7) for max|x| in [2^e, 2^(e+1)))."""
    b, t, h, d, causal = CASES[1]
    arrays = _inputs(b, t, h, d, seed=9)
    got = _grads(kernels.flash_attention, arrays, torch.bfloat16, causal)
    want = _jax_grads(arrays, jnp.bfloat16, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        w = np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=ulp, err_msg=name)


def _emulate_dq_bf16(q, k, v, do, lse, delta, causal):
    """The bf16 dq kernel's arithmetic on the CPU: f32 S and dP of the bf16
    inputs, P = exp(scale S - lse) where kept, dS = P (dP - delta) in f32,
    then dS rounded to bf16 before dq = scale dS K."""
    t, d = q.shape[1], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    return ((ds.bfloat16().float() @ kf) * scale).transpose(1, 2).bfloat16()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("t,causal", [(100, True), (256, False)])
def test_bf16_ds_rounding_fits_the_card_limit(t, causal):
    """The bf16 dq kernel rounds dS to bf16 before dS·K (the JAX kernel
    keeps it f32). Emulated on the CPU from the backward's own lse, delta
    and bf16 dO, that dq stays within the card's bf16 limit, 2e-2 of
    max|want|, of jax.grad through the Pallas kernels (interpret mode) and
    of the port's plain backward on the same inputs."""
    arrays = _inputs(1, t, 2, 32, seed=12)
    q, k, v, w = (torch.from_numpy(a).bfloat16() for a in arrays)
    out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.from_numpy(arrays[3])  # the cotangent of sum(out * w)
    delta = (g * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g.bfloat16(), lse, delta)
    got = _emulate_dq_bf16(*args, causal).float().numpy()
    jax_dq = np.asarray(_jax_grads(arrays, jnp.bfloat16, causal)[0], np.float32)
    plain = kernels.reference_attention_bwd(*args, causal=causal)[0].float().numpy()
    for want in (jax_dq, plain):
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _emulate_dkv_bf16(q, k, v, do, lse, delta, causal):
    """The bf16 dk/dv kernel's arithmetic on the CPU: f32 S^T and dP^T of
    the bf16 inputs, P^T = exp(scale S^T - lse[col]) where kept and dS^T =
    P^T (dP^T - delta[col]) in f32, then P^T and dS^T rounded to bf16
    before dv = P^T dO and dk = scale dS^T Q."""
    t, d = q.shape[1], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    pt = torch.exp((kf @ qf.transpose(-1, -2)) * scale - lse[:, :, None, :])
    if causal:  # rows are keys, columns queries: keep q >= k
        pt = pt.masked_fill(~torch.ones(t, t, dtype=torch.bool).triu(), 0.0)
    dst = pt * (vf @ dof.transpose(-1, -2) - delta[:, :, None, :])
    dv = pt.bfloat16().float() @ dof
    dk = (dst.bfloat16().float() @ qf) * scale
    return tuple(x.transpose(1, 2).bfloat16() for x in (dk, dv))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("t,causal", [(100, True), (256, False)])
def test_bf16_dkv_rounding_fits_the_card_limit(t, causal):
    """The bf16 dk/dv kernel rounds P^T and dS^T to bf16 before P^T·dO and
    dS^T·Q (the JAX kernel keeps them f32). Emulated on the CPU from the
    backward's own lse, delta and bf16 dO, dk and dv stay within the card's
    bf16 limit, 2e-2 of max|want|, of jax.grad through the Pallas kernels
    (interpret mode) and of the port's plain backward on the same inputs."""
    arrays = _inputs(1, t, 2, 32, seed=13)
    q, k, v, w = (torch.from_numpy(a).bfloat16() for a in arrays)
    out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.from_numpy(arrays[3])  # the cotangent of sum(out * w)
    delta = (g * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g.bfloat16(), lse, delta)
    got = [x.float().numpy() for x in _emulate_dkv_bf16(*args, causal)]
    jax_dkv = [np.asarray(x, np.float32) for x in _jax_grads(arrays, jnp.bfloat16, causal)[1:]]
    plain = [x.float().numpy() for x in kernels.reference_attention_bwd(*args, causal=causal)[1:]]
    for name, a, want_jax, want_plain in zip(("dk", "dv"), got, jax_dkv, plain):
        for want in (want_jax, want_plain):
            assert np.abs(a - want).max() <= 2e-2 * np.abs(want).max(), name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_plain_autograd(causal):
    """The Function's backward against autograd through the plain
    attention, including the expanded gradient of a plain sum (stride 0
    along D) that the backward makes contiguous."""
    arrays = _inputs(2, 37, 3, 16, seed=10)
    got = _grads(kernels.flash_attention, arrays, torch.float32, causal)
    want = _grads(kernels.reference_attention, arrays, torch.float32, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    kernels.flash_attention(q, k, v, causal=causal).sum().backward()
    q2, k2, v2 = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    kernels.reference_attention(q2, k2, v2, causal=causal).sum().backward()
    for g, w in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_no_graph_without_grad():
    q = torch.zeros(1, 4, 1, 16, requires_grad=True)
    with torch.no_grad():
        assert kernels.flash_attention(q, q, q).grad_fn is None
    out, lse = kernels.flash_attention(q, q, q, return_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad


@pytest.mark.parametrize("case,match", [
    ("do_shape", "shape"), ("do_dtype", "dtype"), ("do_stride", "stride"),
    ("device", "CUDA device"), ("lse_layout", "lse"), ("delta_dtype", "delta")])
def test_backward_argument_checks(case, match):
    """What the backward kernels' wrappers refuse, checked before any
    launch; each case trips its own check (valid tensors on the meta
    device trip only the CUDA-device check)."""
    q = do = torch.zeros(1, 8, 2, 64, device="meta")
    lse = delta = torch.zeros(1, 2, 8, device="meta")
    if case == "do_shape":
        do = torch.zeros(1, 8, 2, 32, device="meta")
    elif case == "do_dtype":
        do = do.half()
    elif case == "do_stride":
        do = torch.zeros(1, 8, 2, 128, device="meta")[..., ::2]
    elif case == "lse_layout":
        lse = torch.zeros(1, 8, 2, device="meta")
    elif case == "delta_dtype":
        delta = delta.double()
    with pytest.raises(MXNetError, match=match):
        if case in ("lse_layout", "delta_dtype"):
            kernels._check_row_stats(q, lse, delta)
        else:
            kernels._check_row_stats(q, lse, delta)  # valid: passes
            kernels.check_kernel_args(q, q, q, do)
