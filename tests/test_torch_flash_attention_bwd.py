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
from test_torch_conv_kernels import _truncating_sum
from test_torch_flash_attention import CASES, F32_LIMIT, _split_product


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


def _emulate_dkv_f32_split(q, k, v, do, lse, delta, causal, block=64):
    """The f32 dk/dv kernel (``flash_dkv_sm90<D, 2>``) on the CPU: per
    64-row q tile, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as three bf16 products of the
    split planes (``_split_product``); Pᵀ = exp(scale Sᵀ - lse[col]) where
    kept and dSᵀ = Pᵀ (dPᵀ - delta[col]) in f32; then Pᵀ and dSᵀ split into
    hi and lo planes for dv += Pᵀ·dO and dk += dSᵀ·Q, each tile's three
    products summed in a partial that is then added into dv or dk (the
    promotion, one q tile a period); dk = scale·dk."""
    t, d = q.shape[1], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf, dof = (x.transpose(1, 2) for x in (q, k, v, do))  # [B, H, T, D]
    keep = torch.ones(t, t, dtype=torch.bool).triu() if causal else torch.ones(t, t,
                                                                                dtype=torch.bool)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, t, block):
        qt, dot = qf[..., q0:q0 + block, :], dof[..., q0:q0 + block, :]
        kp = keep[:, q0:q0 + block]  # rows are keys, columns this tile's queries
        st = _split_product(kf, qt.transpose(-1, -2)) * scale
        pt = torch.where(kp, torch.exp(st - lse[:, :, None, q0:q0 + block]), torch.tensor(0.0))
        dpt = _split_product(vf, dot.transpose(-1, -2))
        dst = pt * (dpt - delta[:, :, None, q0:q0 + block])
        dv = dv + _split_product(pt, dot)
        dk = dk + _split_product(dst, qt)
    return (dk * scale).transpose(1, 2), dv.transpose(1, 2)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("t", [100, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_split_dkv_fits_the_card_limit(t, causal):
    """The f32 dk/dv kernel takes each f32 product as three bf16 products
    of hi and lo planes, splits Pᵀ and dSᵀ in registers and adds each q
    tile's products into dk and dv after a partial. Emulated on the CPU
    from the forward's lse and delta, dk and dv stay within 2e-5 of
    max|want| (a fifth of the card's f32 limit, 1e-4) of JAX's Pallas
    backward (interpret mode) and of the port's plain backward on the same
    f32 inputs (worst found: 1.5e-5, dk at T = 100 without the mask)."""
    q, k, v, do = _inputs(1, t, 2, 64, seed=23)
    (_, jdk, jdv), lse, delta = _pallas_bwd(q, k, v, do, causal)
    args = [torch.from_numpy(a) for a in (q, k, v, do, lse, delta)]
    got = _emulate_dkv_f32_split(*args, causal)
    plain = kernels.reference_attention_bwd(*args, causal=causal)[1:]
    for name, g, want_jax, want_plain in zip(("dk", "dv"), got, (jdk, jdv), plain):
        for want in (want_jax, want_plain.numpy()):
            err = np.abs(g.numpy() - want).max() / np.abs(want).max()
            assert err <= 2e-5 <= F32_LIMIT, (name, err)


def _emulate_dq_f32_split(q, k, v, do, lse, delta, causal, block=64):
    """The f32 dq kernel (``flash_dq_sm90<D, 2>``) on the CPU: per 64-key
    tile, S = Q·Kᵀ and dP = dO·Vᵀ as three bf16 products of the split
    planes (``_split_product``); P = exp(scale S - lse) where kept and dS =
    P (dP - delta) in f32; then dS split into hi and lo planes for dq +=
    dS·K, each tile's three products summed in a partial that is then
    added into dq (the promotion, one K/V tile a period); dq = scale·dq."""
    t, d = q.shape[1], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf, dof = (x.transpose(1, 2) for x in (q, k, v, do))  # [B, H, T, D]
    keep = torch.ones(t, t, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    dq = torch.zeros_like(qf)
    for k0 in range(0, t, block):
        kt, vt = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
        kp = keep[:, k0:k0 + block]  # rows are queries, columns this tile's keys
        s = _split_product(qf, kt.transpose(-1, -2)) * scale
        p = torch.where(kp, torch.exp(s - lse[..., None]), torch.tensor(0.0))
        ds = p * (_split_product(dof, vt.transpose(-1, -2)) - delta[..., None])
        dq = dq + _split_product(ds, kt)
    return (dq * scale).transpose(1, 2)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("t", [100, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_split_dq_fits_the_card_limit(t, causal):
    """The f32 dq kernel takes each f32 product as three bf16 products of
    hi and lo planes, splits dS in registers and adds each K/V tile's dS·K
    into dq after a partial. Emulated on the CPU from the forward's lse
    and delta, dq stays within 2e-5 of max|want| (a fifth of the card's
    f32 limit, 1e-4) of JAX's Pallas backward (interpret mode) and of the
    port's plain backward on the same f32 inputs (worst found: 1.7e-5, at
    T = 256 without the mask)."""
    q, k, v, do = _inputs(1, t, 2, 64, seed=24)
    (jdq, _, _), lse, delta = _pallas_bwd(q, k, v, do, causal)
    args = [torch.from_numpy(a) for a in (q, k, v, do, lse, delta)]
    got = _emulate_dq_f32_split(*args, causal).numpy()
    plain = kernels.reference_attention_bwd(*args, causal=causal)[0].numpy()
    for want in (jdq, plain):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 2e-5 <= F32_LIMIT, err


def _promotion_operands(kernel, rng, t):
    """The two (t, 8) f32 operands of one backward sum over t rows: dk/dv's
    dSᵀ or Pᵀ against Q or dO, modelled as standard normals; dq's dS
    against K, dS as P (dP - delta) with P in [0, 1)."""
    a, b = (rng.standard_normal((t, 8)).astype(np.float32) for _ in range(2))
    if kernel == "dq":
        a *= rng.random((t, 8)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_dkv_promotion_bounds_a_truncating_accumulator(kernel):
    """dk and dv sum 4 k16 steps a q tile over every q tile, and dq 4 a
    K/V tile over every K/V tile: 512 at T = 8192 and 2048 at T = 32768.
    Under the model of the tensor cores that rounds each wgmma's f32 sum
    toward zero (``_truncating_sum``), one accumulator's error grows with
    T: dk/dv 4.3e-5 of max|exact| at T = 8192 and 1.4e-4, over the f32
    limit, at T = 32768 (dq: 4.5e-5 and 1.3e-4). Adding a partial into the sum after
    every tile, as the kernels do, holds 1e-5 at both (dk/dv 4.5e-6 and
    4.6e-6 found, dq 4.9e-6 and 4.6e-6)."""
    rng = np.random.default_rng(12 if kernel == "dkv" else 13)
    err = {}
    for t in (8192, 32768):
        a, b = _promotion_operands(kernel, rng, t)
        exact = a.astype(np.float64).T @ b.astype(np.float64)
        for every in (None, 1):  # one accumulator; a promotion every tile
            got = _truncating_sum(a, b, every)
            err[t, every] = np.abs(got - exact).max() / np.abs(exact).max()
    assert err[8192, 1] <= 1e-5 and err[32768, 1] <= 1e-5, err
    assert err[8192, 1] < err[8192, None] < F32_LIMIT < err[32768, None], err


def test_kernel_operands_take_a_given_split():
    """A backward's two kernels read the planes of one split pass: given
    ``planes``, the f32 operands are views of their hi planes in it (each
    lo plane one [B, T, H, D] on); planes of another count, dtype or layout
    raise; bf16 operands are read as they are, one plane."""
    x = [torch.from_numpy(a) for a in _inputs(1, 9, 2, 16, seed=25)]
    planes = kernels.split_planes(*x)
    ops, n = kernels._kernel_operands(*x, planes=planes)
    assert n == 2
    for op, xi, pl in zip(ops, x, planes):
        assert op.data_ptr() == pl[0].data_ptr() and op.shape == xi.shape
        assert op.data_ptr() + 2 * xi.numel() == pl[1].data_ptr()
        assert torch.equal(op.view(torch.int16), kernels.split_bf16(xi)[0].view(torch.int16))
    strided = torch.empty((2, 4) + tuple(x[0].shape), dtype=torch.bfloat16).transpose(0, 1)
    for bad in (planes[:3], planes.float(), strided):
        with pytest.raises(MXNetError, match="planes"):
            kernels._kernel_operands(*x, planes=bad)
    b16 = [a.bfloat16() for a in x]
    ops, n = kernels._kernel_operands(*b16, planes=planes)
    assert n == 1 and all(o is a for o, a in zip(ops, b16))


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
