"""The PyTorch port's attention (mxnet_tpu_torch/ops/kernels.py) held
against the JAX package's: the port's plain path and reference against the
Pallas flash kernel (interpret mode on the CPU) and the JAX reference, on
the same numpy inputs, f32, rtol = atol = 1e-5. The CUDA kernel itself is
held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build, kernels

# the Pallas tests' CASES (tests/test_pallas_kernels.py) plus T < 8 and the
# missing causal / non-causal twins
CASES = [
    (2, 64, 2, 32, False),
    (1, 100, 3, 16, True),
    (2, 128, 2, 64, True),
    (2, 64, 2, 32, True),
    (1, 100, 3, 16, False),
    (1, 5, 2, 16, True),
    (2, 3, 1, 32, False),
]


def _inputs(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("b,t,h,d,causal", CASES)
def test_flash_forward_matches_jax(b, t, h, d, causal):
    q, k, v = _inputs(b, t, h, d)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    j_flash = np.asarray(jpk.flash_attention(jq, jk, jv, causal=causal,
                                             block_q=32, block_k=32))
    j_ref = np.asarray(jpk.reference_attention(jq, jk, jv, causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    t_flash = kernels.flash_attention(tq, tk, tv, causal=causal).numpy()
    t_ref = kernels.reference_attention(tq, tk, tv, causal=causal).numpy()
    t_disp = kernels.attention(tq, tk, tv, causal=causal).numpy()
    for got in (t_flash, t_ref, t_disp):
        assert got.shape == (b, t, h, d) and got.dtype == np.float32
        np.testing.assert_allclose(got, j_flash, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, j_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("b,t,h,d,causal", [CASES[1], CASES[2], CASES[5]])
def test_flash_lse_matches_pallas_residual(b, t, h, d, causal):
    """The logsumexp kept for the backward equals the one the Pallas
    forward saves (its residual for _flash_bwd)."""
    q, k, v = _inputs(b, t, h, d, seed=3)
    blk = 32 if t >= 32 else max(8, 1 << (t - 1).bit_length())
    to3 = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, t, d))
    q3, k3, v3 = (jpk._pad_to(to3(a), 1, blk)[0] for a in (q, k, v))
    _, j_lse = jpk._fwd_call(q3, k3, v3, t, 1.0 / np.sqrt(d), causal,
                             blk, blk, True)
    j_lse = np.asarray(j_lse)[:, :t, 0].reshape(b, h, t)
    out, lse = kernels.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=1e-5, atol=1e-5)


def test_reference_attention_bf16_casts_like_jax():
    """bf16 inputs: scores rounded to bf16 by the einsum, softmax and the
    value product in f32, output bf16 — the same cast points as JAX."""
    q, k, v = _inputs(1, 20, 2, 16, seed=5)
    j = jpk.reference_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                causal=True)
    t = kernels.reference_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal=True)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=0, atol=1.6e-2)  # one bf16 ulp at |x| < 4


def test_attention_raises_on_sequence_parallel_mesh():
    """An sp 1 mesh takes the unsharded path; sp 2 runs ring attention over
    two blocks (the same numbers); an sp that does not divide T raises."""
    q, k, v = (torch.from_numpy(np.random.RandomState(i).randn(1, 4, 1, 16).astype(np.float32))
               for i in range(3))
    assert kernels.attention(q, k, v, mesh={"dp": 2, "sp": 1}).shape == q.shape
    torch.testing.assert_close(kernels.attention(q, k, v, causal=True, mesh={"dp": 1, "sp": 2}),
                               kernels.reference_attention(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        kernels.attention(q, k, v, mesh={"dp": 1, "sp": 3})


@pytest.mark.parametrize("case", ["shape", "dtype", "head_dim", "device", "stride",
                                  "bf16_device", "bf16_odd_strides_on_cpu"])
def test_kernel_argument_checks(case):
    """What the CUDA wrapper refuses, checked before any launch: as before
    the TMA kernels, and for bf16 views TMA could not read (those are
    copied only once every check has passed)."""
    q = torch.zeros(1, 8, 2, 64)
    k = v = q
    if case == "bf16_device":
        q = k = v = q.bfloat16()
    elif case == "bf16_odd_strides_on_cpu":
        q = k = v = torch.zeros(1, 8, 2, 65, dtype=torch.bfloat16)[..., :64]
    elif case == "shape":
        k = torch.zeros(1, 9, 2, 64)
    elif case == "dtype":
        q = k = v = q.half()
    elif case == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 48)
    elif case == "stride":
        q = torch.zeros(1, 8, 2, 128)[..., ::2]
    with pytest.raises(MXNetError):
        kernels.check_kernel_args(q, k, v)


def test_tma_compatible():
    """TMA reads a bf16 [B, T, H, D] operand where it lies only from a
    16-byte-aligned base with byte strides that are multiples of 16."""
    x = torch.zeros(2, 8, 3, 64, dtype=torch.bfloat16)
    assert kernels.tma_compatible(x)
    assert kernels.tma_compatible(torch.zeros(2, 8, 3, 128, dtype=torch.bfloat16)[..., 64:])
    assert kernels.tma_compatible(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert kernels.tma_compatible(torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16))
    # odd strides: a row of D + 1 elements, and H stepped by 65 * 2 bytes
    assert not kernels.tma_compatible(torch.zeros(2, 8, 3, 65, dtype=torch.bfloat16)[..., :64])
    # a base 2 bytes off the allocation's 16-byte boundary
    flat = torch.zeros(2 * 8 * 3 * 64 + 8, dtype=torch.bfloat16)
    assert not kernels.tma_compatible(flat[1:1 + 2 * 8 * 3 * 64].view(2, 8, 3, 64))
    assert kernels.tma_compatible(flat[8:8 + 2 * 8 * 3 * 64].view(2, 8, 3, 64))
    # stride 0 along a dimension of size > 1 (a broadcast) is not read by TMA
    assert not kernels.tma_compatible(torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
                                      .expand(2, 8, 3, 64))
    # the strides handed to the kernels: a size-1 dimension gets its packed one
    odd = torch.zeros(1, 8, 5, 64, dtype=torch.bfloat16).as_strided((1, 8, 1, 64),
                                                                    (7, 320, 3, 1))
    assert kernels._strides(odd) == [8 * 64, 320, 64]


def _emulate_forward_bf16(q, k, v, causal, block=64):
    """The bf16 forward kernel's arithmetic on the CPU: f32 scores of the
    bf16 inputs, the online softmax over 64-key tiles with l summing the
    f32 p, and P rounded to bf16 before the value product."""
    b, t, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    rows, cols = torch.arange(t)[:, None], torch.arange(t)[None, :]
    keep = (rows >= cols) if causal else torch.ones(t, t, dtype=torch.bool)
    s_all = torch.where(keep, (qf @ kf.transpose(-1, -2)) * scale, torch.tensor(-1e30))
    m = torch.full((b, h, t, 1), -1e30)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, block):
        s, kp = s_all[..., k0:k0 + block], keep[:, k0:k0 + block]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(kp, torch.exp(s - m_new), torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[..., k0:k0 + block, :]
        m = m_new
    return (acc / torch.where(l > 0, l, torch.ones_like(l))).transpose(1, 2).bfloat16()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("t,causal", [(100, False), (256, True)])
def test_bf16_p_rounding_fits_the_card_limit(t, causal):
    """The bf16 kernel rounds P to bf16 before P·V (the JAX kernel keeps it
    f32). Emulated on the CPU, that output stays within the card's bf16
    limit, 2e-2 absolute, of the JAX package's Pallas forward (interpret
    mode) and of the port's plain version on the same bf16 inputs."""
    q, k, v = _inputs(1, t, 2, 32, seed=11)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = _emulate_forward_bf16(tq, tk, tv, causal).float().numpy()
    jax_out = jpk.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                  causal=causal, block_q=64, block_k=64)
    plain = kernels.reference_attention(tq, tk, tv, causal=causal).float().numpy()
    for want in (np.asarray(jax_out, np.float32), plain):
        assert np.abs(got - want).max() <= 2e-2


F32_LIMIT = 1e-4  # the card's f32 limit for the forward, absolute


def _split_product(a, b):
    """a @ b as the split f32 kernels take it: the hi and lo bf16 planes of
    both (``split_bf16``), three products hi·lo + lo·hi + hi·hi, in the
    kernels' order, each and their sum in f32."""
    (a_hi, a_lo), (b_hi, b_lo) = (p.float() for p in kernels.split_bf16(a)), \
        (p.float() for p in kernels.split_bf16(b))
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _emulate_forward_f32_split(q, k, v, causal, block=64):
    """The f32 forward kernel (``flash_fwd_split_sm90``) on the CPU: S =
    Q·Kᵀ as three bf16 products of the split planes; the online softmax
    over 64-key tiles with l summing the f32 p; P split into its hi and lo
    planes in registers, and each K/V tile's three products P·V summed in
    a partial that starts at zero and is added into O after O's rescale
    (the promotion, one K/V tile a period); o = O / l and lse in f32."""
    b, t, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    rows, cols = torch.arange(t)[:, None], torch.arange(t)[None, :]
    keep = (rows >= cols) if causal else torch.ones(t, t, dtype=torch.bool)
    m = torch.full((b, h, t, 1), -1e30)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, block):
        kp = keep[:, k0:k0 + block]
        s = torch.where(kp, _split_product(qf, kf[..., k0:k0 + block, :].transpose(-1, -2))
                        * scale, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(kp, torch.exp(s - m_new), torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_product(p, vf[..., k0:k0 + block, :])
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe_l).transpose(1, 2), (m + torch.log(safe_l))[..., 0]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("t", [100, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_split_forward_fits_the_card_limit(t, causal):
    """The f32 forward kernel takes each f32 product as three bf16 products
    of hi and lo planes (hi·lo + lo·hi + hi·hi), splits P in registers and
    adds each K/V tile's P·V into O after a partial. Emulated on the CPU,
    its output stays within 2e-5 absolute (a fifth of the card's f32
    limit, 1e-4) of the JAX package's Pallas forward (interpret mode) and
    of the port's plain version, and its lse within 2e-5 of the plain
    one's, on the same f32 inputs (worst found: 1.5e-5 and 1.1e-5)."""
    q, k, v = _inputs(1, t, 2, 64, seed=21)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, lse = _emulate_forward_f32_split(tq, tk, tv, causal)
    jax_out = np.asarray(jpk.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                             causal=causal, block_q=64, block_k=64))
    plain = kernels.reference_attention(tq, tk, tv, causal=causal).numpy()
    for want in (jax_out, plain):
        assert np.abs(got.numpy() - want).max() <= 2e-5 <= F32_LIMIT
    want_lse = kernels.reference_lse(tq, tk, causal=causal)
    assert (lse - want_lse).abs().max().item() <= 2e-5


def test_split_bf16_of_a_view_equals_its_contiguous_copy():
    """The split pass reads f32 operands through their strides: the planes
    of a [B, T, H, D] view of a [B, H, T, D] tensor equal those of its
    contiguous copy bit for bit, and ``split_planes`` (its plain version on
    the CPU) stacks them in operand order."""
    rng = np.random.RandomState(22)
    x = torch.from_numpy(rng.randn(2, 3, 50, 32).astype(np.float32)).transpose(1, 2)
    y = torch.from_numpy(rng.randn(2, 50, 3, 32).astype(np.float32))
    assert not x.is_contiguous()
    view, copy = kernels.split_bf16(x), kernels.split_bf16(x.contiguous())
    assert view.shape == (2, 2, 50, 3, 32) and view.dtype == torch.bfloat16
    assert torch.equal(view.view(torch.int16), copy.view(torch.int16))
    planes = kernels.split_planes(x, y)
    assert planes.shape == (2, 2, 2, 50, 3, 32) and planes.is_contiguous()
    assert torch.equal(planes[0].view(torch.int16), copy.view(torch.int16))
    assert torch.equal(planes[1].view(torch.int16), kernels.split_bf16(y).view(torch.int16))
    with pytest.raises(MXNetError):
        kernels.split_planes(*[y] * 5)


def test_library_key_covers_headers(monkeypatch, tmp_path):
    """Editing a header under csrc/ gives every kernel a new library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in {v[0] for v in _build.KERNELS.values()}:
        (csrc / src).write_text('#include "flash_sm90.cuh"\n')
    (csrc / "flash_sm90.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    assert all(p.parent == tmp_path / "kernels" for p in before.values())
    assert _build.library_path("flash_attn_fwd") == before["flash_attn_fwd"]
    (csrc / "flash_sm90.cuh").write_text("// v2\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    assert all(after[n] != before[n] for n in _build.KERNELS)
    assert after["flash_attn_fwd"].name.startswith("flash_attn_fwd-")


def test_library_key_of_another_source_dir(monkeypatch, tmp_path):
    """``csrc=`` keys a library on that directory's sources: a copy of the
    package's sources maps to the package's library, an edited copy to a
    new one beside it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    copy = tmp_path / "variant"
    copy.mkdir()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (copy / src.name).write_bytes(src.read_bytes())
    for name in _build.KERNELS:
        assert _build.library_path(name, copy) == _build.library_path(name)
    fwd = copy / "flash_attn_fwd.cu"
    fwd.write_text(fwd.read_text() + "// edited\n")
    assert _build.library_path("flash_attn_fwd", copy) != _build.library_path("flash_attn_fwd")
    assert _build.library_path("flash_attn_fwd", copy).parent == tmp_path / "kernels"
    assert _build.library_path("conv_bwd_filter", copy) == _build.library_path("conv_bwd_filter")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building raises with the reason, never falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    lib = _build.library_path("flash_attn_fwd")
    assert lib.parent == tmp_path / "kernels" and lib.name.startswith("flash_attn_fwd-")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()
