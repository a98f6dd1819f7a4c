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
    q = torch.zeros(1, 4, 1, 16)
    assert kernels.attention(q, q, q, mesh={"dp": 2, "sp": 1}).shape == q.shape
    with pytest.raises(NotImplementedError):
        kernels.attention(q, q, q, mesh={"dp": 1, "sp": 2})


@pytest.mark.parametrize("case", ["shape", "dtype", "head_dim", "device", "stride"])
def test_kernel_argument_checks(case):
    """What the CUDA wrapper refuses, checked before any launch."""
    q = torch.zeros(1, 8, 2, 64)
    k = v = q
    if case == "shape":
        k = torch.zeros(1, 9, 2, 64)
    elif case == "dtype":
        q = k = v = q.half()
    elif case == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 48)
    elif case == "stride":
        q = torch.zeros(1, 8, 2, 128)[..., ::2]
    with pytest.raises(MXNetError):
        kernels.check_kernel_args(q, k, v)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building raises with the reason, never falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    lib = _build.library_path("flash_attn_fwd")
    assert lib.parent == tmp_path / "kernels" and lib.name.startswith("flash_attn_fwd-")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()
