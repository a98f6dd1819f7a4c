"""The PyTorch port's CUDA kernels against their plain versions, on the
card. These tests import no JAX, so they run where only PyTorch is
installed; the repo's conftest imports JAX, so on such a machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Without a CUDA device they skip."""
import pytest
import torch

from mxnet_tpu_torch.ops import kernels


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel against its plain version, f32 to 1e-4 and
    bf16 to 2e-2 (the plain version rounds its scores to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    for (b, t, h, d, causal) in [(1, 7, 4, 64, True), (2, 300, 4, 64, False),
                                 (1, 200, 2, 128, True), (2, 70, 3, 32, True)]:
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.randn(b, t, h, d, generator=g).to("cuda", dt)
                       for _ in range(3))
            before = kernels.flash_attention.launches
            out = kernels.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert kernels.flash_attention.launches == before + 1
            ref = kernels.reference_attention(q, k, v, causal=causal)
            assert (out.float() - ref.float()).abs().max().item() <= tol


def _bwd_case(b, t, h, d, dt, causal, g):
    q, k, v, do = (torch.randn(b, t, h, d, generator=g).to("cuda", dt) for _ in range(4))
    out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain_version():
    """On the card: the dq and dk/dv kernels against reference_attention_bwd
    on the same inputs, error relative to max|plain| at most 1e-4 in f32
    and 2e-2 in bf16 (about one bf16 rounding of the output); a second
    launch gives the same bits (one owner per output, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(1)
    for (b, t, h, d, causal) in [(1, 7, 4, 64, True), (2, 300, 4, 64, False),
                                 (1, 200, 2, 128, True), (2, 70, 3, 32, True),
                                 (1, 130, 2, 16, False)]:
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = _bwd_case(b, t, h, d, dt, causal, g)
            before = (kernels.flash_attention_dq.launches, kernels.flash_attention_dkv.launches)
            dq = kernels.flash_attention_dq(*args, causal=causal)
            dk, dv = kernels.flash_attention_dkv(*args, causal=causal)
            torch.cuda.synchronize()
            assert (kernels.flash_attention_dq.launches,
                    kernels.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
            for got, want in zip((dq, dk, dv), kernels.reference_attention_bwd(*args, causal=causal)):
                assert got.dtype == dt and got.shape == (b, t, h, d)
                scale = want.float().abs().max().item()
                assert (got.float() - want.float()).abs().max().item() <= tol * scale
            assert torch.equal(dq, kernels.flash_attention_dq(*args, causal=causal))
            assert all(torch.equal(a, b_) for a, b_ in zip(
                (dk, dv), kernels.flash_attention_dkv(*args, causal=causal)))


@pytest.mark.cuda
def test_cuda_attention_gradient_runs_the_kernels():
    """On the card: autograd through flash_attention launches the forward,
    dq and dk/dv kernels once each and agrees with autograd through the
    plain attention (f32, 1e-4 of max|plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(2)
    q, k, v, w = (torch.randn(2, 150, 4, 64, generator=g).cuda() for _ in range(4))
    grads = []
    for fn in (kernels.flash_attention, kernels.reference_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        counts = (kernels.flash_attention.launches, kernels.flash_attention_dq.launches,
                  kernels.flash_attention_dkv.launches)
        (fn(*leaves, causal=True) * w).sum().backward()
        torch.cuda.synchronize()
        if fn is kernels.flash_attention:
            assert (kernels.flash_attention.launches, kernels.flash_attention_dq.launches,
                    kernels.flash_attention_dkv.launches) == tuple(c + 1 for c in counts)
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
