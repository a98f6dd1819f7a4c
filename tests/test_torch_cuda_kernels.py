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
