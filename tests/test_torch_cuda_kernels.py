"""The PyTorch port's CUDA kernels against their plain versions, on the
card. These tests import no JAX, so they run where only PyTorch is
installed; the repo's conftest imports JAX, so on such a machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Without a CUDA device they skip."""
import itertools

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
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


@pytest.mark.cuda
def test_cuda_split_pass_matches_split_bf16():
    """On the card: the split pass of the f32 flash kernels equals its
    plain version, split_bf16 of each operand, bit for bit, for one to
    four operands, contiguous or [B, H, T, D] views (4-byte loads) next to
    contiguous ones (16-byte loads); refused for bf16 or D % 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(5)
    x = [torch.randn(2, 100, 3, 32, generator=g).cuda() for _ in range(4)]
    view = torch.randn(2, 3, 100, 32, generator=g).cuda().transpose(1, 2)
    for ops in (x[:1], x[:3], x, [view, x[0]]):
        before = kernels.split_planes.launches
        got = kernels.split_planes(*ops)
        assert kernels.split_planes.launches == before + 1
        want = torch.stack([kernels.split_bf16(t) for t in ops])
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    with pytest.raises(MXNetError):
        kernels.split_planes(x[0].bfloat16())
    with pytest.raises(MXNetError):
        kernels.split_planes(torch.randn(1, 4, 1, 12).cuda())


def _bwd_case(b, t, h, d, dt, causal, g, bhtd=False):
    """q, k, v, dO, lse, delta on the card; with ``bhtd``, q, k, v and dO
    are transposed views of [B, H, T, D] tensors."""
    shape = (b, h, t, d) if bhtd else (b, t, h, d)
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", dt) for _ in range(4))
    if bhtd:
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
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
def test_cuda_f32_backward_shares_one_split():
    """On the card: an f32 backward through the autograd Function runs one
    split pass for its dq and dk/dv kernels together; given one split, the
    kernels give the bits of the wrappers that split for themselves; f32
    dq within 1e-4 of max|plain| and bitwise on repeat, up to T 4096."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(7)
    q, k, v, w = (torch.randn(2, 300, 4, 64, generator=g).cuda() for _ in range(4))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = kernels.flash_attention(*leaves, causal=True)
    before = (kernels.split_planes.launches, kernels.flash_attention_dq.launches)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (kernels.split_planes.launches,
            kernels.flash_attention_dq.launches) == (before[0] + 1, before[1] + 1)
    for (b, t, h, d, causal) in [(2, 300, 4, 64, True), (1, 4096, 2, 128, False)]:
        args = _bwd_case(b, t, h, d, torch.float32, causal, g)
        planes = kernels.split_planes(*args[:4])
        dq = kernels.flash_attention_dq(*args, causal=causal, planes=planes)
        dk, dv = kernels.flash_attention_dkv(*args, causal=causal, planes=planes)
        torch.cuda.synchronize()
        assert torch.equal(dq, kernels.flash_attention_dq(*args, causal=causal))
        assert torch.equal(dq, kernels.flash_attention_dq(*args, causal=causal, planes=planes))
        assert all(torch.equal(a, b_) for a, b_ in zip(
            (dk, dv), kernels.flash_attention_dkv(*args, causal=causal)))
        want = kernels.reference_attention_bwd(*args, causal=causal)[0]
        assert (dq - want).abs().max().item() <= 1e-4 * want.abs().max().item()


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


@pytest.mark.cuda
def test_cuda_bf16_tma_kernels_match_plain_version():
    """On the card: the bf16 forward, dq and dk/dv kernels (TMA and wgmma)
    against the plain versions at T 5, 64 and 2047, D 16, 64 and 128,
    causal and not, and on transposed views of [B, H, T, D] tensors
    (strides TMA reads in place, in another order): forward within 2e-2
    absolute, dq, dk and dv within 2e-2 of max|plain|; a repeat gives the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(6)
    cases = [(t, d, causal, False) for t in (5, 64, 2047) for d in (16, 64, 128)
             for causal in (True, False)]
    cases += [(300, 64, True, True), (2047, 128, False, True)]
    for t, d, causal, bhtd in cases:
        args = _bwd_case(1, t, 3, d, torch.bfloat16, causal, g, bhtd)
        assert all(kernels.tma_compatible(x) for x in args[:4])  # read in place, not copied
        q, k, v = args[:3]
        out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
        dq = kernels.flash_attention_dq(*args, causal=causal)
        dk, dv = kernels.flash_attention_dkv(*args, causal=causal)
        ref = kernels.reference_attention(q, k, v, causal=causal)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2, (t, d, causal)
        for got, want in zip((dq, dk, dv), kernels.reference_attention_bwd(*args, causal=causal)):
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2e-2 * want.float().abs().max().item(), (t, d, causal)
        again = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert torch.equal(dq, kernels.flash_attention_dq(*args, causal=causal))
        assert all(torch.equal(a, b) for a, b in zip(
            (dk, dv), kernels.flash_attention_dkv(*args, causal=causal)))


@pytest.mark.cuda
def test_cuda_bf16_views_tma_cannot_read_are_copied():
    """On the card: bf16 operands with odd strides or an unaligned base are
    copied before the TMA kernels launch, and the results still match the
    plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(7)
    wide = torch.randn(2, 130, 3, 65, generator=g).to("cuda", torch.bfloat16)
    flat = torch.randn(2 * 130 * 3 * 64 + 8, generator=g).to("cuda", torch.bfloat16)
    views = [wide[..., :64], flat[1:1 + 2 * 130 * 3 * 64].view(2, 130, 3, 64)]
    assert not any(kernels.tma_compatible(x) for x in views)
    for causal in (True, False):
        q, k = views
        v = torch.randn(2, 130, 3, 64, generator=g).to("cuda", torch.bfloat16)
        before = kernels.flash_attention.launches
        out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
        ref = kernels.reference_attention(q, k, v, causal=causal)
        assert kernels.flash_attention.launches == before + 1
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        do = views[0]
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        grads = (kernels.flash_attention_dq(*args, causal=causal),
                 *kernels.flash_attention_dkv(*args, causal=causal))
        for got, want in zip(grads, kernels.reference_attention_bwd(*args, causal=causal)):
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2e-2 * want.float().abs().max().item()


# ragged shapes around ResNet-50's: N 1 and 3, odd and non-square spatial,
# 1x1 / 3x3 / 5x5 at every pad the envelope takes, C and O off the 64 tile
CONV_CASES = [
    ((1, 8, 7, 7), (16, 8, 3, 3), (1, 1)),
    ((3, 16, 9, 11), (8, 16, 1, 1), (0, 0)),
    ((3, 24, 9, 11), (40, 24, 5, 5), (2, 2)),
    ((1, 64, 7, 9), (72, 64, 3, 3), (0, 0)),
    ((2, 8, 11, 9), (8, 8, 5, 5), (1, 1)),
    # the bf16 kernel's 128-channel tile, ragged C and several o chunks
    ((2, 136, 7, 7), (72, 136, 3, 3), (1, 1)),
    ((1, 256, 9, 11), (136, 256, 1, 1), (0, 0)),
]


@pytest.mark.cuda
def test_cuda_conv_bwd_kernels_match_plain_version():
    """On the card: K2 (conv_bwd_filter) and K3 (conv_bwd_input; TMA and
    wgmma) against their plain versions on the same inputs, f32 outputs
    before any cast, error at most 1e-4 of max|plain| in f32 and bf16
    (bf16 products are exact in f32 and summed in another order; an f32
    product is three bf16 products of its hi and lo planes); a second
    launch gives the same bits (fixed split of M, fixed order of the
    products and of the reduction, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(3)
    for dshape, wshape, pad in CONV_CASES:
        n, _, h, w = dshape
        o, _, kh, kw = wshape
        oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(dshape, generator=g).to("cuda", dt)
            wt = (0.1 * torch.randn(wshape, generator=g)).to("cuda", dt)
            gr = torch.randn(oshape, generator=g).to("cuda", dt)
            before = (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches)
            gw = kernels.conv_bwd_filter(x, gr, wshape, pad)
            gx = kernels.conv_bwd_input(gr, wt, dshape, pad)
            torch.cuda.synchronize()
            assert (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches) == (
                before[0] + 1, before[1] + 1)
            for got, want in ((gw, kernels.conv_bwd_filter_reference(x, gr, wshape, pad)),
                              (gx, kernels.conv_bwd_input_reference(gr, wt, dshape, pad))):
                assert got.dtype == torch.float32 and got.shape == want.shape
                scale = want.abs().max().item()
                assert (got - want).abs().max().item() <= 1e-4 * scale
            assert torch.equal(gw, kernels.conv_bwd_filter(x, gr, wshape, pad))
            assert torch.equal(gx, kernels.conv_bwd_input(gr, wt, dshape, pad))


# the image-classification zoo's shapes outside ResNet: inception-v3's 1 x 7 /
# 7 x 1 on 17 x 17 and 1 x 3 / 3 x 1 on 8 x 8, its 1 x 1 on 17 x 17 and 35 x
# 35 (OH·OW not a multiple of 8), googlenet's 24-channel 5 x 5 and its
# 512 -> 24 reduce, at the models' channel counts and batch 2
CONV_ZOO_CASES = [
    ((2, 128, 17, 17), (128, 128, 1, 7), (0, 3)),
    ((2, 128, 17, 17), (192, 128, 7, 1), (3, 0)),
    ((2, 384, 8, 8), (384, 384, 1, 3), (0, 1)),
    ((2, 384, 8, 8), (384, 384, 3, 1), (1, 0)),
    ((2, 768, 17, 17), (192, 768, 1, 1), (0, 0)),
    ((2, 288, 35, 35), (64, 288, 1, 1), (0, 0)),
    ((2, 24, 14, 14), (64, 24, 5, 5), (2, 2)),
    ((2, 512, 14, 14), (24, 512, 1, 1), (0, 0)),
]


@pytest.mark.cuda
def test_cuda_conv_bwd_kernels_on_the_zoo_shapes():
    """On the card: K2 and K3 against their plain versions on the
    non-square and 24-channel shapes of the zoo, f32 and bf16, within 1e-4
    of max|plain|, one launch each, and a repeat gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(13)
    for (dshape, wshape, pad), dt in itertools.product(CONV_ZOO_CASES,
                                                       (torch.float32, torch.bfloat16)):
        assert kernels.conv_bwd_plan(dshape, wshape, (1, 1), pad, (1, 1), dt)
        n, _, h, w = dshape
        o, _, kh, kw = wshape
        oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
        x = torch.randn(dshape, generator=g).to("cuda", dt)
        wt = (0.1 * torch.randn(wshape, generator=g)).to("cuda", dt)
        gr = torch.randn(oshape, generator=g).to("cuda", dt)
        before = (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches)
        gw = kernels.conv_bwd_filter(x, gr, wshape, pad)
        gx = kernels.conv_bwd_input(gr, wt, dshape, pad)
        torch.cuda.synchronize()
        assert (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches) == (
            before[0] + 1, before[1] + 1)
        for got, want in ((gw, kernels.conv_bwd_filter_reference(x, gr, wshape, pad)),
                          (gx, kernels.conv_bwd_input_reference(gr, wt, dshape, pad))):
            assert got.dtype == torch.float32 and got.shape == want.shape
            err = (got - want).abs().max().item() / want.abs().max().item()
            assert err <= 1e-4, (dshape, wshape, pad, dt, err)
        assert torch.equal(gw, kernels.conv_bwd_filter(x, gr, wshape, pad))
        assert torch.equal(gx, kernels.conv_bwd_input(gr, wt, dshape, pad))


@pytest.mark.cuda
def test_cuda_conv_bwd_kernels_take_views_off_a_16_byte_boundary():
    """On the card: contiguous views that start off a 16-byte boundary, bf16
    2 or 8 bytes past it, which TMA cannot take as a tensor's base and the
    paired layout transposes cannot read a word at a time, go the routes
    that can (K2's channels-last copies, the scalar transposes), and f32
    4 or 8 bytes past it (read by the split layout pass, whose planes
    TMA reads from the wrapper's workspaces), and agree with the plain
    versions to 1e-4 of max|plain|, as aligned inputs do; the
    channels-last copy of grad is its plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(7)

    def at(shape, skip, scale=1.0):
        size = 1
        for d in shape:
            size *= d
        flat = torch.zeros(size + 8, dtype=dt, device="cuda")
        view = flat[skip:skip + size].view(shape)
        view.copy_(scale * torch.randn(shape, generator=g))
        return view

    for dshape, wshape, pad in [((4, 16, 16, 16), (8, 16, 1, 1), (0, 0)),
                                ((2, 8, 10, 10), (16, 8, 3, 3), (1, 1)),
                                ((2, 136, 8, 8), (72, 136, 1, 1), (0, 0))]:
        n, _, h, w = dshape
        o, _, kh, kw = wshape
        oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
        for dt, skip in ((torch.bfloat16, 1), (torch.bfloat16, 4), (torch.float32, 1),
                         (torch.float32, 2)):
            x, wt, gr = at(dshape, skip), at(wshape, skip, 0.1), at(oshape, skip)
            assert x.data_ptr() % 16 and gr.data_ptr() % 16
            mode = kernels.wgrad_plan_sm90(x, gr, wshape, pad, 132)[0]
            assert mode != "nchw"
            for got, want in ((kernels.conv_bwd_filter(x, gr, wshape, pad),
                               kernels.conv_bwd_filter_reference(x, gr, wshape, pad)),
                              (kernels.conv_bwd_input(gr, wt, dshape, pad),
                               kernels.conv_bwd_input_reference(gr, wt, dshape, pad))):
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                assert (got - want).abs().max().item() <= 1e-4 * scale
            assert torch.equal(kernels.conv_grad_channels_last(gr).cpu(),
                               kernels.conv_grad_channels_last(gr.cpu()))


@pytest.mark.cuda
def test_cuda_shared_channels_last_grad_gives_the_standalone_bits():
    """On the card, bf16 and f32: grad's channels-last copy (f32: its hi and
    lo planes, the bits of split_bf16) made once (conv_grad_channels_last)
    and handed to K2 and K3, and the autograd Function's backward that does
    so, give the bits of the two standalone wrappers, each of which
    transposes grad itself; one launch of each kernel per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(5)
    for (dshape, wshape, pad), dt in itertools.product(CONV_CASES,
                                                       (torch.bfloat16, torch.float32)):
        n, _, h, w = dshape
        o, _, kh, kw = wshape
        oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
        x, wt, gr = (t.to("cuda", dt) for t in (
            torch.randn(dshape, generator=g), 0.1 * torch.randn(wshape, generator=g),
            torch.randn(oshape, generator=g)))
        gw = kernels.conv_bwd_filter(x, gr, wshape, pad)
        gx = kernels.conv_bwd_input(gr, wt, dshape, pad)
        g_cl = kernels.conv_grad_channels_last(gr)
        assert torch.equal(g_cl.cpu(), kernels.conv_grad_channels_last(gr.cpu()))
        assert torch.equal(gw, kernels.conv_bwd_filter(x, gr, wshape, pad, g_cl=g_cl))
        assert torch.equal(gx, kernels.conv_bwd_input(gr, wt, dshape, pad, g_cl=g_cl))
        leaves = [x.clone().requires_grad_(), wt.clone().requires_grad_()]
        counts = (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches)
        kernels.conv2d_kernel_bwd(*leaves, pad).backward(gr)
        torch.cuda.synchronize()
        assert (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches) == (
            counts[0] + 1, counts[1] + 1)
        assert torch.equal(leaves[0].grad, gx.to(dt))
        assert torch.equal(leaves[1].grad, gw.to(dt))


@pytest.mark.cuda
def test_cuda_convolution_gradient_runs_the_conv_kernels():
    """On the card: autograd through an in-envelope Convolution launches K2
    and K3 once each and agrees with autograd through F.conv2d (cuDNN,
    TF32 off) at 1e-4 of max|.|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(4)
    x, w, cot = (torch.randn(s, generator=g).cuda()
                 for s in ((2, 16, 12, 12), (32, 16, 3, 3), (2, 32, 12, 12)))
    grads = []
    for fn in (lambda a, b: kernels.conv2d_kernel_bwd(a, b, (1, 1)),
               lambda a, b: torch.nn.functional.conv2d(a, b, padding=1)):
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        counts = (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches)
        (fn(*leaves) * cot).sum().backward()
        torch.cuda.synchronize()
        grads.append([t.grad for t in leaves])
        if not grads[1:]:
            assert (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches) == (
                counts[0] + 1, counts[1] + 1)
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_rtc_reproduces_test_rtc():
    """On the card: tests/test_rtc.py's cases through the port's NVRTC Rtc —
    its expected values (rtol 1e-6), its cache counts (1, then 1, then 2)
    and the MXNetError, with NVRTC's log, for a bad source."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_kernels as rk

    with mx.gpu(0):
        x = mx.nd.array(np.arange(8 * 128, dtype=np.float32).reshape(8, 128))
        y = mx.nd.zeros((8, 128))
        rk.make(rk.AXPB, [x], [y]).push([x], [y], (1, 1, 1), (1, 1, 1))
        np.testing.assert_allclose(y.asnumpy(), x.asnumpy() * 2.0 + 1.0, rtol=1e-6)
        a = mx.nd.array(np.random.RandomState(0).rand(4, 128).astype(np.float32))
        b = mx.nd.array(np.random.RandomState(1).rand(4, 128).astype(np.float32))
        out = mx.nd.zeros((4, 128))
        k = rk.make(rk.MADD, [a, b], [out])
        launches = mx.rtc.Rtc.launches
        k.push([a, b], [out])
        np.testing.assert_allclose(out.asnumpy(), a.asnumpy() * b.asnumpy() + a.asnumpy(),
                                   rtol=1e-6)
        assert len(k._cache) == 1
        k.push([a, b], [out])
        assert len(k._cache) == 1
        a2, o2 = mx.nd.ones((2, 128)), mx.nd.zeros((2, 128))
        k.push([a2, a2], [o2])
        assert len(k._cache) == 2 and mx.rtc.Rtc.launches == launches + 3
        np.testing.assert_allclose(o2.asnumpy(), np.full((2, 128), 2.0))
        with pytest.raises(mx.MXNetError, match="error"):
            mx.rtc.Rtc("bad", [("x", mx.nd.ones((2, 2)))], [("y", mx.nd.ones((2, 2)))],
                       "y[0] = = x[0];")
        with pytest.raises(mx.MXNetError, match="wrong number"):
            k.push([a], [out])
        with pytest.raises(mx.MXNetError, match="1024"):
            k.push([a, b], [out], (1, 1, 1), (2048, 1, 1))


@pytest.mark.cuda
def test_cuda_rtc_kernels_match_plain_versions():
    """On the card: kernels (a)-(c) of rtc_kernels against their plain
    versions, f32 at rtol 1e-6 and bf16 within one bf16 ulp, a repeat
    bitwise; kernel (d) against sgd_mom_update over three steps within 1e-6
    of max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_kernels as rk

    g = torch.Generator().manual_seed(5)
    with mx.gpu(0):
        for dt in (torch.float32, torch.bfloat16):
            x = mx.nd.NDArray((0.5 * torch.randn(3, 1000, generator=g)).to("cuda", dt))
            b = mx.nd.NDArray(torch.rand(3, 1000, generator=g).to("cuda", dt))
            for spec, ins, plain, dims in (
                    (rk.AXPB, [x], rk.axpb_plain, rk.grid_stride_dims(x.size)),
                    (rk.MADD, [x, b], rk.madd_plain, ((2, 1, 1), (64, 1, 1))),
                    (rk.EXP5, [x], rk.exp5_plain, ((3, 1, 1), (1000, 1, 1)))):
                out = mx.nd.zeros(x.shape, dtype=dt)
                k = rk.make(spec, ins, [out])
                k.push(ins, [out], *dims)
                first = out._data.clone()
                k.push(ins, [out], *dims)
                want = plain(*[a._data for a in ins]).float()
                err = (out._data.float() - want).abs()
                if dt == torch.float32:
                    assert (err <= 1e-6 * want.abs()).all(), spec[0]
                else:
                    mag = torch.maximum(want.abs(), out._data.float().abs())
                    assert (err <= 2.0 ** (torch.floor(torch.log2(mag)) - 7)).all(), spec[0]
                assert torch.equal(first, out._data), spec[0]
        w0, gr = (torch.randn(4097, generator=g).cuda() for _ in range(2))
        weight, mom = mx.nd.NDArray(w0.clone()), mx.nd.zeros((4097,))
        weight2, mom2 = mx.nd.NDArray(w0.clone()), mx.nd.zeros((4097,))
        grad = mx.nd.NDArray(gr)
        k = rk.make(rk.sgd_mom_source(0.1, 0.9, 1e-4, 0.5), [grad], [weight, mom])
        for _ in range(3):
            k.push([grad], [weight, mom], *rk.grid_stride_dims(weight.size))
            mx.nd.sgd_mom_update(weight2, grad, mom2, out=weight2, lr=0.1, momentum=0.9,
                                 wd=1e-4, rescale_grad=0.5)
        for got, want in ((weight, weight2), (mom, mom2)):
            scale = want._data.abs().max().item()
            assert (got._data - want._data).abs().max().item() <= 1e-6 * scale
        assert len(k._cache) == 1


def _slab_case(kind, size, g_dtype, g):
    w = torch.randn(size, generator=g).cuda()
    grad = (torch.randn(size, generator=g) * 4).to("cuda", g_dtype)
    states = [(torch.randn(size, generator=g) * 0.1).cuda()
              for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
    if kind == "adam":  # the second moment is never negative
        states[1] = states[1].abs()
    return w, grad, tuple(states)


SLAB_KW = dict(wd=1e-4, rescale_grad=1.0 / 32, momentum=0.9, beta1=0.9, beta2=0.999,
               epsilon=1e-8)
SLAB_KW_MULTI = {k: v for k, v in SLAB_KW.items() if k != "wd"}  # wd is per slab


@pytest.mark.cuda
def test_cuda_slab_update_kernel_matches_plain_version_bitwise():
    """On the card: K1 against its plain version, every output bit for bit
    (the kernel rounds each product, sum, root and quotient once, as each
    PyTorch op does); a skipped step returns its inputs bit for bit; a
    repeat gives the same bits; in place through out= as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(5)
    for kind in ("sgd", "sgd_mom", "adam"):
        for size in (1, 131, 1024, 5000, 70001):
            for g_dtype in (torch.bfloat16, torch.float32):
                w, grad, states = _slab_case(kind, size, g_dtype, g)
                for finite in (1.0, 0.0):
                    for clip in (None, 0.05):
                        args = (kind, w, grad, states, 0.05, 1.0 / 128, finite)
                        before = kernels.fused_slab_update.launches
                        got = kernels.fused_slab_update(*args, clip_gradient=clip, **SLAB_KW)
                        again = kernels.fused_slab_update(*args, clip_gradient=clip, **SLAB_KW)
                        assert kernels.fused_slab_update.launches == before + 2
                        want = kernels.slab_update_reference(*args, clip_gradient=clip,
                                                             **SLAB_KW)
                        for a, b, c in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2]),
                                           (again[0], *again[1], again[2])):
                            assert torch.equal(a, b) and torch.equal(a, c), (kind, size, finite)
                        if finite == 0.0:
                            assert torch.equal(got[0], w)
                            assert all(torch.equal(a, s) for a, s in zip(got[1], states))
                mw, ms = w.clone(), tuple(s.clone() for s in states)
                w16 = torch.empty(size, dtype=torch.bfloat16, device="cuda")
                kernels.fused_slab_update(kind, mw, grad, ms, 0.05, 1.0 / 128, 1.0,
                                          clip_gradient=None, out=(mw, ms, w16), **SLAB_KW)
                want = kernels.slab_update_reference(kind, w, grad, states, 0.05, 1.0 / 128,
                                                     1.0, clip_gradient=None, **SLAB_KW)
                assert torch.equal(mw, want[0]) and torch.equal(w16, want[2])
                assert all(torch.equal(a, b) for a, b in zip(ms, want[1]))


@pytest.mark.cuda
def test_cuda_slab_update_wrapper_raises_on_bad_arguments():
    """A CUDA call launches the kernel or raises: a CPU tensor among CUDA
    ones, a wrong state count, a wrong dtype or an unknown kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.zeros(64, device="cuda")
    g16 = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    mom = torch.zeros(64, device="cuda")
    bad = [
        ("sgd_mom", w, g16.cpu(), (mom,)),
        ("sgd_mom", w, g16, (mom.cpu(),)),
        ("sgd_mom", w, g16, ()),
        ("adam", w, g16, (mom,)),
        ("sgd", w.half(), g16, ()),
        ("nag", w, g16, ()),
    ]
    for kind, a, b, states in bad:
        with pytest.raises(MXNetError):
            kernels.fused_slab_update(kind, a, b, states, 0.1, 1.0, 1.0, clip_gradient=None,
                                      **SLAB_KW)


def _slab_view(size, offset, dtype, g, scale=1.0):
    """A slab of ``size`` random values ``offset`` elements into a larger
    buffer: a view off the 16-byte boundary when ``offset`` % 4 != 0."""
    buf = (torch.randn(size + 8, generator=g) * scale).to("cuda", dtype)
    return buf[offset:offset + size]


def _slab_table_case(kind, g_dtype, g, out=False):
    """Ragged slabs at offsets 0-3 (one with its gradient misaligned against
    its master, which the kernel runs scalar), each with its own lr (one a
    device tensor) and wd; ``out``: in place, with a bf16 copy at the
    master's offset."""
    entries = []
    specs = [(1, 0, 0), (7, 3, 3), (131, 1, 1), (1024, 2, 2), (5000, 1, 3), (70001, 0, 0),
             (2359296, 2, 2)]
    for i, (size, off, g_off) in enumerate(specs):
        w = _slab_view(size, off, torch.float32, g)
        grad = _slab_view(size, g_off, g_dtype, g, 4.0)
        states = [_slab_view(size, off, torch.float32, g, 0.1)
                  for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
        if kind == "adam":  # the second moment is never negative
            states[1] = states[1].abs()
        lr = torch.full((), 0.03, device="cuda") if i == 2 else 0.01 * (i + 1)
        o = None
        if out:
            o = (w, tuple(states), _slab_view(size, off, torch.bfloat16, g))
        entries.append(kernels.SlabEntry(w, grad, tuple(states), lr, (0.0, 1e-4, 5e-4)[i % 3], o))
    return entries


@pytest.mark.cuda
def test_cuda_slab_update_multi_matches_plain_version_bitwise():
    """On the card: K1 over a table of ragged slabs at odd offsets in one
    launch, each slab with its own lr and wd, against the plain version of
    the table: every output bit for bit, a skipped step returns its inputs
    bit for bit, a repeat gives the same bits, in place as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(6)
    for kind, g_dtype in itertools.product(("sgd", "sgd_mom", "adam"),
                                           (torch.bfloat16, torch.float32)):
        entries = _slab_table_case(kind, g_dtype, g)
        for finite, clip in itertools.product((1.0, 0.0), (None, 0.05)):
            args = (kind, entries, torch.full((), 1.0 / 128, device="cuda"),
                    torch.full((), finite, device="cuda"))
            before = kernels.fused_slab_update.launches
            got = kernels.fused_slab_update_multi(*args, clip_gradient=clip, **SLAB_KW_MULTI)
            again = kernels.fused_slab_update_multi(*args, clip_gradient=clip, **SLAB_KW_MULTI)
            assert kernels.fused_slab_update.launches == before + 2
            want = kernels.slab_update_multi_reference(*args, clip_gradient=clip,
                                                       **SLAB_KW_MULTI)
            for e, r, s, a in zip(entries, got, want, again):
                for x, y, z in zip((r[0], *r[1], r[2]), (s[0], *s[1], s[2]),
                                   (a[0], *a[1], a[2])):
                    assert torch.equal(x, y) and torch.equal(x, z), (kind, e.w.shape, finite)
                if finite == 0.0:
                    assert torch.equal(r[0], e.w)
                    assert all(torch.equal(x, y) for x, y in zip(r[1], e.states))
        ins = _slab_table_case(kind, g_dtype, torch.Generator().manual_seed(7), out=True)
        copy = [kernels.SlabEntry(e.w.clone(), e.g, tuple(s.clone() for s in e.states), e.lr,
                                  e.wd) for e in ins]
        kernels.fused_slab_update_multi(kind, ins, 1.0 / 128, 1.0, clip_gradient=None,
                                        **SLAB_KW_MULTI)
        want = kernels.slab_update_multi_reference(kind, copy, 1.0 / 128, 1.0, clip_gradient=None,
                                                   **SLAB_KW_MULTI)
        for e, s in zip(ins, want):
            assert torch.equal(e.w, s[0]) and torch.equal(e.out[2], s[2])
            assert all(torch.equal(x, y) for x, y in zip(e.states, s[1]))


@pytest.mark.cuda
def test_cuda_slab_update_multi_raises_on_bad_arguments():
    """A table call launches the kernel or raises: a wrong dtype, a CPU
    slab among CUDA ones, a length mismatch, two gradient dtypes in one
    table, a per-step scalar of the wrong type; nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.zeros(64, device="cuda")
    g16 = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    mom = torch.zeros(64, device="cuda")
    good = kernels.SlabEntry(w, g16, (mom,), 0.1, 0.0)
    bad = [
        [good, kernels.SlabEntry(w.double(), g16, (mom,), 0.1, 0.0)],
        [good, kernels.SlabEntry(w, g16, (mom.cpu(),), 0.1, 0.0)],
        [good, kernels.SlabEntry(w, g16[:63], (mom,), 0.1, 0.0)],
        [good, kernels.SlabEntry(w, g16.float(), (mom,), 0.1, 0.0)],
        [good, kernels.SlabEntry(w, g16, (mom,), torch.zeros((), dtype=torch.float64,
                                                             device="cuda"), 0.0)],
        [good, kernels.SlabEntry(w[::2], g16[::2], (mom[::2],), 0.1, 0.0)],
    ]
    before = kernels.fused_slab_update.launches
    for entries in bad:
        with pytest.raises(MXNetError):
            kernels.fused_slab_update_multi("sgd_mom", entries, 1.0, 1.0, clip_gradient=None,
                                            **SLAB_KW_MULTI)
    with pytest.raises(MXNetError):
        kernels.fused_slab_update_multi("sgd_mom", [good], torch.ones(2, device="cuda"), 1.0,
                                        clip_gradient=None, **SLAB_KW_MULTI)
    assert kernels.fused_slab_update.launches == before



@pytest.mark.cuda
def test_cuda_slab_update_multi_refuses_host_lrs_under_capture():
    """While the stream is captured into a CUDA graph, K1's table wrapper
    refuses a host-number lr (its pinned copy would be read from a freed
    block at each replay) and takes a device one, which each replay reads
    anew: two replays at two lrs give the plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(8)
    w0 = torch.randn(5000, generator=g).cuda()
    grad = torch.randn(5000, generator=g).cuda().bfloat16()
    mom0 = torch.randn(5000, generator=g).cuda()
    w, mom, w16 = w0.clone(), mom0.clone(), torch.empty(5000, dtype=torch.bfloat16, device="cuda")
    lr = torch.full((), 0.1, device="cuda")
    one = torch.ones((), device="cuda")

    def table(lr_value):
        return [kernels.SlabEntry(w, grad, (mom,), lr_value, 1e-4, (w, (mom,), w16))]

    kernels.fused_slab_update_multi("sgd_mom", table(lr), one, one, clip_gradient=None,
                                    **SLAB_KW_MULTI)  # built and loaded before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with pytest.raises(MXNetError, match="captured into a CUDA graph"):
            kernels.fused_slab_update_multi("sgd_mom", table(0.1), one, one, clip_gradient=None,
                                            **SLAB_KW_MULTI)
        kernels.fused_slab_update_multi("sgd_mom", table(lr), one, one, clip_gradient=None,
                                        **SLAB_KW_MULTI)
    for value in (0.1, 0.25):
        w.copy_(w0)
        mom.copy_(mom0)
        lr.fill_(value)
        graph.replay()
        want = kernels.slab_update_reference("sgd_mom", w0, grad, (mom0,), value, 1.0, 1.0,
                                             wd=1e-4, clip_gradient=None, **SLAB_KW_MULTI)
        torch.cuda.synchronize()
        assert torch.equal(w, want[0]) and torch.equal(mom, want[1][0])
        assert torch.equal(w16, want[2])


def _mlp_trainer(mx, dropout, amp, monkeypatch):
    if amp:
        monkeypatch.setenv("MXTPU_AMP", "bf16")
    else:
        monkeypatch.delenv("MXTPU_AMP", raising=False)
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    if dropout:
        net = mx.sym.Dropout(net, p=0.3)
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1 / 32)
    mesh = mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4)
    tr = mx.parallel.ShardedTrainStep(net, mesh, optimizer=opt).compile()
    assert tr.amp == amp
    shapes, _, _ = net.infer_shape(data=(32, 100), softmax_label=(32,))
    state = tr.init(dict(zip(net.list_arguments(), shapes)), mx.init.Xavier())
    g = torch.Generator().manual_seed(9)
    batches = [{"data": torch.randn(32, 100, generator=g).cuda(),
                "softmax_label": torch.randint(0, 10, (32,), generator=g).float().cuda()}
               for _ in range(2)]
    return tr, state, batches


def _clone_state(state):
    return [{n: tuple(x.clone() for x in v) if isinstance(v, tuple) else
             (None if v is None else v.clone()) for n, v in d.items()} for d in state]


def _state_equal(a, b):
    flat = lambda d: [x for v in d.values() for x in (v if isinstance(v, tuple) else (v,))  # noqa
                      if x is not None]
    return all(torch.equal(x, y) for da, db in zip(a, b) for x, y in zip(flat(da), flat(db)))


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_cuda_captured_group_equals_eager_steps(amp, monkeypatch):
    """A 2-layer MLP's group of 2 fused steps (f32 flat update, or bf16 AMP
    with K1) gives the bits of two eager steps: run eagerly (the warm-up),
    captured and replayed, and replayed again, each from the same state;
    the capture counted K1 once a micro-step under AMP. The AMP case hands
    the group host batches (staged through pinned memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx

    tr, state, batches = _mlp_trainer(mx, False, amp, monkeypatch)
    p, a, s = _clone_state(state)
    outs = []
    for t, batch in enumerate(batches, 1):
        p, a, s, o = tr(p, a, s, batch, lr=0.1, t=t)
        outs.append(o)
    stacked = {n: [b[n].cpu() if amp else b[n] for b in batches] for n in batches[0]}
    for _ in range(3):
        got = tr.call_multi(*_clone_state(state), stacked, [0.1, 0.1], [1, 2])
        torch.cuda.synchronize()
        assert _state_equal(got[:3], (p, a, s))
        assert all(torch.equal(got[3][0][i], o[0]) for i, o in enumerate(outs))
    (stats,) = tr.group_stats()
    assert (stats["warmup_groups"], stats["captures"], stats["replays"]) == (1, 1, 2), stats
    assert stats["captured_launches"] == ({"fused_slab_update": 2} if amp else {}), stats


@pytest.mark.cuda
def test_cuda_replays_draw_fresh_dropout_masks(monkeypatch):
    """The sampler generator is registered with the graph: two replays of a
    Dropout MLP's group from one state give different outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx

    tr, state, batches = _mlp_trainer(mx, True, False, monkeypatch)
    stacked = {n: [b[n] for b in batches] for n in batches[0]}
    runs = [tr.call_multi(*_clone_state(state), stacked, [0.1, 0.1], [1, 2])[3][0].clone()
            for _ in range(3)]
    assert not torch.equal(runs[1], runs[2])


def _mlp_serving_predictor(mx, ctx):
    """A 16-d MLP behind a Predictor on ``ctx``, weights from a seed."""
    import numpy as np

    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.models import mlp

    sym = mlp.get_symbol(num_classes=10, hidden=(32,))
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(1, 16))
    with mx.cpu():
        params = {"arg:" + n: mx.nd.array((rng.randn(*s) * 0.2).astype(np.float32))
                  for n, s in zip(sym.list_arguments(), arg_shapes)
                  if n not in ("data", "softmax_label")}
    return predict.Predictor(sym.tojson(), params, {"data": (1, 16)}, ctx=ctx)


@pytest.mark.cuda
def test_cuda_predictor_bucket_replay_equals_eager():
    """Each captured batch bucket's replay gives the eager predict() of the
    same rows bit for bit, call after call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import mxnet_tpu_torch as mx

    p = _mlp_serving_predictor(mx, mx.gpu(0))
    p.compile([{"data": (b, 16)} for b in (1, 2, 4)])
    rng = np.random.RandomState(1)
    for b in (1, 2, 4):
        assert p._serve_cache[(("data", (b, 16)),)]._graph is not None
        for _ in range(2):
            x = rng.randn(b, 16).astype(np.float32)
            got = p.predict_batch(data=x)[0]
            p.reshape({"data": (b, 16)})
            want = p.predict(data=x)[0]
            assert got.tobytes() == want.tobytes()


@pytest.mark.cuda
def test_cuda_predictor_bucket_after_compile_counts_one_miss():
    """A bucket first seen after compile() is captured on the spot: one
    plan miss, no recompile (its program's first signature is its warm-up),
    and its second call is a replay with no miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry

    was = telemetry.enabled()
    telemetry.enable()
    try:
        p = _mlp_serving_predictor(mx, mx.gpu(0))
        p.compile([{"data": (1, 16)}])
        misses = telemetry.REGISTRY.get("executor.dispatch_plan_misses")
        m0, r0 = misses.value(), telemetry.anatomy._C_RECOMPILES.value()
        x = np.random.RandomState(2).randn(2, 16).astype(np.float32)
        first = p.predict_batch(data=x)[0]
        assert misses.value() - m0 == 1
        assert p._serve_cache[(("data", (2, 16)),)]._graph is not None
        assert p.predict_batch(data=x)[0].tobytes() == first.tobytes()
        assert misses.value() - m0 == 1
        assert telemetry.anatomy._C_RECOMPILES.value() - r0 == 0
    finally:
        telemetry.registry.set_enabled(was)


@pytest.mark.cuda
def test_cuda_predictor_host_read_raises_at_capture(monkeypatch):
    """A forward that reads a host value cannot be captured: compile()
    raises MXNetError naming the bucket, and nothing falls back to eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    op = registry.get("FullyConnected")
    plain = op.fcompute

    def reads_host(attrs, inputs, is_train):
        float(inputs[0].sum())
        return plain(attrs, inputs, is_train)

    p = _mlp_serving_predictor(mx, mx.gpu(0))
    monkeypatch.setattr(op, "fcompute", reads_host)
    with pytest.raises(MXNetError, match="bucket"):
        p.compile([{"data": (2, 16)}])


@pytest.mark.cuda
def test_cuda_captured_decode_step_equals_eager():
    """16 replays of the captured decode step, with a prefill between
    them, against decode_step run eagerly on a clone of the cache: logits
    and the whole cache bit for bit; the cache tensors never move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving.decode import GenerationEngine

    dims = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128)
    init_fn, _ = tfm.transformer_lm(**dims)
    for dtype in (torch.float32, torch.bfloat16):
        params = tfm.params_from_jax(init_fn(0), device="cuda", dtype=dtype)
        model = tfm.transformer_lm_serving(max_len=64, dtype=dtype, **dims)
        decode_step = model[2]
        gen = GenerationEngine(params, model, slots=4, max_len=64, device="cuda").compile()
        assert gen.decode_stats["captures"] == 1
        ptrs = gen._cache_addresses()
        rng = np.random.RandomState(3)

        def admit(slots, length):
            toks = rng.randint(0, 256, (len(slots), 8)).astype(np.int32)
            gen._prefill_call(toks, np.asarray(slots, np.int32),
                              np.full((len(slots),), length, np.int32))

        admit([0, 1], 5)
        for step in range(16):
            if step == 8:
                admit([2], 7)
            toks = rng.randint(0, 256, (5,)).astype(np.int32)
            ref = {k: v.clone() for k, v in gen._cache.items()}
            _, want = decode_step(params, ref, torch.from_numpy(toks).cuda())
            got = gen._decode_call(toks)
            assert torch.equal(got, want), step
            for k in ref:
                assert torch.equal(gen._cache[k], ref[k]), (step, k)
        assert gen._cache_addresses() == ptrs
        assert gen.decode_stats["captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_cuda_gated_slab_update_matches_plain_version_bitwise(kind):
    """The guard's gated K1 launch: the flag is a device scalar ``finite and
    gn2 <= thr`` (0 here, gn2 over the threshold), read by the kernel from
    device memory; every output is its plain version's bit for bit, which is
    its input (the bf16 copy that of the old master). With the threshold
    raised the same launch applies the step, again bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(11)
    entries = _slab_table_case(kind, torch.bfloat16, g)
    thr = torch.zeros((), device="cuda")
    for threshold, applied in ((1.0, False), (float("inf"), True)):
        thr.fill_(threshold)
        gn2 = torch.stack([torch.linalg.vector_norm(e.g, dtype=torch.float32).square()
                           for e in entries]).sum()
        flag = (torch.isfinite(gn2) & (gn2 <= thr)).float()
        args = (kind, entries, torch.tensor(1.0 / 128, device="cuda"), flag)
        before = kernels.fused_slab_update.launches
        got = kernels.fused_slab_update_multi(*args, clip_gradient=None, **SLAB_KW_MULTI)
        assert kernels.fused_slab_update.launches == before + 1
        want = kernels.slab_update_multi_reference(*args, clip_gradient=None, **SLAB_KW_MULTI)
        for e, (gw, gs, g16), (ww, ws, w16) in zip(entries, got, want):
            assert torch.equal(gw, ww) and torch.equal(g16, w16)
            assert all(torch.equal(a, b) for a, b in zip(gs, ws))
            if not applied:
                assert torch.equal(gw, e.w) and torch.equal(g16, e.w.bfloat16())
                assert all(torch.equal(a, b) for a, b in zip(gs, e.states))
            else:
                assert not torch.equal(gw, e.w)


@pytest.mark.cuda
def test_cuda_guarded_group_skips_bitwise_and_rethresholds_without_recapture(monkeypatch):
    """An armed AMP trainer's group of 2 on the card: an inf batch as the
    second micro-step leaves its state bit for bit as after the first (the
    scaler backs off) in the eager warm-up, the capture's replay and a
    second replay; a threshold of 0 written between replays gates both
    micro-steps (the state stays bit for bit) with no new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx

    tr, state, batches = _mlp_trainer(mx, False, True, monkeypatch)
    tr.arm_guard()
    batches[1]["data"][0, 0] = float("inf")
    p, a, s = _clone_state(state)
    p, a, s, _ = tr(p, a, s, batches[0], lr=0.1, t=1)  # the eager first step
    scaler = (tr.AMP_SCALE_KEY, tr.AMP_GOOD_KEY)
    want_opt = {k: v for k, v in s.items() if k not in scaler}
    stacked = {n: [b[n] for b in batches] for n in batches[0]}
    for _ in range(3):
        got = tr.call_multi(*_clone_state(state), stacked, [0.1, 0.1], [1, 2])
        torch.cuda.synchronize()
        assert _state_equal(got[:2], (p, a))
        assert _state_equal([{k: v for k, v in got[2].items() if k not in scaler}], [want_opt])
        assert float(got[2][tr.AMP_SCALE_KEY]) == float(s[tr.AMP_SCALE_KEY]) * 0.5
        diag = got[3][-1]
        assert diag[:, 2].tolist() == [1.0, 0.0]
    tr.guard_threshold = 0.0
    start = _clone_state(state)
    got = tr.call_multi(*_clone_state(state), stacked, [0.1, 0.1], [1, 2])
    torch.cuda.synchronize()
    assert _state_equal(got[:2], start[:2])
    assert got[3][-1][:, 2].tolist() == [0.0, 0.0]
    (stats,) = tr.group_stats()
    assert (stats["warmup_groups"], stats["captures"], stats["replays"]) == (1, 1, 3), stats


@pytest.mark.cuda
def test_cuda_device_feed_stages_pinned_copies_bitwise(monkeypatch):
    """DeviceFeedIter on the card: every staged batch equals the host
    batch bit for bit, lives on gpu(0) and carries ``staged_device``; the
    staged batches dropped by a reset and a skip (copies in flight) leave
    the next batches right, and pinned buffers are reused (at most one
    pair a staged batch and one in hand, over 20 batches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import mxnet_tpu_torch as mx

    pinned = []
    empty = torch.empty

    def counting_empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            pinned.append(args)
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", counting_empty)

    x = np.random.RandomState(0).randn(64, 3, 32, 32).astype(np.float32)
    y = np.arange(64, dtype=np.float32)
    with mx.cpu():
        want = [b.data[0].asnumpy() for b in mx.io.NDArrayIter(x, y, batch_size=8)]
    feed = mx.io.DeviceFeedIter(mx.io.NDArrayIter(x, y, batch_size=8), mx.gpu(0), depth=3)
    for _ in range(2):
        got = []
        for b in feed:
            assert b.staged_device == torch.device("cuda", 0)
            assert b.data[0]._data.is_cuda and b.label[0]._data.is_cuda
            got.append(b.data[0].asnumpy())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        feed.reset()
    feed.next()
    feed.skip(2)
    np.testing.assert_array_equal(feed.next().data[0].asnumpy(), want[3])
    assert 0 < len(pinned) <= 2 * (feed.depth + 1), len(pinned)


@pytest.mark.cuda
def test_cuda_rnn_op_reads_cudnn_layout_and_matches_plain_loop():
    """On the card: the RNN operator hands cuDNN its weights at cuDNN's own
    offsets (no compaction warning) and its outputs and gradients match
    the plain per-step loop to 1e-4 of max, one and two directions."""
    from mxnet_tpu_torch.ops import registry, rnn_op

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(8)
    op = registry.get("RNN")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 products, as the plain loop's
    try:
        _rnn_cases(op, rnn_op, g)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _rnn_cases(op, rnn_op, g):
    import warnings

    for mode, bidir in (("lstm", False), ("gru", True)):
        attrs = op.canon_attrs({"mode": mode, "num_layers": 2, "state_size": 24,
                                "bidirectional": bidir, "state_outputs": True})
        dirs = 2 if bidir else 1
        shapes = [(9, 4, 16), (rnn_op._rnn_param_size(2, 16, 24, bidir, mode),),
                  (2 * dirs, 4, 24)] + ([(2 * dirs, 4, 24)] if mode == "lstm" else [])
        ins = [(0.3 * torch.randn(s, generator=g)).cuda().requires_grad_() for s in shapes]
        got, want = [], []
        for fn, out in ((op.fcompute, got), (rnn_op.rnn_reference, want)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outs = fn(attrs, ins, True)
                out.extend(list(outs) + list(torch.autograd.grad([o.sum() for o in outs], ins)))
            if fn is op.fcompute:
                assert not caught, [str(w.message) for w in caught]
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)


def _mirror_conv_step(mirror, monkeypatch, dropout=False):
    """One training step of a small conv-BN-ReLU net (three in-envelope 3x3
    convolutions) on gpu(0) through the Executor, the mirror on or off:
    the gradients, the wrappers' K2/K3 launches and the forward
    convolutions the dispatcher saw."""
    import collections

    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    import mxnet_tpu_torch as mx

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    if mirror:
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    else:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    with mx.name.NameManager():
        net = mx.sym.Variable("data")
        for i in range(3):
            net = mx.sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=16,
                                     no_bias=True, name="conv%d" % i)
            net = mx.sym.BatchNorm(net, name="bn%d" % i)
            net = mx.sym.Activation(net, act_type="relu")
        if dropout:
            net = mx.sym.Dropout(net, p=0.5)
        net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10, name="fc")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
    exe = net.simple_bind(mx.gpu(0), data=(4, 16, 16, 16), softmax_label=(4,))
    assert exe._mirror == mirror
    rng = np.random.RandomState(0)
    for name, arr in exe.arg_dict.items():
        arr[:] = (rng.randint(0, 10, arr.shape) if name == "softmax_label"
                  else rng.randn(*arr.shape) * 0.1)
    mx.random.seed(3)
    before = {k: getattr(kernels, k).launches for k in ("conv_bwd_filter", "conv_bwd_input")}
    with Count() as count:
        exe.forward(is_train=True)
        exe.backward()
    torch.cuda.synchronize()
    launches = {k: getattr(kernels, k).launches - v for k, v in before.items()}
    grads = {n: g._data.clone() for n, g in exe.grad_dict.items() if g is not None}
    return grads, launches, count.ops


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [False, True])
def test_cuda_mirror_keeps_conv_launches_and_gradients(monkeypatch, dropout):
    """On the card, cuDNN deterministic: a mirrored step runs the same
    forward convolutions and K2/K3 launches (three each) as the plain one,
    recomputes the ReLUs, and gives its gradients bit for bit, Dropout
    included (the generator set back for the recompute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    plain, plain_launches, plain_ops = _mirror_conv_step(False, monkeypatch, dropout)
    got, launches, ops = _mirror_conv_step(True, monkeypatch, dropout)
    assert launches == plain_launches == {"conv_bwd_filter": 3, "conv_bwd_input": 3}
    assert ops["convolution"] == plain_ops["convolution"] == 3
    assert ops["relu"] == 2 * plain_ops["relu"]
    for name, g in plain.items():
        assert torch.equal(got[name], g), name


@pytest.mark.cuda
def test_cuda_mirrored_dropout_group_replays_bitwise(monkeypatch):
    """On the card: a Dropout MLP's trainer under the mirror, three groups
    of two steps from one state (warm-up, capture + replay, replay), gives
    the outputs of the same groups without the mirror bit for bit: eagerly
    the generator is set back for the recompute, in the captured graph the
    draws are kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import mxnet_tpu_torch as mx

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(5)
    batches = {"data": [torch.from_numpy(rng.randn(32, 100).astype(np.float32)).to(dev)
                        for _ in range(2)],
               "softmax_label": [torch.from_numpy(rng.randint(0, 10, 32).astype(np.float32))
                                 .to(dev) for _ in range(2)]}
    runs = {}
    for mirror in (False, True):
        if mirror:
            monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
        else:
            monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64, name="fc1")
        net = mx.sym.Dropout(mx.sym.Activation(net, act_type="relu"), p=0.3)
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(net, num_hidden=10, name="fc2"),
                                   name="softmax")
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1 / 32)
        tr = mx.parallel.ShardedTrainStep(
            net, mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4), optimizer=opt).compile()
        assert tr.mirror == mirror
        arg_shapes, _, _ = net.infer_shape(data=(32, 100), softmax_label=(32,))
        np.random.seed(0)
        state = tr.init(dict(zip(net.list_arguments(), arg_shapes)), mx.init.Xavier())
        mx.random.seed(11)
        outs = []
        for _ in range(3):
            state = tr.call_multi(*state, batches, [0.1, 0.1], [1, 2])[:3]
            outs.append({n: v.clone() for n, v in state[0].items()})
        torch.cuda.synchronize()
        (g,) = tr.group_stats()
        assert (g["warmup_groups"], g["captures"], g["replays"]) == (1, 1, 2), g
        runs[mirror] = outs
    for i, (a, b) in enumerate(zip(runs[False], runs[True])):
        for name in a:
            assert torch.equal(a[name], b[name]), (i, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ring_attention_matches_unsharded_kernel(dtype):
    """On the card: ring attention over sp 4 (causal) and 2 (not) against
    the unsharded flash kernel, output and dq, dk, dv to 1e-4 (f32) / 2e-2
    (bf16) of max; each live block pair launches K4f, K4dq and K4dkv once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention

    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(3)
    for sp, causal in ((4, True), (2, False)):
        q, k, v = (torch.randn(2, 256, 2, 64, generator=g).to("cuda", dtype).requires_grad_()
                   for _ in range(3))
        cot = torch.randn(2, 256, 2, 64, generator=g).to("cuda", dtype)
        before = (kernels.flash_attention.launches, kernels.flash_attention_dq.launches,
                  kernels.flash_attention_dkv.launches)
        out = ring_attention(q, k, v, sp, causal=causal)
        got = (out,) + torch.autograd.grad(out, (q, k, v), cot)
        torch.cuda.synchronize()
        pairs = sp * (sp + 1) // 2 if causal else sp * sp
        after = (kernels.flash_attention.launches, kernels.flash_attention_dq.launches,
                 kernels.flash_attention_dkv.launches)
        assert [b - a for a, b in zip(before, after)] == [pairs] * 3
        ref = kernels.flash_attention(q, k, v, causal=causal)
        want = (ref,) + torch.autograd.grad(ref, (q, k, v), cot)
        for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
            scale = y.float().abs().max().item()
            assert (x.float() - y.float()).abs().max().item() <= tol * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["detection", "proposal"])
def test_cuda_nms_kernel_matches_its_plain_version(kind):
    """On the card: the NMS kernel's suppressed flags equal its plain
    version's on the masks MultiBoxDetection (every anchor a step, classes
    and ties) and Proposal (boxes after each in the score order) build; one
    launch a call; a mask of more boxes than a CTA's shared memory holds
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxnet_tpu_torch.contrib import ops as cops

    g = torch.Generator().manual_seed(22)
    n = 3000
    xy = torch.rand(4, n, 2, generator=g) * 0.8
    boxes = torch.cat([xy, xy + 0.05 + torch.rand(4, n, 2, generator=g) * 0.3], -1).cuda()
    if kind == "detection":
        cls_id = torch.randint(-1, 4, (4, n), generator=g).float().cuda()
        score = torch.rand(4, n, generator=g)
        score[:, ::5] = 0.5  # ties
        order = torch.argsort(-score, dim=1, stable=True).cuda()
        args = cops.detection_nms_inputs(boxes, cls_id, order, 0.5)
    else:
        score = torch.rand(n, generator=g)
        score[::7] = -1.0
        args = cops.proposal_nms_inputs(boxes[0] * 600, score.cuda(), 0.7)
    before = kernels.nms_suppress.launches
    got = kernels.nms_suppress(*args)
    assert kernels.nms_suppress.launches == before + 1
    want = kernels.nms_suppress_reference(*(a.cpu() for a in args))
    assert torch.equal(got.cpu(), want)
    with pytest.raises(MXNetError, match="shared memory"):
        kernels.nms_suppress(torch.zeros((1, 1, 240000), dtype=torch.bool, device="cuda"),
                             torch.zeros((1, 1), dtype=torch.int64, device="cuda"),
                             torch.zeros((1, 240000), dtype=torch.bool, device="cuda"))
