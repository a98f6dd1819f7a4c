"""Kernels of the PyTorch port (counterpart of
``mxnet_tpu/ops/pallas_kernels.py``): flash attention, the conv-backward
pair and the optimizer-slab update.

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu``: blockwise online-softmax attention that saves
the f32 logsumexp, through TMA and ``wgmma`` (f32 operands as the hi and lo
bf16 planes of one ``split_planes`` pass, three bf16 products for each f32
one). ``reference_attention`` is its plain PyTorch version,
the same function with the scores materialised. Its gradient is a
``torch.autograd.Function`` whose backward runs the two kernels of
``csrc/flash_attn_bwd.cu``, wrapped by ``flash_attention_dq`` and
``flash_attention_dkv`` (through TMA and ``wgmma`` as the forward, f32 as
the planes of one split pass for both); ``reference_attention_bwd`` is
their plain version. Each wrapper takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises. ``attention`` is
the dispatch every model calls.

Layout convention as in the JAX package: [B, T, H, D].

``conv_bwd_filter`` (K2) and ``conv_bwd_input`` (K3) wrap the kernels of
``csrc/conv_bwd.cu``, the filter and data gradients of a stride-1 2-D
convolution inside ``conv_bwd_plan``'s envelope; ``conv_bwd_*_reference``
are their plain versions, and ``conv2d_kernel_bwd`` is the convolution
whose autograd backward runs them. Layout NCHW / OIHW, as in JAX; the
kernels (implicit GEMMs through TMA and ``wgmma``) read transposed bf16
copies, for f32 inputs the hi and lo planes of ``split_bf16`` multiplied
as three bf16 products, whose plain versions are ``conv_dgrad_layout``
(K3) and ``conv_wgrad_layout`` (K2); the backward makes grad's
channels-last copy once (``conv_grad_channels_last``) and hands it to
both.

``fused_slab_update_multi`` (K1) wraps ``csrc/slab_update.cu``: one
bf16-AMP optimizer step (sgd, sgd_mom, adam) over a table of flat slabs in
one launch, with a finite select and a bf16 weight copy;
``fused_slab_update`` is the same on one slab (the JAX signature), and
``slab_update_reference`` / ``slab_update_multi_reference`` are their plain
versions.

``nms_suppress`` wraps ``csrc/nms.cu``, the greedy suppression loop of the
detection operators (MultiBoxDetection, Proposal) in one launch; it has no
TPU counterpart (the JAX package runs the loop as a device ``fori_loop``).
``nms_suppress_reference`` is its plain version, and ``box_iou`` the IoU
the callers build the loop's mask from.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_name
from . import _build

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _masked_scores(q, k, causal, scale):
    """f32 scores scale·q·kᵀ with the causal mask applied, [B, H, Tq, Tk];
    the einsum runs in q's dtype and is cast after, as the JAX oracle does."""
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def reference_attention(q, k, v, causal=False, scale=None):
    """Materialised-scores attention, cast for cast the JAX package's
    ``reference_attention``: scores in q's dtype then f32, f32 softmax,
    f32 value product, output in q's dtype."""
    s = _masked_scores(q, k, causal, _default_scale(q, scale))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def reference_lse(q, k, causal=False, scale=None):
    """The logsumexp the kernel saves for a backward pass, [B, H, T] f32."""
    return torch.logsumexp(_masked_scores(q, k, causal, _default_scale(q, scale)), dim=-1)


def reference_attention_bwd(q, k, v, do, lse, delta, causal=False, scale=None):
    """Plain version of the two backward kernels: ``(dq, dk, dv)`` in q's
    dtype from q/k/v/do [B, T, H, D] and the f32 ``lse`` and
    ``delta = Σ_D do·out``, both [B, H, T]. Follows ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``: loads upcast to f32, s = scale·q·kᵀ,
    P = exp(s − lse) where kept else 0, dS = P∘(do·vᵀ − delta), every product
    and sum in f32, the scale applied again to dq and dk."""
    scale = _default_scale(q, scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        t = q.shape[1]
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def tma_compatible(x):
    """Whether the Tensor Memory Accelerator can read the [B, T, H, D] tensor
    ``x`` where it lies: a 16-byte-aligned base, unit stride along D, and
    byte strides along B, T and H that are positive multiples of 16 (the
    stride of a dimension of size 1 is never stepped, so it does not
    count)."""
    if x.data_ptr() % 16 or x.stride(-1) != 1:
        return False
    esize = x.element_size()
    return all(n == 1 or (st > 0 and st * esize % 16 == 0)
               for n, st in zip(x.shape[:3], x.stride()[:3]))


def check_kernel_args(q, k, v, do=None):
    """Raise unless the CUDA kernels take these tensors: q, k, v (and the
    output gradient ``do`` for the backward) of one [B, T, H, D] shape,
    dtype and CUDA device, D in KERNEL_HEAD_DIMS, f32 or bf16, and unit
    stride along D (other strides are read as given).

    Returns the operands as the kernels read them. The bf16 forward, dq and
    dk/dv kernels load their tiles by TMA: a bf16 operand that
    fails :func:`tma_compatible` (an odd stride, a base off 16 bytes) is
    copied into a fresh contiguous tensor first (``check_kernel_args.clones``
    counts those copies). That is a layout repair, not a fallback: the
    kernel still runs."""
    ops = (("q", q), ("k", k), ("v", v)) + ((("do", do),) if do is not None else ())
    shapes = [tuple(x.shape) for _, x in ops]
    if q.dim() != 4 or any(s != shapes[0] for s in shapes):
        raise MXNetError(
            "flash_attention wants %s of one [B, T, H, D] shape, got %s"
            % ("/".join(n for n, _ in ops), " ".join(map(str, shapes))))
    dtypes = [x.dtype for _, x in ops]
    if any(dt != q.dtype for dt in dtypes) or q.dtype not in KERNEL_DTYPES:
        raise MXNetError(
            "flash_attention kernels take float32 or bfloat16 %s of one "
            "dtype, got %s" % ("/".join(n for n, _ in ops), " ".join(map(str, dtypes))))
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise MXNetError(
            "flash_attention kernels take head dim in %s, got %d"
            % (KERNEL_HEAD_DIMS, q.shape[-1]))
    for name, x in ops:
        if x.stride(-1) != 1:
            raise MXNetError(
                "flash_attention kernels want unit stride along D; %s has "
                "strides %s" % (name, x.stride()))
    devices = [x.device for _, x in ops]
    if q.device.type != "cuda" or any(dv != q.device for dv in devices):
        raise MXNetError(
            "flash_attention kernels want %s on one CUDA device, got %s"
            % ("/".join(n for n, _ in ops), " ".join(map(str, devices))))
    if q.dtype != torch.bfloat16:
        return tuple(x for _, x in ops)
    out = []
    for _, x in ops:
        if not tma_compatible(x):
            x = x.clone(memory_format=torch.contiguous_format)
            check_kernel_args.clones += 1
        out.append(x)
    return tuple(out)


check_kernel_args.clones = 0


def _check_row_stats(q, lse, delta):
    b, t, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != (b, h, t) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise MXNetError(
                "flash_attention backward wants %s as a contiguous float32 "
                "[B, H, T] = %s tensor on %s, got %s %s %s"
                % (name, (b, h, t), q.device, tuple(x.shape), x.dtype, x.device))


def _strides(*xs):
    """Element strides along B, T, H of each tensor; a dimension of size 1
    gets its contiguous stride (never stepped, and always TMA-aligned)."""
    out = []
    for x in xs:
        b, t, h, d = x.shape
        for n, st, packed in zip((b, t, h), x.stride()[:3], (t * h * d, h * d, d)):
            out.append(st if n > 1 else packed)
    return out


def _run(name, q, pointers, strides, scale, causal, planes):
    """Launch kernel ``name`` on q's device and current stream; ``planes``
    is the entry point's last integer, the operands' plane count (1 bf16,
    2 split f32); raise if the launch is refused."""
    fn = _build.load(name)
    b, t, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(x.data_ptr() for x in pointers), b, t, h, d, *strides,
                scale, int(bool(causal)), planes, stream)
    if rc != 0:
        raise MXNetError("%s kernel launch failed: CUDA error %d" % (name, rc))


def split_planes(*xs):
    """The :func:`split_bf16` planes of one to four f32 [B, T, H, D]
    operands of one shape, as one contiguous bf16 tensor
    (len(xs), 2, B, T, H, D): plane 0 hi = bf16(x), plane 1 lo =
    bf16(x - hi). On CUDA tensors the split pass of
    ``csrc/flash_attn_fwd.cu`` (``flash_split_kernel``, one launch for
    all the operands; any strides along B, T and H, unit stride along D),
    bit for bit the plain version; ``split_planes.launches`` counts its
    launches. On CPU tensors the plain version, :func:`split_bf16` of each.
    The f32 forward, dq and dk/dv kernels read these planes."""
    if not 1 <= len(xs) <= 4:
        raise MXNetError("split_planes takes one to four operands, got %d" % len(xs))
    if xs[0].device.type == "cpu":
        return torch.stack([split_bf16(x) for x in xs])
    shape = tuple(xs[0].shape)
    for x in xs:
        if (x.dtype != torch.float32 or tuple(x.shape) != shape or x.dim() != 4
                or x.device != xs[0].device or x.device.type != "cuda" or x.stride(-1) != 1
                or shape[-1] % 8):
            raise MXNetError(
                "split_planes wants f32 [B, T, H, D] CUDA tensors of one shape and device, "
                "unit stride along D, D a multiple of 8; got %s %s %s strides %s"
                % (x.dtype, tuple(x.shape), x.device, x.stride()))
    b, t, h, d = shape
    out = torch.empty((len(xs), 2) + shape, dtype=torch.bfloat16, device=xs[0].device)
    ptrs = [x.data_ptr() for x in xs] + [None] * (4 - len(xs))
    strides = _strides(*xs) + [0] * 3 * (4 - len(xs))
    fn = _build.load("flash_split")
    with torch.cuda.device(out.device):
        rc = fn(len(xs), *ptrs, *strides, out.data_ptr(), b, t, h, d,
                torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise MXNetError("flash_split kernel launch failed: CUDA error %d" % rc)
    split_planes.launches += 1
    return out


split_planes.launches = 0


def _kernel_operands(*xs, planes=None):
    """(operands, plane count) as the kernels read them: bf16 tensors as
    they are, one plane; f32 tensors as the views of their hi planes, whose
    lo planes follow them in memory, two planes. The f32 planes are
    ``planes``, one contiguous (2, B, T, H, D) bf16 tensor an operand: the
    (len(xs), 2, B, T, H, D) result of one :func:`split_planes` pass over
    ``xs`` already made (a backward makes one for both of its kernels), a
    sequence of views of passes made over other operand sets (the ring's
    blocks pair one block's q with another's k and v), or else those of a
    pass run here."""
    if xs[0].dtype == torch.bfloat16:
        return xs, 1
    ps = tuple(split_planes(*xs) if planes is None else planes)
    shape = (2,) + tuple(xs[0].shape)
    if len(ps) != len(xs) or any(
            p.dtype != torch.bfloat16 or tuple(p.shape) != shape
            or p.device != xs[0].device or not p.is_contiguous() for p in ps):
        raise MXNetError(
            "flash_attention kernels want %d contiguous bfloat16 %s planes on %s, got %s"
            % (len(xs), shape, xs[0].device, [(p.dtype, tuple(p.shape), p.device) for p in ps]))
    return tuple(p[0] for p in ps), 2


def _launch(q, k, v, causal, scale, planes=None):
    q, k, v = check_kernel_args(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ops, n_planes = _kernel_operands(q, k, v, planes=planes)
    _run("flash_attn_fwd", q, (*ops, out, lse), _strides(*ops), scale, causal, n_planes)
    flash_attention.launches += 1
    return out, lse


def _forward(q, k, v, causal, scale, need_lse, planes=None):
    if q.device.type == "cpu":
        out = reference_attention(q, k, v, causal=causal, scale=scale)
        lse = reference_lse(q, k, causal=causal, scale=scale) if need_lse else None
        return out, lse
    return _launch(q, k, v, causal, scale, planes)


def flash_attention_dq(q, k, v, do, lse, delta, causal=False, scale=None, planes=None):
    """dq of flash attention: the kernel of ``csrc/flash_attn_bwd.cu``
    (``flash_dq_sm90``; f32 q, k, v, dO as their hi and lo planes, from
    ``planes``, one :func:`split_planes` pass over (q, k, v, do) already
    made, or else from a pass run here) on CUDA tensors (no fallback; a
    bf16 operand TMA cannot read where it lies is copied first, see
    :func:`check_kernel_args`; ``flash_attention_dq.launches`` counts its
    launches), the plain version on CPU tensors. Arguments as
    :func:`reference_attention_bwd`."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_bwd(q, k, v, do, lse, delta, causal, scale)[0]
    q, k, v, do = check_kernel_args(q, k, v, do)
    _check_row_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ops, n_planes = _kernel_operands(q, k, v, do, planes=planes)
    _run("flash_attn_bwd_dq", q, (*ops, lse, delta, dq), _strides(*ops), scale, causal,
         n_planes)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False, scale=None, planes=None):
    """(dk, dv) of flash attention: the kernel of ``csrc/flash_attn_bwd.cu``
    (``flash_dkv_sm90``; f32 operands as for :func:`flash_attention_dq`,
    ``planes`` too) on CUDA tensors (no fallback; a bf16 operand TMA cannot
    read where it lies is copied first, see :func:`check_kernel_args`;
    ``flash_attention_dkv.launches`` counts its launches), the plain
    version on CPU tensors. Arguments as :func:`reference_attention_bwd`."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_bwd(q, k, v, do, lse, delta, causal, scale)[1:]
    q, k, v, do = check_kernel_args(q, k, v, do)
    _check_row_stats(q, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ops, n_planes = _kernel_operands(q, k, v, do, planes=planes)
    _run("flash_attn_bwd_dkv", q, (*ops, lse, delta, dk, dv), _strides(*ops), scale, causal,
         n_planes)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the ``jax.custom_vjp`` ``_flash``: the forward saves
    q, k, v, out and the f32 lse; the backward computes
    ``delta = Σ_D g·out`` in f32 from the incoming gradient, casts that
    gradient to q's dtype (``_flash_bwd``), then runs the dq and dk/dv
    wrappers (the kernels on CUDA, their plain version on the CPU); in f32
    on CUDA both kernels read the planes of one split pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        do = g.to(q.dtype)
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            do = do.contiguous()
        planes = None
        if q.device.type == "cuda" and q.dtype == torch.float32:
            # one split pass of q, k, v and dO for both kernels
            planes = split_planes(*check_kernel_args(q, k, v, do))
        dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale, planes)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale, planes)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False, planes=None):
    """Blockwise (flash) attention. q/k/v: [B, T, H, D] -> [B, T, H, D].

    On CUDA tensors: the kernel of ``csrc/flash_attn_fwd.cu``, with no
    fallback (a bf16 operand TMA cannot read where it lies is copied first,
    see :func:`check_kernel_args`; f32 q, k, v are first split into their
    hi and lo planes by one :func:`split_planes` pass, any strides);
    ``flash_attention.launches`` counts its
    launches. On CPU tensors: the plain version. When q, k or v requires a
    gradient, the call is recorded for autograd, whose backward runs
    :func:`flash_attention_dq` and :func:`flash_attention_dkv`.
    ``return_lse=True`` also returns the f32 logsumexp [B, H, T] a backward
    pass needs. ``planes``: f32 q, k, v's split planes already made, as for
    :func:`flash_attention_dq` (a call autograd records takes none)."""
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if planes is not None:
            raise MXNetError("flash_attention takes planes only in a call autograd "
                             "does not record")
        out, lse = _FlashAttention.apply(q, k, v, bool(causal), scale)
    else:
        out, lse = _forward(q, k, v, causal, scale, need_lse=return_lse, planes=planes)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def attention(q, k, v, causal=False, scale=None, mesh=None):
    """Shared attention dispatch. q/k/v: [B, T, H, D] -> [B, T, H, D].

    A mesh (or a mapping of axis sizes) whose 'sp' axis is > 1 routes to
    ``parallel.ring_attention.sequence_parallel_attention``: the sequence
    in sp blocks, each (q-block, kv-block) pair through the flash kernels.
    Every other call goes through :func:`flash_attention`, whatever T: on
    CUDA tensors that is the kernel, so the plain version serves nothing on
    the card's main path (the JAX package's T >= 128 threshold for the
    Pallas kernel was a TPU tuning choice)."""
    from ..parallel.mesh import axis_size

    if mesh is not None and axis_size(mesh, "sp") > 1:
        from ..parallel.ring_attention import sequence_parallel_attention

        return sequence_parallel_attention(q, k, v, mesh, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# Conv-backward pair (counterpart of the conv part of pallas_kernels.py):
# K2 ``conv_bwd_filter`` and K3 ``conv_bwd_input``, hand-written CUDA in
# ``csrc/conv_bwd.cu``, for 2-D convolutions with stride 1, dilation 1 and
# one group. Public layout NCHW / OIHW; outputs f32.
# ---------------------------------------------------------------------------
CONV_DTYPES = (torch.float32, torch.bfloat16)
# The JAX package's per-block VMEM bound (pallas_kernels.py:680-690), kept
# so both packages accept the same shapes; the CUDA kernels themselves have
# no such limit (their tiles are fixed), and every in-envelope ResNet-50
# body convolution is far below it.
CONV_VMEM_BUDGET = 12 * 1024 * 1024
_SM90_STEP = 64  # K2's k step, in positions (kRows), and a warpgroup's o tile
_SM90_PATCH = 8  # the side of its patch of positions (kPatch)
_SM90_STAGES = 4  # the most stages of its ring of TMA stages (kConvStages)
_SM90_CTA_SMEM = 232448  # shared memory a CTA can use on an H100 (kCtaSmem)
_SM90_SMEM = 228 * 1024  # shared memory of an H100 SM, of which 1 KB a CTA is reserved


@functools.lru_cache(maxsize=1024)
def _conv_bwd_plan(dshape, wshape, stride, pad, dilate, dtype):
    n, c, h, w = dshape
    o, cg, kh, kw = wshape
    if dtype not in ("float32", "bfloat16"):
        return False
    if tuple(stride) != (1, 1) or tuple(dilate) != (1, 1) or cg != c:
        return False
    # dgrad-as-flipped-conv needs the kernel to cover its padding
    if kh - 1 - pad[0] < 0 or kw - 1 - pad[1] < 0:
        return False
    oh = h + 2 * pad[0] - kh + 1
    ow = w + 2 * pad[1] - kw + 1
    if oh < 1 or ow < 1:
        return False
    if c % 8 or o % 8:
        return False
    esz = 2 if dtype == "bfloat16" else 4
    x_blk = (h + 2 * pad[0]) * (w + 2 * pad[1]) * c * esz
    g_blk = max(oh * ow * o, (h + kh - 1) * (w + kw - 1) * o) * esz
    acc = max(kh * kw * o * c * 4, h * w * c * 4)
    return x_blk + g_blk + acc <= CONV_VMEM_BUDGET


def conv_bwd_plan(dshape, wshape, stride, pad, dilate, dtype):
    """Whether K2 and K3 take the gradient of this 2-D convolution: the
    shape rules of ``_conv_bwd_plan_uncached`` (``pallas_kernels.py:662``):
    f32 or bf16, stride 1, dilation 1, one group, a kernel that covers its
    padding (k > p), a non-empty output, C and O multiples of 8, and the
    JAX package's VMEM term (see ``CONV_VMEM_BUDGET``)."""
    as_ints = lambda v: tuple(int(x) for x in v)  # noqa: E731
    return _conv_bwd_plan(as_ints(dshape), as_ints(wshape), as_ints(stride), as_ints(pad),
                          as_ints(dilate), dtype_name(dtype))


def conv_bwd_filter_reference(data, grad, wshape, pad):
    """Plain version of K2: the filter gradient (O, C, kh, kw) in f32 of a
    stride-1 conv, one product per tap over the zero-padded data, as
    ``_conv_wgrad_kernel`` computes it: loads upcast to f32, f32 sums."""
    o, c, kh, kw = wshape
    oh, ow = grad.shape[2], grad.shape[3]
    x = F.pad(data.float(), (pad[1], pad[1], pad[0], pad[0]))
    g = grad.float()
    taps = [torch.einsum("nohw,nchw->oc", g, x[:, :, i:i + oh, j:j + ow])
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=-1).reshape(o, c, kh, kw)


def conv_bwd_input_reference(grad, weight, dshape, pad):
    """Plain version of K3: the data gradient (N, C, H, W) in f32 of a
    stride-1 conv, as ``_conv_dgrad_kernel`` computes it: the correlation
    of the (k-1-p)-padded grad with the 180°-rotated filter, tap by tap,
    loads upcast to f32, f32 sums."""
    _, _, h, w = dshape
    _, _, kh, kw = weight.shape
    ph, pw = kh - 1 - pad[0], kw - 1 - pad[1]
    g = F.pad(grad.float(), (pw, pw, ph, ph))
    w_rot = weight.float().flip(2, 3)
    acc = None
    for i in range(kh):
        for j in range(kw):
            term = torch.einsum("nohw,oc->nchw", g[:, :, i:i + h, j:j + w], w_rot[:, :, i, j])
            acc = term if acc is None else acc + term
    return acc


def split_bf16(x):
    """The two bf16 planes the f32 kernels multiply in place of f32 ``x``,
    stacked as (2, *x.shape): hi = bf16(x) and lo = bf16(x - hi), both
    rounded to nearest even (``__float2bfloat16_rn`` in
    ``csrc/conv_bwd.cu``; x - hi is exact in f32). hi + lo is x to within
    2^-16 of |x| wherever |x| >= 2^-118 (lo a normal bf16), and to within
    2^-134 below; a product a·b is taken as a_hi·b_lo + a_lo·b_hi +
    a_hi·b_hi, three bf16 products summed in f32."""
    hi = x.to(torch.bfloat16)
    return torch.stack((hi, (x - hi.float()).to(torch.bfloat16)))


def _planes(x):
    """x as the kernels read it: bf16 as it is, f32 as its split_bf16
    planes."""
    return x if x.dtype == torch.bfloat16 else split_bf16(x)


def _check_conv_args(name, a, b, dshape, wshape, pad):
    if a.dtype != b.dtype or a.dtype not in CONV_DTYPES:
        raise MXNetError("%s takes float32 or bfloat16 tensors of one dtype, got %s and %s"
                         % (name, a.dtype, b.dtype))
    if a.device.type != "cuda" or b.device != a.device:
        raise MXNetError("%s wants its tensors on one CUDA device, got %s and %s"
                         % (name, a.device, b.device))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise MXNetError("%s wants contiguous NCHW / OIHW tensors" % name)
    if not conv_bwd_plan(dshape, wshape, (1, 1), pad, (1, 1), a.dtype):
        raise MXNetError("%s: data %s, weight %s, pad %s is outside the kernels' "
                         "envelope (conv_bwd_plan)" % (name, dshape, wshape, tuple(pad)))


def _conv_geometry(dshape, wshape, pad):
    n, c, h, w = (int(v) for v in dshape)
    o, _, kh, kw = (int(v) for v in wshape)
    ph, pw = int(pad[0]), int(pad[1])
    return n, c, h, w, o, kh, kw, ph, pw, h + 2 * ph - kh + 1, w + 2 * pw - kw + 1


def wgrad_mode_sm90(oh, ow, kh, kw, ph, pw, aligned=True):
    """How K2 (``conv_wgrad_sm90``) reads its operands: ``"nchw"`` (a
    1 x 1 kernel with no padding whose NCHW rows, OH·OW·2 bytes, TMA can
    step, on bf16 x and grad that start on a 16-byte boundary, ``aligned``,
    as TMA wants a tensor's base: both read in place), ``"flat"`` (another
    1 x 1 with no padding: the channels-last copies as N·OH·OW rows) or
    ``"patch"`` (the channels-last copies in 8 x 8 patches of each
    image)."""
    if kh == kw == 1 and ph == pw == 0:
        return "nchw" if oh * ow % 8 == 0 and aligned else "flat"
    return "patch"


def wgrad_steps_sm90(mode, n, oh, ow):
    """The k steps of K2, 64 positions each, in ``mode``
    (:func:`wgrad_mode_sm90`): runs of 64 over each image's OH·OW (nchw)
    or over all N·OH·OW positions (flat), or the 8 x 8 patches of every
    image's OH x OW (patch)."""
    if mode == "nchw":
        return n * -(-oh * ow // _SM90_STEP)
    if mode == "flat":
        return -(-n * oh * ow // _SM90_STEP)
    return n * -(-oh // _SM90_PATCH) * -(-ow // _SM90_PATCH)


def sm90_stages(stage_bytes):
    """The depth of a conv kernel's ring whose stage holds ``stage_bytes``:
    ``_SM90_STAGES``, or as many as fit a CTA's shared memory with 1 KB of
    alignment and the barriers (``ConvRing::kStages``)."""
    return min(_SM90_STAGES, (_SM90_CTA_SMEM - 1024 - 16 * _SM90_STAGES) // stage_bytes)


def wgrad_ctas_per_sm90(o_tile, c_tile, stages=None, planes=1):
    """How many K2 CTAs of ``o_tile`` o (64 a warpgroup) and ``c_tile``
    channels fit an SM by shared memory: a ring of ``stages`` stages (by
    default :func:`sm90_stages`) of ``planes`` (1 for bf16, 2 for the hi
    and lo planes of f32) times (o_tile + c_tile) / 64 boxes of 8 KB, 1 KB
    for the 1024-byte alignment, 16 B of barriers a stage, and the 1 KB the
    card reserves a CTA."""
    stage = planes * (o_tile + c_tile) // _SM90_STEP * 8192
    if stages is None:
        stages = sm90_stages(stage)
    smem = 1024 + stages * stage + 16 * stages
    return _SM90_SMEM // (smem + 1024)


def wgrad_splits_sm90(o, c, taps, steps, sm_count, o_tile=None, stages=None, planes=1):
    """K2's split of its k steps: ``(splits, steps per split)``. A CTA
    takes 128 o (two warpgroups) where O > 64, else 64 (``o_tile`` sets
    it), and 64 channels where C <= 64, else 128; as many splits as keep
    the (o tile, c tile, tap, split) CTAs within one wave of the card, of
    :func:`wgrad_ctas_per_sm90` CTAs an SM (``stages``, ``planes``), each
    split at least 8 steps; one split where the tiles alone fill a wave or
    more. A function of the shape and the SM count only, so a repeat sums
    in the same order."""
    if o_tile is None:
        o_tile = 2 * _SM90_STEP if o > _SM90_STEP else _SM90_STEP
    c_tile = 2 * _SM90_STEP if c > _SM90_STEP else _SM90_STEP
    tiles = -(-o // o_tile) * -(-c // c_tile) * taps
    slots = sm_count * wgrad_ctas_per_sm90(o_tile, c_tile, stages, planes)
    splits = max(1, min(slots // tiles, steps // 8))
    per = -(-steps // splits)
    return -(-steps // per), per


def wgrad_plan_sm90(data, grad, wshape, pad, sm_count):
    """K2's plan for these tensors: ``(mode, splits, steps per split)`` by
    :func:`wgrad_mode_sm90`, :func:`wgrad_steps_sm90` and
    :func:`wgrad_splits_sm90`; "nchw" only where bf16 data and grad start
    on a 16-byte boundary (f32 is split into its planes first, so never),
    and the f32 ring's stage holds two planes."""
    n, c, _, _, o, kh, kw, ph, pw, oh, ow = _conv_geometry(data.shape, wshape, pad)
    bf16 = data.dtype == torch.bfloat16
    aligned = bf16 and data.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0
    mode = wgrad_mode_sm90(oh, ow, kh, kw, ph, pw, aligned)
    return (mode, *wgrad_splits_sm90(o, c, kh * kw, wgrad_steps_sm90(mode, n, oh, ow),
                                     sm_count, planes=1 if bf16 else 2))


def conv_wgrad_layout(data, grad):
    """The operands of the K2 kernel in the layouts TMA reads: data
    (N, C, H, W) and grad (N, O, OH, OW) as contiguous channels-last
    (N, H, W, C) and (N, OH, OW, O) tensors (rows of C·2 and O·2 bytes,
    multiples of 16 inside ``conv_bwd_plan``), bf16 as they are and f32 as
    their :func:`split_bf16` planes, (2, N, H, W, C) and (2, N, OH, OW, O).
    The plain version of the layout pass the kernel's entry point runs
    first (``transpose_bf16``, ``transpose_bf16_split``)."""
    return (_planes(data.permute(0, 2, 3, 1).contiguous()),
            _planes(grad.permute(0, 2, 3, 1).contiguous()))


def _grad_cl_shape(grad):
    """The shape of grad's channels-last copy as the kernels read it: bf16
    (N, OH, OW, O), f32 its two planes (2, N, OH, OW, O)."""
    n, o, oh, ow = grad.shape
    return (n, oh, ow, o) if grad.dtype == torch.bfloat16 else (2, n, oh, ow, o)


def conv_grad_channels_last(grad):
    """grad (N, O, OH, OW) as the contiguous channels-last bf16 copy both
    kernels read, (N, OH, OW, O) for bf16 and its :func:`split_bf16`
    planes (2, N, OH, OW, O) for f32: made once by a backward that wants
    both gradients and handed to K2 and K3 as ``g_cl``. On a CUDA tensor
    the layout pass of ``csrc/conv_bwd.cu`` (``transpose_bf16``,
    ``transpose_bf16_split``), on a CPU tensor its plain version."""
    if grad.device.type == "cpu":
        return _planes(grad.permute(0, 2, 3, 1).contiguous())
    if grad.dtype not in CONV_DTYPES or grad.dim() != 4 or not grad.is_contiguous():
        raise MXNetError("conv_grad_channels_last wants a contiguous 4-D f32 or bf16 tensor, "
                         "got %s %s" % (grad.dtype, tuple(grad.shape)))
    n, o, oh, ow = grad.shape
    out = torch.empty(_grad_cl_shape(grad), dtype=torch.bfloat16, device=grad.device)
    fn = _build.load("conv_channels_last")
    with torch.cuda.device(grad.device):
        rc = fn(grad.data_ptr(), out.data_ptr(), n, o, oh * ow,
                int(grad.dtype == torch.bfloat16),
                torch.cuda.current_stream(grad.device).cuda_stream)
    if rc != 0:
        raise MXNetError("conv_channels_last kernel launch failed: CUDA error %d" % rc)
    return out


def _grad_cl(name, grad, g_cl):
    """(g_cl tensor, g_ready) for a kernel: the caller's channels-last copy
    of grad (:func:`conv_grad_channels_last`), checked, or room for the
    entry point to make its own."""
    shape = _grad_cl_shape(grad)
    if g_cl is None:
        return torch.empty(shape, dtype=torch.bfloat16, device=grad.device), 0
    if (g_cl.dtype != torch.bfloat16 or g_cl.device != grad.device or not g_cl.is_contiguous()
            or tuple(g_cl.shape) != shape):
        raise MXNetError("%s: g_cl must be %s grad's contiguous channels-last bf16 copy %s, got "
                         "%s %s" % (name, grad.dtype, shape, g_cl.dtype, tuple(g_cl.shape)))
    if g_cl.data_ptr() % 16:
        raise MXNetError("%s: g_cl must start on a 16-byte boundary (TMA reads it)" % name)
    return g_cl, 1


def _workspace(shape, dtype, device):
    """A bf16 layout workspace (one plane for bf16, two for f32) that TMA
    reads: fresh from the allocator, so on a 16-byte boundary, as every
    plane is (each holds a multiple of 8 values inside the envelope)."""
    planes = () if dtype == torch.bfloat16 else (2,)
    return torch.empty(planes + tuple(shape), dtype=torch.bfloat16, device=device)


def conv_bwd_filter(data, grad, wshape, pad, *, g_cl=None):
    """K2, the filter gradient of a stride-1 2-D conv: data (N, C, H, W) and
    grad (N, O, OH, OW) -> f32 (O, C, kh, kw). On CUDA tensors the kernels of
    ``csrc/conv_bwd.cu``: ``conv_wgrad_sm90`` (TMA and ``wgmma``) on bf16
    data and grad in place (:func:`wgrad_plan_sm90` "nchw") or on the
    channels-last copies :func:`conv_wgrad_layout` describes (for f32, the
    hi and lo planes, three bf16 products for each f32 one), which its
    entry point makes in workspaces allocated here, unless ``g_cl``
    (:func:`conv_grad_channels_last` of grad) is given; then
    ``conv_wgrad_reduce_kernel``. No fallback;
    ``conv_bwd_filter.launches`` counts the calls that launch them. On CPU
    tensors the plain version."""
    if data.device.type == "cpu":
        return conv_bwd_filter_reference(data, grad, wshape, pad)
    _check_conv_args("conv_bwd_filter", data, grad, tuple(data.shape), tuple(wshape), pad)
    geo = _conv_geometry(data.shape, wshape, pad)
    n, c, h, w, o, kh, kw, _, _, oh, ow = geo
    if tuple(grad.shape) != (n, o, oh, ow):
        raise MXNetError("conv_bwd_filter: grad %s does not match data %s and weight %s"
                         % (tuple(grad.shape), tuple(data.shape), tuple(wshape)))
    dev = data.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = data.dtype == torch.bfloat16
    mode, splits, per = wgrad_plan_sm90(data, grad, wshape, pad, sms)
    if mode != "nchw":
        x_cl = _workspace((n, h, w, c), data.dtype, dev)
        g_cl, g_ready = _grad_cl("conv_bwd_filter", grad, g_cl)
    else:
        x_cl = g_cl = torch.empty(0, dtype=data.dtype, device=dev)
        g_ready = 0
    ws = torch.empty((splits, kh * kw, o, c), dtype=torch.float32, device=dev)
    gw = torch.empty(tuple(wshape), dtype=torch.float32, device=dev)
    fn = _build.load("conv_bwd_filter")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(data.data_ptr(), grad.data_ptr(), x_cl.data_ptr(), g_cl.data_ptr(), ws.data_ptr(),
                gw.data_ptr(), *geo, splits, per, int(bf16), g_ready, int(mode == "nchw"),
                stream)
    if rc != 0:
        raise MXNetError("conv_bwd_filter kernel launch failed: CUDA error %d" % rc)
    conv_bwd_filter.launches += 1
    return gw


def conv_dgrad_layout(grad, weight):
    """The operands of the K3 kernel in the layouts TMA reads: grad
    (N, O, OH, OW) as a contiguous channels-last (N, OH, OW, O) tensor and
    weight (O, C, kh, kw) as a contiguous (C, kh, kw, O) tensor, bf16 as
    they are and f32 as their :func:`split_bf16` planes (a leading 2).
    TMA wants byte strides that are multiples of 16, which a row of NCHW
    (OW·2 bytes) is not at OW = 7, 14 or 28; O·2 is, since
    ``conv_bwd_plan`` takes O % 8 == 0. The plain version of the layout
    pass the kernel's entry point runs first (``transpose_bf16``,
    ``transpose_bf16_split`` in ``csrc/conv_bwd.cu``), into workspaces
    :func:`conv_bwd_input` allocates: a layout repair, as
    :func:`check_kernel_args`'s copy is."""
    return (_planes(grad.permute(0, 2, 3, 1).contiguous()),
            _planes(weight.permute(1, 2, 3, 0).contiguous()))


def conv_bwd_input(grad, weight, dshape, pad, *, g_cl=None):
    """K3, the data gradient of a stride-1 2-D conv: grad (N, O, OH, OW) and
    weight (O, C, kh, kw) -> f32 (N, C, H, W). On CUDA tensors the kernel of
    ``csrc/conv_bwd.cu``, ``conv_dgrad_sm90`` (TMA and ``wgmma``), on the
    transposed copies :func:`conv_dgrad_layout` describes (for f32, the hi
    and lo planes, three bf16 products for each f32 one), in workspaces
    allocated here, grad's unless ``g_cl`` (:func:`conv_grad_channels_last`
    of grad) is given; no fallback; ``conv_bwd_input.launches`` counts the
    calls that launch it. On CPU tensors the plain version."""
    if grad.device.type == "cpu":
        return conv_bwd_input_reference(grad, weight, dshape, pad)
    _check_conv_args("conv_bwd_input", grad, weight, tuple(dshape), tuple(weight.shape), pad)
    geo = _conv_geometry(dshape, weight.shape, pad)
    n, c, h, w, o, kh, kw, _, _, oh, ow = geo
    if tuple(grad.shape) != (n, o, oh, ow):
        raise MXNetError("conv_bwd_input: grad %s does not match data %s and weight %s"
                         % (tuple(grad.shape), tuple(dshape), tuple(weight.shape)))
    g_cl, g_ready = _grad_cl("conv_bwd_input", grad, g_cl)
    w_t = _workspace((c, kh, kw, o), grad.dtype, grad.device)
    dx = torch.empty((n, c, h, w), dtype=torch.float32, device=grad.device)
    fn = _build.load("conv_bwd_input")
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        rc = fn(grad.data_ptr(), weight.data_ptr(), g_cl.data_ptr(), w_t.data_ptr(),
                dx.data_ptr(), *geo, int(grad.dtype == torch.bfloat16), g_ready, stream)
    if rc != 0:
        raise MXNetError("conv_bwd_input kernel launch failed: CUDA error %d" % rc)
    conv_bwd_input.launches += 1
    return dx


conv_bwd_filter.launches = 0
conv_bwd_input.launches = 0


class _Conv2dKernelBwd(torch.autograd.Function):
    """Counterpart of the ``jax.custom_vjp`` of ``_conv2d_pallas_bwd``
    (``ops/nn.py:451-465``): the forward is ``F.conv2d``; the backward runs
    K3 for the data gradient and K2 for the filter gradient (their plain
    versions for CPU tensors) and casts each f32 result to its input's
    dtype. Both are looked up in this module at call time. When both run
    on CUDA tensors, grad's channels-last copy (for f32, its hi and lo
    planes) is made once and handed to both (``g_cl``)."""

    @staticmethod
    def forward(ctx, data, weight, pad):
        ctx.save_for_backward(data, weight)
        ctx.pad = pad
        return F.conv2d(data, weight, padding=pad)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        data, weight = ctx.saved_tensors
        g = g.to(data.dtype).contiguous()
        shared = {}
        if g.is_cuda and all(ctx.needs_input_grad[:2]):
            shared["g_cl"] = conv_grad_channels_last(g)
        gd = gw = None
        if ctx.needs_input_grad[0]:
            gd = conv_bwd_input(g, weight.contiguous(), tuple(data.shape), ctx.pad, **shared)
            gd = gd.to(data.dtype)
        if ctx.needs_input_grad[1]:
            gw = conv_bwd_filter(data.contiguous(), g, tuple(weight.shape), ctx.pad, **shared)
            gw = gw.to(weight.dtype)
        return gd, gw, None


def conv2d_kernel_bwd(data, weight, pad):
    """Stride-1, dilation-1, one-group 2-D conv (NCHW / OIHW, symmetric
    ``pad``) whose gradient runs K2 and K3 when autograd records it. Meant
    for shapes inside :func:`conv_bwd_plan`."""
    pad = (int(pad[0]), int(pad[1]))
    if torch.is_grad_enabled() and (data.requires_grad or weight.requires_grad):
        return _Conv2dKernelBwd.apply(data, weight, pad)
    return F.conv2d(data, weight, padding=pad)


# ---------------------------------------------------------------------------
# K1 ``fused_slab_update`` (counterpart of ``pallas_kernels.py:451-597``):
# one AMP optimizer step over flat 1-D slabs, hand-written CUDA in
# ``csrc/slab_update.cu``: one launch for a table of up to
# ``SLAB_TABLE_CAP`` slabs (``fused_slab_update_multi``; a standalone slab
# is a table of one). ``slab_update_reference`` is its plain version, and
# ``slab_update_multi_reference`` that of a table.
# ---------------------------------------------------------------------------
SLAB_STATE_SLOTS = {"sgd": 0, "sgd_mom": 1, "adam": 2}
SLAB_TABLE_CAP = 32  # slabs a launch (kMaxEntries): the table rides in the parameter block
_SLAB_KIND_CODE = {"sgd": 0, "sgd_mom": 1, "adam": 2}
_SLAB_TILE = 2048  # elements a CTA tile (kTile): 256 threads, two 4-element vectors each
_SLAB_CTAS_PER_SM = 4
# the rows of csrc/slab_update.cu: SlabEntry (8 slab pointers, the lr pointer,
# n, tile0, head, lr value, wd, has_wd, pad) and SlabShared (the inv_scale and
# finite pointers, their values, the eight hyperparameters, has_rescale,
# has_clip, n_entries, n_tiles)
_SLAB_ENTRY = struct.Struct("<9Qq2i2f2i")
_SLAB_SHARED = struct.Struct("<2Q10f4i")
_SM_COUNT = {}

SlabEntry = collections.namedtuple("SlabEntry", "w g states lr wd out", defaults=(None,))
SlabEntry.__doc__ = """One slab of :func:`fused_slab_update_multi`: master ``w``
(S,) f32, gradient ``g`` (S,) bf16 or f32, ``states`` as the kind takes them,
the step's ``lr`` (a number or a one-element f32 tensor) and ``wd`` (a
number); ``out = (w_out, states_out, w16_out)`` receives the results (they may
be ``w`` and ``states`` themselves), else they are allocated."""


def _as_f32(x, device):
    """A Python number or a one-element tensor as a 0-d f32 tensor on
    ``device`` (the plain version's scalars)."""
    if torch.is_tensor(x):
        return x.reshape(()).to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def slab_update_reference(kind, w, g, states, lr, inv_scale, finite, *, wd, rescale_grad,
                          clip_gradient, momentum=0.0, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Plain version of K1, ``_slab_update_math`` op for op: the gradient
    unscaled by ``inv_scale`` (then rescaled, clipped, weight-decayed when
    those are set), the sgd / sgd_mom / adam update in f32, a finite select
    (``finite > 0.5`` keeps the new values, else the old bits) and the bf16
    copy of the new weight. ``lr`` / ``inv_scale`` / ``finite`` are numbers
    or one-element tensors. Returns ``(new_w, new_states, w16)``."""
    dev = w.device
    lr, inv_scale, finite = (_as_f32(x, dev) for x in (lr, inv_scale, finite))
    w = w.float()
    g = g.float() * inv_scale
    if rescale_grad != 1.0:
        g = g * float(rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -float(clip_gradient), float(clip_gradient))
    if wd != 0.0:
        g = g + float(wd) * w
    if kind == "sgd":
        new_w = w - lr * g
        new_states = ()
    elif kind == "sgd_mom":
        new_mom = float(momentum) * states[0].float() - lr * g
        new_w = w + new_mom
        new_states = (new_mom,)
    elif kind == "adam":
        mean, var = states[0].float(), states[1].float()
        new_mean = float(beta1) * mean + (1.0 - beta1) * g
        new_var = float(beta2) * var + (1.0 - beta2) * torch.square(g)
        new_w = w - lr * new_mean / (torch.sqrt(new_var) + float(epsilon))
        new_states = (new_mean, new_var)
    else:
        raise ValueError("unknown slab kind %r" % (kind,))
    keep = finite > 0.5
    new_w = torch.where(keep, new_w, w)
    new_states = tuple(torch.where(keep, ns, os_.float()) for ns, os_ in zip(new_states, states))
    return new_w, new_states, new_w.to(torch.bfloat16)


def _write_out(out, result):
    out[0].copy_(result[0])
    for o, s in zip(out[1], result[1]):
        o.copy_(s)
    out[2].copy_(result[2])
    return out[0], tuple(out[1]), out[2]


def slab_update_multi_reference(kind, entries, inv_scale, finite, **statics):
    """Plain version of a table of slabs: :func:`slab_update_reference` on
    each :class:`SlabEntry` in order, with its own ``lr`` and ``wd`` and the
    shared ``statics`` (``rescale_grad``, ``clip_gradient``, ``momentum``,
    ``beta1``, ``beta2``, ``epsilon``), written to its ``out`` where given.
    Returns one ``(new_w, new_states, w16)`` an entry."""
    results = []
    for e in entries:
        res = slab_update_reference(kind, e.w, e.g, tuple(e.states), e.lr, inv_scale, finite,
                                    wd=e.wd, **statics)
        results.append(res if e.out is None else _write_out(e.out, res))
    return results


def _slab_bad(i, kind, entry, out, dev, g_dtype):
    """The error for slab ``i`` of a table, naming its first bad tensor."""
    f32 = torch.float32
    named = [("w", entry.w, f32), ("g", entry.g, g_dtype), ("out w", out[0], f32),
             ("out w16", out[2], torch.bfloat16)]
    named += [("state %d" % j, s, f32) for j, s in enumerate(entry.states)]
    named += [("out state %d" % j, s, f32) for j, s in enumerate(out[1])]
    n = entry.w.shape[0] if entry.w.dim() == 1 else -1
    for name, x, dtype in named:
        if not (x.get_device() == dev and x.dtype is dtype and x.dim() == 1
                and x.shape[0] == n and x.is_contiguous()):
            break
    return MXNetError("fused_slab_update: slab %d's %s must be a 1-D %s tensor of %d elements "
                      "with stride 1 on cuda:%d (%s; one gradient dtype a table), got %s %s "
                      "with strides %s on %s" % (i, name, dtype, n, dev, kind, x.dtype,
                                                 tuple(x.shape), x.stride(), x.device))


def _slab_scalar(x, dev, name):
    """``(pointer, value)`` of a per-step scalar in the table: a one-element
    f32 tensor on the slabs' device is read through its pointer, a number
    (or a CPU tensor) goes into the launch as its value."""
    if not torch.is_tensor(x):
        return 0, float(x)
    if x.device.type == "cpu":
        return 0, float(x)
    if x.get_device() != dev or x.dtype is not torch.float32 or x.numel() != 1:
        raise MXNetError("fused_slab_update: %s must be a number or a one-element float32 "
                         "tensor on cuda:%d, got %s %s on %s"
                         % (name, dev, x.dtype, tuple(x.shape), x.device))
    return x.data_ptr(), 0.0


def _slab_table(kind, entries):
    """One pass over a table of :class:`SlabEntry`: checks every slab (one
    CUDA device, dtypes, length, stride 1; one gradient dtype for the
    table), allocates the outputs an entry lacks, and lays each non-empty
    slab out as the kernel's row. Returns ``(device index, gradient is bf16,
    results, rows)``: ``results`` one ``(new_w, new_states, w16)`` an entry,
    ``rows`` one ``[pointers (8), n, head, tiles, lr, wd]`` a non-empty slab
    (``head``: elements before the first 16-byte boundary, -1 where the
    operands are misaligned against each other; ``lr`` the entry's own, a
    number or a tensor)."""
    if kind not in SLAB_STATE_SLOTS:
        raise MXNetError("fused_slab_update: unknown kind %r (sgd, sgd_mom, adam)" % (kind,))
    slots = SLAB_STATE_SLOTS[kind]
    f32, bf16 = torch.float32, torch.bfloat16
    dev = entries[0].w.get_device()
    g_dtype = entries[0].g.dtype
    if dev < 0 or g_dtype not in (bf16, f32):
        raise MXNetError("fused_slab_update wants CUDA slabs and a bf16 or f32 gradient, got w "
                         "on %s and a %s gradient" % (entries[0].w.device, g_dtype))
    results, rows = [], []
    for i, e in enumerate(entries):
        w, g, states, lr, wd, out = e
        states = tuple(states)
        if len(states) != slots:
            raise MXNetError("fused_slab_update: %s takes %d state slabs, slab %d has %d"
                             % (kind, slots, i, len(states)))
        shape = w.shape
        n = shape[0] if len(shape) == 1 else -1
        if out is None:
            out = (torch.empty_like(w), tuple(torch.empty_like(s) for s in states),
                   torch.empty(max(n, 0), dtype=bf16, device=w.device))
        ow, ostates, w16 = out[0], tuple(out[1]), out[2]
        if len(ostates) != slots:
            raise MXNetError("fused_slab_update: slab %d's out holds %d state slabs, %s takes %d"
                             % (i, len(ostates), kind, slots))
        # one pass: every tensor of the slab on the device, of its dtype,
        # of w's shape and stride 1 (an output that is its input once)
        checks = [(w, f32), (g, g_dtype), (w16, bf16)]
        checks += [(s, f32) for s in states]
        checks += [(o, f32) for o, x in zip((ow, *ostates), (w, *states)) if o is not x]
        for x, dtype in checks:
            if (n < 0 or x.get_device() != dev or x.dtype is not dtype or x.shape != shape
                    or not x.is_contiguous()):
                raise _slab_bad(i, kind, e, (ow, ostates, w16), dev, g_dtype)
        results.append((ow, ostates, w16))
        if n == 0:
            continue
        sp = [s.data_ptr() for s in states] + [0, 0]
        op = [o.data_ptr() for o in ostates] + [0, 0]
        ptrs = (w.data_ptr(), g.data_ptr(), sp[0], sp[1], ow.data_ptr(), op[0], op[1],
                w16.data_ptr())
        rows.append([ptrs, n, *_slab_head_tiles(ptrs, n, g_dtype is bf16), lr, wd])
    return dev, g_dtype is bf16, results, rows


def _slab_head_tiles(ptrs, n, g_bf16):
    """``(head, tiles)`` of a slab of ``n`` > 0 elements whose eight
    pointers (w, g, s0, s1, out w, out s0, out s1, w16; 0 for a state the
    kind lacks) are ``ptrs``: the elements before the first 16-byte
    boundary of its f32 operands, where every operand reaches its vector
    boundary (16 bytes of f32, 8 of bf16: 4 elements) at the same element,
    else -1 (scalar throughout); and its tiles of ``_SLAB_TILE``."""
    w, g, s0, s1, ow, os0, os1, w16 = ptrs
    m = (w >> 2) & 3
    if (((g >> (1 if g_bf16 else 2)) & 3) != m or ((w16 >> 1) & 3) != m
            or (ow >> 2) & 3 != m
            or (s0 and ((s0 >> 2) & 3 != m or (os0 >> 2) & 3 != m))
            or (s1 and ((s1 >> 2) & 3 != m or (os1 >> 2) & 3 != m))):
        return -1, -(-n // _SLAB_TILE)
    head = min((4 - m) & 3, n)
    return head, max(1, -(-(n - head) // _SLAB_TILE))


def _slab_pack(rows, lr_ptrs, statics):
    """The launches of a table: ``(shared, entries, count, tiles)`` for
    every ``SLAB_TABLE_CAP`` rows, ``shared`` and ``entries`` the bytes of
    the kernel's SlabShared and SlabEntry rows (each row's ``tile0`` the
    tiles of the rows before it in its launch); ``statics`` the shared
    row's fields up to ``n_entries``."""
    launches = []
    for lo in range(0, len(rows), SLAB_TABLE_CAP):
        packed, tiles = [], 0
        for (ptrs, n, head, row_tiles, lr, wd), lr_ptr in zip(
                rows[lo:lo + SLAB_TABLE_CAP], lr_ptrs[lo:lo + SLAB_TABLE_CAP]):
            packed.append(_SLAB_ENTRY.pack(*ptrs, lr_ptr, n, tiles, head,
                                           0.0 if lr_ptr else float(lr), float(wd),
                                           int(wd != 0.0), 0))
            tiles += row_tiles
        launches.append((_SLAB_SHARED.pack(*statics, len(packed), tiles), b"".join(packed),
                         len(packed), tiles))
    return launches


def _slab_launch(kind, g_bf16, dev, rows, lr_ptrs, inv_scale, finite, *, rescale_grad,
                 clip_gradient, momentum, beta1, beta2, epsilon):
    """K1's launches over ``rows`` (from :func:`_slab_table`), at most
    ``SLAB_TABLE_CAP`` a launch; ``lr_ptrs`` the device pointer of each
    row's lr, 0 where its number goes into the launch."""
    inv_ptr, inv_val = _slab_scalar(inv_scale, dev, "inv_scale")
    fin_ptr, fin_val = _slab_scalar(finite, dev, "finite")
    clip = float(clip_gradient) if clip_gradient else -1.0
    statics = (inv_ptr, fin_ptr, inv_val, fin_val, float(rescale_grad), clip, float(momentum),
               float(beta1), float(beta2), 1.0 - beta1, 1.0 - beta2, float(epsilon),
               int(rescale_grad != 1.0), int(clip > 0))
    sms = _SM_COUNT.get(dev)
    if sms is None:
        sms = _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _build.load("slab_update")
    switch = torch.cuda.current_device() != dev
    with (torch.cuda.device(dev) if switch else contextlib.nullcontext()):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for shared, packed, count, tiles in _slab_pack(rows, lr_ptrs, statics):
            rc = fn(_SLAB_KIND_CODE[kind], int(g_bf16), shared, packed, count,
                    min(tiles, _SLAB_CTAS_PER_SM * sms), stream)
            if rc != 0:
                raise MXNetError("slab_update kernel launch failed: CUDA error %d" % rc)
            fused_slab_update.launches += 1


def fused_slab_update_multi(kind, entries, inv_scale, finite, *, rescale_grad, clip_gradient,
                            momentum=0.0, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """K1 over a table: one AMP optimizer step over every
    :class:`SlabEntry` of ``entries``, each with its own ``lr`` and ``wd``,
    sharing ``inv_scale`` / ``finite`` (numbers or one-element f32 tensors)
    and the static hyperparameters. The slabs must not overlap one another
    (a slab's ``out`` may be its own inputs). Returns one ``(new_w,
    new_states, w16)`` an entry.

    On CUDA tensors: one kernel launch for every ``SLAB_TABLE_CAP`` slabs
    (``fused_slab_update.launches`` counts K1's launches), the checks in one
    pass over the table, the entries' host-number lrs copied to the device
    in one non-blocking copy from a pinned block made for the call, tensors
    read through their pointers; nothing else is launched and nothing waits
    for the device. A captured copy would read that block at every replay
    after it is freed, so while the current stream is being captured into
    a CUDA graph every lr must be a one-element f32 tensor on the slabs'
    device (memory the host writes before each replay), and a host number
    raises :class:`MXNetError`. On CPU tensors:
    :func:`slab_update_multi_reference`."""
    statics = dict(rescale_grad=rescale_grad, clip_gradient=clip_gradient, momentum=momentum,
                   beta1=beta1, beta2=beta2, epsilon=epsilon)
    entries = list(entries)
    if not entries:
        return []
    if entries[0].w.device.type == "cpu":
        if any(e.w.device.type != "cpu" for e in entries):
            raise MXNetError("fused_slab_update_multi wants every slab on one device")
        return slab_update_multi_reference(kind, entries, inv_scale, finite, **statics)
    dev, g_bf16, results, rows = _slab_table(kind, entries)
    lr_ptrs, host = [], []
    for j, row in enumerate(rows):
        lr = row[4]
        if torch.is_tensor(lr) and lr.device.type != "cpu":
            lr_ptrs.append(_slab_scalar(lr, dev, "lr")[0])
        else:
            lr_ptrs.append(0)
            host.append(j)
    if host and torch.cuda.is_current_stream_capturing():
        raise MXNetError("fused_slab_update_multi: slab %d's lr is a host number while the "
                         "stream is captured into a CUDA graph, where its copy would be read "
                         "from a freed block at each replay; pass a one-element float32 tensor "
                         "on cuda:%d" % (host[0], dev))
    if host:
        lrs = torch.tensor([float(rows[j][4]) for j in host], dtype=torch.float32,
                           pin_memory=True).to(torch.device("cuda", dev), non_blocking=True)
        base = lrs.data_ptr()
        for k, j in enumerate(host):
            lr_ptrs[j] = base + 4 * k
    if rows:
        _slab_launch(kind, g_bf16, dev, rows, lr_ptrs, inv_scale, finite, **statics)
    return results


def fused_slab_update(kind, w, g, states, lr, inv_scale, finite, *, wd, rescale_grad,
                      clip_gradient, momentum=0.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                      out=None):
    """K1: one AMP optimizer step over a flat slab (the JAX signature).

    ``w`` (S,) f32 master; ``g`` (S,) bf16 (under AMP) or f32 gradient;
    ``states`` 0, 1 or 2 (S,) f32 slabs for ``kind`` sgd / sgd_mom / adam;
    ``lr`` / ``inv_scale`` / ``finite`` numbers or one-element tensors
    (``finite`` 1 applies the step, 0 leaves every output equal to its
    input bit for bit). Returns ``(new_w, new_states, w16)``; with ``out =
    (w_out, states_out, w16_out)`` the results are written there (they may
    be ``w`` and ``states`` themselves) and those tensors returned.

    On CUDA tensors: one launch of the kernel of ``csrc/slab_update.cu`` on
    a table of one slab, no fallback (``fused_slab_update.launches`` counts
    its launches); a number goes into the launch as its value, a one-element
    f32 tensor on the slab's device is read through its pointer, so the call
    launches nothing else and never waits for the device. On CPU tensors:
    :func:`slab_update_reference`."""
    statics = dict(rescale_grad=rescale_grad, clip_gradient=clip_gradient, momentum=momentum,
                   beta1=beta1, beta2=beta2, epsilon=epsilon)
    states = tuple(states)
    if w.device.type == "cpu":
        res = slab_update_reference(kind, w, g, states, lr, inv_scale, finite, wd=wd, **statics)
        return res if out is None else _write_out(out, res)
    dev, g_bf16, results, rows = _slab_table(kind, [SlabEntry(w, g, states, lr, wd, out)])
    if rows:
        lr_ptr, lr_val = _slab_scalar(lr, dev, "lr")
        rows[0][4] = lr_val
        _slab_launch(kind, g_bf16, dev, rows, [lr_ptr], inv_scale, finite, **statics)
    return results[0]


fused_slab_update.launches = 0  # K1's launches, from either wrapper


# --------------------------------------------------------------------------
# greedy NMS: the detection operators' suppression loop in one launch
# --------------------------------------------------------------------------
def box_iou(a, b):
    """[Na, 4] x [Nb, 4] -> [Na, Nb] IoU of corner-format boxes, op for op
    the JAX package's ``_iou`` (``mxnet_tpu/contrib/ops.py:97``)."""
    ax1, ay1, ax2, ay2 = (a[:, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[:, i] for i in range(4))
    ix1 = torch.maximum(ax1[:, None], bx1[None, :])
    iy1 = torch.maximum(ay1[:, None], by1[None, :])
    ix2 = torch.minimum(ax2[:, None], bx2[None, :])
    iy2 = torch.minimum(ay2[:, None], by2[None, :])
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = iw * ih
    area_a = torch.clamp((ax2 - ax1) * (ay2 - ay1), min=0.0)
    area_b = torch.clamp((bx2 - bx1) * (by2 - by1), min=0.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype,
                                                              device=inter.device))


def nms_suppress_reference(mask, order, active):
    """Plain version of the NMS kernel. For each sample b, steps s = 0 ..
    S-1 in order visit box ``i = order[b, s]``; if ``active[b, i]`` and box i
    is not suppressed yet, suppress every box j with ``mask[b, s, j]``.
    ``mask`` bool [B, S, n], ``order`` int64 [B, S], ``active`` bool [B, n];
    returns the suppressed flags, bool [B, n]."""
    m = mask.cpu().numpy()
    o = order.cpu().numpy()
    act = active.cpu().numpy()
    sup = np.zeros(act.shape, bool)
    for b in range(m.shape[0]):
        s_b, m_b, a_b = sup[b], m[b], act[b]
        for s, i in enumerate(o[b]):
            if a_b[i] and not s_b[i]:
                s_b |= m_b[s]
    return torch.from_numpy(sup).to(mask.device)


def nms_suppress(mask, order, active):
    """The suppressed flags of the greedy loop of
    :func:`nms_suppress_reference` (arguments and result as there). On CUDA
    tensors: the kernel of ``csrc/nms.cu``, one CTA a sample, launched on
    the current stream without waiting for the device; no fallback
    (``nms_suppress.launches`` counts its launches). On CPU tensors: the
    plain version."""
    if mask.dim() != 3 or order.dim() != 2 or active.dim() != 2:
        raise MXNetError("nms_suppress: mask [B, S, n], order [B, S] and active [B, n], "
                         "got %s, %s, %s" % (tuple(mask.shape), tuple(order.shape),
                                             tuple(active.shape)))
    b, steps, n = mask.shape
    if tuple(order.shape) != (b, steps) or tuple(active.shape) != (b, n):
        raise MXNetError("nms_suppress: order %s and active %s do not match mask %s"
                         % (tuple(order.shape), tuple(active.shape), tuple(mask.shape)))
    if mask.dtype != torch.bool or active.dtype != torch.bool or order.dtype != torch.int64:
        raise MXNetError("nms_suppress: mask and active are bool, order int64")
    if mask.device.type != "cuda":
        return nms_suppress_reference(mask, order, active)
    if n > 227 * 1024:
        raise MXNetError("nms_suppress: %d boxes exceed one CTA's shared memory" % n)
    mask, order, active = mask.contiguous(), order.contiguous(), active.contiguous()
    out = torch.empty((b, n), dtype=torch.bool, device=mask.device)
    err = _build.load("nms")(
        mask.data_ptr(), order.data_ptr(), active.data_ptr(), out.data_ptr(), b, steps, n,
        torch.cuda.current_stream(mask.device).cuda_stream)
    if err:
        raise MXNetError("nms kernel launch failed (cudaError %d)" % err)
    nms_suppress.launches += 1
    return out


nms_suppress.launches = 0
