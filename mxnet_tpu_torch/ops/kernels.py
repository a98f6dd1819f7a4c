"""Attention kernels of the PyTorch port (counterpart of the flash part of
``mxnet_tpu/ops/pallas_kernels.py``).

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu``: blockwise online-softmax attention that saves
the f32 logsumexp. ``reference_attention`` is its plain PyTorch version,
the same function with the scores materialised. Its gradient is a
``torch.autograd.Function`` whose backward runs the two kernels of
``csrc/flash_attn_bwd.cu``, wrapped by ``flash_attention_dq`` and
``flash_attention_dkv``; ``reference_attention_bwd`` is their plain
version. Each wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches its kernel or raises. ``attention`` is
the dispatch every model calls.

Layout convention as in the JAX package: [B, T, H, D].
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch

from ..base import MXNetError
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


def check_kernel_args(q, k, v, do=None):
    """Raise unless the CUDA kernels take these tensors: q, k, v (and the
    output gradient ``do`` for the backward) of one [B, T, H, D] shape,
    dtype and CUDA device, D in KERNEL_HEAD_DIMS, f32 or bf16, and unit
    stride along D (other strides are read as given)."""
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
    return [s for x in xs for s in x.stride()[:3]]


def _run(name, q, pointers, strides, scale, causal):
    """Launch kernel ``name`` on q's device and current stream; raise if
    the launch is refused."""
    fn = _build.load(name)
    b, t, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(x.data_ptr() for x in pointers), b, t, h, d, *strides,
                scale, int(bool(causal)), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise MXNetError("%s kernel launch failed: CUDA error %d" % (name, rc))


def _launch(q, k, v, causal, scale):
    check_kernel_args(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _run("flash_attn_fwd", q, (q, k, v, out, lse), _strides(q, k, v), scale, causal)
    flash_attention.launches += 1
    return out, lse


def _forward(q, k, v, causal, scale, need_lse):
    if q.device.type == "cpu":
        out = reference_attention(q, k, v, causal=causal, scale=scale)
        lse = reference_lse(q, k, causal=causal, scale=scale) if need_lse else None
        return out, lse
    return _launch(q, k, v, causal, scale)


def flash_attention_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """dq of flash attention: the kernel ``flash_dq_kernel`` of
    ``csrc/flash_attn_bwd.cu`` on CUDA tensors (no fallback;
    ``flash_attention_dq.launches`` counts its launches), the plain
    version on CPU tensors. Arguments as :func:`reference_attention_bwd`."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_bwd(q, k, v, do, lse, delta, causal, scale)[0]
    check_kernel_args(q, k, v, do)
    _check_row_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _run("flash_attn_bwd_dq", q, (q, k, v, do, lse, delta, dq),
         _strides(q, k, v, do), scale, causal)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """(dk, dv) of flash attention: the kernel ``flash_dkv_kernel`` of
    ``csrc/flash_attn_bwd.cu`` on CUDA tensors (no fallback;
    ``flash_attention_dkv.launches`` counts its launches), the plain
    version on CPU tensors. Arguments as :func:`reference_attention_bwd`."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_bwd(q, k, v, do, lse, delta, causal, scale)[1:]
    check_kernel_args(q, k, v, do)
    _check_row_stats(q, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _run("flash_attn_bwd_dkv", q, (q, k, v, do, lse, delta, dk, dv),
         _strides(q, k, v, do), scale, causal)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the ``jax.custom_vjp`` ``_flash``: the forward saves
    q, k, v, out and the f32 lse; the backward computes
    ``delta = Σ_D g·out`` in f32 from the incoming gradient, casts that
    gradient to q's dtype (``_flash_bwd``), then runs the dq and dk/dv
    wrappers (the kernels on CUDA, their plain version on the CPU)."""

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
        dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False):
    """Blockwise (flash) attention. q/k/v: [B, T, H, D] -> [B, T, H, D].

    On CUDA tensors: the kernel of ``csrc/flash_attn_fwd.cu``, with no
    fallback; ``flash_attention.launches`` counts its launches. On CPU
    tensors: the plain version. When q, k or v requires a gradient, the
    call is recorded for autograd, whose backward runs
    :func:`flash_attention_dq` and :func:`flash_attention_dkv`.
    ``return_lse=True`` also returns the f32 logsumexp [B, H, T] a backward
    pass needs."""
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, bool(causal), scale)
    else:
        out, lse = _forward(q, k, v, causal, scale, need_lse=return_lse)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _sp_size(mesh):
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError("mesh must map axis names to sizes, got %r" % (mesh,))
    return int(shape.get("sp", 1))


def attention(q, k, v, causal=False, scale=None, mesh=None):
    """Shared attention dispatch. q/k/v: [B, T, H, D] -> [B, T, H, D].

    Every call goes through :func:`flash_attention`, whatever T: on CUDA
    tensors that is the kernel, so the plain version serves nothing on the
    card's main path (the JAX package's T >= 128 threshold for the Pallas
    kernel was a TPU tuning choice). A mesh that shards the sequence axis
    ('sp' > 1) would need ring attention, which is not ported yet."""
    if mesh is not None and _sp_size(mesh) > 1:
        raise NotImplementedError(
            "sequence-parallel (ring) attention is not ported to PyTorch yet")
    return flash_attention(q, k, v, causal=causal, scale=scale)
