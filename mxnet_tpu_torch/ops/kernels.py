"""Attention kernels of the PyTorch port (counterpart of the flash part of
``mxnet_tpu/ops/pallas_kernels.py``).

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu``: blockwise online-softmax attention that saves
the f32 logsumexp. ``reference_attention`` is its plain PyTorch version,
the same function with the scores materialised. The wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises. ``attention`` is the dispatch every model calls.

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


def check_kernel_args(q, k, v):
    """Raise unless the CUDA kernel takes these tensors: the same [B, T, H, D]
    shape, dtype and CUDA device, D in KERNEL_HEAD_DIMS, f32 or bf16, and
    unit stride along D (other strides are read as given)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise MXNetError(
            "flash_attention wants q, k, v of one [B, T, H, D] shape, got %s %s %s"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise MXNetError(
            "flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            "dtype, got %s %s %s" % (q.dtype, k.dtype, v.dtype))
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise MXNetError(
            "flash_attention kernel takes head dim in %s, got %d"
            % (KERNEL_HEAD_DIMS, q.shape[-1]))
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise MXNetError(
            "flash_attention kernel wants q, k, v on one CUDA device, got "
            "%s %s %s" % (q.device, k.device, v.device))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise MXNetError(
                "flash_attention kernel wants unit stride along D; %s has "
                "strides %s" % (name, x.stride()))


def _launch(q, k, v, causal, scale):
    check_kernel_args(q, k, v)
    fn = _build.load("flash_attn_fwd")
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, t, h, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], scale, int(bool(causal)),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise MXNetError("flash_attn_fwd kernel launch failed: CUDA error %d" % rc)
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False):
    """Blockwise (flash) attention. q/k/v: [B, T, H, D] -> [B, T, H, D].

    On CUDA tensors: the kernel of ``csrc/flash_attn_fwd.cu``, with no
    fallback; ``flash_attention.launches`` counts its launches. On CPU
    tensors: the plain version. ``return_lse=True`` also returns the f32
    logsumexp [B, H, T] a backward pass needs."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        out = reference_attention(q, k, v, causal=causal, scale=scale)
        lse = reference_lse(q, k, causal=causal, scale=scale) if return_lse else None
    else:
        out, lse = _launch(q, k, v, causal, scale)
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
