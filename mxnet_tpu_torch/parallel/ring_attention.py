"""Ring attention over the 'sp' axis of a mesh (counterpart of
``mxnet_tpu/parallel/ring_attention.py``).

The JAX package shards the sequence over the mesh's sp devices with
``shard_map`` and rotates key/value blocks around the ring with
``ppermute``; each device folds the blocks it visits into an online
softmax. Here the sp ranks are logical ranks of one device, so a rank is a
block of T / sp positions of the one tensor: query block i visits
key/value blocks in the JAX ring's order, i, i - 1, ... (its own block
first), and every (q-block, kv-block) pair that is not wholly above the
causal diagonal runs :func:`ops.kernels.flash_attention` (the K4f kernel
on the card; causal only on the diagonal block). A block wholly above the
diagonal is skipped: in the JAX loop it adds exactly 0, since
``exp(-1e30 - m)`` is 0 in f32. The blocks' outputs are merged in f32 by
their logsumexps, ``lse_i = logsumexp_j lse_ij`` and
``out_i = sum_j exp(lse_ij - lse_i) o_ij``, and cast to q's dtype.

The backward (:class:`_RingAttention`) is exact blockwise flash attention:
with the merged output's ``delta = sum_D dO * out`` and the global
``lse_i``, ``exp(S_ij - lse_i)`` is the true softmax restricted to block
j, so every live pair runs the dq and dk/dv kernels (K4dq, K4dkv) with
those row statistics; dq sums over j and dk, dv over i, in f32. In f32 on
the card each block's q, k, v (and dO) are split into their bf16 planes
once, and each pair's kernels read the planes of its own blocks.

On CPU tensors the flash wrappers run their plain versions, so the same
code runs on the host. :func:`ring_attention_reference` is JAX's own
online-softmax loop (``_block_attn`` and the scan of ``ring_attention``)
in plain PyTorch.

T must divide by sp, as ``shard_map`` requires; a ``q_offset`` shifts the
queries' positions by whole blocks only.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import kernels
from .mesh import axis_size

_NEG_INF = -1e30


def _block_plan(q, k, v, sp, q_offset):
    """(block length, queries' shift in whole blocks); raise where the ring
    cannot run these arguments."""
    sp = int(sp)
    if sp < 1:
        raise ValueError("ring attention wants sp >= 1, got %d" % sp)
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise MXNetError("ring attention wants q, k, v of one [B, T, H, D] shape, got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    t = q.shape[1]
    if t % sp:
        raise ValueError("ring attention over sp = %d ranks wants T divisible by %d, got T = %d"
                         % (sp, sp, t))
    tb = t // sp
    q_offset = int(q_offset)
    if q_offset < 0 or q_offset % tb:
        raise NotImplementedError(
            "ring attention shifts queries by whole blocks of %d positions only, got q_offset "
            "%d: an offset inside a block needs a mask the flash kernels do not take "
            "(mxnet_tpu/parallel/ring_attention.py:90-115 masks by position)" % (tb, q_offset))
    return tb, q_offset // tb


def live_pairs(sp, causal, shift=0):
    """(i, j, diagonal) for every (q-block i, kv-block j) pair the ring
    computes, each query block's in the JAX ring's order i, i - 1, ...;
    with ``causal`` the pairs wholly above the diagonal (kv block j after
    query block i + ``shift``) are left out: sp (sp + 1) / 2 pairs at
    shift 0, sp * sp without ``causal``."""
    pairs = []
    for i in range(sp):
        g = i + shift
        for step in range(sp):
            j = (i - step) % sp
            if causal and j > g:
                continue
            pairs.append((i, j, bool(causal) and j == g))
    return pairs


def _blocks(x, sp):
    return x.chunk(sp, dim=1)


def _split_blocks(*blocks):
    """On the card in f32: one split pass over each block's operands,
    (n, 2, B, T / sp, H, D) bf16 a block; else Nones."""
    first = blocks[0][0]
    if first.device.type != "cuda" or first.dtype != torch.float32:
        return [None] * len(blocks[0])
    return [kernels.split_planes(*kernels.check_kernel_args(*ops)) for ops in zip(*blocks)]


def _ring_forward(q, k, v, sp, causal, scale, shift):
    """(out in q's dtype, f32 lse [B, H, T]) of the ring."""
    qs, ks, vs = _blocks(q, sp), _blocks(k, sp), _blocks(v, sp)
    planes = _split_blocks(qs, ks, vs)
    outs, lses = [[] for _ in range(sp)], [[] for _ in range(sp)]
    for i, j, diag in live_pairs(sp, causal, shift):
        pair = None if planes[i] is None else (planes[i][0], planes[j][1], planes[j][2])
        o, lse = kernels.flash_attention(qs[i], ks[j], vs[j], causal=diag, scale=scale,
                                         return_lse=True, planes=pair)
        outs[i].append(o)
        lses[i].append(lse)
    out_blocks, lse_blocks = [], []
    for o_i, l_i in zip(outs, lses):
        if len(o_i) == 1:
            out_blocks.append(o_i[0])
            lse_blocks.append(l_i[0])
            continue
        stacked = torch.stack(l_i)  # [n, B, H, Tb]
        lse = torch.logsumexp(stacked, dim=0)
        w = torch.exp(stacked - lse).transpose(2, 3)[..., None]  # [n, B, Tb, H, 1]
        o = sum(w[n] * o.float() for n, o in enumerate(o_i))
        out_blocks.append(o.to(q.dtype))
        lse_blocks.append(lse)
    return torch.cat(out_blocks, dim=1), torch.cat(lse_blocks, dim=-1).contiguous()


def _sum(parts, dtype):
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    return total.to(dtype)


class _RingAttention(torch.autograd.Function):
    """The ring's forward, saving q, k, v, the merged output and the global
    f32 lse; the backward runs the dq and dk/dv wrappers on every live pair
    with the global row statistics."""

    @staticmethod
    def forward(ctx, q, k, v, sp, causal, scale, shift):
        out, lse = _ring_forward(q, k, v, sp, causal, scale, shift)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sp, ctx.causal, ctx.scale, ctx.shift = sp, causal, scale, shift
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        sp = ctx.sp
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        do = g.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        qs, ks, vs, dos = (_blocks(x, sp) for x in (q, k, v, do))
        lse_b = [x.contiguous() for x in lse.chunk(sp, dim=-1)]
        delta_b = [x.contiguous() for x in delta.chunk(sp, dim=-1)]
        planes = _split_blocks(qs, ks, vs, dos)
        dq, dk, dv = ([[] for _ in range(sp)] for _ in range(3))
        for i, j, diag in live_pairs(sp, ctx.causal, ctx.shift):
            pair = (None if planes[i] is None
                    else (planes[i][0], planes[j][1], planes[j][2], planes[i][3]))
            args = (qs[i], ks[j], vs[j], dos[i], lse_b[i], delta_b[i], diag, ctx.scale, pair)
            dq[i].append(kernels.flash_attention_dq(*args))
            dk_ij, dv_ij = kernels.flash_attention_dkv(*args)
            dk[j].append(dk_ij)
            dv[j].append(dv_ij)
        grads = []
        for parts in (dq, dk, dv):
            blocks = [_sum(p, q.dtype) if p else torch.zeros_like(b)
                      for p, b in zip(parts, qs)]
            grads.append(torch.cat(blocks, dim=1))
        return (*grads, None, None, None, None)


def ring_attention(q, k, v, sp, causal=False, scale=None, q_offset=0):
    """Exact attention over ``sp`` sequence blocks of q, k, v [B, T, H, D]
    (one device), every live block pair through the flash wrappers and
    merged by logsumexp; differentiable (the dq and dk/dv wrappers on the
    same pairs). ``q_offset`` (a multiple of T / sp) shifts every query's
    position, moving the causal diagonal by whole blocks."""
    tb, shift = _block_plan(q, k, v, sp, q_offset)
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)
    sp, causal = int(sp), bool(causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _RingAttention.apply(q, k, v, sp, causal, scale, shift)
    return _ring_forward(q, k, v, sp, causal, scale, shift)[0]


def sequence_parallel_attention(q, k, v, mesh, causal=True, q_offset=0, scale=None):
    """:func:`ring_attention` over the mesh's 'sp' axis. ``mesh`` is a
    :class:`~.mesh.Mesh` (its ranks on q's device) or a mapping of axis
    sizes; ``q_offset`` as there."""
    device = getattr(mesh, "device", None)
    if device is not None and torch.device(device) != q.device:
        raise MXNetError("the mesh's ranks are on %s but q is on %s" % (device, q.device))
    return ring_attention(q, k, v, axis_size(mesh, "sp"), causal=causal, scale=scale,
                          q_offset=q_offset)


def ring_attention_reference(q, k, v, sp, causal=False, scale=None, q_offset=0):
    """The plain version: JAX's ``_block_attn`` online softmax (numerator,
    denominator and running max in q's dtype, -1e30 for masked scores, the
    kv blocks in ring order i, i - 1, ...) over ``sp`` blocks, every block
    pair computed, masked ones included."""
    b, t, h, d = q.shape
    if t % sp:
        raise ValueError("ring attention over sp = %d ranks wants T divisible by %d, got T = %d"
                         % (sp, sp, t))
    tb = t // sp
    scale = 1.0 / (d ** 0.5) if scale is None else float(scale)
    qs, ks, vs = _blocks(q, sp), _blocks(k, sp), _blocks(v, sp)
    pos = torch.arange(tb, device=q.device)
    out = []
    for i in range(sp):
        num = torch.zeros((b, tb, h, d), dtype=q.dtype, device=q.device)
        den = torch.zeros((b, h, tb), dtype=q.dtype, device=q.device)
        mx = torch.full((b, h, tb), _NEG_INF, dtype=q.dtype, device=q.device)
        for step in range(sp):
            j = (i - step) % sp
            s = torch.einsum("bqhd,bkhd->bhqk", qs[i], ks[j]) * scale
            if causal:
                keep = (q_offset + i * tb + pos)[:, None] >= (j * tb + pos)[None, :]
                s = s + torch.where(keep, 0.0, _NEG_INF).to(s.dtype)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            n_i = torch.einsum("bhqk,bkhd->bqhd", p, vs[j])
            d_i, m_i = p.sum(-1), m[..., 0]
            new_m = torch.maximum(mx, m_i)
            alpha, beta = torch.exp(mx - new_m), torch.exp(m_i - new_m)
            num = num * alpha[..., None].transpose(1, 2) + n_i * beta[..., None].transpose(1, 2)
            den = den * alpha + d_i * beta
            mx = new_m
        out.append(num / den.transpose(1, 2)[..., None].clamp_min(1e-30))
    return torch.cat(out, dim=1)
