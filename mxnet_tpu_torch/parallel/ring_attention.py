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

Across processes (a :class:`~.mesh.Mesh` whose sp axis spans them:
:func:`sequence_parallel_attention`), each process holds the T / sp blocks
of its own sp positions of q, k and v. The ring is the same code, run on the
sp :class:`~.mesh.AxisGroup` (one process holding every block is the case
above): one all-gather of k and v (stacked, one collective) over the sp
axis's processes gives every process every block, and its own query blocks
visit them in the JAX ring's order with the same pairs, kernels and
logsumexp merge. That is the transport chosen here in place of the ring's
send / receive of one block a step: one collective a layer instead of
sp - 1, the same bytes. The backward computes dq of its own blocks and dk,
dv of every block its queries touched, each block's sum in f32 rounded to
q's dtype once, and a reduce-scatter over the sp processes in q's dtype
returns to each process the sum of its own blocks' dk and dv.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import kernels
from . import mesh as _mesh
from .mesh import axis_size

_NEG_INF = -1e30


def _block_plan(q, k, v, grp, q_offset):
    """(block length, queries' shift in whole blocks); raise where the ring
    cannot run these arguments. q, k, v are this process's ``grp.local``
    blocks of a sequence of ``grp.size * grp.local`` blocks."""
    sp = grp.size * grp.local
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise MXNetError("ring attention wants q, k, v of one [B, T, H, D] shape, got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    t = q.shape[1] * grp.size
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


def _split_blocks(blocks):
    """On the card in f32: one split pass over each block's operands (a
    tuple a block), (n, 2, B, T / sp, H, D) bf16 a block; else Nones."""
    first = blocks[0][0]
    if first.device.type != "cuda" or first.dtype != torch.float32:
        return [None] * len(blocks)
    return [kernels.split_planes(*ops) for ops in blocks]


def _ring_forward(q, kf, vf, grp, causal, scale, shift):
    """(out in q's dtype, f32 lse [B, H, Tl]) of this process's query
    blocks against every block of the gathered kf, vf. Each block's planes
    are (k, v) and, for a block of this process, q after them."""
    sp, mine = grp.size * grp.local, list(grp.positions)
    qs = dict(zip(mine, _blocks(q, grp.local)))
    ks, vs = _blocks(kf, sp), _blocks(vf, sp)
    planes = _split_blocks([(ks[j], vs[j]) + ((qs[j],) if j in qs else ()) for j in range(sp)])
    outs, lses = {i: [] for i in mine}, {i: [] for i in mine}
    for i, j, diag in live_pairs(sp, causal, shift):
        if i not in qs:
            continue
        pair = None if planes[i] is None else (planes[i][2], planes[j][0], planes[j][1])
        o, lse = kernels.flash_attention(qs[i], ks[j], vs[j], causal=diag, scale=scale,
                                         return_lse=True, planes=pair)
        outs[i].append(o)
        lses[i].append(lse)
    merged = [_merge(outs[i], lses[i], q.dtype) for i in mine]
    return (torch.cat([o for o, _ in merged], dim=1),
            torch.cat([lse for _, lse in merged], dim=-1).contiguous())


def _merge(o_i, l_i, dtype):
    """One query block's output and f32 lse from its pairs' (o, lse), merged
    in f32 by their logsumexps."""
    if len(o_i) == 1:
        return o_i[0], l_i[0]
    stacked = torch.stack(l_i)  # [n, B, H, Tb]
    lse = torch.logsumexp(stacked, dim=0)
    w = torch.exp(stacked - lse).transpose(2, 3)[..., None]  # [n, B, Tb, H, 1]
    o = sum(w[n] * o.float() for n, o in enumerate(o_i))
    return o.to(dtype), lse


def _sum(parts, dtype):
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    return total.to(dtype)


def _gather_seq(grp, *xs):
    """Each [B, Tl, H, D] tensor of ``xs`` gathered along T over the sp
    processes (one all-gather for all of them): [B, n·Tl, H, D] each, the
    processes' blocks in their order; ``xs`` when ``grp`` spans one."""
    if grp.size == 1:
        return xs
    stacked = torch.stack(xs)  # [m, B, Tl, H, D]
    full = _mesh.all_gather(stacked, axis=grp)  # [n·m, B, Tl, H, D]
    m, b, tl = stacked.shape[:3]
    full = full.view((grp.size,) + tuple(stacked.shape)).permute(1, 2, 0, 3, 4, 5)
    return full.reshape((m, b, grp.size * tl) + tuple(stacked.shape[3:])).unbind(0)


def _scatter_seq(grp, *xs):
    """The inverse pairing of :func:`_gather_seq` for gradients: each
    [B, n·Tl, H, D] tensor summed over the sp processes, of which this
    process keeps its own [B, Tl, H, D] block (one reduce-scatter)."""
    if grp.size == 1:
        return xs
    stacked = torch.stack(xs)  # [m, B, n·Tl, H, D]
    m, b, t = stacked.shape[:3]
    tl = t // grp.size
    per = stacked.view((m, b, grp.size, tl) + tuple(stacked.shape[3:])).permute(2, 0, 1, 3, 4, 5)
    mine = _mesh.reduce_scatter_sum(per.reshape((grp.size * m, b, tl) + tuple(stacked.shape[3:])),
                                    axis=grp)
    return mine.unbind(0)


class _GatherSequence(torch.autograd.Function):
    """:func:`gather_sequence`'s all-gather along T forward, its
    reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _gather_seq(grp, x[:, :, None])[0][:, :, 0]

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(ctx.grp, g.contiguous()[:, :, None])[0][:, :, 0], None


def gather_sequence(x, grp):
    """This process's [B, Tl, d] block of a sequence gathered along T over
    the sp processes of ``grp`` into [B, n·Tl, d]; backward, the gradient
    summed over them and cut back to this process's block. ``x`` itself
    when ``grp`` spans one process."""
    if grp is None or grp.size <= 1:
        return x
    if not torch.is_grad_enabled():
        return _gather_seq(grp, x[:, :, None])[0][:, :, 0]
    return _GatherSequence.apply(x, grp)


class _RingAttention(torch.autograd.Function):
    """The ring's forward (k and v gathered over the sp processes first),
    saving q, the gathered k and v, the merged output and the f32 lse of
    this process's query blocks; the backward runs the dq and dk/dv
    wrappers on every live pair of those blocks with the global row
    statistics, and returns each block's dk, dv to its process."""

    @staticmethod
    def forward(ctx, q, k, v, grp, causal, scale, shift):
        kf, vf = _gather_seq(grp, k, v)
        out, lse = _ring_forward(q, kf, vf, grp, causal, scale, shift)
        ctx.save_for_backward(q, kf, vf, out, lse)
        ctx.grp, ctx.causal, ctx.scale, ctx.shift = grp, causal, scale, shift
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, kf, vf, out, lse = ctx.saved_tensors
        grp = ctx.grp
        sp, m, mine = grp.size * grp.local, grp.local, list(grp.positions)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        do = g.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        qs, dos = dict(zip(mine, _blocks(q, m))), dict(zip(mine, _blocks(do, m)))
        ks, vs = _blocks(kf, sp), _blocks(vf, sp)
        lse_b = dict(zip(mine, [x.contiguous() for x in lse.chunk(m, dim=-1)]))
        delta_b = dict(zip(mine, [x.contiguous() for x in delta.chunk(m, dim=-1)]))
        planes = _split_blocks([(ks[j], vs[j]) + ((qs[j], dos[j]) if j in qs else ())
                                for j in range(sp)])
        dq = {i: [] for i in mine}
        dk, dv = [[] for _ in range(sp)], [[] for _ in range(sp)]
        for i, j, diag in live_pairs(sp, ctx.causal, ctx.shift):
            if i not in qs:
                continue
            pair = (None if planes[i] is None
                    else (planes[i][2], planes[j][0], planes[j][1], planes[i][3]))
            args = (qs[i], ks[j], vs[j], dos[i], lse_b[i], delta_b[i], diag, ctx.scale, pair)
            dq[i].append(kernels.flash_attention_dq(*args))
            dk_ij, dv_ij = kernels.flash_attention_dkv(*args)
            dk[j].append(dk_ij)
            dv[j].append(dv_ij)
        dq = torch.cat([_sum(dq[i], q.dtype) if dq[i] else torch.zeros_like(qs[i])
                        for i in mine], dim=1)
        # each block's pairs summed in f32 and rounded to q's dtype once; across
        # processes the rounded partials are summed by the reduce-scatter
        dk, dv = (torch.cat([_sum(p, q.dtype) if p else torch.zeros_like(b)
                             for p, b in zip(parts, ks)], dim=1) for parts in (dk, dv))
        dk, dv = _scatter_seq(grp, dk, dv)
        return dq, dk, dv, None, None, None, None


def _ring(q, k, v, grp, causal, scale, q_offset):
    _, shift = _block_plan(q, k, v, grp, q_offset)
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)
    causal = bool(causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _RingAttention.apply(q, k, v, grp, causal, scale, shift)
    with torch.no_grad():
        kf, vf = _gather_seq(grp, k, v)
        return _ring_forward(q, kf, vf, grp, causal, scale, shift)[0]


def ring_attention(q, k, v, sp, causal=False, scale=None, q_offset=0):
    """Exact attention over ``sp`` sequence blocks of q, k, v [B, T, H, D]
    (one device), every live block pair through the flash wrappers and
    merged by logsumexp; differentiable (the dq and dk/dv wrappers on the
    same pairs). ``q_offset`` (a multiple of T / sp) shifts every query's
    position, moving the causal diagonal by whole blocks."""
    sp = int(sp)
    if sp < 1:
        raise ValueError("ring attention wants sp >= 1, got %d" % sp)
    grp = _mesh.AxisGroup("sp", range(sp), [0], 0, None)  # every block here
    return _ring(q, k, v, grp, causal, scale, q_offset)


def sequence_parallel_attention(q, k, v, mesh, causal=True, q_offset=0, scale=None):
    """:func:`ring_attention` over the mesh's 'sp' axis. ``mesh`` is a
    :class:`~.mesh.Mesh` (its ranks on q's device) or a mapping of axis
    sizes; ``q_offset`` as there. Where the mesh's sp axis spans processes,
    q, k, v are this process's blocks of the sequence and the ring runs
    across the processes; ``q_offset`` then shifts the global positions."""
    device = getattr(mesh, "device", None)
    if device is not None and torch.device(device) != q.device:
        raise MXNetError("the mesh's ranks are on %s but q is on %s" % (device, q.device))
    if getattr(mesh, "processes", 1) > 1:
        grp = _mesh.axis_group(mesh, "sp")
        if grp.size * grp.local != axis_size(mesh, "sp"):
            raise MXNetError("sp = %d is not %d processes of %d blocks"
                             % (axis_size(mesh, "sp"), grp.size, grp.local))
        return _ring(q, k, v, grp, causal, scale, q_offset)
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
