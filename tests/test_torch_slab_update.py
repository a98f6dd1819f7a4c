"""K1's plain version in the PyTorch port (``slab_update_reference``) held
against the JAX package's ``fused_slab_update`` (the Pallas kernel in
interpret mode) and its ``slab_update_reference``, on the same numpy
inputs: sgd / sgd_mom / adam, ragged sizes, clipping on and off, a finite
and a skipped step. Masters and states within rtol 1e-6 / atol 1e-7, the
bf16 weight copy bit for bit, and a skipped step returns its inputs bit
for bit. The wrapper on CPU tensors runs the plain version (its launch
count stays put), also when it writes in place through ``out=``."""
import collections
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels

KW = dict(wd=0.0001, rescale_grad=1.0 / 32, momentum=0.9, beta1=0.9, beta2=0.999,
          epsilon=1e-8)
LR, INV_SCALE = 0.05, 1.0 / 128


def _inputs(kind, size):
    rng = np.random.RandomState(size + len(kind))
    w = rng.randn(size).astype(np.float32)
    g = (rng.randn(size) * 4).astype(np.float32)
    states = [rng.randn(size).astype(np.float32) * 0.1
              for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
    return w, g, states


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("size", [131, 1024, 5000])
@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_plain_version_matches_jax(kind, size, clip):
    w, g, states = _inputs(kind, size)
    jw, jg = jnp.asarray(w), jnp.asarray(g, jnp.bfloat16)
    jst = tuple(jnp.asarray(s) for s in states)
    tw = torch.from_numpy(w)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tst = tuple(torch.from_numpy(s) for s in states)
    for finite in (1.0, 0.0):
        args = (LR, INV_SCALE, finite)
        got = kernels.slab_update_reference(kind, tw, tg, tst, *args, clip_gradient=clip, **KW)
        ref = pk.slab_update_reference(kind, jw, jg, jst, *args, clip_gradient=clip, **KW)
        pallas = pk.fused_slab_update(kind, jw, jg, jst, *args, clip_gradient=clip,
                                      interpret=True, **KW)
        for want in (ref, pallas):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6,
                                       atol=1e-7)
            assert len(got[1]) == len(want[1]) == len(states)
            for a, b in zip(got[1], want[1]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(got[2].float().numpy(),
                                          np.asarray(want[2].astype(jnp.float32)))
        if finite == 0.0:
            np.testing.assert_array_equal(got[0].numpy(), w)
            for a, s in zip(got[1], states):
                np.testing.assert_array_equal(a.numpy(), s)
            np.testing.assert_array_equal(_bits(got[2]), _bits(tw.to(torch.bfloat16)))


@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_wrapper_on_cpu_tensors_runs_the_plain_version(kind):
    w, g, states = _inputs(kind, 300)
    tw, tg = torch.from_numpy(w), torch.from_numpy(g).to(torch.bfloat16)
    tst = tuple(torch.from_numpy(s) for s in states)
    before = kernels.fused_slab_update.launches
    args = (kind, tw, tg, tst, torch.tensor(LR), torch.tensor(INV_SCALE), torch.tensor(1.0))
    got = kernels.fused_slab_update(*args, clip_gradient=None, **KW)
    want = kernels.slab_update_reference(*args, clip_gradient=None, **KW)
    for a, b in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # in place through out=: master and states overwritten, w16 written
    mw, mst = tw.clone(), tuple(s.clone() for s in tst)
    w16 = torch.empty(300, dtype=torch.bfloat16)
    out = kernels.fused_slab_update(kind, mw, tg, mst, LR, INV_SCALE, 1.0, clip_gradient=None,
                                    out=(mw, mst, w16), **KW)
    assert out[0] is mw and out[2] is w16
    for a, b in zip((mw, *mst, w16), (want[0], *want[1], want[2])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert kernels.fused_slab_update.launches == before


# ---------------------------------------------------------------------------
# a table of slabs: the plain version against JAX entry by entry, the wrapper
# on CPU tensors, and the launch table the kernel walks
# ---------------------------------------------------------------------------
TABLE_SIZES = (1, 7, 131, 1024, 5000)
TABLE_WD = (0.0, 1e-4, 5e-4, 0.0, 1e-3)
STATICS = {k: v for k, v in KW.items() if k != "wd"}


def _table(kind, seed):
    """Ragged numpy slabs, each with its own lr and wd."""
    rng = np.random.RandomState(seed)
    table = []
    for i, size in enumerate(TABLE_SIZES):
        w = rng.randn(size).astype(np.float32)
        g = (rng.randn(size) * 4).astype(np.float32)
        states = [rng.randn(size).astype(np.float32) * 0.1
                  for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
        if kind == "adam":  # the second moment is never negative
            states[1] = np.abs(states[1])
        table.append((w, g, states, 0.01 * (i + 1), TABLE_WD[i]))
    return table


def _entries(table, g_dtype, out=False):
    entries = []
    for w, g, states, lr, wd in table:
        tw = torch.from_numpy(w.copy())
        tst = tuple(torch.from_numpy(s.copy()) for s in states)
        w16 = torch.empty(w.shape[0], dtype=torch.bfloat16)
        entries.append(kernels.SlabEntry(tw, torch.from_numpy(g).to(g_dtype), tst, lr, wd,
                                         (tw, tst, w16) if out else None))
    return entries


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_multi_plain_version_matches_jax_entry_by_entry(kind, g_dtype, clip):
    table = _table(kind, len(kind) + (g_dtype == "float32"))
    tdt, jdt = getattr(torch, g_dtype), getattr(jnp, g_dtype)
    for finite in (1.0, 0.0):
        got = kernels.slab_update_multi_reference(
            kind, _entries(table, tdt), INV_SCALE, finite, clip_gradient=clip, **STATICS)
        assert len(got) == len(table)
        for (w, g, states, lr, wd), res in zip(table, got):
            args = (kind, jnp.asarray(w), jnp.asarray(g, jdt),
                    tuple(jnp.asarray(s) for s in states), lr, INV_SCALE, finite)
            ref = pk.slab_update_reference(*args, wd=wd, clip_gradient=clip, **STATICS)
            pallas = pk.fused_slab_update(*args, wd=wd, clip_gradient=clip, interpret=True,
                                          **STATICS)
            for want in (ref, pallas):
                np.testing.assert_allclose(res[0].numpy(), np.asarray(want[0]), rtol=1e-6,
                                           atol=1e-7)
                assert len(res[1]) == len(want[1]) == len(states)
                for a, b in zip(res[1], want[1]):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
                np.testing.assert_array_equal(res[2].float().numpy(),
                                              np.asarray(want[2].astype(jnp.float32)))
            if finite == 0.0:
                np.testing.assert_array_equal(res[0].numpy(), w)
                for a, s in zip(res[1], states):
                    np.testing.assert_array_equal(a.numpy(), s)
                np.testing.assert_array_equal(
                    _bits(res[2]), _bits(torch.from_numpy(w).to(torch.bfloat16)))


@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_multi_wrapper_on_cpu_tensors_runs_the_plain_version(kind):
    table = _table(kind, 7)
    before = kernels.fused_slab_update.launches
    args = (kind, _entries(table, torch.bfloat16), torch.tensor(INV_SCALE), torch.tensor(1.0))
    got = kernels.fused_slab_update_multi(*args, clip_gradient=None, **STATICS)
    want = kernels.slab_update_multi_reference(*args, clip_gradient=None, **STATICS)
    for r, s in zip(got, want):
        for a, b in zip((r[0], *r[1], r[2]), (s[0], *s[1], s[2])):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # in place through each entry's out: masters and states overwritten
    entries = _entries(table, torch.bfloat16, out=True)
    got = kernels.fused_slab_update_multi(kind, entries, INV_SCALE, 1.0, clip_gradient=None,
                                          **STATICS)
    for e, r, s in zip(entries, got, want):
        assert r[0] is e.out[0] and r[2] is e.out[2]
        assert all(a is b for a, b in zip(r[1], e.states))
        for a, b in zip((e.w, *e.states, e.out[2]), (s[0], *s[1], s[2])):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert kernels.fused_slab_update.launches == before
    assert kernels.fused_slab_update_multi(kind, [], INV_SCALE, 1.0, clip_gradient=None,
                                           **STATICS) == []
    w = torch.zeros(4, device="meta")
    mixed = _entries(table, torch.bfloat16)[:1] + [kernels.SlabEntry(
        w, w.to(torch.bfloat16), tuple(torch.zeros(4, device="meta")
                                       for _ in range(kernels.SLAB_STATE_SLOTS[kind])), 0.1, 0.0)]
    with pytest.raises(MXNetError):
        kernels.fused_slab_update_multi(kind, mixed, INV_SCALE, 1.0, clip_gradient=None,
                                        **STATICS)


def _fake_slab(base, n, offsets, g_bf16, slots):
    """The eight pointers of a slab of ``n`` elements whose operands (w, g,
    states, outs, w16) start ``offsets`` elements past 256-byte-aligned
    bases, as K1's wrapper reads them from tensors (0 for a state the kind
    lacks), and the head the kernel must take: the elements up to the first
    vector boundary where every operand reaches it at one element, else -1."""
    sizes = (4, 2 if g_bf16 else 4, 4, 4, 4, 4, 4, 2)
    used = (True, True, slots > 0, slots > 1, True, slots > 0, slots > 1, True)
    ptrs = tuple(base + 2**20 * j + off * size if u else 0
                 for j, (off, size, u) in enumerate(zip(offsets, sizes, used)))
    first = {off for off, u in zip(offsets, used) if u}
    return ptrs, (min((4 - first.pop()) % 4, n) if len(first) == 1 else -1)


def _walk(launch, grid, itemsizes):
    """The kernel's walk over one launch's table (``slab_update_kernel``):
    each CTA steps through the tiles with a grid stride and moves its entry
    on; an entry's tile 0 also takes its scalar head, a full vector of 4 is
    one access of every operand (which must be 16-byte aligned for f32, 8
    for bf16), a partial one at the entry's end goes scalar. Returns each
    entry's count of updates an element."""
    shared, packed, count, tiles = launch
    fields = _SLAB_SHARED_FIELDS(*kernels._SLAB_SHARED.unpack(shared))
    assert (fields.n_entries, fields.n_tiles) == (count, tiles)
    rows = [_SLAB_ENTRY_FIELDS(*kernels._SLAB_ENTRY.unpack_from(packed, i * 104))
            for i in range(count)]
    done = [np.zeros(r.n, np.int64) for r in rows]
    tid = np.arange(256)
    for cta in range(grid):
        k = 0
        for tile in range(cta, tiles, grid):
            while k + 1 < count and tile >= rows[k + 1].tile0:
                k += 1
            r = rows[k]
            assert r.tile0 <= tile and (k + 1 == count or tile < rows[k + 1].tile0)
            local = tile - r.tile0
            if r.head < 0:
                idx = local * 2048 + np.arange(2048)
                np.add.at(done[k], idx[idx < r.n], 1)
                continue
            if local == 0:
                done[k][:r.head] += 1
            for v in (0, 1):
                idx = r.head + local * 2048 + v * 1024 + 4 * tid
                full = idx[idx + 4 <= r.n]
                for p, size in zip(r[:8], itemsizes):
                    if p:
                        assert not ((p + full * size) % (4 * size)).any()
                for j in range(4):
                    np.add.at(done[k], full + j, 1)
                for i in idx[(idx < r.n) & (idx + 4 > r.n)]:
                    done[k][i:] += 1
    return rows, done


_SLAB_ENTRY_FIELDS = collections.namedtuple(
    "_SLAB_ENTRY_FIELDS", "w g s0 s1 out_w out_s0 out_s1 w16 lr_ptr n tile0 head lr wd has_wd pad")
_SLAB_SHARED_FIELDS = collections.namedtuple(
    "_SLAB_SHARED_FIELDS", "inv_ptr fin_ptr inv fin rescale clip momentum beta1 beta2 omb1 omb2 "
    "eps has_rescale has_clip n_entries n_tiles")


@pytest.mark.parametrize("grid", [1, 5, 528])
@pytest.mark.parametrize("kind,g_bf16", [("sgd_mom", True), ("adam", False), ("sgd", True)])
def test_launch_table_covers_every_element_once(kind, g_bf16, grid):
    """The rows the wrapper packs for a table of ragged slabs at odd
    offsets (aligned, all at one odd offset, operands misaligned against
    each other), and more slabs than one launch takes: each launch's tile
    prefix, and the kernel's walk over them updates every element of every
    slab exactly once, with every vector access aligned."""
    slots = kernels.SLAB_STATE_SLOTS[kind]
    sizes = (1, 2, 3, 5, 7, 2047, 2048, 2049, 5000, 70001)
    offsets = [(0,) * 8, (1,) * 8, (2,) * 8, (3,) * 8, (1, 2, 1, 1, 1, 1, 1, 1),
               (0, 0, 0, 0, 0, 0, 0, 1), (1, 1, 0, 0, 1, 1, 1, 1), (2, 2, 2, 2, 2, 2, 0, 2)]
    rows, lr_ptrs, want_heads = [], [], []
    for i, (n, off) in enumerate(itertools.product(sizes, offsets)):
        ptrs, want_head = _fake_slab(2**32 * (i + 1), n, off, g_bf16, slots)
        head, tiles = kernels._slab_head_tiles(ptrs, n, g_bf16)
        want_heads.append(want_head)
        rows.append([ptrs, n, head, tiles, 0.01 * i, 1e-4 * (i % 3)])
        lr_ptrs.append(0 if i % 2 else 2**40 + 4 * i)
    assert [r[2] for r in rows] == want_heads
    statics = (0, 0, INV_SCALE, 1.0, 1.0, -1.0, 0.9, 0.9, 0.999, 0.1, 0.001, 1e-8, 0, 0)
    launches = kernels._slab_pack(rows, lr_ptrs, statics)
    assert len(launches) == -(-len(rows) // kernels.SLAB_TABLE_CAP) > 1
    itemsizes = (4, 2 if g_bf16 else 4, 4, 4, 4, 4, 4, 2)
    at = 0
    for launch in launches:
        got, done = _walk(launch, min(grid, launch[3]), itemsizes)
        for r, d, row, lr_ptr in zip(got, done, rows[at:], lr_ptrs[at:]):
            assert (d == 1).all()
            assert r[:8] == row[0] and (r.n, r.head) == (row[1], row[2])
            assert r.lr_ptr == lr_ptr and np.float32(r.lr) == np.float32(0.0 if lr_ptr else row[4])
            assert np.float32(r.wd) == np.float32(row[5]) and r.has_wd == (row[5] != 0.0)
        at += len(got)
    assert at == len(rows)
