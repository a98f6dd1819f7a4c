"""Shape bucketing (a copy of ``mxnet_tpu/serving/buckets.py``).

The smallest-covering-bucket discipline: a few static shapes, each
request padded up to the smallest bucket that covers it. The generation
engine picks its prefill (count, length) buckets with it. Pure
numpy/bisect.
"""
from __future__ import annotations

import bisect

import numpy as np


def bucket_ladder(cap, base=1):
    """Powers-of-two ladder up to and including ``cap``:
    bucket_ladder(8) -> [1, 2, 4, 8]; a non-power cap is appended so
    the ladder always covers it (bucket_ladder(6) -> [1, 2, 4, 6])."""
    if cap < 1:
        raise ValueError("bucket ladder cap must be >= 1, got %r" % (cap,))
    ladder = []
    b = max(1, base)
    while b < cap:
        ladder.append(b)
        b *= 2
    ladder.append(cap)
    return ladder


def smallest_covering(buckets, size):
    """Index of the smallest bucket >= size, or None if nothing covers.

    ``buckets`` must be sorted ascending. This is THE bucket-selection
    rule: the same bisect both BucketSentenceIter and the serving
    queue apply."""
    slot = bisect.bisect_left(buckets, size)
    if slot == len(buckets):
        return None
    return slot


def covering_value(buckets, size):
    """The smallest bucket value >= size, or None."""
    slot = smallest_covering(buckets, size)
    return None if slot is None else buckets[slot]


def pad_to_width(row, width, fill):
    """Pad a 1-D sequence into a fixed-width numpy row (training-side
    sentence padding)."""
    row = np.asarray(row)
    out = np.full((width,), fill, dtype=row.dtype)
    out[: len(row)] = row
    return out


def pad_batch(rows, bucket_batch, fill=0):
    """Stack per-request arrays (each ``[feature...]``, no batch axis)
    into a ``[bucket_batch, feature...]`` array, padding the trailing
    rows with ``fill`` (serving-side batch coalescing). Returns the
    padded array; callers slice the first ``len(rows)`` outputs back."""
    if not rows:
        raise ValueError("pad_batch needs at least one row")
    first = np.asarray(rows[0])
    if len(rows) > bucket_batch:
        raise ValueError(
            "pad_batch: %d rows exceed bucket batch %d"
            % (len(rows), bucket_batch))
    out = np.full((bucket_batch,) + first.shape, fill, dtype=first.dtype)
    for i, r in enumerate(rows):
        r = np.asarray(r)
        if r.shape != first.shape or r.dtype != first.dtype:
            raise ValueError(
                "pad_batch: row %d shape/dtype %s/%s differs from row 0 "
                "%s/%s" % (i, r.shape, r.dtype, first.shape, first.dtype))
        out[i] = r
    return out


def scatter_rows(batched, n):
    """Inverse of pad_batch: split the first ``n`` rows of each output
    array back out per request. ``batched`` is a list of
    ``[bucket_batch, ...]`` arrays; returns a list of n per-request
    lists."""
    return [[np.asarray(o)[i] for o in batched] for i in range(n)]
