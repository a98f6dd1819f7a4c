"""Shape-inference and parameter helpers for operator definitions (the
part of ``mxnet_tpu/ops/utils.py`` the ported operators use)."""
from __future__ import annotations

import numpy as np

from ..base import MXNetError


def as_tuple(v, n=None, name="param"):
    """Normalize an int-or-tuple param to a tuple (kernel=(2,2) style)."""
    if v is None:
        return None
    if isinstance(v, (int, np.integer)):
        v = (int(v),) * (n or 1)
    v = tuple(int(x) for x in v)
    if n is not None and len(v) != n:
        raise MXNetError("%s must have %d elements, got %s" % (name, n, (v,)))
    return v


def merge_shapes(a, b, name="shape"):
    """Dim-wise merge with MXNet's 0-means-unknown convention."""
    if a is None:
        return tuple(b) if b is not None else None
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        raise MXNetError("%s: rank mismatch %s vs %s" % (name, a, b))
    out = []
    for x, y in zip(a, b):
        if x == 0:
            out.append(y)
        elif y == 0 or x == y:
            out.append(x)
        else:
            raise MXNetError("%s: incompatible %s vs %s" % (name, a, b))
    return tuple(out)


def shape_known(s):
    return s is not None and all(d > 0 for d in s)


def same_shape_infer(n_in, n_out=1):
    """All inputs and outputs share one shape (elemwise), merging partial
    shapes (0 = unknown) dim by dim."""

    def infer(attrs, in_shapes):
        merged = None
        for s in in_shapes:
            merged = merge_shapes(merged, s, "elemwise")
        if merged is None:
            raise MXNetError("cannot infer shape: all inputs unknown")
        return [merged] * len(in_shapes), [merged] * n_out, []

    return infer
