"""Shape-inference and parameter helpers for operator definitions
(counterpart of ``mxnet_tpu/ops/utils.py``), and the dtype rules the
ported operators share."""
from __future__ import annotations

import numpy as np
import torch

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


def broadcast_shape(lhs, rhs, name="broadcast"):
    """Numpy-style broadcast of two shapes."""
    l, r = list(lhs), list(rhs)
    if len(l) < len(r):
        l = [1] * (len(r) - len(l)) + l
    if len(r) < len(l):
        r = [1] * (len(l) - len(r)) + r
    out = []
    for a, b in zip(l, r):
        if a == b or b == 1:
            out.append(a)
        elif a == 1:
            out.append(b)
        else:
            raise MXNetError("%s: incompatible shapes %s %s" % (name, lhs, rhs))
    return tuple(out)


def binary_broadcast_infer(attrs, in_shapes):
    lhs, rhs = in_shapes
    if lhs is None or rhs is None:
        raise MXNetError("broadcast op: both input shapes required")
    return [tuple(lhs), tuple(rhs)], [broadcast_shape(lhs, rhs)], []


def reduce_out_shape(ishape, axis, keepdims, exclude=False):
    """(output shape, reduced axes) of a reduction over ``axis``."""
    ishape = tuple(ishape)
    ndim = len(ishape)
    if axis is None or axis == () or axis == []:
        axes = tuple(range(ndim))
    else:
        if isinstance(axis, (int, np.integer)):
            axis = (int(axis),)
        axes = tuple(sorted(a % ndim for a in axis))
        if exclude:
            axes = tuple(a for a in range(ndim) if a not in axes)
    if keepdims:
        return tuple(1 if i in axes else d for i, d in enumerate(ishape)), axes
    out = tuple(d for i, d in enumerate(ishape) if i not in axes)
    return out, axes


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


def as_float(x):
    """``x`` itself when floating, else ``x`` as the float jnp promotes it
    to under the JAX package's x64: float64 for int64, float32 for the
    narrower integers and bool (an integer input to sqrt, exp, a mean or a
    true division)."""
    if x.is_floating_point():
        return x
    return x.double() if x.dtype == torch.int64 else x.float()


def scalar_like(value, x):
    """A 0-d tensor of ``value`` in ``x``'s dtype, as
    ``jnp.asarray(scalar, dtype=x.dtype)`` makes it (truncated for an
    integer dtype). It stays on the host: torch takes a 0-d CPU tensor as a
    scalar operand of a CUDA op."""
    return torch.tensor(float(value), dtype=torch.float64).to(x.dtype)
