"""Matrix / layout / slicing operators (counterpart of
``mxnet_tpu/ops/matrix.py``): Reshape with MXNet's 0/-1/-2/-3/-4 codes,
Flatten, transpose, expand_dims, SwapAxis, dot, batch_dot, slice,
slice_axis, clip, repeat, tile, reverse, Concat, SliceChannel, Pad and
where.

dot and batch_dot give an f32 result cast to the inputs' result type, as
the JAX package's ``preferred_element_type=float32`` does (so float64
products are rounded to f32 on the way, there as here). View-returning
ops (Reshape, transpose, slice, ...) may alias their input; the
imperative layer copies such results before handing them out.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, register
from .registry import get as _get_op
from .utils import as_tuple


# --------------------------------------------------------------------------
# Reshape with MXNet special codes (reference matrix_op-inl.h ReshapeParam)
# --------------------------------------------------------------------------
def _infer_reshape_target(ishape, target):
    ishape = tuple(ishape)
    if not target:
        raise MXNetError("Reshape: shape attr required")
    out = []
    src = list(ishape)
    i = 0  # index into src
    t = 0
    target = list(target)
    while t < len(target):
        d = target[t]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1  # placeholder; fixed below
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = target[t + 1], target[t + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            t += 2
        else:
            out.append(int(d))
            i += 1
        t += 1
    if out.count(-1) > 1:
        raise MXNetError("Reshape: more than one -1")
    if -1 in out:
        knownprod = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(ishape)) if ishape else 1
        out[out.index(-1)] = total // knownprod
    if int(np.prod(out) if out else 1) != int(np.prod(ishape) if ishape else 1):
        raise MXNetError("Reshape: size mismatch %s -> %s" % (ishape, out))
    return tuple(out)


def _reshape_target(attrs):
    tgt = attrs.get("shape") or attrs.get("target_shape")
    if isinstance(tgt, (int, np.integer)):
        tgt = (int(tgt),)
    return tgt


def _reshape_infer(attrs, in_shapes):
    ishape = in_shapes[0]
    if ishape is None:
        raise MXNetError("Reshape: input shape required")
    return [tuple(ishape)], [_infer_reshape_target(ishape, _reshape_target(attrs))], []


register(
    OpDef(
        "Reshape",
        lambda attrs, ins, is_train: [
            ins[0].reshape(_infer_reshape_target(ins[0].shape, _reshape_target(attrs)))],
        arguments=("data",),
        defaults={"shape": None},
        infer_shape=_reshape_infer,
        aliases=("reshape",),
    )
)

register(
    OpDef(
        "Flatten",
        lambda attrs, ins, is_train: [ins[0].reshape(ins[0].shape[0], -1)],
        arguments=("data",),
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0])],
            [(in_shapes[0][0], int(np.prod(in_shapes[0][1:])))],
            [],
        ),
        aliases=("flatten",),
    )
)


# --------------------------------------------------------------------------
# transpose / expand_dims / SwapAxis
# --------------------------------------------------------------------------
def _transpose(attrs, ins, is_train):
    axes = attrs.get("axes") or tuple(reversed(range(ins[0].dim())))
    return [ins[0].permute(*axes)]


def _transpose_infer(attrs, in_shapes):
    ishape = in_shapes[0]
    axes = attrs.get("axes") or tuple(reversed(range(len(ishape))))
    return [tuple(ishape)], [tuple(ishape[a] for a in axes)], []


register(
    OpDef(
        "transpose",
        _transpose,
        arguments=("data",),
        defaults={"axes": ()},
        infer_shape=_transpose_infer,
    )
)


def _expand_axis(attrs, ndim):
    return int(attrs["axis"]) % (ndim + 1)


register(
    OpDef(
        "expand_dims",
        lambda attrs, ins, is_train: [
            ins[0].unsqueeze(_expand_axis(attrs, ins[0].dim()))],
        arguments=("data",),
        defaults={"axis": 0},
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0])],
            [
                tuple(
                    list(in_shapes[0])[: _expand_axis(attrs, len(in_shapes[0]))]
                    + [1]
                    + list(in_shapes[0])[_expand_axis(attrs, len(in_shapes[0])):]
                )
            ],
            [],
        ),
    )
)


def _swapaxis_infer(attrs, in_shapes):
    s = list(in_shapes[0])
    a, b = int(attrs.get("dim1", 0)), int(attrs.get("dim2", 0))
    s[a], s[b] = s[b], s[a]
    return [tuple(in_shapes[0])], [tuple(s)], []


register(
    OpDef(
        "SwapAxis",
        lambda attrs, ins, is_train: [
            torch.swapaxes(ins[0], int(attrs.get("dim1", 0)), int(attrs.get("dim2", 0)))
        ],
        arguments=("data",),
        defaults={"dim1": 0, "dim2": 0},
        infer_shape=_swapaxis_infer,
        aliases=("swapaxes",),
    )
)


# --------------------------------------------------------------------------
# dot / batch_dot
# --------------------------------------------------------------------------
def _result_type(a, b):
    return torch.promote_types(a.dtype, b.dtype)


def _accumulate(a, b, product):
    """``product`` of a and b as the JAX package computes it
    (``preferred_element_type=float32``): an f32 result — from f32 inputs,
    or f64 ones for float64 — cast to the inputs' result type."""
    out_t = _result_type(a, b)
    if out_t == torch.float64:
        return product(a.double(), b.double()).float().to(out_t)
    return product(a.float(), b.float()).to(out_t)


def _dot(attrs, ins, is_train):
    a, b = ins
    if attrs.get("transpose_a"):
        a = a.permute(*reversed(range(a.dim())))
    if attrs.get("transpose_b"):
        b = b.permute(*reversed(range(b.dim())))
    if a.dim() == 1 and b.dim() == 1:
        out_t = _result_type(a, b)
        return [torch.dot(a.to(out_t), b.to(out_t)).reshape(1)]
    return [_accumulate(a, b, lambda x, y: torch.tensordot(x, y, dims=1))]


def _dot_infer(attrs, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        raise MXNetError("dot: both input shapes required")
    a = tuple(reversed(a)) if attrs.get("transpose_a") else tuple(a)
    b = tuple(reversed(b)) if attrs.get("transpose_b") else tuple(b)
    if len(a) == 1 and len(b) == 1:
        out = (1,)
    else:
        if a[-1] != b[0]:
            raise MXNetError("dot: shape mismatch %s %s" % (in_shapes[0], in_shapes[1]))
        out = a[:-1] + b[1:]
    return [tuple(in_shapes[0]), tuple(in_shapes[1])], [out], []


register(
    OpDef(
        "dot",
        _dot,
        arguments=("lhs", "rhs"),
        defaults={"transpose_a": False, "transpose_b": False},
        infer_shape=_dot_infer,
    )
)


def _batch_dot(attrs, ins, is_train):
    a, b = ins
    if attrs.get("transpose_a"):
        a = torch.swapaxes(a, -1, -2)
    if attrs.get("transpose_b"):
        b = torch.swapaxes(b, -1, -2)
    return [_accumulate(a, b, torch.matmul)]


def _batch_dot_infer(attrs, in_shapes):
    a, b = [list(s) for s in in_shapes]
    if attrs.get("transpose_a"):
        a[-1], a[-2] = a[-2], a[-1]
    if attrs.get("transpose_b"):
        b[-1], b[-2] = b[-2], b[-1]
    if a[-1] != b[-2] or a[:-2] != b[:-2]:
        raise MXNetError("batch_dot: shape mismatch %s %s" % tuple(in_shapes))
    return (
        [tuple(in_shapes[0]), tuple(in_shapes[1])],
        [tuple(a[:-1] + [b[-1]])],
        [],
    )


register(
    OpDef(
        "batch_dot",
        _batch_dot,
        arguments=("lhs", "rhs"),
        defaults={"transpose_a": False, "transpose_b": False},
        infer_shape=_batch_dot_infer,
    )
)


# --------------------------------------------------------------------------
# slice / slice_axis / clip / repeat / tile / reverse
# --------------------------------------------------------------------------
def _norm_begin_end(shape, begin, end):
    begin = list(begin)
    end = list(end)
    out_b, out_e = [], []
    for i, dim in enumerate(shape):
        b = begin[i] if i < len(begin) and begin[i] is not None else 0
        e = end[i] if i < len(end) and end[i] is not None else dim
        if b < 0:
            b += dim
        if e < 0:
            e += dim
        out_b.append(int(b))
        out_e.append(int(e if e < dim else dim))
    return out_b, out_e


def _slice(attrs, ins, is_train):
    b, e = _norm_begin_end(ins[0].shape, attrs["begin"], attrs["end"])
    idx = tuple(slice(bb, ee) for bb, ee in zip(b, e))
    return [ins[0][idx]]


def _slice_infer(attrs, in_shapes):
    b, e = _norm_begin_end(in_shapes[0], attrs["begin"], attrs["end"])
    return (
        [tuple(in_shapes[0])],
        [tuple(ee - bb for bb, ee in zip(b, e))],
        [],
    )


register(
    OpDef(
        "slice",
        _slice,
        arguments=("data",),
        defaults={"begin": (), "end": ()},
        infer_shape=_slice_infer,
        aliases=("crop",),
    )
)


def _axis_range(attrs, dim):
    b = int(attrs.get("begin", 0))
    e = attrs.get("end")
    e = dim if e is None else int(e)
    if b < 0:
        b += dim
    if e < 0:
        e += dim
    return b, e


def _slice_axis(attrs, ins, is_train):
    ax = int(attrs["axis"])
    b, e = _axis_range(attrs, ins[0].shape[ax])
    idx = [slice(None)] * ins[0].dim()
    idx[ax] = slice(b, e)
    return [ins[0][tuple(idx)]]


def _slice_axis_infer(attrs, in_shapes):
    s = list(in_shapes[0])
    ax = int(attrs["axis"])
    b, e = _axis_range(attrs, s[ax])
    s[ax] = e - b
    return [tuple(in_shapes[0])], [tuple(s)], []


register(
    OpDef(
        "slice_axis",
        _slice_axis,
        arguments=("data",),
        defaults={"axis": 0, "begin": 0, "end": None},
        infer_shape=_slice_axis_infer,
    )
)

register(
    OpDef(
        "clip",
        lambda attrs, ins, is_train: [
            torch.clamp(ins[0], float(attrs["a_min"]), float(attrs["a_max"]))
        ],
        arguments=("data",),
        defaults={"a_min": 0.0, "a_max": 1.0},
    )
)


def _repeat(attrs, ins, is_train):
    ax = attrs.get("axis")
    reps = int(attrs["repeats"])
    if ax is None:
        return [torch.repeat_interleave(ins[0].reshape(-1), reps)]
    return [torch.repeat_interleave(ins[0], reps, dim=int(ax))]


def _repeat_infer(attrs, in_shapes):
    ax = attrs.get("axis")
    reps = int(attrs["repeats"])
    if ax is None:
        out = (int(np.prod(in_shapes[0])) * reps,)
    else:
        s = list(in_shapes[0])
        s[int(ax)] *= reps
        out = tuple(s)
    return [tuple(in_shapes[0])], [out], []


register(
    OpDef(
        "repeat",
        _repeat,
        arguments=("data",),
        defaults={"repeats": 1, "axis": None},
        infer_shape=_repeat_infer,
    )
)


def _tile_infer(attrs, in_shapes):
    reps = as_tuple(attrs["reps"])
    s = list(in_shapes[0])
    if len(reps) < len(s):
        reps = (1,) * (len(s) - len(reps)) + reps
    if len(s) < len(reps):
        s = [1] * (len(reps) - len(s)) + s
    return [tuple(in_shapes[0])], [tuple(a * b for a, b in zip(s, reps))], []


register(
    OpDef(
        "tile",
        lambda attrs, ins, is_train: [torch.tile(ins[0], as_tuple(attrs["reps"]))],
        arguments=("data",),
        defaults={"reps": (1,)},
        infer_shape=_tile_infer,
    )
)

register(
    OpDef(
        "reverse",
        lambda attrs, ins, is_train: [torch.flip(ins[0], as_tuple(attrs["axis"]))],
        arguments=("data",),
        defaults={"axis": (0,)},
        aliases=("flip",),
    )
)


# --------------------------------------------------------------------------
# Concat / SliceChannel (multi-in / multi-out layer ops)
# --------------------------------------------------------------------------
def _concat_infer(attrs, in_shapes):
    dim = int(attrs.get("dim", 1))
    known = [s for s in in_shapes if s is not None]
    if not known:
        raise MXNetError("Concat: need at least one known shape")
    base = list(known[0])
    total = 0
    completed = []
    for s in in_shapes:
        if s is None:
            raise MXNetError("Concat: all input shapes required")
        total += s[dim]
        completed.append(tuple(s))
    out = list(base)
    out[dim] = total
    return completed, [tuple(out)], []


register(
    OpDef(
        "Concat",
        lambda attrs, ins, is_train: [torch.cat(list(ins), dim=int(attrs.get("dim", 1)))],
        arguments=("data",),
        key_var_num_args="num_args",
        defaults={"dim": 1, "num_args": 1},
        infer_shape=_concat_infer,
        aliases=("concat",),
    )
)


def _slice_channel(attrs, ins, is_train):
    n = int(attrs["num_outputs"])
    ax = int(attrs.get("axis", 1))
    parts = list(torch.chunk(ins[0], n, dim=ax))
    if attrs.get("squeeze_axis"):
        parts = [p.squeeze(ax) for p in parts]
    return parts


def _slice_channel_infer(attrs, in_shapes):
    n = int(attrs["num_outputs"])
    ax = int(attrs.get("axis", 1))
    s = list(in_shapes[0])
    if s[ax] % n != 0:
        raise MXNetError("SliceChannel: axis %d (%d) not divisible by %d" % (ax, s[ax], n))
    s[ax] //= n
    if attrs.get("squeeze_axis"):
        if s[ax] != 1:
            raise MXNetError("SliceChannel: squeeze_axis needs size-1 result")
        s = s[:ax] + s[ax + 1:]
    return [tuple(in_shapes[0])], [tuple(s)] * n, []


register(
    OpDef(
        "SliceChannel",
        _slice_channel,
        arguments=("data",),
        outputs=("output",),  # dynamic count via list_outputs override below
        defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False},
        infer_shape=_slice_channel_infer,
        aliases=("split",),
    )
)


def _slice_channel_outputs(attrs=None):
    n = int((attrs or {}).get("num_outputs", 1))
    return ["output%d" % i for i in range(n)]


_get_op("SliceChannel").list_outputs = _slice_channel_outputs


# --------------------------------------------------------------------------
# Pad (reference pad.cc) — NCHW/NCDHW edge/constant/reflect padding
# --------------------------------------------------------------------------
def _pad(attrs, ins, is_train):
    pw = as_tuple(attrs["pad_width"])
    mode = attrs.get("mode", "constant")
    x = ins[0]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        # F.pad lists the last dim first
        flat = [p for pair in reversed(pairs) for p in pair]
        return [F.pad(x, flat, value=float(attrs.get("constant_value", 0.0)))]
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %s" % mode)
    # F.pad's edge/reflect modes pad the trailing spatial dims of an
    # (N, C, ...) input; the JAX package pads N and C with zero width too
    if any(pairs[i] != (0, 0) for i in range(2)):
        raise MXNetError("Pad: %s mode pads only the spatial dims" % mode)
    flat = [p for pair in reversed(pairs[2:]) for p in pair]
    return [F.pad(x, flat, mode="replicate" if mode == "edge" else "reflect")]


def _pad_infer(attrs, in_shapes):
    pw = as_tuple(attrs["pad_width"])
    s = list(in_shapes[0])
    out = [d + pw[2 * i] + pw[2 * i + 1] for i, d in enumerate(s)]
    return [tuple(in_shapes[0])], [tuple(out)], []


register(
    OpDef(
        "Pad",
        _pad,
        arguments=("data",),
        defaults={"mode": "constant", "pad_width": (), "constant_value": 0.0},
        infer_shape=_pad_infer,
        aliases=("pad",),
    )
)


# --------------------------------------------------------------------------
# where (reference control_flow_op.cc)
# --------------------------------------------------------------------------
def _where_infer(attrs, in_shapes):
    cond, x, y = in_shapes
    shp = tuple(x if x is not None else y)
    return [tuple(cond) if cond else shp, shp, shp], [shp], []


def _where(attrs, ins, is_train):
    cond, x, y = ins
    mask = cond != 0
    if cond.dim() != x.dim():
        mask = mask.reshape(tuple(cond.shape) + (1,) * (x.dim() - cond.dim()))
    return [torch.where(mask, x, y)]


register(
    OpDef(
        "where",
        _where,
        arguments=("condition", "x", "y"),
        infer_shape=_where_infer,
    )
)
