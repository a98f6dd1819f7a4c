"""Index / gather / ordering operators (counterpart of
``mxnet_tpu/ops/indexing.py``): take, batch_take, Embedding, one_hot, pick,
sort, argsort, topk.

Indices arrive as floats, as in MXNet, and are truncated to integers.
``take`` clips (or wraps) out-of-range indices as jnp.take's modes do;
``one_hot`` is all zeros for an index outside [0, depth), as
``jax.nn.one_hot`` is. Sorts are stable, as jnp's are, so equal keys keep
their order and index outputs agree.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, torch_dtype
from .registry import OpDef, register


def _index(t):
    return t.to(torch.int32).long()


# --------------------------------------------------------------------------
# take / batch_take / Embedding
# --------------------------------------------------------------------------
def _take(attrs, ins, is_train):
    a, idx = ins
    axis = int(attrs.get("axis", 0)) % a.dim()
    mode = attrs.get("mode", "clip")
    n = a.shape[axis]
    i = _index(idx)
    if mode == "clip":
        i = i.clamp(0, n - 1)
    elif mode == "wrap":
        i = torch.remainder(i, n)
    else:
        raise MXNetError("take: unsupported mode %s" % mode)
    out = torch.index_select(a, axis, i.reshape(-1))
    return [out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape) + tuple(a.shape[axis + 1:]))]


def _take_infer(attrs, in_shapes):
    a, idx = in_shapes
    if a is None or idx is None:
        raise MXNetError("take: both shapes required")
    axis = int(attrs.get("axis", 0))
    out = tuple(a[:axis]) + tuple(idx) + tuple(a[axis + 1:])
    return [tuple(a), tuple(idx)], [out], []


register(
    OpDef(
        "take",
        _take,
        arguments=("a", "indices"),
        defaults={"axis": 0, "mode": "clip"},
        infer_shape=_take_infer,
    )
)


def _batch_take(attrs, ins, is_train):
    a, idx = ins
    return [torch.gather(a, 1, _index(idx)[:, None])[:, 0]]


register(
    OpDef(
        "batch_take",
        _batch_take,
        arguments=("a", "indices"),
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0]), tuple(in_shapes[1])],
            [tuple(in_shapes[1])],
            [],
        ),
    )
)


def _embedding(attrs, ins, is_train):
    data, weight = ins
    return [weight[_index(data)]]


def _embedding_infer(attrs, in_shapes):
    dshape, wshape = in_shapes
    if dshape is None:
        raise MXNetError("Embedding: data shape required")
    inp = int(attrs["input_dim"])
    out = int(attrs["output_dim"])
    wshape = (inp, out)
    return [tuple(dshape), wshape], [tuple(dshape) + (out,)], []


register(
    OpDef(
        "Embedding",
        _embedding,
        arguments=("data", "weight"),
        defaults={"input_dim": 0, "output_dim": 0},
        infer_shape=_embedding_infer,
    )
)


# --------------------------------------------------------------------------
# one_hot / pick
# --------------------------------------------------------------------------
def _one_hot(attrs, ins, is_train):
    depth = int(attrs["depth"])
    on = float(attrs.get("on_value", 1.0))
    off = float(attrs.get("off_value", 0.0))
    i = _index(ins[0])
    oh = (i.unsqueeze(-1) == torch.arange(depth, device=i.device)).double()
    return [(oh * (on - off) + off).to(torch_dtype(attrs.get("dtype", "float32")))]


register(
    OpDef(
        "one_hot",
        _one_hot,
        arguments=("indices",),
        defaults={"depth": 1, "on_value": 1.0, "off_value": 0.0, "dtype": "float32"},
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0])],
            [tuple(in_shapes[0]) + (int(attrs["depth"]),)],
            [],
        ),
    )
)


def _pick_axis(attrs, ndim):
    axis = attrs.get("axis", -1)
    axis = int(axis) if axis is not None else -1
    return axis % ndim


def _pick(attrs, ins, is_train):
    data, index = ins
    axis = _pick_axis(attrs, data.dim())
    out = torch.gather(data, axis, _index(index).unsqueeze(axis))
    if not bool(attrs.get("keepdims", False)):
        out = out.squeeze(axis)
    return [out]


def _pick_infer(attrs, in_shapes):
    dshape = list(in_shapes[0])
    axis = _pick_axis(attrs, len(dshape))
    ishape = dshape[:axis] + dshape[axis + 1:]
    out = list(dshape)
    if bool(attrs.get("keepdims", False)):
        out[axis] = 1
    else:
        out = ishape
    return [tuple(in_shapes[0]), tuple(ishape)], [tuple(out)], []


register(
    OpDef(
        "pick",
        _pick,
        arguments=("data", "index"),
        defaults={"axis": -1, "keepdims": False},
        infer_shape=_pick_infer,
        aliases=("choose_element_0index",),
    )
)


# --------------------------------------------------------------------------
# sort / argsort / topk (reference ordering_op.cc)
# --------------------------------------------------------------------------
def _sort_input(attrs, x):
    """(x, axis): flattened with axis 0 when attrs' axis is None."""
    axis = attrs.get("axis", -1)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis) % x.dim()


def _sort(attrs, ins, is_train):
    x, axis = _sort_input(attrs, ins[0])
    out = torch.sort(x, dim=axis, stable=True).values
    if not bool(attrs.get("is_ascend", True)):
        out = torch.flip(out, (axis,))
    return [out]


register(
    OpDef(
        "sort",
        _sort,
        arguments=("data",),
        defaults={"axis": -1, "is_ascend": True},
    )
)


def _argsort(attrs, ins, is_train):
    x, axis = _sort_input(attrs, ins[0])
    out = torch.argsort(x, dim=axis, stable=True)
    if not bool(attrs.get("is_ascend", True)):
        out = torch.flip(out, (axis,))
    return [out.to(ins[0].dtype)]


register(
    OpDef(
        "argsort",
        _argsort,
        arguments=("data",),
        defaults={"axis": -1, "is_ascend": True},
    )
)


def _topk_out_shapes(attrs, ishape):
    axis = attrs.get("axis", -1)
    axis = len(ishape) - 1 if axis is None else int(axis) % len(ishape)
    k = int(attrs.get("k", 1))
    ret_typ = attrs.get("ret_typ", "indices")
    s = list(ishape)
    if ret_typ != "mask":
        s[axis] = k
    n_out = 2 if ret_typ == "both" else 1
    return [tuple(s)] * n_out, axis, k, ret_typ


def _topk(attrs, ins, is_train):
    _, axis, k, ret_typ = _topk_out_shapes(attrs, ins[0].shape)
    x = ins[0]
    key = x if bool(attrs.get("is_ascend", False)) else -x
    idx = torch.argsort(key, dim=axis, stable=True).narrow(axis, 0, k)
    vals = torch.gather(x, axis, idx)
    if ret_typ == "value":
        return [vals]
    if ret_typ == "indices":
        return [idx.to(x.dtype)]
    if ret_typ == "mask":
        return [torch.zeros_like(x).scatter(axis, idx, torch.ones_like(vals))]
    return [vals, idx.to(x.dtype)]


def _topk_infer(attrs, in_shapes):
    out_shapes, _, _, _ = _topk_out_shapes(attrs, in_shapes[0])
    return [tuple(in_shapes[0])], out_shapes, []


_topk_def = OpDef(
    "topk",
    _topk,
    arguments=("data",),
    defaults={"axis": -1, "k": 1, "ret_typ": "indices", "is_ascend": False},
    infer_shape=_topk_infer,
)
_topk_def.list_outputs = lambda attrs=None: (
    ["value", "indices"]
    if (attrs or {}).get("ret_typ") == "both"
    else ["output"]
)
register(_topk_def)
