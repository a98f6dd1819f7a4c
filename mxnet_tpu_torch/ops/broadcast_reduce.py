"""Reductions and broadcast-shape operators (counterpart of
``mxnet_tpu/ops/broadcast_reduce.py``): sum/mean/prod/nansum/nanprod/max/
min, norm, argmax/argmin/argmax_channel, broadcast_to/broadcast_axis.

Integer sums and products widen to int64 and an integer mean is float64,
as jnp's are under x64; argmax/argmin return the index in the input's
dtype, the first of equal maxima.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import OpDef, register
from .utils import as_float, reduce_out_shape


def _reduce_infer(attrs, in_shapes):
    ishape = in_shapes[0]
    if ishape is None:
        raise MXNetError("reduce op: input shape required")
    out, _ = reduce_out_shape(
        ishape,
        attrs.get("axis"),
        bool(attrs.get("keepdims", False)),
        bool(attrs.get("exclude", False)),
    )
    return [tuple(ishape)], [out], []


def _sum(x, axes, keepdims):
    return torch.sum(x, dim=axes, keepdim=keepdims)


def _mean(x, axes, keepdims):
    return torch.mean(as_float(x), dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _nansum(x, axes, keepdims):
    if not x.is_floating_point():
        return _sum(x, axes, keepdims)
    return torch.nansum(x, dim=axes, keepdim=keepdims)


def _nanprod(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


def _amax(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims)


def _amin(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims)


def _register_reduce(name, fn, aliases=()):
    def fcompute(attrs, ins, is_train, _fn=fn):
        _, axes = reduce_out_shape(
            ins[0].shape,
            attrs.get("axis"),
            False,
            bool(attrs.get("exclude", False)),
        )
        x = ins[0]
        if not axes:  # nothing to reduce: jnp returns the input
            return [_fn(x.unsqueeze(0), (0,), False)]
        return [_fn(x, axes, bool(attrs.get("keepdims", False)))]

    register(
        OpDef(
            name,
            fcompute,
            arguments=("data",),
            defaults={"axis": None, "keepdims": False, "exclude": False},
            infer_shape=_reduce_infer,
            aliases=aliases,
        )
    )


_register_reduce("sum", _sum, aliases=("sum_axis",))
_register_reduce("mean", _mean)
_register_reduce("prod", _prod)
_register_reduce("nansum", _nansum)
_register_reduce("nanprod", _nanprod)
_register_reduce("max", _amax, aliases=("max_axis",))
_register_reduce("min", _amin, aliases=("min_axis",))


# norm: reference flattens to a scalar L2 norm (broadcast_reduce_op_value.cc)
register(
    OpDef(
        "norm",
        lambda attrs, ins, is_train: [
            torch.sqrt(torch.sum(torch.square(ins[0].float()))).to(ins[0].dtype)
        ],
        arguments=("data",),
        infer_shape=lambda attrs, in_shapes: ([tuple(in_shapes[0])], [(1,)], []),
    )
)


def _argminmax(fn):
    def fcompute(attrs, ins, is_train, _fn=fn):
        axis = attrs.get("axis")
        keepdims = bool(attrs.get("keepdims", False))
        x = ins[0]
        if axis is None:
            out = _fn(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * x.dim())
        else:
            out = _fn(x, dim=int(axis), keepdim=keepdims)
        return [out.to(x.dtype)]

    return fcompute


def _argminmax_infer(attrs, in_shapes):
    ishape = in_shapes[0]
    if ishape is None:
        raise MXNetError("argmax/argmin: input shape required")
    axis = attrs.get("axis")
    keepdims = bool(attrs.get("keepdims", False))
    if axis is None:
        out = (1,) * len(ishape) if keepdims else ()
    else:
        out, _ = reduce_out_shape(ishape, int(axis), keepdims)
    return [tuple(ishape)], [out if out else (1,)], []


for _nm, _f in [("argmax", torch.argmax), ("argmin", torch.argmin)]:
    register(
        OpDef(
            _nm,
            _argminmax(_f),
            arguments=("data",),
            defaults={"axis": None, "keepdims": False},
            infer_shape=_argminmax_infer,
        )
    )

# argmax_channel: argmax over axis 1 keeping batch (reference: used by Accuracy)
register(
    OpDef(
        "argmax_channel",
        lambda attrs, ins, is_train: [torch.argmax(ins[0], dim=1).to(ins[0].dtype)],
        arguments=("data",),
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0])],
            [(in_shapes[0][0],) + tuple(in_shapes[0][2:])],
            [],
        ),
    )
)


# --------------------------------------------------------------------------
# broadcast_to / broadcast_axis
# --------------------------------------------------------------------------
def _broadcast_to_infer(attrs, in_shapes):
    ishape = in_shapes[0]
    tgt = tuple(int(d) for d in attrs["shape"])
    if ishape is None:
        raise MXNetError("broadcast_to: input shape required")
    out = tuple(t if t != 0 else s for t, s in zip(tgt, ishape))
    for s, o in zip(ishape, out):
        if s != o and s != 1:
            raise MXNetError("broadcast_to: cannot broadcast %s to %s" % (ishape, tgt))
    return [tuple(ishape)], [out], []


def _broadcast_to(attrs, ins, is_train):
    tgt = tuple(int(d) for d in attrs["shape"])
    out = tuple(t if t != 0 else s for t, s in zip(tgt, ins[0].shape))
    return [torch.broadcast_to(ins[0], out)]


register(
    OpDef(
        "broadcast_to",
        _broadcast_to,
        arguments=("data",),
        defaults={"shape": ()},
        infer_shape=_broadcast_to_infer,
    )
)


def _axis_sizes(attrs):
    axes = attrs.get("axis", ())
    sizes = attrs.get("size", ())
    if isinstance(axes, (int, np.integer)):
        axes = (axes,)
    if isinstance(sizes, (int, np.integer)):
        sizes = (sizes,)
    return axes, sizes


def _broadcast_axis(attrs, ins, is_train):
    out = list(ins[0].shape)
    for a, s in zip(*_axis_sizes(attrs)):
        out[int(a)] = int(s)
    return [torch.broadcast_to(ins[0], tuple(out))]


def _broadcast_axis_infer(attrs, in_shapes):
    ishape = list(in_shapes[0])
    for a, s in zip(*_axis_sizes(attrs)):
        ishape[int(a)] = int(s)
    return [tuple(in_shapes[0])], [tuple(ishape)], []


register(
    OpDef(
        "broadcast_axis",
        _broadcast_axis,
        arguments=("data",),
        defaults={"axis": (), "size": ()},
        infer_shape=_broadcast_axis_infer,
        aliases=("broadcast_axes",),
    )
)
