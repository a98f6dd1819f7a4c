"""Creation operators (counterpart of ``mxnet_tpu/ops/init_ops.py``):
_zeros/_ones/_arange/zeros_like/ones_like.

An operator with no input makes its tensor on ``attrs["__device__"]``,
which the imperative layer and the graph program set (the context asked
for, or the device of the graph's inputs)."""
from __future__ import annotations

import numpy as np
import torch

from ..base import np_dtype, torch_dtype
from .registry import OpDef, register
from .utils import as_tuple


def _creation_infer(attrs, in_shapes):
    shape = as_tuple(attrs.get("shape", ()))
    return [], [shape], []


def _creation_type(attrs, in_types):
    return [], [np_dtype(attrs.get("dtype", "float32"))], []


def device_of(attrs):
    """Where an operator without inputs puts its output."""
    return attrs.get("__device__") or torch.device("cpu")


def _register_creation(name, fill):
    register(
        OpDef(
            name,
            lambda attrs, ins, is_train, _v=fill: [
                torch.full(
                    as_tuple(attrs.get("shape", ())),
                    _v,
                    dtype=torch_dtype(attrs.get("dtype", "float32")),
                    device=device_of(attrs),
                )
            ],
            arguments=(),
            defaults={"shape": (), "dtype": "float32"},
            infer_shape=_creation_infer,
            infer_type=_creation_type,
        )
    )


_register_creation("_zeros", 0)
_register_creation("_ones", 1)


def _arange_values(attrs):
    start = float(attrs.get("start", 0.0))
    stop = attrs.get("stop")
    step = float(attrs.get("step", 1.0))
    repeat = int(attrs.get("repeat", 1))
    if stop is None:
        out = np.arange(0.0, start, step)
    else:
        out = np.arange(start, float(stop), step)
    if repeat > 1:
        out = np.repeat(out, repeat)
    return out


def _arange(attrs, ins, is_train):
    out = torch.from_numpy(_arange_values(attrs))
    return [out.to(device_of(attrs), torch_dtype(attrs.get("dtype", "float32")))]


register(
    OpDef(
        "_arange",
        _arange,
        arguments=(),
        defaults={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1, "dtype": "float32"},
        infer_shape=lambda attrs, in_shapes: ([], [(len(_arange_values(attrs)),)], []),
        infer_type=_creation_type,
    )
)

register(
    OpDef(
        "zeros_like",
        lambda attrs, ins, is_train: [torch.zeros_like(ins[0])],
        arguments=("data",),
    )
)
register(
    OpDef(
        "ones_like",
        lambda attrs, ins, is_train: [torch.ones_like(ins[0])],
        arguments=("data",),
    )
)
