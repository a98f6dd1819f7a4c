"""Elementwise operators of the PyTorch port (the part of
``mxnet_tpu/ops/elemwise.py`` ResNet needs: ``elemwise_add``, which a
Symbol's ``+`` creates)."""
from __future__ import annotations

from .registry import OpDef, register
from .utils import merge_shapes, same_shape_infer


def elemwise_backward_infer(attrs, in_shapes, out_shapes):
    """Reverse inference for same-shape ops: outputs refine inputs."""
    merged = None
    for s in list(out_shapes) + list(in_shapes):
        merged = merge_shapes(merged, s, "elemwise")
    return [merged] * len(in_shapes)


register(
    OpDef(
        "elemwise_add",
        lambda attrs, ins, is_train: [ins[0] + ins[1]],
        arguments=("lhs", "rhs"),
        infer_shape=same_shape_infer(2),
        backward_infer_shape=elemwise_backward_infer,
        aliases=("_plus", "_add", "_Plus"),
    )
)
