"""Shape operators of the PyTorch port (the part of
``mxnet_tpu/ops/matrix.py`` ResNet needs: ``Flatten``)."""
from __future__ import annotations

import numpy as np

from .registry import OpDef, register

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
