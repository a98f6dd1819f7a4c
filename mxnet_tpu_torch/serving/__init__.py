"""Inference serving of the PyTorch port (counterpart of
``mxnet_tpu/serving``): the slot-based KV-cached decode loop
(``decode.GenerationEngine``) and shared shape bucketing (``buckets``).
The Symbol-predictor ``ServingEngine`` and int8 quantisation are not
ported yet."""
from __future__ import annotations

from . import buckets  # noqa: F401
from .decode import GenerationEngine  # noqa: F401
from .engine import ServeClosed  # noqa: F401
