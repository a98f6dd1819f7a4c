"""Inference serving of the PyTorch port (counterpart of
``mxnet_tpu/serving``): the continuous-batching request queue over the
predict executor pool (``engine.ServingEngine``, one CUDA-graph replay a
batch on the card), int8 weight quantization (``quant``), the slot-based
KV-cached decode loop whose decode step is one captured CUDA graph
(``decode.GenerationEngine``), and shared shape bucketing (``buckets``)."""
from __future__ import annotations

from . import buckets  # noqa: F401
from . import decode, engine, quant  # noqa: F401
from .decode import GenerationEngine  # noqa: F401
from .engine import ServeClosed, ServingEngine  # noqa: F401

__all__ = ["GenerationEngine", "ServeClosed", "ServingEngine", "buckets", "decode",
           "engine", "quant"]
