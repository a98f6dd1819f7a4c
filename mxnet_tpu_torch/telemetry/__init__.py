"""Telemetry of the PyTorch port: the metrics registry the serving path
instruments against (counterpart of ``mxnet_tpu/telemetry``), and of the
step anatomy only its recompile accounting (``anatomy``: a CUDA-graph
capture on the serving hot path counts as JAX's recompile); spans,
exporters and the rest of anatomy are not ported.

    from mxnet_tpu_torch import telemetry
    telemetry.enable()
    telemetry.histogram("serve.prefill_seconds").percentile(99)
"""
from __future__ import annotations

from . import anatomy  # noqa: F401
from . import registry as _registry
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, REGISTRY,
    counter, gauge, histogram, snapshot, enabled, percentile_from_counts,
)


def enable():
    """Turn collection on."""
    _registry.set_enabled(True)


def disable():
    """Turn collection off."""
    _registry.set_enabled(False)


def reset():
    """Zero all metric values; handles held by instrument sites stay
    registered."""
    _registry.REGISTRY.reset_values()
