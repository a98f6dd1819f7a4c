"""Telemetry of the PyTorch port: the metrics registry the serving path
instruments against (counterpart of ``mxnet_tpu/telemetry``; spans,
exporters and the step-anatomy recompile detector are not ported).

    from mxnet_tpu_torch import telemetry
    telemetry.enable()
    telemetry.histogram("serve.prefill_seconds").percentile(99)
"""
from __future__ import annotations

from . import registry as _registry
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, REGISTRY,
    counter, gauge, histogram, snapshot, enabled, percentile_from_counts,
)


def enable():
    """Turn collection on."""
    _registry.set_enabled(True)


def reset():
    """Zero all metric values; handles held by instrument sites stay
    registered."""
    _registry.REGISTRY.reset_values()
