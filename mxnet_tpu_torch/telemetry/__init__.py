"""Unified telemetry of the port: metrics registry + span tracing +
exporters + step anatomy (counterpart of ``mxnet_tpu/telemetry``).

The observability substrate the port's layers instrument against (engine
queue/worker metrics, executor step time, module/fit phase timing,
kvstore bytes and latency, serving queues). One import, three surfaces:

    from mxnet_tpu_torch import telemetry

    telemetry.counter("kvstore.push_bytes").inc(nbytes, key=str(k))
    telemetry.gauge("engine.queue_depth").set(depth)
    telemetry.histogram("executor.step_seconds").observe(dt)

    with telemetry.span("fwdbwd", step=n):   # nests, thread-local
        ...

    telemetry.render_prometheus()            # text exposition
    telemetry.flush()                        # JSONL snapshot + prom file

Collection is OFF by default and every instrument is a guarded no-op
until ``telemetry.enable()`` (or ``MXTPU_TELEMETRY=1`` /
``MXTPU_TELEMETRY_FILE=...`` in the environment). While the port's
profiler runs, spans also open ``torch.profiler.record_function`` ranges,
so the Kineto trace carries framework spans around the CUDA kernels.
"""
from __future__ import annotations

import os

from . import export as _export
from . import registry as _registry
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, REGISTRY,
    counter, gauge, histogram, render_prometheus, snapshot, enabled,
    percentile_from_counts, total,
)
from .tracer import span, current_span, Span  # noqa: F401
from .export import (  # noqa: F401
    sample_device_memory, write_prometheus_file, set_prometheus_file,
    jsonl_path,
)
from . import anatomy  # noqa: F401  (step anatomy / MFU / recompiles)
from . import costmodel  # noqa: F401
from . import fleet  # noqa: F401  (cross-rank aggregation + /metrics)
from .fleet import FleetAggregator  # noqa: F401


def enable(jsonl=None, prometheus=None, prometheus_interval=None,
           metrics_port=None):
    """Turn collection on; optionally point the exporters at files.

    ``jsonl``: path for the structured JSONL stream (spans as they
    close, metrics snapshots on flush). ``prometheus``: path for the
    text dump, rewritten on flush and every ``prometheus_interval``
    seconds (default 30). ``metrics_port`` (or MXTPU_METRICS_PORT)
    starts the localhost /metrics + /healthz HTTP endpoint. With
    MXTPU_RUN_DIR set and no explicit jsonl path, records land in the
    per-rank fleet sink ``<run_dir>/telemetry_r<rank>.jsonl``."""
    if jsonl is not None:
        _export.set_jsonl_path(jsonl)
    if prometheus is not None:
        _export.set_prometheus_file(prometheus, prometheus_interval)
    _registry.set_enabled(True)
    _export.ensure_fleet_sink()
    if metrics_port is not None or os.environ.get("MXTPU_METRICS_PORT"):
        fleet.maybe_start_metrics_server(metrics_port)


def disable():
    """Turn collection off (metrics keep their values; spans become
    no-ops again)."""
    _registry.set_enabled(False)


def flush():
    """Write a metrics snapshot to every configured sink."""
    _export.flush_metrics()


def reset():
    """Zero all metric values and detach the sinks — test isolation
    helper. Metric handles held by instrument sites stay registered."""
    _registry.REGISTRY.reset_values()
    anatomy.reset_state()
    _export.set_jsonl_path(None)
    _export.stop_prom_thread()
    _export.set_prometheus_file(None)
    fleet.stop_metrics_server()


# env-driven enablement at import (MXTPU_TELEMETRY=1): adopt the fleet
# sink and, if MXTPU_METRICS_PORT asks, serve /metrics right away
if _registry.enabled():
    _export.ensure_fleet_sink()
    if os.environ.get("MXTPU_METRICS_PORT"):
        fleet.maybe_start_metrics_server()
