"""Process-wide metrics registry: counters, gauges and histograms.

Counterpart of ``mxnet_tpu/telemetry/registry.py``, cut to what the
serving path uses. The same two rules hold: collection is OFF until
:func:`set_enabled` (or ``MXTPU_TELEMETRY=1`` in the environment), and
every mutator starts with that one flag check, so instrument sites hold
module-level handles and call them unconditionally; each metric guards
its own updates with its own lock. Stdlib only.
"""
from __future__ import annotations

import os
import threading

_enabled = os.environ.get("MXTPU_TELEMETRY", "0") not in ("", "0")


def enabled():
    """Whether collection is on (the flag every mutator guards on)."""
    return _enabled


def set_enabled(flag):
    global _enabled
    _enabled = bool(flag)


def _label_key(labels):
    return tuple(sorted(labels.items())) if labels else ()


class _Metric:
    """Base: one named instrument holding per-label-set streams."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = {}  # label-key tuple -> stream state

    def clear(self):
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount=1, **labels):
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counter %s: negative increment" % self.name)
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value (queue depth, slot occupancy)."""

    kind = "gauge"

    def set(self, value, **labels):
        if not _enabled:
            return
        with self._lock:
            self._values[_label_key(labels)] = value

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


# latency-shaped default: 500us .. 30s
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram(_Metric):
    """Bucketed distribution (prefill and decode-step latency)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value, **labels):
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = {"counts": [0] * (len(self.buckets) + 1),
                         "sum": 0.0, "count": 0}
                self._values[key] = state
            for i, b in enumerate(self.buckets):
                if value <= b:
                    state["counts"][i] += 1
                    break
            else:
                state["counts"][-1] += 1  # +Inf bucket
            state["sum"] += value
            state["count"] += 1

    def count(self, **labels):
        with self._lock:
            state = self._values.get(_label_key(labels))
            return state["count"] if state else 0

    def sum(self, **labels):
        with self._lock:
            state = self._values.get(_label_key(labels))
            return state["sum"] if state else 0.0

    def percentile(self, q, **labels):
        """Estimated q-th percentile (q in 0..100) from bucket counts:
        0.0 when empty, the exact sample when count == 1, linear
        interpolation inside the bucket otherwise (+Inf bucket clamps to
        the top finite edge)."""
        with self._lock:
            state = self._values.get(_label_key(labels))
            if not state:
                return 0.0
            return percentile_from_counts(
                self.buckets, state["counts"], state["count"],
                state["sum"], q)


def percentile_from_counts(buckets, counts, count, total_sum, q):
    """Percentile estimate from exported histogram state (shared by
    :meth:`Histogram.percentile` and offline readers of snapshots)."""
    if count <= 0:
        return 0.0
    if count == 1:
        return float(total_sum)  # the single sample, exactly
    q = min(max(float(q), 0.0), 100.0)
    target = q / 100.0 * count
    cum = 0
    lo = 0.0
    for i, edge in enumerate(buckets):
        c = counts[i]
        if c > 0 and cum + c >= target:
            return lo + (float(edge) - lo) * ((target - cum) / c)
        cum += c
        lo = float(edge)
    # everything left is in the +Inf bucket: clamp to the top finite edge
    return float(buckets[-1]) if buckets else float(total_sum) / count


class Registry:
    """Name -> metric map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, requested %s"
                    % (name, m.kind, cls.kind))
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def reset_values(self):
        """Zero every metric in place: instrument sites hold handles."""
        for m in self.metrics():
            m.clear()

    def snapshot(self):
        """Plain-data dump: name -> kind + per label-set values (the same
        shape as the JAX package's snapshot)."""
        out = {}
        for m in self.metrics():
            streams = []
            with m._lock:
                items = list(m._values.items())
            for key, val in items:
                labels = dict(key)
                if m.kind == "histogram":
                    streams.append({"labels": labels, "sum": val["sum"],
                                    "count": val["count"],
                                    "counts": list(val["counts"]),
                                    "buckets": list(m.buckets)})
                else:
                    streams.append({"labels": labels, "value": val})
            out[m.name] = {"kind": m.kind, "streams": streams}
        return out


REGISTRY = Registry()

# module-level conveniences bound to the process registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
