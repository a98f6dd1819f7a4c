"""Process-wide metrics registry: counters, gauges, histograms with labels
(counterpart of ``mxnet_tpu/telemetry/registry.py``, line for line).

The substrate the port's layers (engine, executor, module, kvstore,
train step, serving) instrument against. Design constraints, in order:

1. **Disabled means free.** Every mutator starts with one global-flag
   check and returns; instrument sites can therefore hold module-level
   metric handles and call them unconditionally on hot paths.
2. **Thread-safe.** Engine workers, the serving batcher and the training
   thread all write concurrently; each metric serializes its own updates
   under one lock (no global lock on the update path).
3. **Stdlib only.** This module imports neither torch nor anything else
   of the port, so the tools can load it by path.

Naming follows the framework's dotted convention (``engine.ops_pushed``);
the Prometheus renderer sanitizes to ``mxtpu_engine_ops_pushed`` at the
edge, the same exposition names the JAX package serves.
"""
from __future__ import annotations

import logging
import math
import os
import threading

# enabled at import via env so `MXTPU_TELEMETRY=1 python train.py` needs
# no code changes; MXTPU_TELEMETRY_FILE implies enablement (an export
# destination without collection would silently produce nothing)
_enabled = (
    os.environ.get("MXTPU_TELEMETRY", "0") not in ("", "0")
    or bool(os.environ.get("MXTPU_TELEMETRY_FILE"))
)


def enabled():
    """Whether collection is on (the flag every mutator guards on)."""
    return _enabled


def set_enabled(flag):
    global _enabled
    _enabled = bool(flag)


def _label_key(labels):
    return tuple(sorted(labels.items())) if labels else ()


# per-shape/per-key labels can grow without bound in long runs; past this
# many distinct label sets a metric folds new ones into one overflow stream
_OVERFLOW_KEY = (("overflow", "true"),)


def _max_label_sets():
    try:
        return int(os.environ.get("MXTPU_METRIC_MAX_LABELS", "256"))
    except ValueError:
        return 256


class _Metric:
    """Base: one named instrument holding per-label-set streams."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = {}  # label-key tuple -> stream state
        self._overflowed = False

    def _slot(self, key):
        """Cardinality guard — call under ``self._lock``. Existing keys
        always pass; a NEW key past MXTPU_METRIC_MAX_LABELS folds into the
        overflow stream (warn once per metric)."""
        if key in self._values or key == _OVERFLOW_KEY:
            return key
        if len(self._values) < _max_label_sets():
            return key
        if not self._overflowed:
            self._overflowed = True
            logging.getLogger("mxnet_tpu_torch.telemetry").warning(
                "metric %s exceeded MXTPU_METRIC_MAX_LABELS=%d distinct "
                "label sets; further new label sets fold into "
                "{overflow=\"true\"}", self.name, _max_label_sets())
        return _OVERFLOW_KEY

    def label_sets(self):
        with self._lock:
            return list(self._values.keys())

    def clear(self):
        with self._lock:
            self._values.clear()
            self._overflowed = False


class Counter(_Metric):
    """Monotonically increasing count (ops pushed, bytes moved, seconds
    accumulated)."""

    kind = "counter"

    def inc(self, amount=1, **labels):
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counter %s: negative increment" % self.name)
        key = _label_key(labels)
        with self._lock:
            key = self._slot(key)
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value (queue depth, samples/sec, liveness age)."""

    kind = "gauge"

    def set(self, value, **labels):
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            key = self._slot(key)
            self._values[key] = value

    def inc(self, amount=1, **labels):
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            key = self._slot(key)
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


# latency-shaped default: 500us .. 30s, the range framework step/compile
# times actually land in
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram(_Metric):
    """Bucketed distribution (step latency, push/pull time)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value, **labels):
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            key = self._slot(key)
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
        """Estimated q-th percentile (q in 0..100) from bucket counts.

        Defined on every histogram state: 0.0 when empty, the exact
        sample when count == 1, linear interpolation inside the bucket
        otherwise (+Inf bucket clamps to the top finite edge).
        """
        with self._lock:
            state = self._values.get(_label_key(labels))
            if not state:
                return 0.0
            return percentile_from_counts(
                self.buckets, state["counts"], state["count"],
                state["sum"], q)


def percentile_from_counts(buckets, counts, count, total_sum, q):
    """Percentile estimate from exported histogram state — shared by the
    live :meth:`Histogram.percentile` and offline JSONL readers
    (tools/perf_doctor.py) so both agree on edge cases."""
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


def union_edges(a, b):
    """Sorted union of two bucket-edge tuples (cross-process histogram
    merge: ranks may run different bucket-edge generations)."""
    return tuple(sorted(set(a) | set(b)))


def rebucket_counts(counts, src_edges, dst_edges):
    """Re-express histogram ``counts`` (len(src_edges)+1, trailing +Inf
    bucket) on ``dst_edges``, which must be a superset of ``src_edges``.

    A source bucket ``(src[i-1], src[i]]`` maps onto the destination
    bucket whose upper edge is the SAME ``src[i]`` — i.e. all mass
    inside a source bucket is attributed to the top of that bucket.
    Cumulative counts at every *source* edge are therefore preserved
    exactly; at edges the destination inserted inside a source bucket
    the cumulative count is a lower bound, so
    :func:`percentile_from_counts` on the merged state is exact at
    source edges and off by at most one source bucket width elsewhere.
    """
    pos = {float(e): i for i, e in enumerate(dst_edges)}
    out = [0] * (len(dst_edges) + 1)
    for i, edge in enumerate(src_edges):
        c = counts[i]
        if c:
            out[pos[float(edge)]] += c
    out[-1] += counts[-1]  # +Inf bucket maps to +Inf bucket
    return out


class Registry:
    """Name -> metric map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        # rank -> highest snapshot seq merged so far (merge_snapshot)
        self._merge_seq = {}

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

    def total(self, name):
        """Aggregate a metric across ALL label sets: counters/gauges sum
        their values, histograms sum their ``sum`` fields. Missing metric
        reads as 0.0 — callers take interval deltas and must not care
        whether an instrument fired yet."""
        m = self.get(name)
        if m is None:
            return 0.0
        with m._lock:
            vals = list(m._values.values())
        if m.kind == "histogram":
            return float(sum(v["sum"] for v in vals))
        return float(sum(vals))

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def reset_values(self):
        """Zero every metric IN PLACE: instrument sites hold handles, so
        dropping registrations (rather than clearing) would silently
        detach them from future renders."""
        for m in self.metrics():
            m.clear()

    # -- snapshots -----------------------------------------------------
    def snapshot(self):
        """Plain-data dump for the JSONL exporter: name -> kind + per
        label-set values."""
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

    def render_prometheus(self):
        """Prometheus text exposition (0.0.4) of every metric."""
        lines = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            name = _prom_name(m.name)
            if m.help:
                lines.append("# HELP %s %s" % (name, m.help))
            lines.append("# TYPE %s %s" % (name, m.kind))
            with m._lock:
                items = sorted(m._values.items())
            for key, val in items:
                if m.kind == "histogram":
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum += val["counts"][i]
                        lines.append("%s_bucket%s %d" % (
                            name, _prom_labels(key, le=_prom_float(b)), cum))
                    cum += val["counts"][-1]
                    lines.append("%s_bucket%s %d" % (
                        name, _prom_labels(key, le="+Inf"), cum))
                    lines.append("%s_sum%s %s" % (
                        name, _prom_labels(key), _prom_float(val["sum"])))
                    lines.append("%s_count%s %d" % (
                        name, _prom_labels(key), val["count"]))
                else:
                    lines.append("%s%s %s" % (
                        name, _prom_labels(key), _prom_float(val)))
        return "\n".join(lines) + "\n"

    # -- cross-process merge -------------------------------------------
    def merge_snapshot(self, snap, rank=None, seq=None):
        """Fold one rank's :meth:`snapshot` dump into THIS registry.

        Intended for private aggregator registries (the fleet plane),
        not the live process registry: it writes stream state directly,
        bypassing the ``_enabled`` fast path and the instrument API.

        Semantics:

        * Snapshots are **cumulative** registry dumps, so a newer
          snapshot from the same rank REPLACES that rank's streams
          (per metric) rather than adding to them.
        * When ``rank`` is given, every merged stream gains a
          ``rank`` label, and the merge is **idempotent per
          (rank, seq)**: a snapshot whose ``seq`` is not strictly
          greater than the last one merged for that rank is a no-op
          (returns False). Replayed or reordered JSONL tails therefore
          cannot double-count.
        * Histogram streams from ranks with different bucket-edge
          generations merge by edge-set union: the target metric's
          edges grow to the union and existing streams are rebucketed
          via :func:`rebucket_counts` (exact at source edges,
          conservative at inserted ones).
        """
        rank_key = None if rank is None else str(rank)
        if rank_key is not None and seq is not None:
            with self._lock:
                if seq <= self._merge_seq.get(rank_key, -1):
                    return False
                self._merge_seq[rank_key] = seq
        for name, entry in snap.items():
            kind = entry.get("kind", "untyped")
            streams = entry.get("streams", [])
            if kind == "histogram":
                edges = DEFAULT_BUCKETS
                for s in streams:
                    if s.get("buckets"):
                        edges = tuple(sorted(s["buckets"]))
                        break
                m = self.histogram(name, buckets=edges)
            elif kind == "counter":
                m = self.counter(name)
            else:
                m = self.gauge(name)
            with m._lock:
                if rank_key is not None:
                    stale = [k for k in m._values
                             if ("rank", rank_key) in k]
                    for k in stale:
                        del m._values[k]
                for s in streams:
                    labels = dict(s.get("labels", {}))
                    if rank_key is not None:
                        labels["rank"] = rank_key
                    key = _label_key(labels)
                    if kind != "histogram":
                        m._values[key] = s.get("value", 0)
                        continue
                    src_edges = tuple(sorted(s.get("buckets", m.buckets)))
                    counts = list(s.get("counts", []))
                    if src_edges != m.buckets:
                        dst = union_edges(m.buckets, src_edges)
                        if dst != m.buckets:
                            for st in m._values.values():
                                st["counts"] = rebucket_counts(
                                    st["counts"], m.buckets, dst)
                            m.buckets = dst
                        counts = rebucket_counts(counts, src_edges,
                                                 m.buckets)
                    m._values[key] = {
                        "counts": counts,
                        "sum": float(s.get("sum", 0.0)),
                        "count": int(s.get("count", 0)),
                    }
        return True


def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    return "mxtpu_" + s if not s.startswith("mxtpu_") else s


def _prom_float(v):
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _prom_labels(key, **extra):
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs)
    return "{%s}" % body


REGISTRY = Registry()

# module-level conveniences bound to the process registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
render_prometheus = REGISTRY.render_prometheus
snapshot = REGISTRY.snapshot
total = REGISTRY.total
