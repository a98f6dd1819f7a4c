"""Span tracer: nested, thread-local timing regions (counterpart of
``mxnet_tpu/telemetry/tracer.py``).

``with telemetry.span("fwdbwd", step=n):`` stamps one region. Spans

- nest per thread (a thread-local stack tracks the enclosing span, so
  every record knows its parent and depth),
- aggregate into the ``mxtpu.span_seconds`` histogram (labelled by span
  name) — the per-phase totals ``tools/trace_summary.py`` and the
  Prometheus dump report,
- while the port's profiler runs (``profiler.profiler_set_state("run")``),
  emit a complete chrome-trace ``"X"`` event into its host buffer AND open
  a ``torch.profiler.record_function`` range for the span's extent, so the
  Kineto trace shows framework spans as the enclosing ranges of the CUDA
  kernels they launched (``profiler.attribute_trace`` joins on them),
- append a JSONL record when a JSONL sink is configured.

Spans time the host: a span around a call that only enqueues device work
(an eager step, a CUDA-graph replay) measures the enqueue, not the card.

When telemetry is disabled ``span()`` returns a shared no-op context
manager — no allocation, no clock read.
"""
from __future__ import annotations

import threading
import time

from . import registry as _reg

_tls = threading.local()

SPAN_SECONDS = _reg.histogram(
    "mxtpu.span_seconds", "time spent inside telemetry spans, by name")


class _NullSpan:
    """Shared disabled-path span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attrs(self, **attrs):
        pass


_NULL = _NullSpan()


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    __slots__ = ("name", "attrs", "parent", "depth", "_t0", "_ts_us",
                 "duration", "_range")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.parent = None
        self.depth = 0
        self.duration = None
        self._range = None

    def set_attrs(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        if st:
            self.parent = st[-1]
            self.depth = self.parent.depth + 1
        st.append(self)
        from .. import profiler as _profiler

        # a Kineto range only while the port's profiler traces (it imports
        # torch; the metrics layer itself never does)
        self._range = _profiler.open_range(self.name)
        # wall clock for the trace timeline, monotonic for the duration
        self._ts_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        self.duration = dur
        from .. import profiler as _profiler

        if self._range is not None:
            _profiler.close_range(self._range)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        SPAN_SECONDS.observe(dur, span=self.name)
        args = dict(self.attrs)
        if self.parent is not None:
            args["parent"] = self.parent.name
        if exc_type is not None:
            args["error"] = exc_type.__name__
        _profiler.record_event_complete(
            self.name, self._ts_us, dur * 1e6, category="framework",
            args=args or None)
        from . import export as _export

        _export.emit_span({
            "type": "span", "name": self.name, "ts": self._ts_us / 1e6,
            "dur": dur, "depth": self.depth,
            "thread": threading.get_ident() % 10000, "attrs": args,
        })
        return False


def span(name, **attrs):
    """Open a timing region. Usage::

        with telemetry.span("fwdbwd", step=n):
            ...
    """
    if not _reg._enabled:
        return _NULL
    return Span(name, attrs)


def current_span():
    """The innermost active span on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None
