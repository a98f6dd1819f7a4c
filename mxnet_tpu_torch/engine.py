"""Host-side dependency engine of the PyTorch port (counterpart of
``mxnet_tpu/engine.py``, the reference's ``src/engine/``).

On the card the device-side ordering is CUDA's: kernels on a stream run in
order, and streams meet through events. What remains on the host (file
IO, decode, batch staging, kvstore host reductions) is scheduled here with
the reference's interface:

- ``push(fn, const_vars, mutable_vars)``: run once the vars' earlier
  conflicting ops are done (Engine::PushAsync);
- ``Var`` read/write queues (ThreadedVar);
- ``wait_for_var`` / ``wait_for_all``;
- ``NaiveEngine`` (synchronous), chosen by ``MXNET_ENGINE_TYPE``, the
  reference's debug switch.

``get()`` prefers the native C++ engine (``src/engine.cc``) where the host
library built; ``comm()`` is the kvstore's engine, always the Python one.
"""
from __future__ import annotations

import heapq
import os
import sys
import threading
import time
import traceback
from collections import deque

from .base import MXNetError
from . import telemetry as _tm

def get_env(name, default):
    """An integer environment knob, ``default`` when unset or malformed."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# module-level handles: .inc()/.set()/.observe() are guarded no-ops
# while telemetry is disabled, so the hot path pays one flag check
_M_OPS_PUSHED = _tm.counter(
    "engine.ops_pushed", "ops pushed to the host dependency engine")
_M_OPS_EXECUTED = _tm.counter(
    "engine.ops_executed", "ops executed by engine workers")
_M_OP_ERRORS = _tm.counter(
    "engine.op_errors", "async ops that raised (surfaced via raise_pending)")
_M_WORKER_WAIT = _tm.counter(
    "engine.worker_wait_seconds",
    "cumulative time workers spent waiting for runnable ops")
_G_QUEUE_DEPTH = _tm.gauge(
    "engine.queue_depth", "ready-queue depth at last dispatch/pop")
_H_OP_SECONDS = _tm.histogram(
    "engine.op_seconds", "execution time of engine-scheduled ops")


class Var:
    """A dependency variable with read/write queues (ThreadedVar)."""

    __slots__ = ("_lock", "_queue", "_pending_write", "_num_pending_reads",
                 "_last_opr")

    def __init__(self):
        self._lock = threading.Lock()
        self._queue = deque()  # of _OprBlock waiting on this var
        self._pending_write = False
        self._num_pending_reads = 0
        self._last_opr = None  # most recently PUSHED op touching this var


class _OprBlock:
    __slots__ = ("fn", "const_vars", "mutable_vars", "wait", "done", "lock",
                 "priority", "name")

    def __init__(self, fn, const_vars, mutable_vars, priority=0, name=None):
        self.fn = fn
        self.const_vars = const_vars
        self.mutable_vars = mutable_vars
        self.wait = 0
        self.done = threading.Event()
        self.lock = threading.Lock()
        self.priority = priority
        self.name = name


class ThreadedEngine:
    """Asynchronous host-side dependency engine (ThreadedEnginePooled).

    Ready-to-run ops dispatch through a PRIORITY heap (higher ``priority``
    runs first when workers are contended), the discipline the reference
    uses to overlap gradient communication with backward: push(key,
    priority=-param_index) makes the front layers' reduces jump the queue
    so the next forward can start sooner (reference
    src/kvstore/comm.h kCPUPrioritized reduce + engine PushAsync
    priority)."""

    def __init__(self, num_workers=None):
        if num_workers is None:
            num_workers = get_env("MXNET_CPU_WORKER_NTHREADS", 4)
        self._lock = threading.Lock()
        self._inflight = 0
        self._all_done = threading.Condition(self._lock)
        self._ready = []  # heap of (-priority, seq, opr)
        self._ready_cv = threading.Condition()
        self._seq = 0
        self._trace = None  # list when tracing, else None
        # op exceptions: recorded here (workers never die from an op
        # failure) and re-raised on the CALLER's thread by
        # raise_pending() — kvstore calls it at every API entry, so a
        # failed async push/pull stops training deterministically
        # instead of silently dropping updates
        self._errors = []
        self._workers = []
        for i in range(num_workers):
            t = threading.Thread(
                target=self._worker, daemon=True,
                name="mxtpu-engine-%d" % i)
            t.start()
            self._workers.append(t)

    def new_variable(self):
        return Var()

    # -- tracing (test/diagnostic hook: records execution order) --------
    def start_trace(self):
        """Begin recording executed ops as dicts (name, priority, start,
        end, thread). Returns the live list; stop_trace() detaches it."""
        self._trace = []
        return self._trace

    def stop_trace(self):
        t, self._trace = self._trace, None
        return t

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name=None):
        """Schedule fn once all vars' prior conflicting ops complete."""
        const_vars = list(const_vars)
        mutable_vars = list(mutable_vars)
        self._check_duplicate(const_vars, mutable_vars)
        _M_OPS_PUSHED.inc()
        opr = _OprBlock(fn, const_vars, mutable_vars, priority, name)
        with self._lock:
            self._inflight += 1
        # Self-hold refcount: opr.wait starts at 1 so a producer that
        # completes DURING this enqueue loop can decrement freely without
        # racing a later bulk assignment (the increment happens-before
        # the queue append, both under the var lock, so _on_complete can
        # only ever see an already-counted entry).
        opr.wait = 1
        for var in const_vars:
            with var._lock:
                var._last_opr = opr
                if var._pending_write or var._queue:
                    with opr.lock:
                        opr.wait += 1
                    var._queue.append(("r", opr))
                else:
                    var._num_pending_reads += 1
        for var in mutable_vars:
            with var._lock:
                var._last_opr = opr
                if var._pending_write or var._num_pending_reads or var._queue:
                    with opr.lock:
                        opr.wait += 1
                    var._queue.append(("w", opr))
                else:
                    var._pending_write = True
        with opr.lock:
            opr.wait -= 1  # release the self-hold
            ready = opr.wait == 0
        if ready:
            self._dispatch(opr)
        return opr

    def _check_duplicate(self, const_vars, mutable_vars):
        mset = set(id(v) for v in mutable_vars)
        if len(mset) != len(mutable_vars):
            raise MXNetError("duplicate mutable vars")
        for v in const_vars:
            if id(v) in mset:
                raise MXNetError(
                    "var appears in both const_vars and mutable_vars"
                )

    def _dispatch(self, opr):
        with self._ready_cv:
            heapq.heappush(self._ready, (-opr.priority, self._seq, opr))
            self._seq += 1
            if _tm.enabled():
                _G_QUEUE_DEPTH.set(len(self._ready))
            self._ready_cv.notify()

    def _worker(self):
        while True:
            with self._ready_cv:
                if not self._ready:
                    t0 = time.monotonic()
                    while not self._ready:
                        self._ready_cv.wait()
                    _M_WORKER_WAIT.inc(time.monotonic() - t0)
                _, _, opr = heapq.heappop(self._ready)
                if _tm.enabled():
                    _G_QUEUE_DEPTH.set(len(self._ready))
            self._execute(opr)

    def _execute(self, opr):
        t0 = time.monotonic()
        try:
            opr.fn()
        except BaseException as e:  # noqa: BLE001 — worker must survive
            # A raising op must NOT kill the worker (a dead worker
            # eventually deadlocks every dependent op); record for
            # raise_pending() and keep going.
            self._errors.append(e)
            _M_OP_ERRORS.inc()
            traceback.print_exc(file=sys.stderr)
        finally:
            _M_OPS_EXECUTED.inc()
            if _tm.enabled():
                _H_OP_SECONDS.observe(time.monotonic() - t0)
            trace = self._trace
            if trace is not None:
                trace.append({
                    "name": opr.name, "priority": opr.priority,
                    "start": t0, "end": time.monotonic(),
                    "thread": threading.current_thread().name,
                })
            self._on_complete(opr)

    def raise_pending(self):
        """Re-raise the first recorded async-op exception on the
        caller's thread (clearing the queue). No-op if none."""
        if self._errors:
            errs, self._errors = self._errors, []
            raise errs[0]

    def _on_complete(self, opr):
        """CompleteReadDependency/CompleteWriteDependency + trigger
        successors (ThreadedEngine::OnComplete, threaded_engine.cc:351)."""
        to_dispatch = []
        for var in opr.const_vars:
            with var._lock:
                var._num_pending_reads -= 1
                if var._num_pending_reads == 0:
                    to_dispatch.extend(self._drain(var))
        for var in opr.mutable_vars:
            with var._lock:
                var._pending_write = False
                to_dispatch.extend(self._drain(var))
        for nxt in to_dispatch:
            with nxt.lock:
                nxt.wait -= 1
                ready = nxt.wait == 0
            if ready:
                self._dispatch(nxt)
        opr.done.set()
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._all_done.notify_all()

    def _drain(self, var):
        """Pop newly-runnable ops off a var's queue (caller holds var lock)."""
        out = []
        while var._queue:
            mode, opr = var._queue[0]
            if mode == "r":
                if var._pending_write:
                    break
                var._queue.popleft()
                var._num_pending_reads += 1
                out.append(opr)
            else:
                if var._pending_write or var._num_pending_reads:
                    break
                var._queue.popleft()
                var._pending_write = True
                out.append(opr)
                break
        return out

    def wait_for_var(self, var):
        done = threading.Event()
        self.push(done.set, const_vars=[var])
        done.wait()

    def wait_last(self, var):
        """Cheaper read-barrier: wait for the most recently PUSHED op on
        var (whose completion implies every earlier WRITE on var is
        done — var grants are FIFO). Used by NDArray._drain_engine on
        the per-batch hot path, where pushing a sentinel op per array
        per step (wait_for_var) measurably costs throughput."""
        opr = var._last_opr
        if opr is not None:
            opr.done.wait()

    def wait_for_all(self):
        with self._lock:
            while self._inflight:
                self._all_done.wait()


class NaiveEngine:
    """Synchronous engine for debugging (naive_engine.cc:16)."""

    def new_variable(self):
        return Var()

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name=None):
        _M_OPS_PUSHED.inc()
        fn()
        _M_OPS_EXECUTED.inc()

    def raise_pending(self):
        pass

    def wait_for_var(self, var):
        pass

    def wait_last(self, var):
        pass

    def wait_for_all(self):
        pass

    def start_trace(self):
        return []

    def stop_trace(self):
        return []


_ENGINE = None


def get():
    """Engine singleton, type from MXNET_ENGINE_TYPE (engine.cc:13).
    Default prefers the native C++ engine (src/engine.cc) when
    the toolchain built it; NaiveEngine remains the synchronous debug
    fallback exactly as in the reference."""
    global _ENGINE
    if _ENGINE is None:
        etype = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
        if etype == "NaiveEngine":
            _ENGINE = NaiveEngine()
        elif etype == "ThreadedEngine":  # explicit python engine
            _ENGINE = ThreadedEngine()
        else:
            try:
                from .native import NativeEngine

                _ENGINE = NativeEngine(
                    get_env("MXNET_CPU_WORKER_NTHREADS", 4)
                )
            except Exception:
                _ENGINE = ThreadedEngine()
    return _ENGINE


_COMM_ENGINE = None


def comm():
    """The COMMUNICATION engine: schedules KVStore push/pull host work
    (reduce, cross-process allreduce, optimizer update, broadcast-copy)
    so gradient sync overlaps the python train loop the way the
    reference's engine-scheduled kvstore ops overlap backward
    (src/kvstore/comm.h kCPUPrioritized).

    Always the python ThreadedEngine (or NaiveEngine under
    MXNET_ENGINE_TYPE=NaiveEngine — the same synchronous debug toggle
    governs both engines): comm ops are chunky host-side reductions
    where dispatch overhead is irrelevant, and the python engine carries
    the priority heap + execution trace the kvstore tests assert on.
    Separate from get() so IO prefetch load can never starve gradient
    sync (the reference likewise splits IO and comm thread pools)."""
    global _COMM_ENGINE
    if _COMM_ENGINE is None:
        if os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine":
            _COMM_ENGINE = NaiveEngine()
        else:
            _COMM_ENGINE = ThreadedEngine(
                get_env("MXNET_KVSTORE_NTHREADS", 4))
    return _COMM_ENGINE
