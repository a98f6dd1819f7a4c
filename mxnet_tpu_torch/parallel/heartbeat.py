"""Worker liveness: heartbeat files, dead-node detection and the watchdog's
inputs (counterpart of ``mxnet_tpu/parallel/heartbeat.py``, whose file
format this module keeps, so either package reads the other's files).

The reference's ps-lite Van sends heartbeats to the scheduler and surfaces
stale peers through ``KVStore::get_num_dead_node(node_id, timeout)``. There
is no scheduler process here: liveness runs over the one medium every
launcher shares with its workers, the run directory. It is deliberately
not a collective: liveness checks must keep working exactly when
collectives hang.

Two signals per rank, two files:

* ``hb_<rank>``: **process liveness.** Touched every ``interval`` seconds
  by a daemon thread. Detects dead or frozen processes, not a main thread
  wedged in a collective (the daemon keeps beating).
* ``prog_<rank>``: **training progress.** Touched (rate-limited) from the
  worker's own hot path: KVStore push / pull / barrier and ``fit``'s step
  bookkeeping call ``HeartbeatWriter.progress()``. A rank hung inside a
  collective stops touching this one, so ``tools/watchdog.py
  --progress-timeout`` catches exactly the hang the liveness beat cannot.

``tools/launch.py`` exports ``MXTPU_RUN_DIR``, so heartbeats start whenever
a dist kvstore is created or ``fit`` runs under it; ``tools/watchdog.py``
supervises a training command on its exit code and both staleness
signals. Stdlib only (besides the optional telemetry gauges), and
loadable by path.
"""
import os
import threading
import time

try:
    from .. import telemetry as _tm
except ImportError:
    # Loaded standalone by file path (tools/watchdog.py helpers and the
    # failure-recovery tests do this so liveness needs zero heavy
    # imports); record nothing in that mode.
    class _NoopMetric:
        def set(self, *args, **kwargs):
            pass

    class _NoopTelemetry:
        @staticmethod
        def enabled():
            return False

        @staticmethod
        def gauge(*args, **kwargs):
            return _NoopMetric()

    _tm = _NoopTelemetry()

_G_HB_AGE = _tm.gauge(
    "heartbeat.age_seconds",
    "Per-rank liveness-beat age at the last dead_nodes() poll "
    "(inf = never beat)")
_G_PROG_AGE = _tm.gauge(
    "heartbeat.progress_age_seconds",
    "Per-rank progress-mark age at the last stalled_nodes() poll")

RUN_DIR_ENV = "MXTPU_RUN_DIR"
_HB_PREFIX = "hb_"
_PROG_PREFIX = "prog_"
# Tombstones: an external controller (or resilience/fault.py's
# replica_lost / heartbeat_stall directives — which replicate these
# file names to stay stdlib-standalone) declares a rank gone by
# dropping ``lost_<rank>`` / ``stall_<rank>`` into the run dir. Writers
# honor them (a tombstoned rank stops beating / reporting progress) and
# lost_nodes() treats a lost tombstone as immediately dead — no need to
# wait out the staleness timeout, which keeps elastic-shrink tests
# deterministic.
_LOST_PREFIX = "lost_"
_STALL_PREFIX = "stall_"


def run_dir():
    """The launcher-provided liveness directory, or None outside a
    launched job."""
    return os.environ.get(RUN_DIR_ENV) or None


def _touch(path):
    with open(path, "a"):
        pass
    os.utime(path, None)


def _tombstone(directory, prefix, rank):
    return os.path.join(directory, "%s%d" % (prefix, int(rank)))


def mark_lost(directory, rank, stall_only=False):
    """Declare ``rank`` lost (or, with ``stall_only``, progress-wedged):
    drop the tombstone and back-date the corresponding signal file so
    pollers trip on their next pass regardless of timeout. This is the
    controller-side half of the elastic contract; the passive half is
    that this rank's own HeartbeatWriter stops touching the file."""
    prefixes = ((_STALL_PREFIX, _PROG_PREFIX) if stall_only
                else (_LOST_PREFIX, _HB_PREFIX))
    _touch(_tombstone(directory, prefixes[0], rank))
    stale = os.path.join(directory, "%s%d" % (prefixes[1], int(rank)))
    with open(stale, "a"):
        pass
    os.utime(stale, (1.0, 1.0))


def tombstoned(directory):
    """Ranks with a ``lost_<rank>`` tombstone in the run dir (what
    tools/watchdog.py --elastic reads to size the restart world)."""
    ranks = set()
    try:
        entries = os.listdir(directory)
    except OSError:
        return ranks
    for name in entries:
        if name.startswith(_LOST_PREFIX):
            try:
                ranks.add(int(name[len(_LOST_PREFIX):]))
            except ValueError:
                pass
    return ranks


class HeartbeatWriter:
    """Touch ``<run_dir>/hb_<rank>`` every ``interval`` seconds from a
    daemon thread (reference analog: Van::Heartbeat thread), and
    ``prog_<rank>`` whenever the worker reports forward progress."""

    def __init__(self, directory, rank, interval=2.0):
        self._dir = directory
        self.rank = int(rank)
        self._path = os.path.join(directory, "%s%d" % (_HB_PREFIX, rank))
        self._prog_path = os.path.join(
            directory, "%s%d" % (_PROG_PREFIX, rank))
        self._interval = float(interval)
        self._stop = threading.Event()
        self._thread = None
        self._last_prog = 0.0
        self._last_ticks = 0
        self._lost = False  # sticky once the tombstone is seen
        os.makedirs(directory, exist_ok=True)

    def _is_lost(self):
        """A ``lost_<rank>`` tombstone silences this writer for good:
        fault injection (replica_lost) simulates a vanished replica by
        freezing its heartbeat, and a writer that kept re-touching the
        back-dated file would un-kill it every interval."""
        if not self._lost:
            self._lost = os.path.exists(
                _tombstone(self._dir, _LOST_PREFIX, self.rank))
        return self._lost

    def start(self):
        if self._thread is not None:
            if self._thread.is_alive() and not self._stop.is_set():
                return self  # already beating
            # Previous thread is winding down (stop() timed out before
            # it exited) or already finished; wait it out and reap it so
            # two beaters never run at once.
            self._thread.join()
            self._thread = None
        self._stop.clear()  # writers are restartable (stop() then start())
        self._beat()
        self.progress()
        try:
            # the writer is the one long-lived per-rank presence in the
            # run dir, so it also drops the clock handshake the fleet
            # aggregator aligns timelines with (telemetry/fleet.py) —
            # best-effort: absent telemetry package (standalone load)
            # the per-rank JSONL sink writes it instead
            from ..telemetry import export as _texport

            _texport.write_clock_handshake(self._dir, self.rank)
        except Exception:  # noqa: BLE001 — liveness must start regardless
            pass
        self._thread = threading.Thread(
            target=self._loop, name="mxtpu-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 1.0)
            if self._thread.is_alive():
                # Join timed out: the thread is still winding down (e.g.
                # blocked in a slow _touch). Keep the handle so start()
                # cannot spawn a second beater alongside it; the next
                # start() reaps it once it exits.
                return
            self._thread = None

    def progress(self, ticks=1):
        """Mark forward progress from the worker's OWN thread (kvstore
        push/pull/barrier; fused update). Rate-limited to one touch per
        interval so per-key push loops don't turn into an utime storm.

        ``ticks`` > 1 reports a multi-batch dispatch (Module.update_multi
        runs K optimizer steps per host call, so the next report is K
        batch-times away). The K-1 extra ticks bank FUTURE mtime credit
        — estimated from the previous inter-report gap — so
        ``tools/watchdog.py --progress-timeout`` tuned to per-batch
        cadence doesn't false-trip mid-dispatch (ADVICE r5)."""
        now = time.monotonic()
        if ticks <= 1 and now - self._last_prog < self._interval:
            return
        if self._is_lost() or os.path.exists(
                _tombstone(self._dir, _STALL_PREFIX, self.rank)):
            return  # tombstoned: the rank must LOOK wedged to pollers
        per_tick = 0.0
        if self._last_prog > 0.0 and self._last_ticks > 0:
            per_tick = max(0.0, now - self._last_prog) / self._last_ticks
        self._last_prog = now
        self._last_ticks = ticks
        try:
            _touch(self._prog_path)
            credit = (ticks - 1) * per_tick
            if credit > 0.0:
                t = time.time() + credit
                os.utime(self._prog_path, (t, t))
        except OSError:
            pass  # progress is advisory; liveness beat handles teardown

    def _beat(self):
        # liveness is the file's mtime (all dead_nodes reads); touch is
        # cheaper and atomic vs the readers, no payload needed
        if self._is_lost():
            return
        _touch(self._path)

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._beat()
            except OSError:
                # Only give up if the run dir is actually gone (job
                # teardown); transient write errors (ENOSPC blip, NFS
                # hiccup) must not silently stop liveness and get a
                # healthy job killed.
                if not os.path.isdir(self._dir):
                    return


def dead_nodes(directory, num_workers, timeout=60.0, now=None,
               prefix=_HB_PREFIX):
    """Ranks whose heartbeat is missing or older than ``timeout`` seconds.

    Semantics of ``get_num_dead_node``: a node that never wrote a
    heartbeat counts as dead (the reference's scheduler likewise treats
    an unregistered-but-expected node as not alive)."""
    now = time.time() if now is None else now
    record = _tm.enabled() and prefix == _HB_PREFIX
    dead = []
    for rank in range(int(num_workers)):
        path = os.path.join(directory, "%s%d" % (prefix, rank))
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            if record:
                _G_HB_AGE.set(float("inf"), rank=str(rank))
            dead.append(rank)
            continue
        if record:
            _G_HB_AGE.set(age, rank=str(rank))
        if age > timeout:
            dead.append(rank)
    return dead


def stalled_nodes(directory, num_workers, timeout, now=None):
    """Ranks alive (process beating) but without recent progress — the
    wedged-in-a-collective signature.

    A missing ``prog_`` file is "not yet started", not "stalled": the
    initial progress touch can land after the liveness beat (start()
    ordering) or be swallowed by a transient write error, and killing a
    healthy job over that race would be worse than missing one poll.
    Such a rank only counts once its prog file exists and is stale."""
    now = time.time() if now is None else now
    alive = set(range(int(num_workers))) - set(
        dead_nodes(directory, num_workers, timeout, now=now))
    stalled = []
    for rank in sorted(alive):
        path = os.path.join(directory, "%s%d" % (_PROG_PREFIX, rank))
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue  # never progressed yet -> startup, not a stall
        if _tm.enabled():
            _G_PROG_AGE.set(age, rank=str(rank))
        if age > timeout:
            stalled.append(rank)
    return stalled


def lost_nodes(directory, num_workers, timeout=60.0, now=None):
    """Ranks declared LOST for elastic-shrink purposes: a ``lost_``
    tombstone, or a heartbeat file that exists but is stale past
    ``timeout``.

    Deliberately stricter than :func:`dead_nodes`: a rank that never
    wrote a heartbeat is a launcher/startup problem (watchdog
    startup_timeout territory), not a shrink signal — treating it as
    lost would shrink a healthy fleet that is still compiling. Only a
    rank that was seen alive and then went silent (or was explicitly
    tombstoned) votes for a smaller world."""
    now = time.time() if now is None else now
    lost = tombstoned(directory)
    for rank in range(int(num_workers)):
        path = os.path.join(directory, "%s%d" % (_HB_PREFIX, rank))
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue  # never started: not a shrink vote
        if age > timeout:
            lost.add(rank)
    return sorted(r for r in lost if 0 <= r < int(num_workers))
