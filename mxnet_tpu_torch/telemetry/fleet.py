"""Run-level observability plane of the port: cross-rank aggregation over
MXTPU_RUN_DIR (counterpart of ``mxnet_tpu/telemetry/fleet.py``).

Per-rank telemetry (anatomy records, registry snapshots, heartbeats)
lands in the run dir as ``telemetry_r<rank>.jsonl`` plus a
``clock_<rank>.json`` handshake. This module turns those per-process
streams into one fleet view:

- :func:`read_clock_offsets` — align streams from machines whose clocks
  drift, using the shared filesystem's mtime as the common reference.
- :class:`FleetAggregator` — merge per-rank streams, align anatomy
  intervals by cumulative step id, and decompose each rank's
  ``collective`` phase into *own work* vs *waiting for the straggler*,
  then use the straggler's own phase record to say WHAT made it slow
  (input, stage, dispatch, device, collective, host).
- :class:`MetricsServer` — opt-in localhost HTTP endpoint
  (``MXTPU_METRICS_PORT``) serving the live registry in Prometheus text
  exposition at ``/metrics`` and a JSON liveness view at ``/healthz``.

Skew model (the invariant tools/tests rely on): for one aligned
interval, each rank reports wall time ``W_r`` and a disjoint phase
split including ``collective_r``. Only the collective phase can hide
time spent blocked on peers, so

    own_r            = W_r - collective_r          (work no peer causes)
    wait_r           = min(collective_r, max(0, max_own - own_r))
    collective_own_r = collective_r - wait_r       (the transfer itself)
    score_r          = W_r - wait_r                (self-inflicted wall)

The straggler is the rank with the largest score (ties break to the
lowest rank) and skew is ``max(score) - min(score)``. Nothing is
re-normalized: per rank, phases + unattributed still sum to ``W_r``
exactly — the decomposition only splits ``collective`` in two.

Heartbeat liveness reads the signal files the JAX package's
``parallel/heartbeat.py`` writes; the port writes none yet, so its
liveness view stays empty until several processes are ported.

Stdlib-only at import (``tools/fleet_top.py`` loads this file by path,
without torch); only :mod:`.registry` is required, resolved by relative
import inside the package and by file-path loading when standalone.
"""
from __future__ import annotations

import glob
import json
import os
import re
import threading
import time

try:
    from . import registry as _registry
except ImportError:  # pragma: no cover - loaded by file path from tools/
    import importlib.util

    _here = os.path.dirname(os.path.abspath(__file__))
    _spec = importlib.util.spec_from_file_location(
        "mxtpu_fleet_registry", os.path.join(_here, "registry.py"))
    _registry = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_registry)

Registry = _registry.Registry
percentile_from_counts = _registry.percentile_from_counts

RUN_DIR_ENV = "MXTPU_RUN_DIR"

_TELEMETRY_RE = re.compile(r"telemetry_r(\d+)\.jsonl$")
_CLOCK_RE = re.compile(r"clock_(\d+)\.json$")

# liveness signal files — the names the heartbeat writers use, replicated
# here so the fleet view stays importable without torch
_HB_PREFIX = "hb_"
_PROG_PREFIX = "prog_"
_LOST_PREFIX = "lost_"
_STALL_PREFIX = "stall_"

# anatomy phase -> short bottleneck label used in decisions and advice
PHASE_LABELS = (
    ("input_wait", "input"),
    ("stage_host", "stage"),
    ("dispatch_host", "dispatch"),
    ("device_sync", "device"),
    ("collective", "collective"),
)


# ---------------------------------------------------------------------------
# run-dir discovery
# ---------------------------------------------------------------------------

def discover(run_dir):
    """rank -> path of every per-rank telemetry stream in the run dir."""
    out = {}
    if not run_dir or not os.path.isdir(run_dir):
        return out
    for path in glob.glob(os.path.join(run_dir, "telemetry_r*.jsonl")):
        m = _TELEMETRY_RE.search(os.path.basename(path))
        if m:
            out[int(m.group(1))] = path
    return out


def read_clock_offsets(run_dir):
    """rank -> clock info from each ``clock_<rank>.json`` handshake.

    ``offset`` is (file mtime - recorded wall clock): the file's mtime
    is stamped by the shared filesystem, so ``t + offset`` places a
    rank-local wall timestamp on the filesystem's timeline regardless
    of that rank's clock drift. Single-machine runs see offsets near 0.
    """
    out = {}
    if not run_dir or not os.path.isdir(run_dir):
        return out
    for path in glob.glob(os.path.join(run_dir, "clock_*.json")):
        m = _CLOCK_RE.search(os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                data = json.load(f)
            mtime = os.path.getmtime(path)
        except (OSError, ValueError):
            continue
        rank = int(m.group(1))
        data["offset"] = mtime - float(data.get("wall", mtime))
        out[rank] = data
    return out


def read_liveness(run_dir, now=None):
    """rank -> heartbeat/progress age and tombstone flags, from the
    signal files the heartbeat writers maintain."""
    out = {}
    if not run_dir or not os.path.isdir(run_dir):
        return out
    now = time.time() if now is None else now
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out

    def _slot(rank):
        return out.setdefault(rank, {"hb_age": None, "prog_age": None,
                                     "lost": False, "stalled": False})

    for name in names:
        for prefix, field in ((_HB_PREFIX, "hb_age"),
                              (_PROG_PREFIX, "prog_age")):
            if name.startswith(prefix):
                try:
                    rank = int(name[len(prefix):])
                    age = now - os.path.getmtime(os.path.join(run_dir, name))
                except (ValueError, OSError):
                    continue
                _slot(rank)[field] = age
        for prefix, field in ((_LOST_PREFIX, "lost"),
                              (_STALL_PREFIX, "stalled")):
            if name.startswith(prefix):
                try:
                    rank = int(name[len(prefix):])
                except ValueError:
                    continue
                _slot(rank)[field] = True
    return out


def _iter_jsonl(path):
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue  # torn tail line of a live writer
    except OSError:
        return


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def _snapshot_counter(metrics, name):
    """Total of a counter metric in a raw registry snapshot (all label
    streams summed), 0 when absent/malformed."""
    try:
        streams = (metrics or {}).get(name, {}).get("streams") or []
        return sum(float(s.get("value") or 0.0) for s in streams)
    except (TypeError, ValueError, AttributeError):
        return 0.0


class FleetAggregator:
    """Merge per-rank telemetry streams from one run dir into a single
    cross-rank view. :meth:`refresh` re-reads the files and is safe to
    call repeatedly (metric merges are idempotent per (rank, seq))."""

    def __init__(self, run_dir=None):
        self.run_dir = run_dir or os.environ.get(RUN_DIR_ENV)
        self.registry = Registry()
        self.ranks = {}  # rank -> {"anatomy": [...], "recompiles": n, ...}
        self.offsets = {}
        self.liveness = {}

    def refresh(self):
        self.offsets = read_clock_offsets(self.run_dir)
        self.liveness = read_liveness(self.run_dir)
        self.ranks = {}
        for rank, path in sorted(discover(self.run_dir).items()):
            state = {"rank": rank, "path": path, "pid": None, "host": None,
                     "anatomy": [], "recompiles": 0, "metrics": None}
            offset = self.offsets.get(rank, {}).get("offset", 0.0)
            for rec in _iter_jsonl(path):
                if state["pid"] is None and "pid" in rec:
                    state["pid"] = rec.get("pid")
                    state["host"] = rec.get("host")
                typ = rec.get("type")
                if typ == "anatomy":
                    rec = dict(rec)
                    if "t" in rec:
                        rec["t_aligned"] = rec["t"] + offset
                    state["anatomy"].append(rec)
                elif typ == "metrics":
                    self.registry.merge_snapshot(
                        rec.get("metrics", {}), rank=rank,
                        seq=rec.get("seq"))
                    # last-wins raw snapshot: counters are cumulative,
                    # so the newest record IS the rank's current total
                    # (guardrail/bad-record flags read from here)
                    state["metrics"] = rec.get("metrics")
                elif typ == "recompile":
                    state["recompiles"] += 1
            self.ranks[rank] = state
        return self

    # -- interval alignment -------------------------------------------
    def intervals(self):
        """Anatomy records grouped across ranks, aligned by cumulative
        step id (``step_end``; interval index as fallback for old
        streams). Returns ``[(key, {rank: record})]`` sorted by key,
        keeping only keys at least one rank reported."""
        use_step_end = all(
            "step_end" in rec
            for st in self.ranks.values() for rec in st["anatomy"])
        grouped = {}
        for rank, st in self.ranks.items():
            for rec in st["anatomy"]:
                key = rec["step_end"] if use_step_end else rec.get(
                    "interval", 0)
                grouped.setdefault(key, {})[rank] = rec
        return sorted(grouped.items())

    # -- skew decomposition -------------------------------------------
    @staticmethod
    def decompose(per_rank):
        """Apply the skew model (module docstring) to one aligned
        interval ``{rank: anatomy record}``."""
        own = {}
        for r, rec in per_rank.items():
            coll = float(rec.get("phases", {}).get("collective", 0.0))
            own[r] = float(rec["wall_seconds"]) - coll
        max_own = max(own.values())
        ranks = {}
        for r, rec in per_rank.items():
            wall = float(rec["wall_seconds"])
            phases = dict(rec.get("phases", {}))
            coll = float(phases.get("collective", 0.0))
            wait = min(coll, max(0.0, max_own - own[r]))
            ranks[r] = {
                "wall_seconds": wall,
                "steps": rec.get("steps"),
                "step_ms": rec.get("step_ms"),
                "phases": phases,
                "unattributed_seconds": rec.get("unattributed_seconds", 0.0),
                "own_seconds": own[r],
                "wait_seconds": wait,
                "collective_own_seconds": coll - wait,
                "score_seconds": wall - wait,
                "mfu": rec.get("mfu"),
            }
        scores = {r: v["score_seconds"] for r, v in ranks.items()}
        top = max(scores.values())
        straggler = min(r for r, s in scores.items() if s == top)
        out = {
            "straggler": straggler,
            "skew_seconds": top - min(scores.values()),
            "bottleneck": _bottleneck(ranks, straggler),
            "ranks": ranks,
        }
        return out

    @staticmethod
    def check_interval(per_rank, decomp, rel_tol=1e-9):
        """Invariant check: per rank, phases + unattributed == wall AND
        collective_own + wait == collective, exactly (up to float
        rounding). Returns a list of violation strings (empty = ok)."""
        bad = []
        for r, rec in per_rank.items():
            wall = float(rec["wall_seconds"])
            total = (sum(rec.get("phases", {}).values())
                     + rec.get("unattributed_seconds", 0.0))
            tol = rel_tol * max(abs(wall), 1.0)
            if abs(total - wall) > tol:
                bad.append("rank %s: phases+unattributed %.9f != wall %.9f"
                           % (r, total, wall))
            d = decomp["ranks"][r]
            coll = float(rec.get("phases", {}).get("collective", 0.0))
            if abs(d["collective_own_seconds"] + d["wait_seconds"]
                   - coll) > tol:
                bad.append("rank %s: collective split does not re-sum" % r)
        return bad

    # -- rollups -------------------------------------------------------
    def summary(self, max_intervals=None):
        """Cross-rank rollup: per-rank stats, decomposed intervals,
        modal straggler + bottleneck, and skew aggregates. Interval 0
        (warmup: first-batch compiles) is excluded from the modal
        straggler vote when later intervals exist."""
        intervals = []
        for idx, (key, per) in enumerate(self.intervals()):
            decomp = self.decompose(per)
            decomp["key"] = key
            decomp["index"] = idx
            intervals.append(decomp)
        voting = [d for d in intervals[1:]] or intervals
        counts = {}
        bottlenecks = {}
        for d in voting:
            if len(d["ranks"]) < 2:
                continue
            r = d["straggler"]
            counts[r] = counts.get(r, 0) + 1
            bottlenecks.setdefault(r, []).append(d["bottleneck"])
        straggler = None
        bottleneck = None
        if counts:
            top = max(counts.values())
            straggler = min(r for r, c in counts.items() if c == top)
            labels = bottlenecks[straggler]
            straggler_top = max(labels.count(x) for x in set(labels))
            bottleneck = min(x for x in set(labels)
                             if labels.count(x) == straggler_top)
        skews = sorted(d["skew_seconds"] for d in intervals
                       if len(d["ranks"]) > 1)
        per_rank = {}
        for rank, st in sorted(self.ranks.items()):
            anat = st["anatomy"]
            steps = sum(a.get("steps", 0) for a in anat)
            wall = sum(a.get("wall_seconds", 0.0) for a in anat)
            feed = sum(a.get("phases", {}).get("input_wait", 0.0)
                       for a in anat)
            mfu = None
            for a in reversed(anat):
                if a.get("mfu") is not None:
                    mfu = a["mfu"]
                    break
            live = self.liveness.get(rank, {})
            per_rank[rank] = {
                "pid": st["pid"], "host": st["host"],
                "steps": steps,
                "wall_seconds": wall,
                "step_ms": 1000.0 * wall / steps if steps else None,
                "step_rate": steps / wall if wall > 0 else None,
                "feed_wait_ms_per_step":
                    1000.0 * feed / steps if steps else None,
                "mfu": mfu,
                "recompiles": st["recompiles"],
                "clock_offset": self.offsets.get(rank, {}).get("offset"),
                "hb_age": live.get("hb_age"),
                "prog_age": live.get("prog_age"),
                "lost": live.get("lost", False),
                "stalled": live.get("stalled", False),
                "guard_trips":
                    _snapshot_counter(st["metrics"], "guard.trips"),
                "guard_skips":
                    _snapshot_counter(st["metrics"], "guard.skips"),
                "guard_rewinds":
                    _snapshot_counter(st["metrics"], "guard.rewinds"),
                "bad_records":
                    _snapshot_counter(st["metrics"], "io.bad_records"),
            }
        if max_intervals is not None:
            intervals = intervals[-max_intervals:]
        return {
            "run_dir": self.run_dir,
            "ranks": sorted(self.ranks),
            "per_rank": per_rank,
            "intervals": intervals,
            "straggler_counts": counts,
            "straggler": straggler,
            "bottleneck": bottleneck,
            "max_skew_ms": 1000.0 * skews[-1] if skews else None,
            "median_skew_ms":
                1000.0 * skews[len(skews) // 2] if skews else None,
        }

    def evidence(self, max_intervals=3):
        """Compact form of :meth:`summary` for watchdog decision
        records: who the straggler is, why, how big the skew is, and
        the last few decomposed intervals as raw evidence."""
        s = self.summary(max_intervals=max_intervals)
        intervals = []
        for d in s["intervals"]:
            intervals.append({
                "key": d["key"],
                "straggler": d["straggler"],
                "bottleneck": d["bottleneck"],
                "skew_ms": 1000.0 * d["skew_seconds"],
                "ranks": {
                    str(r): {
                        "wall_ms": 1000.0 * v["wall_seconds"],
                        "wait_ms": 1000.0 * v["wait_seconds"],
                        "own_ms": 1000.0 * v["own_seconds"],
                    } for r, v in d["ranks"].items()},
            })
        liveness = {
            str(r): {k: v for k, v in live.items() if v not in (None, False)}
            for r, live in sorted(self.liveness.items())}
        return {
            "telemetry_ranks": len(self.ranks),
            "straggler": s["straggler"],
            "bottleneck": s["bottleneck"],
            "straggler_counts":
                {str(r): c for r, c in s["straggler_counts"].items()},
            "max_skew_ms": s["max_skew_ms"],
            "median_skew_ms": s["median_skew_ms"],
            "last_intervals": intervals,
            "liveness": liveness,
        }

    def advice(self):
        """Human advice lines for perf_doctor's fleet section."""
        s = self.summary()
        lines = []
        if s["straggler"] is None:
            if len(s["ranks"]) > 1:
                lines.append("no persistent straggler: skew is balanced "
                             "across ranks")
            return lines
        r = s["straggler"]
        label = s["bottleneck"] or "host"
        metric = dict(_ADVICE_METRIC).get(label, label)
        mine, base = _phase_vs_median(s["intervals"], r, label)
        if base > 1e-9:
            lines.append(
                "rank %d is %s-bound — its %s is %.1f× the median of the "
                "other ranks" % (r, label, metric, mine / base))
        else:
            lines.append(
                "rank %d is %s-bound — its %s dominates while other ranks "
                "report none" % (r, label, metric))
        skews = [d["skew_seconds"] * 1000.0 for d in s["intervals"]
                 if len(d["ranks"]) > 1]
        if len(skews) >= 2:
            lines.append("skew trend (ms/interval): "
                         + " -> ".join("%.1f" % v for v in skews[-5:]))
        if s["max_skew_ms"] is not None:
            lines.append("cross-rank skew: max %.1f ms, median %.1f ms "
                         "per interval"
                         % (s["max_skew_ms"], s["median_skew_ms"]))
        return lines


_ADVICE_METRIC = (
    ("input", "feed_wait"),
    ("stage", "stage_host"),
    ("dispatch", "dispatch_host"),
    ("device", "device_sync"),
    ("collective", "collective"),
    ("host", "unattributed"),
)


def _phase_value(entry, label):
    if label == "collective":
        return entry["collective_own_seconds"]
    if label == "host":
        return entry["unattributed_seconds"]
    for phase, lab in PHASE_LABELS:
        if lab == label:
            return entry["phases"].get(phase, 0.0)
    return 0.0


def _median(vals):
    vals = sorted(vals)
    if not vals:
        return 0.0
    n = len(vals)
    if n % 2:
        return vals[n // 2]
    return 0.5 * (vals[n // 2 - 1] + vals[n // 2])


def _phase_vs_median(intervals, rank, label):
    """(straggler's per-interval mean, other ranks' median mean) for one
    phase label — the numbers behind an advice ratio."""
    mine, others = [], []
    for d in intervals:
        if rank not in d["ranks"]:
            continue
        mine.append(_phase_value(d["ranks"][rank], label))
        per = [_phase_value(v, label)
               for r, v in d["ranks"].items() if r != rank]
        if per:
            others.append(_median(per))
    m = sum(mine) / len(mine) if mine else 0.0
    o = sum(others) / len(others) if others else 0.0
    return m, o


def _bottleneck(ranks, straggler):
    """What made the straggler slow: the phase with the largest EXCESS
    over the median of the other ranks (absolute value when alone), with
    ``host`` (unattributed) only when it beats every explicit phase by
    2× — unattributed time is a measurement residual, so it must
    dominate clearly before we blame it."""
    mine = ranks[straggler]
    others = [v for r, v in ranks.items() if r != straggler]
    excess = {}
    for _, label in PHASE_LABELS:
        base = _median([_phase_value(o, label) for o in others])
        excess[label] = _phase_value(mine, label) - base
    best = max(v for v in excess.values())
    label = min(lab for lab, v in excess.items() if v == best)
    un_base = _median([o["unattributed_seconds"] for o in others])
    un_excess = mine["unattributed_seconds"] - un_base
    if un_excess > 0 and un_excess > 2.0 * max(best, 0.0):
        return "host"
    return label


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Localhost HTTP endpoint over a live registry.

    ``GET /metrics`` — Prometheus text exposition (0.0.4) of the
    registry; ``GET /healthz`` — JSON: identity, uptime, and (when a
    run dir is known) per-rank heartbeat liveness. Binds 127.0.0.1 by
    default (metrics can leak model/config details — exposing them
    beyond the host is an explicit MXTPU_METRICS_ADDR decision).
    ``port=0`` picks an ephemeral port (tests read ``.port``)."""

    def __init__(self, port, addr="127.0.0.1", registry=None, run_dir=None):
        self._registry = registry if registry is not None \
            else _registry.REGISTRY
        self.run_dir = run_dir or os.environ.get(RUN_DIR_ENV)
        self._t0 = time.time()
        self._httpd = None
        self._thread = None
        self.addr = addr
        self.port = port

    def start(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — quiet
                pass

            def do_GET(self):
                if self.path.split("?")[0] == "/metrics":
                    body = server._registry.render_prometheus() \
                        .encode("utf-8")
                    ctype = PROM_CONTENT_TYPE
                elif self.path.split("?")[0] == "/healthz":
                    body = json.dumps(server.health()).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.addr, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    def health(self):
        out = {
            "status": "ok",
            "time": time.time(),
            "uptime_seconds": time.time() - self._t0,
            "pid": os.getpid(),
            "rank": _env_rank(),
            "telemetry_enabled": _registry.enabled(),
        }
        if self.run_dir:
            out["run_dir"] = self.run_dir
            out["liveness"] = {
                str(r): v for r, v in read_liveness(self.run_dir).items()}
        return out

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._thread = None


def _env_rank():
    for var in ("DMLC_RANK", "RANK"):
        val = os.environ.get(var)
        if val:
            try:
                return int(val)
            except ValueError:
                pass
    return 0


_server = None
_server_lock = threading.Lock()


def maybe_start_metrics_server(port=None):
    """Start the process-wide metrics endpoint if MXTPU_METRICS_PORT
    (or ``port``) asks for one. Idempotent; returns the server or
    None."""
    global _server
    if port is None:
        raw = os.environ.get("MXTPU_METRICS_PORT")
        if not raw:
            return None
        try:
            port = int(raw)
        except ValueError:
            return None
    with _server_lock:
        if _server is not None:
            return _server
        addr = os.environ.get("MXTPU_METRICS_ADDR", "127.0.0.1")
        try:
            _server = MetricsServer(port, addr=addr).start()
        except OSError:
            _server = None
        return _server


def stop_metrics_server():
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
