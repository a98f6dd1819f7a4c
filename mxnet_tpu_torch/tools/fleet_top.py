#!/usr/bin/env python
"""Live per-rank fleet table over a run dir's telemetry streams
(counterpart of the repo's ``tools/fleet_top.py``, the same table).

Renders one row per rank from the port's fleet aggregator
(mxnet_tpu_torch/telemetry/fleet.py): step count and rate, MFU, per-interval
skew vs the fastest rank, input feed wait, heartbeat/progress age, and
tombstone flags — plus the aggregator's straggler attribution line.

Usage:
    python -m mxnet_tpu_torch.tools.fleet_top RUN_DIR          # one table, exit
    python -m mxnet_tpu_torch.tools.fleet_top RUN_DIR --watch  # refresh every
                                                     # MXTPU_FLEET_INTERVAL s
    python -m mxnet_tpu_torch.tools.fleet_top --self-test

Also home of :func:`check_prometheus_text`, the Prometheus text
exposition (0.0.4) format checker the endpoint tests scrape with.

Stdlib-only: the port's fleet module is loaded by file path, so this
tool never imports torch.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import sys
import tempfile
import time

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_fleet():
    path = os.path.join(_PACKAGE, "telemetry", "fleet.py")
    spec = importlib.util.spec_from_file_location("mxtpu_torch_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fleet = _load_fleet()


# ---------------------------------------------------------------------------
# Prometheus text exposition checker
# ---------------------------------------------------------------------------

_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABELS_RE = (r"\{%s=\"(?:\\\\|\\\"|\\n|[^\"\\])*\""
              r"(?:,%s=\"(?:\\\\|\\\"|\\n|[^\"\\])*\")*,?\}"
              % (r"[a-zA-Z_][a-zA-Z0-9_]*", r"[a-zA-Z_][a-zA-Z0-9_]*"))
_VALUE_RE = r"(?:[+-]?Inf|NaN|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"
_SAMPLE_RE = re.compile(
    r"^(%s)(%s)? (%s)(?: [+-]?[0-9]+)?$" % (_NAME_RE, _LABELS_RE, _VALUE_RE))
_TYPE_RE = re.compile(r"^# TYPE (%s) (counter|gauge|histogram|summary|"
                      r"untyped)$" % _NAME_RE)
_HELP_RE = re.compile(r"^# HELP (%s) .*$" % _NAME_RE)

_LABEL_ITEM_RE = re.compile(
    r"([a-zA-Z_][a-zA-Z0-9_]*)=\"((?:\\\\|\\\"|\\n|[^\"\\])*)\"")


def check_prometheus_text(text):
    """Validate Prometheus text exposition format 0.0.4.

    Returns a list of error strings — empty means the text parses. Also
    checks histogram semantics: per series, ``_bucket`` counts must be
    cumulative (non-decreasing in ``le``), the ``+Inf`` bucket must be
    present and equal ``_count``.
    """
    errors = []
    types = {}
    # (base name, labels-minus-le) -> {"buckets": [(le, v)], "count": v}
    hist = {}
    for n, line in enumerate(text.split("\n"), 1):
        if not line:
            continue
        if line.startswith("#"):
            if not (_TYPE_RE.match(line) or _HELP_RE.match(line)
                    or line.startswith("# ")):
                errors.append("line %d: malformed comment: %r" % (n, line))
            m = _TYPE_RE.match(line)
            if m:
                if m.group(1) in types:
                    errors.append("line %d: duplicate TYPE for %s"
                                  % (n, m.group(1)))
                types[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append("line %d: malformed sample: %r" % (n, line))
            continue
        name, labels_raw, value = m.group(1), m.group(2) or "", m.group(3)
        labels = dict(_LABEL_ITEM_RE.findall(labels_raw))
        for base in (name[:-len(s)] for s in ("_bucket", "_sum", "_count")
                     if name.endswith(s)):
            if types.get(base) == "histogram":
                key = (base, tuple(sorted(
                    (k, v) for k, v in labels.items() if k != "le")))
                h = hist.setdefault(key, {"buckets": [], "count": None,
                                          "line": n})
                if name.endswith("_bucket"):
                    if "le" not in labels:
                        errors.append("line %d: histogram bucket without "
                                      "le label" % n)
                    else:
                        h["buckets"].append((labels["le"], float(value)))
                elif name.endswith("_count"):
                    h["count"] = float(value)
    for (base, labels), h in sorted(hist.items()):
        les = [le for le, _ in h["buckets"]]
        if "+Inf" not in les:
            errors.append("histogram %s%s: no +Inf bucket"
                          % (base, dict(labels)))
            continue
        counts = [v for _, v in h["buckets"]]
        if any(b > a for a, b in zip(counts[1:], counts[:-1])):
            errors.append("histogram %s%s: bucket counts not cumulative"
                          % (base, dict(labels)))
        if h["count"] is not None and counts and counts[-1] != h["count"]:
            errors.append("histogram %s%s: +Inf bucket %s != count %s"
                          % (base, dict(labels), counts[-1], h["count"]))
    return errors


# ---------------------------------------------------------------------------
# table rendering
# ---------------------------------------------------------------------------

def _fmt(value, spec="%.1f", none="-"):
    return none if value is None else spec % value


def render_table(summary):
    """One text table from ``FleetAggregator.summary()``."""
    lines = []
    last = None
    for d in reversed(summary["intervals"]):
        if len(d["ranks"]) > 1:
            last = d
            break
    skew_ms = {}
    if last is not None:
        base = min(v["score_seconds"] for v in last["ranks"].values())
        skew_ms = {r: 1000.0 * (v["score_seconds"] - base)
                   for r, v in last["ranks"].items()}
    header = ("rank  steps  step/s  step_ms     mfu  skew_ms  feed_ms"
              "  hb_age  prog_age  flags")
    lines.append(header)
    lines.append("-" * len(header))
    for rank in summary["ranks"]:
        pr = summary["per_rank"][rank]
        flags = []
        if pr.get("lost"):
            flags.append("LOST")
        if pr.get("stalled"):
            flags.append("STALL")
        if summary.get("straggler") == rank:
            flags.append("STRAGGLER")
        if pr.get("guard_rewinds"):
            flags.append("REWOUND×%d" % int(pr["guard_rewinds"]))
        elif pr.get("guard_trips") or pr.get("guard_skips"):
            flags.append("GUARD")
        if pr.get("bad_records"):
            flags.append("BADREC×%d" % int(pr["bad_records"]))
        lines.append(
            "%4d  %5s  %6s  %7s  %6s  %7s  %7s  %6s  %8s  %s" % (
                rank,
                _fmt(pr["steps"], "%d"),
                _fmt(pr["step_rate"], "%.2f"),
                _fmt(pr["step_ms"], "%.1f"),
                _fmt(pr["mfu"], "%.3f"),
                _fmt(skew_ms.get(rank), "%.1f"),
                _fmt(pr["feed_wait_ms_per_step"], "%.1f"),
                _fmt(pr["hb_age"], "%.0fs"),
                _fmt(pr["prog_age"], "%.0fs"),
                " ".join(flags)))
    if summary.get("straggler") is not None:
        lines.append("")
        lines.append("straggler: rank %d (%s-bound); skew max %s ms, "
                     "median %s ms" % (
                         summary["straggler"],
                         summary["bottleneck"] or "host",
                         _fmt(summary["max_skew_ms"]),
                         _fmt(summary["median_skew_ms"])))
    return "\n".join(lines)


def _default_interval():
    try:
        return float(os.environ.get("MXTPU_FLEET_INTERVAL", "10"))
    except ValueError:
        return 10.0


# ---------------------------------------------------------------------------
# self-test
# ---------------------------------------------------------------------------

def _write_rank(run_dir, rank, intervals, slow_phase=None, slow=0.0,
                extra_metrics=None):
    """Synthesize one rank's telemetry stream: anatomy intervals with an
    exact phase/wall invariant, plus a seq'd metrics snapshot
    (``extra_metrics`` merges additional counters into the snapshot)."""
    path = os.path.join(run_dir, "telemetry_r%d.jsonl" % rank)
    now = time.time()
    with open(path, "w") as f:
        for i in range(intervals):
            phases = {"input_wait": 0.010, "stage_host": 0.005,
                      "dispatch_host": 0.020, "device_sync": 0.080,
                      "collective": 0.015}
            if slow_phase:
                phases[slow_phase] += slow
            wall = sum(phases.values()) + 0.003  # 3ms unattributed
            rec = {"type": "anatomy", "t": now + i, "rank": rank,
                   "pid": 1000 + rank, "host": "host%d" % rank,
                   "interval": i, "step_end": (i + 1) * 4, "steps": 4,
                   "wall_seconds": wall, "step_ms": 250.0 * wall,
                   "phases": phases,
                   "unattributed_seconds": wall - sum(phases.values()),
                   "recompiles": 0, "mfu": 0.30 - 0.01 * rank}
            f.write(json.dumps(rec) + "\n")
        snap = {"fit.steps": {"kind": "counter", "streams": [
            {"labels": {}, "value": intervals * 4}]}}
        snap.update(extra_metrics or {})
        f.write(json.dumps({"type": "metrics", "ts": now, "seq": 1,
                            "rank": rank, "pid": 1000 + rank,
                            "host": "host%d" % rank,
                            "metrics": snap}) + "\n")
    with open(os.path.join(run_dir, "clock_%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "pid": 1000 + rank,
                   "host": "host%d" % rank, "wall": time.time(),
                   "mono": 0.0}, f)
    open(os.path.join(run_dir, "hb_%d" % rank), "w").close()


def _self_test():
    tmp = tempfile.mkdtemp(prefix="mxtpu_fleet_top_")
    try:
        # -- straggler table over a synthetic 3-rank run ----------------
        guard_snap = {
            "guard.trips": {"kind": "counter", "streams": [
                {"labels": {}, "value": 2}]},
            "guard.rewinds": {"kind": "counter", "streams": [
                {"labels": {}, "value": 1}]},
            "io.bad_records": {"kind": "counter", "streams": [
                {"labels": {}, "value": 3}]},
        }
        for rank in range(3):
            _write_rank(tmp, rank, intervals=3,
                        slow_phase="input_wait" if rank == 2 else None,
                        slow=0.200 if rank == 2 else 0.0,
                        extra_metrics=guard_snap if rank == 1 else None)
        agg = fleet.FleetAggregator(tmp).refresh()
        summary = agg.summary()
        assert summary["ranks"] == [0, 1, 2], summary["ranks"]
        assert summary["straggler"] == 2, summary["straggler"]
        assert summary["bottleneck"] == "input", summary["bottleneck"]
        assert summary["max_skew_ms"] is not None
        # 200ms injected excess + the fast ranks' 15ms collective, which
        # the model attributes entirely to waiting on the straggler
        assert abs(summary["max_skew_ms"] - 215.0) < 1.0, \
            summary["max_skew_ms"]
        # guardrail counters surface per rank and flag in the table
        pr1 = summary["per_rank"][1]
        assert pr1["guard_trips"] == 2 and pr1["guard_rewinds"] == 1, pr1
        assert pr1["bad_records"] == 3, pr1
        assert summary["per_rank"][0]["guard_trips"] == 0
        table = render_table(summary)
        assert "STRAGGLER" in table and "rank 2 (input-bound)" in table, \
            table
        assert "REWOUND×1" in table and "BADREC×3" in table, table
        for d in summary["intervals"]:
            for r, v in d["ranks"].items():
                total = (sum(v["phases"].values())
                         + v["unattributed_seconds"])
                assert abs(total - v["wall_seconds"]) < 1e-9, (r, v)

        # -- Prometheus format checker over a merged registry -----------
        text = agg.registry.render_prometheus()
        errors = check_prometheus_text(text)
        assert not errors, errors
        reg = fleet.Registry()
        reg.merge_snapshot({"lat": {"kind": "histogram", "streams": [
            {"labels": {"op": "x"}, "sum": 2.5, "count": 3,
             "counts": [1, 2, 0], "buckets": [1.0, 2.0]}]}}, rank=0, seq=1)
        errors = check_prometheus_text(reg.render_prometheus())
        assert not errors, errors
        bad = 'metric{le="nope} 1\n'
        assert check_prometheus_text(bad), "malformed text must fail"
        bad_hist = ("# TYPE h histogram\n"
                    'h_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
                    "h_sum 1\nh_count 3\n")
        assert check_prometheus_text(bad_hist), \
            "non-cumulative buckets must fail"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("fleet_top self-test passed")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Live per-rank fleet table over MXTPU_RUN_DIR "
                    "telemetry streams")
    parser.add_argument("run_dir", nargs="?",
                        default=os.environ.get("MXTPU_RUN_DIR"),
                        help="run dir (default: $MXTPU_RUN_DIR)")
    parser.add_argument("--watch", action="store_true",
                        help="refresh every --interval seconds")
    parser.add_argument("--interval", type=float,
                        default=_default_interval(),
                        help="refresh period for --watch (default: "
                             "$MXTPU_FLEET_INTERVAL or 10)")
    parser.add_argument("--json", action="store_true",
                        help="print the aggregator summary as JSON")
    parser.add_argument("--self-test", action="store_true")
    args = parser.parse_args(argv)
    if args.self_test:
        sys.exit(_self_test())
    if not args.run_dir:
        parser.error("no run dir (positional arg or MXTPU_RUN_DIR)")
    agg = fleet.FleetAggregator(args.run_dir)
    while True:
        summary = agg.refresh().summary()
        if args.json:
            print(json.dumps(summary, indent=2, sort_keys=True,
                             default=str))
        else:
            if args.watch:
                sys.stdout.write("\x1b[2J\x1b[H")
            print("fleet: %s  (%d rank(s), %s)" % (
                args.run_dir, len(summary["ranks"]),
                time.strftime("%H:%M:%S")))
            print(render_table(summary))
        if not args.watch:
            break
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
