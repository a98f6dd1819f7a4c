"""Summarize telemetry output of the port: chrome traces and telemetry
JSONL (counterpart of the repo's ``tools/trace_summary.py``, the same
tables).

Reads either artifact the port's observability stack produces —

* a chrome trace-event JSON (``profiler.dump_profile`` output, also the
  Kineto trace ``torch.profiler`` exports) — complete ``"X"`` events are
  grouped by name;
* a telemetry JSONL stream (``MXTPU_TELEMETRY_FILE`` /
  ``telemetry.enable(jsonl=...)``) — ``span`` lines are grouped by
  name, and the LAST ``metrics`` snapshot is rendered below the table.

For each span/event name: count, total ms, mean ms, and share of wall
time (first start to last end). Usage::

    python -m mxnet_tpu_torch.tools.trace_summary profile.json
    python -m mxnet_tpu_torch.tools.trace_summary telemetry.jsonl --top 15
    python -m mxnet_tpu_torch.tools.trace_summary 'run_dir/telemetry_r*.jsonl'
    python -m mxnet_tpu_torch.tools.trace_summary telemetry.jsonl --anatomy
    python -m mxnet_tpu_torch.tools.trace_summary --merge 'run_dir/trace_r*.json' \
        --out merged.json
    python -m mxnet_tpu_torch.tools.trace_summary --self-test

``--anatomy`` renders the step-anatomy intervals
(``telemetry/anatomy.py`` ``{"type": "anatomy"}`` records): per-step
phase breakdown, explicit unattributed remainder, MFU, and roofline
bound per interval. ``mxnet_tpu_torch/tools/perf_doctor.py`` builds a
diagnosis on top of the same records.

Paths accept globs (quoted so the shell doesn't expand them); several
files aggregate into one table. ``--merge`` combines per-rank chrome
traces (``trace_r<k>.json``) into a single chrome://tracing file with
one ``pid`` lane per rank, shifting each rank's timestamps by the
run dir's ``clock_<rank>.json`` handshake offset so the lanes share one
timeline.
"""
from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import re
import sys


# collective spans carry an ``nbytes`` attr (parallel/mesh.py) — those
# get a dedicated bytes/bandwidth table below the phase table
_COLLECTIVE_PREFIX = "mesh."


def _note_collective(coll, name, dur_us, attrs):
    if not name.startswith(_COLLECTIVE_PREFIX) or not attrs:
        return
    nbytes = attrs.get("nbytes")
    if nbytes is None:
        return
    tot_us, cnt, tot_b = coll.get(name, (0.0, 0, 0))
    coll[name] = (tot_us + dur_us, cnt + 1, tot_b + int(nbytes))


def _rows_from_events(events):
    """(name, total_us, count) rows + wall µs + collective bytes from
    chrome 'X' events (span attrs ride the event's ``args``)."""
    agg = {}
    coll = {}
    t_min, t_max = None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        name = e.get("name", "?")
        tot, cnt = agg.get(name, (0.0, 0))
        agg[name] = (tot + dur, cnt + 1)
        _note_collective(coll, name, dur, e.get("args"))
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = ts + dur if t_max is None else max(t_max, ts + dur)
    wall = (t_max - t_min) if agg else 0.0
    return [(n, t, c) for n, (t, c) in agg.items()], wall, coll


def _rows_from_jsonl(lines):
    """Span rows + wall µs + last metrics snapshot + collective bytes
    from telemetry JSONL."""
    agg = {}
    coll = {}
    t_min, t_max = None, None
    metrics = None
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn trailing line (live file)
        if rec.get("type") == "metrics":
            metrics = rec.get("metrics")
            continue
        if rec.get("type") != "span":
            continue
        ts = float(rec.get("ts", 0.0)) * 1e6
        dur = float(rec.get("dur", 0.0)) * 1e6
        name = rec.get("name", "?")
        tot, cnt = agg.get(name, (0.0, 0))
        agg[name] = (tot + dur, cnt + 1)
        _note_collective(coll, name, dur, rec.get("attrs"))
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = ts + dur if t_max is None else max(t_max, ts + dur)
    wall = (t_max - t_min) if agg else 0.0
    return [(n, t, c) for n, (t, c) in agg.items()], wall, metrics, coll


def load(path):
    """Returns (rows, wall_us, metrics_or_None, collectives). Sniffs the
    format: a JSON document with 'traceEvents' is a chrome trace,
    anything else is treated as JSONL."""
    with open(path) as f:
        content = f.read()
    try:
        doc = json.loads(content)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        rows, wall, coll = _rows_from_events(doc["traceEvents"])
        return rows, wall, None, coll
    return _rows_from_jsonl(content.splitlines())


def format_table(rows, wall_us, top=0):
    rows = sorted(rows, key=lambda r: -r[1])
    if top:
        rows = rows[:top]
    out = ["%-32s %8s %12s %10s %7s" % (
        "phase", "count", "total ms", "mean ms", "% wall")]
    out.append("-" * 73)
    for name, tot, cnt in rows:
        pct = (100.0 * tot / wall_us) if wall_us else 0.0
        out.append("%-32s %8d %12.3f %10.3f %6.1f%%" % (
            name[:32], cnt, tot / 1e3, tot / cnt / 1e3, pct))
    out.append("wall: %.3f ms" % (wall_us / 1e3))
    return "\n".join(out)


def format_collectives(coll):
    """Bytes/bandwidth table for mesh collectives (reduce_scatter_sum,
    all_gather, allreduce_sum): what the bucketed sharded-update path is
    supposed to shrink — see docs/performance.md."""
    out = ["", "collectives:", "%-28s %6s %10s %10s %10s" % (
        "op", "count", "total ms", "MiB moved", "MiB/s")]
    for name in sorted(coll):
        tot_us, cnt, tot_b = coll[name]
        mib = tot_b / (1024.0 * 1024.0)
        rate = mib / (tot_us / 1e6) if tot_us else 0.0
        out.append("%-28s %6d %10.3f %10.3f %10.1f" % (
            name[:28], cnt, tot_us / 1e3, mib, rate))
    return "\n".join(out)


def format_metrics(metrics):
    out = ["", "metrics (last snapshot):"]
    for name in sorted(metrics):
        m = metrics[name]
        for stream in m.get("streams", []):
            labels = stream.get("labels") or {}
            lbl = ",".join("%s=%s" % kv for kv in sorted(labels.items()))
            suffix = ("{%s}" % lbl) if lbl else ""
            if m.get("kind") == "histogram":
                cnt = stream.get("count", 0)
                tot = stream.get("sum", 0.0)
                mean = (tot / cnt) if cnt else 0.0
                val = "count=%d sum=%.6g mean=%.6g" % (cnt, tot, mean)
            else:
                val = "%.6g" % stream.get("value", 0.0)
            out.append("  %-44s %s" % (name + suffix, val))
    return "\n".join(out)


def _format_bucket_hist(metrics):
    """One-line digest of the kvstore.bucket_bytes histogram: how well
    the GradBucketer coalesced (mean flat-collective payload per flush,
    split by path=dist / path=flat_update)."""
    hist = metrics.get("kvstore.bucket_bytes") if metrics else None
    if not hist:
        return None
    lines = ["", "gradient buckets (kvstore.bucket_bytes):"]
    for stream in hist.get("streams", []):
        cnt = stream.get("count", 0)
        if not cnt:
            continue
        mean_kib = stream.get("sum", 0.0) / cnt / 1024.0
        path = (stream.get("labels") or {}).get("path", "?")
        lines.append("  path=%-12s flushes=%-6d mean bucket %.1f KiB"
                     % (path, cnt, mean_kib))
    return "\n".join(lines) if len(lines) > 2 else None


# phase columns of an anatomy record, in fit-loop order (matches
# telemetry/anatomy.py _PHASES)
ANATOMY_PHASES = ("input_wait", "stage_host", "dispatch_host",
                  "device_sync", "collective")


def load_anatomy(path):
    """All {"type": "anatomy"} interval records from a telemetry JSONL,
    in file order."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn trailing line (live file)
            if rec.get("type") == "anatomy":
                records.append(rec)
    return records


def format_anatomy(records):
    """Per-interval table: step time split into named phases (per-step
    ms) with the unattributed remainder explicit, plus MFU and the
    roofline bound when the cost model resolved."""
    if not records:
        return ("no anatomy records (enable telemetry with a JSONL sink "
                "and leave MXTPU_ANATOMY on)")
    head = ("%4s %6s %9s " % ("ivl", "steps", "step ms")
            + " ".join("%9s" % c[:9] for c in ANATOMY_PHASES)
            + " %9s %7s %8s" % ("unattrib", "mfu", "bound"))
    out = ["step anatomy (per-step ms):", head, "-" * len(head)]
    for r in records:
        steps = max(int(r.get("steps", 1)), 1)

        def ms(seconds):
            return 1000.0 * seconds / steps

        phases = r.get("phases", {})
        mfu = r.get("mfu")
        out.append(
            "%4d %6d %9.3f " % (int(r.get("interval", 0)), steps,
                                float(r.get("step_ms", 0.0)))
            + " ".join("%9.3f" % ms(float(phases.get(c, 0.0)))
                       for c in ANATOMY_PHASES)
            + " %9.3f %7s %8s" % (
                ms(float(r.get("unattributed_seconds", 0.0))),
                ("%.3f" % mfu) if mfu is not None else "-",
                str((r.get("roofline") or {}).get("bound", "-"))))
    last = records[-1]
    if last.get("flops_per_step"):
        out.append("model: %.4g FLOPs/step, %.4g bytes/step" % (
            last["flops_per_step"], last.get("bytes_per_step") or 0.0))
    return "\n".join(out)


def summarize(path, top=0):
    rows, wall, metrics, coll = load(path)
    if not rows and metrics is None:
        return "no span/event records in %s" % path
    text = format_table(rows, wall, top=top) if rows else (
        "no span records in %s" % path)
    if coll:
        text += "\n" + format_collectives(coll)
    bucket = _format_bucket_hist(metrics)
    if bucket:
        text += "\n" + bucket
    if metrics:
        text += "\n" + format_metrics(metrics)
    return text


def expand_paths(patterns):
    """Glob-expand each pattern (sorted); a pattern with no hits passes
    through so open() reports the missing file by name."""
    out = []
    for pat in patterns:
        hits = sorted(_glob.glob(pat))
        out.extend(hits if hits else [pat])
    return out


def summarize_many(paths, top=0):
    """One aggregated table over several telemetry/trace files (a
    glob'd multi-rank run dir): span rows and collective bytes sum
    across files; wall is the widest single file (streams overlap in
    time, so summing walls would double-count)."""
    if len(paths) == 1:
        return summarize(paths[0], top=top)
    agg, coll_all = {}, {}
    wall_max = 0.0
    any_rows = False
    for path in paths:
        rows, wall, _, coll = load(path)
        any_rows = any_rows or bool(rows)
        wall_max = max(wall_max, wall)
        for n, t, c in rows:
            tot, cnt = agg.get(n, (0.0, 0))
            agg[n] = (tot + t, cnt + c)
        for n, (t, c, b) in coll.items():
            tot, cnt, byt = coll_all.get(n, (0.0, 0, 0))
            coll_all[n] = (tot + t, cnt + c, byt + b)
    if not any_rows:
        return "no span/event records in %d file(s)" % len(paths)
    text = "%d files aggregated\n" % len(paths)
    text += format_table([(n, t, c) for n, (t, c) in agg.items()],
                         wall_max, top=top)
    if coll_all:
        text += "\n" + format_collectives(coll_all)
    return text


# ---------------------------------------------------------------------------
# multi-rank trace merge
# ---------------------------------------------------------------------------

_TRACE_RANK_RE = re.compile(r"trace_r(\d+)\.json$")


def _rank_of(path):
    m = _TRACE_RANK_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def _clock_offsets(run_dir):
    """rank -> seconds to ADD to that rank's timestamps, from the
    ``clock_<rank>.json`` handshakes (mxnet_tpu_torch/telemetry/fleet.py
    semantics: file mtime is the shared filesystem's clock, the recorded
    ``wall`` is the rank's — the difference aligns drifting clocks)."""
    offsets = {}
    for path in _glob.glob(os.path.join(run_dir, "clock_*.json")):
        m = re.search(r"clock_(\d+)\.json$", os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                data = json.load(f)
            offsets[int(m.group(1))] = (
                os.path.getmtime(path) - float(data["wall"]))
        except (OSError, ValueError, KeyError):
            continue
    return offsets


def merge_traces(paths, out_path):
    """Merge per-rank chrome traces into ONE chrome://tracing file.

    Every event of rank k lands in lane ``pid``=k (with a
    ``process_name`` metadata event naming it), and its timestamps are
    shifted by the clock-offset handshake so all lanes share one
    timeline. Returns (number of traces merged, total events).
    """
    merged = []
    n_traces = 0
    for idx, path in enumerate(paths):
        rank = _rank_of(path)
        rank = idx if rank is None else rank
        offsets = _clock_offsets(os.path.dirname(path) or ".")
        shift_us = offsets.get(rank, 0.0) * 1e6
        with open(path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents", doc) if isinstance(doc, dict) \
            else doc
        n_traces += 1
        merged.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "args": {"name": "rank %d" % rank}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": rank, "tid": 0,
                       "args": {"sort_index": rank}})
        for e in events:
            if not isinstance(e, dict):
                continue
            if e.get("ph") == "M" and e.get("name") in (
                    "process_name", "process_sort_index"):
                continue  # replaced by the per-rank lane metadata above
            e = dict(e)
            e["pid"] = rank
            if "ts" in e:
                e["ts"] = float(e["ts"]) + shift_us
            merged.append(e)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    return n_traces, len(merged)


def _self_test():
    """Exercise both readers on synthetic files; raises on mismatch."""
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="trace_summary_test_")
    # chrome trace: two names, overlapping events
    trace = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 0, "args": {}},
        {"name": "fwd", "ph": "X", "ts": 0.0, "dur": 1000.0, "pid": 0},
        {"name": "fwd", "ph": "X", "ts": 2000.0, "dur": 3000.0, "pid": 0},
        {"name": "bwd", "ph": "X", "ts": 1000.0, "dur": 500.0, "pid": 0},
    ]}
    trace["traceEvents"].append(
        {"name": "mesh.all_gather", "ph": "X", "ts": 4000.0,
         "dur": 200.0, "pid": 0, "args": {"nbytes": 1 << 20}})
    tp = os.path.join(d, "profile.json")
    with open(tp, "w") as f:
        json.dump(trace, f)
    rows, wall, metrics, coll = load(tp)
    by = {n: (t, c) for n, t, c in rows}
    assert metrics is None
    assert by["fwd"] == (4000.0, 2), by
    assert by["bwd"] == (500.0, 1), by
    assert wall == 5000.0, wall  # 0 .. 2000+3000
    assert coll["mesh.all_gather"] == (200.0, 1, 1 << 20), coll

    # telemetry JSONL: spans (incl. collectives with nbytes attrs) + a
    # metrics snapshot (incl. the bucket-size histogram) + a torn line
    jp = os.path.join(d, "telemetry.jsonl")
    with open(jp, "w") as f:
        f.write(json.dumps({"type": "span", "name": "fit.step",
                            "ts": 10.0, "dur": 0.5}) + "\n")
        f.write(json.dumps({"type": "span", "name": "fit.step",
                            "ts": 11.0, "dur": 0.25}) + "\n")
        f.write(json.dumps({"type": "span",
                            "name": "mesh.reduce_scatter_sum",
                            "ts": 10.1, "dur": 0.01,
                            "attrs": {"nbytes": 4096}}) + "\n")
        f.write(json.dumps({"type": "span",
                            "name": "mesh.reduce_scatter_sum",
                            "ts": 10.2, "dur": 0.03,
                            "attrs": {"nbytes": 8192}}) + "\n")
        f.write(json.dumps({"type": "span", "name": "mesh.all_gather",
                            "ts": 10.3, "dur": 0.02,
                            "attrs": {"nbytes": 4096}}) + "\n")
        f.write(json.dumps({"type": "metrics", "metrics": {
            "mxtpu.demo": {"kind": "counter",
                           "streams": [{"labels": {}, "value": 7}]},
            "mxtpu.lat": {"kind": "histogram",
                          "streams": [{"labels": {"op": "x"},
                                       "count": 2, "sum": 0.75}]},
            "kvstore.bucket_bytes": {
                "kind": "histogram",
                "streams": [{"labels": {"path": "dist"},
                             "count": 4, "sum": 4 * 2048.0}]},
        }}) + "\n")
        f.write('{"type": "span", "name": "torn')  # no newline, mid-write
    rows, wall, metrics, coll = load(jp)
    by = {n: (t, c) for n, t, c in rows}
    assert by["fit.step"] == (750000.0, 2), by
    assert abs(wall - 1.25e6) < 1e-6, wall  # 10.0s .. 11.25s
    assert metrics["mxtpu.demo"]["streams"][0]["value"] == 7
    assert coll["mesh.reduce_scatter_sum"][1] == 2, coll
    assert coll["mesh.reduce_scatter_sum"][2] == 12288, coll
    assert coll["mesh.all_gather"] == (20000.0, 1, 4096), coll
    text = summarize(jp)
    assert "fit.step" in text and "mxtpu.demo" in text, text
    assert "collectives:" in text and "mesh.all_gather" in text, text
    assert "gradient buckets" in text and "mean bucket 2.0 KiB" in text, \
        text

    # anatomy intervals: appended to the same JSONL; the span/metrics
    # readers must keep ignoring them and --anatomy must render them
    with open(jp, "a") as f:
        f.write("\n" + json.dumps({
            "type": "anatomy", "interval": 0, "steps": 4,
            "wall_seconds": 0.08, "step_ms": 20.0,
            "phases": {"input_wait": 0.004, "stage_host": 0.002,
                       "dispatch_host": 0.01, "device_sync": 0.02,
                       "collective": 0.004},
            "unattributed_seconds": 0.04, "recompiles": 0}) + "\n")
        f.write(json.dumps({
            "type": "anatomy", "interval": 1, "steps": 4,
            "wall_seconds": 0.04, "step_ms": 10.0,
            "phases": {"input_wait": 0.0, "stage_host": 0.002,
                       "dispatch_host": 0.01, "device_sync": 0.02,
                       "collective": 0.004},
            "unattributed_seconds": 0.004, "recompiles": 0,
            "flops_per_step": 2.5e9, "bytes_per_step": 1e8,
            "mfu": 0.125,
            "roofline": {"bound": "memory"}}) + "\n")
    recs = load_anatomy(jp)
    assert len(recs) == 2, recs
    rows2, _, _, _ = load(jp)
    assert {n for n, _, _ in rows2} == {
        "fit.step", "mesh.reduce_scatter_sum", "mesh.all_gather"}, rows2
    table = format_anatomy(recs)
    # interval 1: device_sync 0.02s/4 steps = 5 ms; unattrib 1 ms
    assert "5.000" in table and "0.125" in table, table
    assert "memory" in table, table
    assert "2.5e+09" in table, table
    # phases + unattributed must reproduce the wall (record invariant)
    for r in recs:
        total = sum(r["phases"].values()) + r["unattributed_seconds"]
        assert abs(total - r["wall_seconds"]) < 1e-9, r
    assert "no anatomy records" in format_anatomy([])

    # -- multi-rank merge: pid lanes + clock-offset shift ---------------
    run = os.path.join(d, "run")
    os.makedirs(run)
    for rank in (0, 1):
        with open(os.path.join(run, "trace_r%d.json" % rank), "w") as f:
            json.dump({"traceEvents": [
                {"name": "process_name", "ph": "M", "pid": 0, "args": {}},
                {"name": "step", "ph": "X", "ts": 1000.0, "dur": 100.0,
                 "pid": 0, "tid": 1},
            ]}, f)
    # rank 1's clock runs 2s behind the filesystem's: handshake wall is
    # 2s older than the file mtime -> offset +2s
    now = __import__("time").time()
    for rank, skew in ((0, 0.0), (1, 2.0)):
        cp = os.path.join(run, "clock_%d.json" % rank)
        with open(cp, "w") as f:
            json.dump({"rank": rank, "wall": now - skew, "mono": 0.0}, f)
        os.utime(cp, (now, now))
    out = os.path.join(d, "merged.json")
    n, _ = merge_traces(
        expand_paths([os.path.join(run, "trace_r*.json")]), out)
    assert n == 2, n
    with open(out) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert sorted(e["pid"] for e in xs) == [0, 1], xs
    by_pid = {e["pid"]: e for e in xs}
    assert abs(by_pid[0]["ts"] - 1000.0) < 1e4, by_pid  # ~no offset
    # rank 1 shifted by ~2s (2e6 us) onto the shared timeline
    assert abs(by_pid[1]["ts"] - by_pid[0]["ts"] - 2e6) < 1e4, by_pid
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"]
    assert names == ["rank 0", "rank 1"], names
    # merged file is a normal chrome trace: the summary reader takes it
    rows3, _, _, _ = load(out)
    assert dict((n_, (t, c)) for n_, t, c in rows3)["step"][1] == 2, rows3

    # -- glob summary aggregates across per-rank files ------------------
    text2 = summarize_many(
        expand_paths([os.path.join(run, "trace_r*.json")]))
    assert "2 files aggregated" in text2 and "step" in text2, text2

    print("self-test passed")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Summarize chrome traces / telemetry JSONL files "
                    "(paths accept globs), or merge per-rank traces")
    parser.add_argument("paths", nargs="*",
                        help="profile.json / telemetry .jsonl / glob")
    parser.add_argument("--top", type=int, default=0,
                        help="show only the N most expensive phases")
    parser.add_argument("--anatomy", action="store_true",
                        help="show the step-anatomy interval table "
                             "(telemetry JSONL only)")
    parser.add_argument("--merge", metavar="GLOB",
                        help="merge per-rank chrome traces "
                             "(trace_r<k>.json) into --out, one pid "
                             "lane per rank, clock offsets applied")
    parser.add_argument("--out", default="trace_merged.json",
                        help="output path for --merge "
                             "(default: trace_merged.json)")
    parser.add_argument("--self-test", action="store_true",
                        help="run built-in checks on synthetic inputs")
    args = parser.parse_args(argv)
    if args.self_test:
        return _self_test()
    if args.merge:
        paths = expand_paths([args.merge])
        n, events = merge_traces(paths, args.out)
        print("merged %d trace(s), %d events -> %s"
              % (n, events, args.out))
        return 0
    if not args.paths:
        parser.error("path required (or --merge / --self-test)")
    paths = expand_paths(args.paths)
    if args.anatomy:
        for path in paths:
            if len(paths) > 1:
                print("== %s" % path)
            print(format_anatomy(load_anatomy(path)))
        return 0
    print(summarize_many(paths, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
