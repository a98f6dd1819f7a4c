#!/usr/bin/env python
"""Perf doctor of the port: turn a telemetry JSONL into a step-time
diagnosis (counterpart of the repo's ``tools/perf_doctor.py``, the same
tables).

Reads the artifacts the anatomy layer (``mxnet_tpu_torch/telemetry/anatomy.py``)
writes into the telemetry JSONL stream — ``{"type": "anatomy"}`` interval
records, ``{"type": "recompile"}`` fingerprint diffs, and the last
``{"type": "metrics"}`` snapshot — and prints:

* the per-interval step-anatomy table (shared with
  ``mxnet_tpu_torch/tools/trace_summary.py --anatomy``),
* the MFU trajectory across intervals,
* the top recompile causes (grouped by which fingerprint fields changed),
* a ranked "where the milliseconds went" diagnosis with one actionable
  hint per phase, naming the largest cost explicitly.

Usage::

    python -m mxnet_tpu_torch.tools.perf_doctor telemetry.jsonl
    python -m mxnet_tpu_torch.tools.perf_doctor telemetry.jsonl --all-intervals
    python -m mxnet_tpu_torch.tools.perf_doctor RUN_DIR          # multi-rank fleet view
    python -m mxnet_tpu_torch.tools.perf_doctor --self-test

Pointed at a run dir (or at one rank's stream inside a run dir that
holds several ``telemetry_r<k>.jsonl`` files), the report grows a
"fleet" section fed from the fleet aggregator
(``mxnet_tpu_torch/telemetry/fleet.py``): slowest-rank ranking, per-interval
skew trend, and straggler advice — the single-stream diagnosis below it
then covers the straggler's own stream.

The first interval of a run usually carries the warm-up (on the card a
K-step group's eager warm-up and its CUDA-graph capture) inside its
unattributed time; it is dropped from the diagnosis by default
(``--all-intervals`` keeps it). The table always shows every interval.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..telemetry.registry import percentile_from_counts
from .trace_summary import ANATOMY_PHASES, format_anatomy

# one actionable hint per phase — the point of the doctor is that the
# largest line always comes with the knob that shrinks it
_ADVICE = {
    "input_wait": "input pipeline starving the device: deepen prefetch "
                  "(MXTPU_DEVICE_FEED=1 / MXTPU_FEED_DEPTH) or speed up "
                  "decode",
    "stage_host": "host input staging: MXTPU_DEVICE_FEED=1 adopts "
                  "device-resident batches and removes this phase",
    "dispatch_host": "per-dispatch host overhead: raise "
                     "MXNET_FIT_MULTISTEP to amortize K steps per "
                     "dispatch",
    "device_sync": "blocked on device results: device compute dominates "
                   "— see the roofline bound for which resource to "
                   "attack",
    "collective": "gradient collectives: tune MXTPU_BUCKET_BYTES / "
                  "MXTPU_BUCKET_TWO_PHASE, or shard the update "
                  "(MXTPU_SHARD_UPDATE)",
    "unattributed": "host time no instrumented phase covers: python "
                    "loop/callback overhead, GC, or compile — check "
                    "anatomy.recompiles and profile the fit loop",
}


def load_records(path):
    """(anatomy, recompiles, last-metrics, last-op_costs) from one
    telemetry JSONL."""
    anatomy, recompiles, metrics, op_costs = [], [], None, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn trailing line (live file)
            t = rec.get("type")
            if t == "anatomy":
                anatomy.append(rec)
            elif t == "recompile":
                recompiles.append(rec)
            elif t == "metrics":
                metrics = rec.get("metrics")
            elif t == "op_costs":
                op_costs = rec
    return anatomy, recompiles, metrics, op_costs


def steady_intervals(records, keep_all=False):
    """Drop the warmup interval (the first one, whose unattributed time
    contains the compile) when there is anything after it."""
    if keep_all or len(records) < 2:
        return records
    return records[1:]


def diagnose(records):
    """Rank phases + unattributed by total seconds across intervals.

    Returns (ranked, steps, wall_seconds) where ranked is a list of
    (name, seconds, per_step_ms, pct_of_wall) sorted most-expensive
    first — ranked[0] IS the diagnosis.
    """
    steps = sum(max(int(r.get("steps", 0)), 0) for r in records)
    wall = sum(float(r.get("wall_seconds", 0.0)) for r in records)
    totals = {name: 0.0 for name in ANATOMY_PHASES}
    totals["unattributed"] = 0.0
    for r in records:
        phases = r.get("phases", {})
        for name in ANATOMY_PHASES:
            totals[name] += float(phases.get(name, 0.0))
        totals["unattributed"] += float(r.get("unattributed_seconds", 0.0))
    ranked = []
    for name, sec in sorted(totals.items(), key=lambda kv: -kv[1]):
        per_ms = 1000.0 * sec / steps if steps else 0.0
        pct = 100.0 * sec / wall if wall else 0.0
        ranked.append((name, sec, per_ms, pct))
    return ranked, steps, wall


def format_mfu_trajectory(records):
    pts = [(int(r.get("interval", i)), r["mfu"])
           for i, r in enumerate(records) if r.get("mfu") is not None]
    if not pts:
        return ("no MFU values (cost model unresolved: check "
                "MXTPU_ANATOMY_COSTS and the peak-rate table / "
                "MXTPU_ANATOMY_PEAK_TFLOPS)")
    traj = " -> ".join("%.3f" % m for _, m in pts)
    vals = [m for _, m in pts]
    return "%s   (min %.3f, max %.3f, last %.3f over %d intervals)" % (
        traj, min(vals), max(vals), vals[-1], len(pts))


def recompile_causes(recompiles):
    """Group recompile records by WHICH fields changed; most frequent
    first. Returns [(count, cause, example_detail)]."""
    groups = {}
    for rec in recompiles:
        diff = rec.get("diff") or {}
        parts = []
        for name, fields in sorted((diff.get("changed") or {}).items()):
            for f in sorted(fields):
                parts.append("%s.%s" % (name, f))
        if diff.get("added"):
            parts.append("added:%s" % ",".join(diff["added"]))
        if diff.get("removed"):
            parts.append("removed:%s" % ",".join(diff["removed"]))
        for f in sorted(diff.get("meta") or {}):
            parts.append("meta.%s" % f)
        cause = " ".join(parts) or "(no visible diff)"
        cnt, example = groups.get(cause, (0, None))
        if example is None:
            changed = diff.get("changed") or {}
            for name, fields in sorted(changed.items()):
                for f, wasnow in sorted(fields.items()):
                    example = "%s.%s %s -> %s" % (
                        name, f, wasnow.get("was"), wasnow.get("now"))
                    break
                break
        groups[cause] = (cnt + 1, example)
    return sorted(((cnt, cause, ex) for cause, (cnt, ex) in groups.items()),
                  reverse=True)


def amp_advice(records):
    """f32 compute on the card is the one misconfiguration the anatomy
    stream can see directly: interval records carry the program's
    ``compute_dtype`` and the ``device_kind``. An H100's dense bf16
    tensor-core rate is about 15x its FP32 rate (the costmodel's peak
    table; the port runs f32 with TF32 off), so an f32 step leaves most of
    the card's arithmetic idle. Returns an advice string, or None when the
    run is already bf16 / not on a card / untagged."""
    for r in reversed(records):
        dtype = r.get("compute_dtype")
        kind = str(r.get("device_kind", ""))
        if not dtype:
            continue
        on_card = "nvidia" in kind.lower() or "h100" in kind.lower()
        if on_card and str(dtype).startswith(("f32", "float32")):
            return ("fp32 compute on the card (%s): the MFU above is "
                    "measured against its FP32 peak; set MXTPU_AMP=bf16 "
                    "to run forward/backward in bf16 with fp32 master "
                    "weights (kernel K1 updates them)" % kind)
        return None
    return None


def input_advice(ranked, metrics=None):
    """The streaming-input misconfiguration the anatomy stream exposes:
    ``input_wait`` (backed by the ``io.feed_wait_seconds`` histogram)
    ranked as the largest phase means the device is eating batches
    faster than the host decodes them. The fix is the process decode
    pool, not deeper prefetch — a deeper buffer only delays the same
    starvation. Returns an advice string, or None when input is not the
    diagnosis."""
    if not ranked or ranked[0][0] != "input_wait" or ranked[0][1] <= 0.0:
        return None
    depth = None
    qd = (metrics or {}).get("io.queue_depth")
    for stream in (qd or {}).get("streams", []):
        if stream.get("labels", {}).get("queue") == "ready":
            depth = stream.get("value")
    detail = ""
    if depth is not None:
        detail = (" (io.queue_depth ready=%g: %s)" %
                  (depth, "decode pool keeping up — feed handoff is the "
                          "gap" if depth and depth > 0
                   else "decode pool empty — workers are the bottleneck"))
    return ("input-bound — raise MXTPU_INPUT_WORKERS / check "
            "io.queue_depth%s; see docs/performance.md \"Streaming "
            "input pipeline\"" % detail)


def _counter_total(metrics, name):
    """Total of a counter in a metrics snapshot (all label streams
    summed), 0 when absent."""
    try:
        streams = (metrics or {}).get(name, {}).get("streams") or []
        return sum(float(s.get("value") or 0.0) for s in streams)
    except (TypeError, ValueError, AttributeError):
        return 0.0


def guardrail_section(metrics):
    """Training-guardrail activity from the last metrics snapshot:
    anomaly trips, skipped updates, rewinds, and quarantined input
    records. None when the run tripped nothing (the common case) —
    a silent run should not grow a section."""
    trips = _counter_total(metrics, "guard.trips")
    skips = _counter_total(metrics, "guard.skips")
    rewinds = _counter_total(metrics, "guard.rewinds")
    bad = _counter_total(metrics, "io.bad_records")
    if not (trips or skips or rewinds or bad):
        return None
    out = ["== guardrails =="]
    if trips or skips:
        out.append(
            "  %d anomaly trip(s), %d update(s) skipped — see "
            "guardrail events in the run log; raise MXTPU_GUARD_ZMAX "
            "only if these are known-benign spikes"
            % (int(trips), int(skips)))
    if rewinds:
        out.append(
            "  %d rewind(s) to last-good checkpoint — training state "
            "was rolled back; inspect with tools/ckpt_inspect.py "
            "--last-good" % int(rewinds))
    if bad:
        out.append(
            "  %d input record(s) quarantined (io.bad_records) — see "
            "quarantine.jsonl in the run dir for uri/ordinal of each"
            % int(bad))
    return "\n".join(out)


def _hist_percentiles(metrics, name, qs=(50, 99)):
    """Percentiles of any histogram in a metrics snapshot (label streams
    aggregated), or None when absent/empty."""
    hist = (metrics or {}).get(name)
    if not hist:
        return None
    agg_counts, agg_sum, agg_n, buckets = None, 0.0, 0, None
    for stream in hist.get("streams", []):
        b = stream.get("buckets")
        c = stream.get("counts")
        if not b or not c:
            continue
        if agg_counts is None:
            buckets, agg_counts = b, list(c)
        elif b == buckets:
            agg_counts = [x + y for x, y in zip(agg_counts, c)]
        agg_sum += stream.get("sum", 0.0)
        agg_n += stream.get("count", 0)
    if not agg_n or buckets is None:
        return None
    return tuple(percentile_from_counts(buckets, agg_counts, agg_n,
                                        agg_sum, q) for q in qs)


def serving_section(metrics):
    """Serving-engine activity from the last metrics snapshot:
    per-request latency percentiles split into queue-wait vs end-to-end,
    batch occupancy, and the KV-decode token counters. None when the
    process served nothing (training runs should not grow a section)."""
    reqs = _counter_total(metrics, "serve.requests")
    gens = _counter_total(metrics, "serve.gen_requests")
    toks = _counter_total(metrics, "serve.tokens")
    if not (reqs or gens or toks):
        return None
    out = ["== serving =="]
    if reqs:
        batches = _counter_total(metrics, "serve.batches")
        pad = _counter_total(metrics, "serve.pad_rows")
        occ = reqs / (reqs + pad) if (reqs + pad) else 0.0
        out.append(
            "  %d request(s) in %d batch(es), mean occupancy %.0f%% "
            "(%d padding rows wasted)"
            % (int(reqs), int(batches), 100.0 * occ, int(pad)))
        e2e = _hist_percentiles(metrics, "serve.e2e_seconds")
        wait = _hist_percentiles(metrics, "serve.queue_wait_seconds")
        if e2e:
            out.append("  latency p50=%.2f ms p99=%.2f ms (e2e)"
                       % (1000.0 * e2e[0], 1000.0 * e2e[1]))
        if e2e and wait:
            out.append("  queue wait p50=%.2f ms p99=%.2f ms"
                       % (1000.0 * wait[0], 1000.0 * wait[1]))
            if wait[1] > 0.5 * e2e[1] and e2e[1] > 0:
                out.append(
                    "  p99 is queue-dominated — raise "
                    "MXTPU_SERVE_MAX_BATCH or add replicas; lowering "
                    "MXTPU_SERVE_BATCH_TIMEOUT_MS only helps p50")
        if occ and occ < 0.5 and batches > 1:
            out.append(
                "  occupancy under 50%% — batches dispatch mostly "
                "empty; raise MXTPU_SERVE_BATCH_TIMEOUT_MS to collect "
                "more co-riders per bucket")
    if gens or toks:
        pre = _hist_percentiles(metrics, "serve.prefill_seconds")
        dec = _hist_percentiles(metrics, "serve.decode_step_seconds")
        line = "  decode: %d generation(s), %d token(s)" % (
            int(gens), int(toks))
        if pre:
            line += ", prefill p50=%.2f ms" % (1000.0 * pre[0])
        if dec:
            line += ", decode step p50=%.2f ms" % (1000.0 * dec[0])
        out.append(line)
    return "\n".join(out)


def _step_latency_percentiles(metrics):
    """p50/p99 of fit.step_seconds from the last metrics snapshot, using
    the same bucket interpolation as the live registry (the snapshot
    carries bucket edges since the anatomy PR)."""
    hist = (metrics or {}).get("fit.step_seconds")
    if not hist:
        return None
    agg_counts, agg_sum, agg_n, buckets = None, 0.0, 0, None
    for stream in hist.get("streams", []):
        b = stream.get("buckets")
        c = stream.get("counts")
        if not b or not c:
            continue
        if agg_counts is None:
            buckets, agg_counts = b, list(c)
        elif b == buckets:
            agg_counts = [x + y for x, y in zip(agg_counts, c)]
        agg_sum += stream.get("sum", 0.0)
        agg_n += stream.get("count", 0)
    if not agg_n or buckets is None:
        return None
    return tuple(percentile_from_counts(buckets, agg_counts, agg_n,
                                        agg_sum, q) for q in (50, 99))


def kernel_candidates_section(op_costs, anatomy):
    """Roofline-ranked "write a kernel here next" table.

    Joins the fit loop's ``type=op_costs`` record (per-op analytic
    flops/bytes from ``costmodel.analytic_op_costs``) with the peak-rate
    tables via ``costmodel.rank_kernel_candidates``: memory-bound ops
    sorted by the per-forward-pass milliseconds a fused hand-written
    CUDA kernel could recover. Returns the formatted section, or None when there is no
    op_costs record or the device's peaks are unknown."""
    if not op_costs or not op_costs.get("ops"):
        return None
    from ..telemetry import costmodel

    kind = op_costs.get("device_kind")
    dtype = op_costs.get("compute_dtype")
    if (not kind or not dtype) and anatomy:
        last = anatomy[-1]
        kind = kind or last.get("device_kind")
        dtype = dtype or last.get("compute_dtype")
    ranked = costmodel.rank_kernel_candidates(
        op_costs["ops"], kind=kind, dtype=dtype, top=8)
    if not ranked:
        return None
    out = ["== kernel candidates (memory-bound ops, roofline-ranked) =="]
    out.append("  %-28s %-14s %10s %10s %8s %12s" % (
        "op", "type", "flops", "bytes", "flop/B", "recover ms"))
    for r in ranked:
        out.append("  %-28s %-14s %10.3g %10.3g %8.2f %12.4f" % (
            r.get("name", "?"), r.get("op", "?"),
            r.get("flops", 0.0), r.get("bytes", 0.0),
            r.get("intensity") or 0.0, r["recoverable_ms"]))
    out.append(
        "  (per forward pass at %s peaks; recover ms = t_memory - "
        "t_compute, the ceiling a fused hand-written CUDA kernel could "
        "reclaim — the conv-backward pair K2/K3 already runs as "
        "csrc/conv_bwd.cu)" % (kind or "device"))
    return "\n".join(out)


def fleet_section(run_dir):
    """The cross-rank block of the report, fed from the fleet
    aggregator (never re-parsed here): slowest-rank ranking, skew
    trend, straggler advice. None when the run dir holds fewer than two
    rank streams."""
    from ..telemetry import fleet as _fleet

    agg = _fleet.FleetAggregator(run_dir).refresh()
    summary = agg.summary()
    if len(summary["ranks"]) < 2:
        return None, None
    out = ["== fleet (%d ranks) ==" % len(summary["ranks"])]
    ranking = sorted(
        summary["per_rank"].items(),
        key=lambda kv: -(kv[1]["step_ms"] or 0.0))
    for rank, pr in ranking:
        flags = []
        if rank == summary.get("straggler"):
            flags.append("STRAGGLER")
        if pr.get("lost"):
            flags.append("LOST")
        if pr.get("stalled"):
            flags.append("STALLED")
        if pr.get("guard_rewinds") or pr.get("guard_trips"):
            flags.append("GUARD")
        if pr.get("bad_records"):
            flags.append("BADREC")
        out.append(
            "  rank %-3d %8.1f ms/step  mfu %-6s feed %6.1f ms/step  "
            "recompiles %-3d %s" % (
                rank, pr["step_ms"] or 0.0,
                ("%.3f" % pr["mfu"]) if pr["mfu"] is not None else "-",
                pr["feed_wait_ms_per_step"] or 0.0,
                pr["recompiles"], " ".join(flags)))
    for line in agg.advice():
        out.append("  " + line)
    return "\n".join(out), summary


def report(path, keep_all=False):
    fleet_text = None
    if os.path.isdir(path):
        # run dir: fleet section + the straggler's own stream below it
        try:
            fleet_text, summary = fleet_section(path)
        except Exception as exc:  # noqa: BLE001 — fleet view is advisory
            fleet_text, summary = "== fleet ==\n  unavailable: %s" % exc, \
                None
        streams = sorted(
            f for f in os.listdir(path)
            if f.startswith("telemetry_r") and f.endswith(".jsonl"))
        if not streams:
            return (fleet_text or
                    "no telemetry_r*.jsonl streams in %s" % path)
        pick = "telemetry_r%d.jsonl" % summary["straggler"] \
            if summary and summary.get("straggler") is not None \
            else streams[0]
        out = [fleet_text] if fleet_text else []
        out.append("")
        out.append("-- single-stream diagnosis: %s --" % pick)
        out.append(report(os.path.join(path, pick), keep_all=keep_all))
        return "\n".join(out)
    run_dir = os.path.dirname(os.path.abspath(path))
    siblings = [f for f in os.listdir(run_dir)
                if f.startswith("telemetry_r") and f.endswith(".jsonl")]
    if len(siblings) > 1:
        try:
            fleet_text, _ = fleet_section(run_dir)
        except Exception:  # noqa: BLE001
            fleet_text = None
    anatomy, recompiles, metrics, op_costs = load_records(path)
    out = ["== step anatomy ==", format_anatomy(anatomy)]
    if fleet_text:
        out = [fleet_text, ""] + out
    if not anatomy:
        # a pure serving process has no fit-loop anatomy intervals but
        # still deserves its latency/occupancy summary
        serve = serving_section(metrics)
        if serve:
            out += ["", serve]
        return "\n".join(out)

    out += ["", "== MFU trajectory ==", format_mfu_trajectory(anatomy)]

    out += ["", "== recompiles =="]
    if recompiles:
        out.append("%d recompile(s) after warmup; top causes:"
                   % len(recompiles))
        for cnt, cause, example in recompile_causes(recompiles)[:5]:
            line = "  %dx %s" % (cnt, cause)
            if example:
                line += "   e.g. %s" % example
            out.append(line)
    else:
        out.append("none after warmup (dispatch-plan cache is steady)")

    steady = steady_intervals(anatomy, keep_all=keep_all)
    ranked, steps, wall = diagnose(steady)
    out += ["", "== where the milliseconds went (%d steps, %.1f ms/step) =="
            % (steps, 1000.0 * wall / steps if steps else 0.0)]
    for i, (name, sec, per_ms, pct) in enumerate(ranked):
        if sec <= 0.0:
            continue
        out.append("%2d. %-14s %8.3f ms/step  %5.1f%%  — %s" % (
            i + 1, name, per_ms, pct, _ADVICE.get(name, "")))
    top = ranked[0]
    roof = (steady[-1].get("roofline") or {}).get("bound") if steady else None
    diag = "diagnosis: largest cost is %s (%.3f ms/step, %.1f%% of wall)" % (
        top[0], top[2], top[3])
    if roof and roof != "unknown":
        diag += "; device model says the interval is %s-bound" % roof
    out += ["", diag]

    ms = next((r["multistep"] for r in reversed(anatomy)
               if r.get("multistep")), None)
    if ms:
        out.append(
            "multistep: K=%d%s%s" % (
                ms.get("k", 0),
                " (auto, settled)" if ms.get("settled")
                else " (auto, still growing)" if ms.get("auto") else "",
                "" if ms.get("dispatch_frac") is None else
                ", dispatch at %.1f%% of device time"
                % (100.0 * ms["dispatch_frac"])))

    amp = amp_advice(anatomy)
    if amp:
        out.append(amp)

    inp = input_advice(ranked, metrics)
    if inp:
        out.append(inp)

    kc = kernel_candidates_section(op_costs, anatomy)
    if kc:
        out += ["", kc]

    guard = guardrail_section(metrics)
    if guard:
        out += ["", guard]

    serve = serving_section(metrics)
    if serve:
        out += ["", serve]

    pcts = _step_latency_percentiles(metrics)
    if pcts:
        out.append("step latency p50=%.3f ms p99=%.3f ms (fit.step_seconds)"
                   % (1000.0 * pcts[0], 1000.0 * pcts[1]))
    return "\n".join(out)


def _self_test():
    """Synthetic JSONL through the full report; raises on mismatch."""
    import tempfile

    d = tempfile.mkdtemp(prefix="perf_doctor_test_")
    path = os.path.join(d, "telemetry.jsonl")

    def anatomy_rec(ivl, phases, unattr, mfu=None, bound=None,
                    dtype=None, kind=None):
        rec = {"type": "anatomy", "interval": ivl, "steps": 10,
               "wall_seconds": sum(phases.values()) + unattr,
               "step_ms": 100.0 * (sum(phases.values()) + unattr),
               "phases": phases, "unattributed_seconds": unattr,
               "recompiles": 0}
        if mfu is not None:
            rec["mfu"] = mfu
            rec["flops_per_step"] = 1e9
            rec["roofline"] = {"bound": bound or "compute"}
        if dtype is not None:
            rec["compute_dtype"] = dtype
        if kind is not None:
            rec["device_kind"] = kind
        return rec

    base = {"input_wait": 0.001, "stage_host": 0.002,
            "dispatch_host": 0.01, "device_sync": 0.12,
            "collective": 0.005}
    with open(path, "w") as f:
        # interval 0: warmup — huge unattributed (compile); dropped from
        # the diagnosis by default
        f.write(json.dumps(anatomy_rec(0, dict(base), 2.0)) + "\n")
        f.write(json.dumps(anatomy_rec(1, dict(base), 0.01,
                                       mfu=0.12)) + "\n")
        rec2 = anatomy_rec(2, dict(base), 0.01, mfu=0.14,
                           bound="compute", dtype="f32", kind="NVIDIA H100 80GB HBM3")
        rec2["multistep"] = {"k": 8, "auto": True, "settled": True,
                             "dispatch_frac": 0.031}
        f.write(json.dumps(rec2) + "\n")
        # op_costs record: one clearly memory-bound op (bn) and one
        # clearly compute-bound (conv) — only bn may surface as a
        # kernel candidate
        f.write(json.dumps({
            "type": "op_costs", "device_kind": "NVIDIA H100 80GB HBM3",
            "compute_dtype": "bf16", "n_ops": 2, "ops": [
                {"name": "stage1_bn1", "op": "BatchNorm",
                 "flops": 1e6, "bytes": 1e9, "numel_out": 100},
                {"name": "stage1_conv1", "op": "Convolution",
                 "flops": 1e13, "bytes": 1e6, "numel_out": 100},
            ]}) + "\n")
        for shape in ([16, 8], [12, 8]):
            f.write(json.dumps({
                "type": "recompile", "program": 0,
                "diff": {"changed": {"data": {"shape": {
                    "was": [32, 8], "now": shape}}},
                    "added": [], "removed": []}}) + "\n")
        f.write(json.dumps({"type": "metrics", "metrics": {
            "fit.step_seconds": {"kind": "histogram", "streams": [{
                "labels": {}, "count": 20, "sum": 20 * 0.012,
                "counts": [0, 0, 0, 0, 18, 2, 0, 0, 0, 0, 0, 0, 0, 0,
                           0, 0],
                "buckets": [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                            0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                            30.0]}]}}}) + "\n")

    anatomy, recompiles, metrics, op_costs = load_records(path)
    assert len(anatomy) == 3 and len(recompiles) == 2, (anatomy, recompiles)
    assert op_costs and op_costs["n_ops"] == 2, op_costs

    # kernel candidates: the memory-bound bn surfaces, the
    # compute-bound conv does not
    kc = kernel_candidates_section(op_costs, anatomy)
    assert kc and "stage1_bn1" in kc, kc
    assert "stage1_conv1" not in kc, kc
    # unknown device kind -> no peaks -> section degrades to None
    assert kernel_candidates_section(
        {"ops": op_costs["ops"], "device_kind": "mystery-chip",
         "compute_dtype": "bf16"}, []) is None

    # steady diagnosis must drop the warmup interval and rank
    # device_sync (12 ms/step) first; with it kept, the warmup
    # unattributed (2 s over 10 steps) dominates instead
    ranked, steps, wall = diagnose(steady_intervals(anatomy))
    assert steps == 20 and ranked[0][0] == "device_sync", ranked
    assert abs(ranked[0][2] - 12.0) < 1e-6, ranked
    ranked_all, _, _ = diagnose(steady_intervals(anatomy, keep_all=True))
    assert ranked_all[0][0] == "unattributed", ranked_all

    causes = recompile_causes(recompiles)
    assert causes[0][0] == 2 and causes[0][1] == "data.shape", causes

    traj = format_mfu_trajectory(anatomy)
    assert "0.120 -> 0.140" in traj and "last 0.140" in traj, traj

    pcts = _step_latency_percentiles(metrics)
    assert pcts is not None and 0.005 < pcts[0] <= 0.01, pcts
    assert 0.01 < pcts[1] <= 0.025, pcts

    # AMP advice fires on (f32, the card); stays silent for bf16 or CPU
    assert "MXTPU_AMP=bf16" in (amp_advice(anatomy) or ""), anatomy
    assert amp_advice([anatomy_rec(0, dict(base), 0.01, mfu=0.2,
                                   dtype="bf16", kind="NVIDIA H100 80GB HBM3")]) is None
    assert amp_advice([anatomy_rec(0, dict(base), 0.01, mfu=0.2,
                                   dtype="f32", kind="cpu")]) is None
    assert amp_advice([anatomy_rec(0, dict(base), 0.01)]) is None

    # input-bound advice fires when input_wait is the diagnosis, and
    # folds in the io.queue_depth reading when the snapshot carries it
    starve = dict(base)
    starve["input_wait"] = 0.5
    starve_ranked, _, _ = diagnose([anatomy_rec(0, starve, 0.01)])
    msg = input_advice(starve_ranked) or ""
    assert "input-bound — raise MXTPU_INPUT_WORKERS / check " \
           "io.queue_depth" in msg, msg
    msg = input_advice(starve_ranked, {"io.queue_depth": {
        "kind": "gauge", "streams": [
            {"labels": {"queue": "ready"}, "value": 0.0}]}}) or ""
    assert "workers are the bottleneck" in msg, msg
    assert input_advice(ranked) is None, ranked  # device_sync diagnosis

    # guardrail section: silent run -> no section; any activity -> the
    # matching lines, with counts summed across label streams
    assert guardrail_section(metrics) is None
    assert guardrail_section(None) is None
    gtext = guardrail_section({
        "guard.trips": {"kind": "counter", "streams": [
            {"labels": {}, "value": 3}]},
        "guard.skips": {"kind": "counter", "streams": [
            {"labels": {}, "value": 2}]},
        "guard.rewinds": {"kind": "counter", "streams": [
            {"labels": {}, "value": 1}]},
        "io.bad_records": {"kind": "counter", "streams": [
            {"labels": {"uri": "a"}, "value": 4},
            {"labels": {"uri": "b"}, "value": 1}]}})
    assert "== guardrails ==" in gtext, gtext
    assert "3 anomaly trip(s), 2 update(s) skipped" in gtext, gtext
    assert "1 rewind(s) to last-good checkpoint" in gtext, gtext
    assert "5 input record(s) quarantined" in gtext, gtext

    # serving section: silent for a training run; latency + occupancy +
    # decode lines when the snapshot carries serve.* activity
    assert serving_section(metrics) is None
    assert serving_section(None) is None
    lat_buckets = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0]
    stext = serving_section({
        "serve.requests": {"kind": "counter", "streams": [
            {"labels": {}, "value": 90}]},
        "serve.batches": {"kind": "counter", "streams": [
            {"labels": {}, "value": 15}]},
        "serve.pad_rows": {"kind": "counter", "streams": [
            {"labels": {}, "value": 30}]},
        "serve.e2e_seconds": {"kind": "histogram", "streams": [
            {"labels": {}, "count": 90, "sum": 90 * 0.004,
             "counts": [0, 0, 45, 40, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0],
             "buckets": lat_buckets}]},
        "serve.queue_wait_seconds": {"kind": "histogram", "streams": [
            {"labels": {}, "count": 90, "sum": 90 * 0.003,
             "counts": [0, 0, 50, 38, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0],
             "buckets": lat_buckets}]},
        "serve.gen_requests": {"kind": "counter", "streams": [
            {"labels": {}, "value": 4}]},
        "serve.tokens": {"kind": "counter", "streams": [
            {"labels": {}, "value": 64}]}})
    assert "== serving ==" in stext, stext
    assert "90 request(s) in 15 batch(es), mean occupancy 75%" in stext, \
        stext
    assert "latency p50=" in stext and "p99=" in stext, stext
    assert "queue-dominated" in stext, stext
    assert "decode: 4 generation(s), 64 token(s)" in stext, stext

    text = report(path)
    assert "diagnosis: largest cost is device_sync" in text, text
    assert "== guardrails ==" not in text, text  # silent run
    assert "input-bound" not in text, text
    assert "compute-bound" in text, text
    assert "fp32 compute on the card" in text, text
    assert "2x data.shape" in text, text
    assert "MFU trajectory" in text and "step anatomy" in text, text
    assert "p50=" in text and "p99=" in text, text
    assert "kernel candidates" in text and "stage1_bn1" in text, text
    assert "multistep: K=8 (auto, settled)" in text, text

    # empty / anatomy-free file degrades to a message, not a crash
    empty = os.path.join(d, "empty.jsonl")
    with open(empty, "w") as f:
        f.write(json.dumps({"type": "span", "name": "x", "ts": 0,
                            "dur": 1}) + "\n")
    assert "no anatomy records" in report(empty)

    # -- fleet section over a multi-rank run dir ------------------------
    run = os.path.join(d, "run")
    os.makedirs(run)
    for rank in range(3):
        slow = 0.2 if rank == 1 else 0.0
        with open(os.path.join(run, "telemetry_r%d.jsonl" % rank),
                  "w") as f:
            for ivl in range(3):
                phases = dict(base)
                phases["input_wait"] += slow
                wall = sum(phases.values()) + 0.01
                f.write(json.dumps({
                    "type": "anatomy", "interval": ivl,
                    "step_end": (ivl + 1) * 10, "steps": 10,
                    "rank": rank, "pid": 100 + rank, "host": "h",
                    "wall_seconds": wall, "step_ms": 100.0 * wall,
                    "phases": phases, "unattributed_seconds": 0.01,
                    "recompiles": 0}) + "\n")
    fleet_report = report(run)
    assert "== fleet (3 ranks) ==" in fleet_report, fleet_report
    assert "rank 1 is input-bound" in fleet_report, fleet_report
    assert "STRAGGLER" in fleet_report, fleet_report
    assert "single-stream diagnosis: telemetry_r1.jsonl" in fleet_report, \
        fleet_report
    assert "skew trend" in fleet_report, fleet_report
    # pointing at ONE rank's stream inside the same run dir also grows
    # the fleet section above the single-stream diagnosis
    one = report(os.path.join(run, "telemetry_r0.jsonl"))
    assert "== fleet (3 ranks) ==" in one, one
    assert "== step anatomy ==" in one, one
    print("self-test passed")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Diagnose step-time anatomy from a telemetry JSONL")
    parser.add_argument("path", nargs="?", help="telemetry .jsonl file")
    parser.add_argument("--all-intervals", action="store_true",
                        help="include the warmup interval in the "
                             "diagnosis (kept out by default)")
    parser.add_argument("--self-test", action="store_true",
                        help="run built-in checks on synthetic inputs")
    args = parser.parse_args(argv)
    if args.self_test:
        return _self_test()
    if not args.path:
        parser.error("path required (or --self-test)")
    print(report(args.path, keep_all=args.all_intervals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
