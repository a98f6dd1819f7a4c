"""Step-time anatomy of the port: MFU attribution, roofline accounting,
recompiles (counterpart of ``mxnet_tpu/telemetry/anatomy.py``).

- **Cost capture** — the fused trainer hands this module a cost thunk per
  dispatch signature (one step, or a group of K); :func:`capture_cost`
  runs it once per signature and exports live ``anatomy.model_flops`` /
  ``anatomy.model_bytes_accessed`` gauges. The JAX package's thunk AOT-
  compiles the program and reads XLA's ``cost_analysis()``; the port's
  counts the bound symbol with ``costmodel.analytic_step_cost`` and runs
  nothing, so a capture moves no parameter, optimizer state, generator
  or allocator state (``MXTPU_ANATOMY_COSTS=0`` and ``=1`` train to the
  same bits). ``steps`` divides a K-step group's cost back to one step.
- **Phase decomposition** — the fit loop calls :func:`begin_loop` /
  :func:`on_steps`; every MXTPU_ANATOMY_INTERVAL steps (and at epoch
  end) :func:`emit_interval` takes registry deltas of the phase-time
  histograms (input wait, staging, dispatch, device sync, collectives),
  subtracts them from measured wall time, and writes one
  ``{"type": "anatomy"}`` JSONL record in which the *unattributed*
  remainder is an explicit field, so phases + unattributed = wall
  exactly — plus MFU and a roofline classification against the card's
  peak table (``costmodel``) when the cost is known.
- **Recompile detector** — a dispatch signature seen for the first time
  is the port's counterpart of a fresh trace and compile: a fresh
  CUDA-graph capture (the serving programs, ``predict._ServeFn`` and the
  decode step, the fit's K-step groups, which report as a program of
  their own beside the eager single step). Each miss reports here; after
  the warm-up capture each
  miss increments ``anatomy.recompiles``, writes a ``{"type":
  "recompile"}`` record and logs the structured fingerprint diff.

Disjointness under asynchronous dispatch: the phases are host wall time
on the fit loop's thread. An eager step's kernels, and a CUDA-graph
replay, are enqueued and the call returns before the card runs them, so
``dispatch_host`` (and any span around such a call) measures the host's
enqueue, not the card. The device leg is what the host later waits for:
``device_sync`` (``module.output_sync_seconds``), where the fit loop
reads a step's outputs. The same rule holds in the JAX package under its
async dispatch.

Everything is a no-op unless telemetry is enabled AND MXTPU_ANATOMY is
not "0"; all hooks are exception-safe observers — anatomy must never
break a dispatch.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from . import costmodel
from . import export as _export
from . import registry as _registry

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry.anatomy")

_lock = threading.Lock()


def enabled():
    """Anatomy rides on telemetry: off when collection is off, and
    MXTPU_ANATOMY=0 switches just this layer off."""
    return (_registry.enabled()
            and os.environ.get("MXTPU_ANATOMY", "1") not in ("", "0"))


def wants_cost():
    """Whether the trainers should capture the step's cost
    (MXTPU_ANATOMY_COSTS=0 skips it; the capture counts the symbol and
    runs nothing)."""
    return (enabled()
            and os.environ.get("MXTPU_ANATOMY_COSTS", "1") not in ("", "0"))


def _interval_steps():
    try:
        return max(int(os.environ.get("MXTPU_ANATOMY_INTERVAL", "32")), 1)
    except ValueError:
        return 32


_C_RECOMPILES = _registry.counter(
    "anatomy.recompiles",
    "Dispatch-plan signature cache misses AFTER the warmup capture — "
    "each one is a fresh CUDA-graph capture on the hot path; the paired "
    "JSONL 'recompile' record carries the structured fingerprint diff")
_C_COST_HITS = _registry.counter(
    "anatomy.cost_cache_hits",
    "Cost-model lookups served from the per-signature cache")
_C_COST_MISSES = _registry.counter(
    "anatomy.cost_cache_misses",
    "Cost-model lookups that ran the cost thunk (the analytic count)")
_G_MFU = _registry.gauge(
    "anatomy.mfu",
    "Model FLOPs utilization over the last anatomy interval: "
    "flops_per_step * steps / wall / peak_flops (wall-rate based)")
_G_MODEL_FLOPS = _registry.gauge(
    "anatomy.model_flops",
    "Per-step FLOPs of the active program (costmodel.analytic_step_cost)")
_G_MODEL_BYTES = _registry.gauge(
    "anatomy.model_bytes_accessed",
    "Per-step HBM bytes of the active program "
    "(costmodel.analytic_step_cost)")


# ---------------------------------------------------------------------------
# cost capture (per compiled program, cached by dispatch-plan signature)
# ---------------------------------------------------------------------------

_cost_cache = {}  # (program_uid, key) -> {"flops", "bytes_accessed"} | None
_current_cost = None  # the cost dict of the most recently dispatched program


def capture_cost(program_uid, key, cost_thunk, steps=1, dtype=None):
    """Resolve the per-step device cost of one program.

    ``cost_thunk`` returns ``{"flops", "bytes_accessed"}`` of one dispatch
    of the program at the signature ``key`` (``costmodel.
    analytic_step_cost``, times K for a K-step group); it runs at most
    once per (program, signature). ``steps`` divides multi-step program
    totals back to per-step. ``dtype`` tags the program's compute dtype
    ("bf16"/"f32") so MFU is computed against the right peak — f32
    compute can never reach the bf16 peak. Failures cache as None —
    never retried, never raised.
    """
    global _current_cost
    ck = (program_uid, key)
    with _lock:
        if ck in _cost_cache:
            _C_COST_HITS.inc()
            cost = _cost_cache[ck]
            if cost:
                _current_cost = cost
            return cost
    _C_COST_MISSES.inc()
    cost = None
    try:
        raw = cost_thunk() or {}
        raw = {"flops": raw.get("flops"),
               "bytes_accessed": raw.get("bytes_accessed")}
        if raw["flops"] or raw["bytes_accessed"]:
            cost = {
                "flops": (raw["flops"] or 0.0) / max(steps, 1),
                "bytes_accessed":
                    (raw["bytes_accessed"] or 0.0) / max(steps, 1),
            }
            if dtype:
                cost["compute_dtype"] = str(dtype)
    except Exception as exc:
        _LOG.debug("cost capture failed (program=%s): %s", program_uid, exc)
    with _lock:
        _cost_cache[ck] = cost
        if cost:
            _current_cost = cost
    if cost:
        _G_MODEL_FLOPS.set(cost["flops"])
        _G_MODEL_BYTES.set(cost["bytes_accessed"])
    return cost


# ---------------------------------------------------------------------------
# recompile detector
# ---------------------------------------------------------------------------

_program_meta = {}  # program_uid -> {"mesh": ..., "donation": ...}
_last_fp = {}  # program_uid -> fingerprint dict


def register_program(program_uid, **meta):
    """Attach trace-level context (mesh layout, donation policy) that a
    dispatch signature alone cannot see; it joins every fingerprint."""
    clean = {k: v for k, v in meta.items() if v is not None}
    if clean:
        _program_meta[program_uid] = clean


def _fingerprint(program_uid, sig):
    inputs = {}
    tags = []
    for entry in sig:
        if (isinstance(entry, tuple) and len(entry) == 4
                and isinstance(entry[0], str)):
            name, shape, dtype, sharding = entry
            inputs[name] = {"shape": list(shape), "dtype": str(dtype),
                            "sharding": str(sharding)}
        else:
            tags.append(str(entry))
    fp = {"inputs": inputs}
    if tags:
        fp["tags"] = tags
    fp.update(_program_meta.get(program_uid, {}))
    return fp


def fingerprint_diff(prev, now):
    """Structured diff between two program fingerprints: per-input field
    changes plus added/removed inputs and changed program meta."""
    pi, ni = prev.get("inputs", {}), now.get("inputs", {})
    changed = {}
    for name in sorted(set(pi) & set(ni)):
        fields = {}
        for f in ("shape", "dtype", "sharding"):
            if pi[name].get(f) != ni[name].get(f):
                fields[f] = {"was": pi[name].get(f), "now": ni[name].get(f)}
        if fields:
            changed[name] = fields
    out = {"changed": changed,
           "added": sorted(set(ni) - set(pi)),
           "removed": sorted(set(pi) - set(ni))}
    meta = {}
    for f in sorted(set(prev) | set(now) - {"inputs"}):
        if f == "inputs":
            continue
        if prev.get(f) != now.get(f):
            meta[f] = {"was": prev.get(f), "now": now.get(f)}
    if meta:
        out["meta"] = meta
    return out


def note_plan_miss(program_uid, sig):
    """Called on every signature-cache miss of a captured program. The
    first miss per program is the warm-up capture; each later miss is a
    recompile: counter + structured JSONL diff + warning."""
    if not enabled():
        return
    fp = _fingerprint(program_uid, sig)
    with _lock:
        prev = _last_fp.get(program_uid)
        _last_fp[program_uid] = fp
    if prev is None:
        return
    _C_RECOMPILES.inc()
    diff = fingerprint_diff(prev, fp)
    _export.emit_record({"type": "recompile", "t": time.time(),
                         "program": program_uid, "diff": diff,
                         "fingerprint": fp})
    _LOG.warning("recompile: program=%s diff=%s", program_uid,
                 json.dumps(diff, sort_keys=True))


# ---------------------------------------------------------------------------
# per-interval step anatomy
# ---------------------------------------------------------------------------

# (phase name, source metric). Phases are DISJOINT host-wall regions of
# the fit loop; dispatch_host is special-cased below because its
# measurement window includes the staging slice.
_PHASES = (
    ("input_wait", "io.feed_wait_seconds"),
    ("stage_host", "module.stage_host_seconds"),
    ("dispatch_host", "module.dispatch_host_seconds"),
    ("device_sync", "module.output_sync_seconds"),
    ("collective", "parallel.collective_seconds"),
)


def _phase_totals():
    return {name: _registry.REGISTRY.total(metric)
            for name, metric in _PHASES}


_state = None  # active interval accumulator (fit-loop thread only)
_multistep = None  # last MXNET_FIT_MULTISTEP=auto decision (joins records)


def note_multistep(k, settled, dispatch_frac=None):
    """Record the fit loop's current multi-step group depth (the
    MXNET_FIT_MULTISTEP=auto tuner's choice) so every subsequent anatomy
    interval record carries it — the chosen depth is part of the step's
    anatomy, not a side channel."""
    global _multistep
    ms = {"k": int(k), "auto": True, "settled": bool(settled)}
    if dispatch_frac is not None:
        ms["dispatch_frac"] = round(float(dispatch_frac), 4)
    _multistep = ms


def emit_decision(record):
    """Write one freestanding decision record (e.g. type=multistep_auto)
    to the telemetry JSONL. No-op when anatomy is off; never raises."""
    if not enabled():
        return
    try:
        rec = dict(record)
        rec.setdefault("t", time.time())
        _export.emit_record(rec)
    except Exception as exc:  # noqa: BLE001 — observers must not raise
        _LOG.debug("emit_decision failed: %s", exc)


def note_op_costs(ops, device_kind=None, compute_dtype=None):
    """Emit the per-op analytic cost table (costmodel.analytic_op_costs)
    as one ``{"type": "op_costs"}`` JSONL record. perf_doctor joins it
    with the peak tables to rank memory-bound ops as candidates for
    hand-written CUDA. Best-effort: truncates to 64 ops, never raises."""
    if not enabled() or not ops:
        return
    try:
        _export.emit_record({
            "type": "op_costs",
            "t": time.time(),
            "device_kind": device_kind or _device_kind(),
            "compute_dtype": compute_dtype,
            "n_ops": len(ops),
            "ops": list(ops)[:64],
        })
    except Exception as exc:  # noqa: BLE001 — observers must not raise
        _LOG.debug("note_op_costs failed: %s", exc)


def begin_loop():
    """Arm the interval accumulator at the top of a fit loop."""
    global _state
    if not enabled():
        _state = None
        return
    _state = {
        "t0": time.perf_counter(),
        "totals": _phase_totals(),
        "steps": 0,
        "interval": 0,
        "step_end": 0,
        "recompiles0": _C_RECOMPILES.value(),
    }


def on_steps(n=1):
    """Record n completed optimizer steps; emits when the interval
    fills."""
    if _state is None or n <= 0:
        return
    _state["steps"] += n
    if _state["steps"] >= _interval_steps():
        emit_interval()


def emit_interval(force=False):
    """Close the current interval: phase deltas vs wall time, MFU,
    roofline, recompile count — one JSONL record. ``force`` flushes a
    partial interval (epoch end); empty intervals never emit."""
    st = _state
    if st is None:
        return None
    steps = st["steps"]
    if steps <= 0 or (steps < _interval_steps() and not force):
        return None
    now = time.perf_counter()
    wall = now - st["t0"]
    totals = _phase_totals()
    phases = {name: max(totals[name] - st["totals"][name], 0.0)
              for name, _ in _PHASES}
    # the dispatch measurement window includes staging — report only the
    # non-stage remainder so the phases stay disjoint
    phases["dispatch_host"] = max(
        phases["dispatch_host"] - phases["stage_host"], 0.0)
    record = {
        "type": "anatomy",
        "t": time.time(),
        "interval": st["interval"],
        # cumulative steps completed at interval close — the step id the
        # fleet aggregator aligns cross-rank intervals on
        "step_end": st["step_end"] + steps,
        "steps": steps,
        "wall_seconds": wall,
        "step_ms": 1000.0 * wall / steps,
        "phases": phases,
        # NOT clamped: phases + unattributed must sum to wall exactly
        "unattributed_seconds": wall - sum(phases.values()),
        "recompiles": _C_RECOMPILES.value() - st["recompiles0"],
    }
    if _multistep is not None:
        record["multistep"] = dict(_multistep)
    cost = _current_cost
    if cost:
        record["flops_per_step"] = cost["flops"]
        record["bytes_per_step"] = cost["bytes_accessed"]
        kind = _device_kind()
        dtype = cost.get("compute_dtype")
        if dtype:
            record["compute_dtype"] = dtype
        record["device_kind"] = kind
        # dtype-aware roofline: f32 programs are measured against the
        # card's FP32 peak, not the bf16 number it is sold on
        pf = costmodel.peak_flops_for_kind(kind, dtype)
        pb = costmodel.peak_bytes_for_kind(kind)
        if cost["flops"] and pf and wall > 0:
            mfu = cost["flops"] * steps / wall / pf
            if mfu <= 1.0:
                record["mfu"] = mfu
                _G_MFU.set(mfu)
            else:
                # >100% means the peak table or the cost model is wrong
                # for this device — say so instead of reporting a
                # nonsense utilization
                record["mfu_error"] = (
                    "mfu %.2f > 1: check peak table / "
                    "MXTPU_ANATOMY_PEAK_TFLOPS for kind %r" % (mfu, kind))
        record["roofline"] = costmodel.classify(
            cost["flops"] * steps if cost["flops"] else None,
            (cost["bytes_accessed"] * steps
             if cost["bytes_accessed"] else None),
            wall, phases["collective"], pf, pb)
    _export.emit_record(record)
    st["t0"] = now
    st["totals"] = totals
    st["step_end"] += steps
    st["steps"] = 0
    st["interval"] += 1
    st["recompiles0"] += record["recompiles"]
    return record


_kind_cache = None


def _device_kind():
    """The card's name (``torch.cuda.get_device_name``), "" on a process
    without one; the peak tables are keyed by it."""
    global _kind_cache
    if _kind_cache is None:
        try:
            import torch

            _kind_cache = (torch.cuda.get_device_name(0)
                           if torch.cuda.is_available() else "")
        except Exception:
            _kind_cache = ""
    return _kind_cache


def reset_state():
    """Drop caches, fingerprints, and the active interval (telemetry
    reset path — test isolation)."""
    global _state, _current_cost, _multistep
    with _lock:
        _cost_cache.clear()
        _last_fp.clear()
        _program_meta.clear()
        _state = None
        _current_cost = None
        _multistep = None
