"""Recompile accounting of the PyTorch port (the recompile detector of
``mxnet_tpu/telemetry/anatomy.py``; the rest of step anatomy — cost
capture, phase decomposition, MFU and roofline records — waits for the
telemetry step of the port's roadmap, Queue 1 step 10).

In the JAX package a dispatch-plan signature seen for the first time is a
fresh trace and compile. Its counterpart here is a fresh CUDA-graph
capture: a serving dispatch (``predict._ServeFn``, the decode step of
``serving.decode.GenerationEngine``) whose signature has no graph yet.
Each such miss reports here with the program's uid and its signature. The
first miss per program is its warm-up; each later one increments
``anatomy.recompiles``, is logged with the fingerprint diff against the
program's previous signature, and means the steady state left its
compiled buckets. Nothing is counted while telemetry is disabled (or
``MXTPU_ANATOMY=0``).
"""
from __future__ import annotations

import json
import logging
import os
import threading

from . import registry as _registry

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry.anatomy")

_lock = threading.Lock()

_C_RECOMPILES = _registry.counter(
    "anatomy.recompiles",
    "Dispatch-plan signature cache misses AFTER the warmup capture — "
    "each one is a fresh CUDA-graph capture on the hot path")

_last_fp = {}  # program_uid -> fingerprint dict


def enabled():
    """Anatomy rides on telemetry: off when collection is off, and
    MXTPU_ANATOMY=0 switches just this layer off."""
    return (_registry.enabled()
            and os.environ.get("MXTPU_ANATOMY", "1") not in ("", "0"))


def _fingerprint(sig):
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
    return fp


def fingerprint_diff(prev, now):
    """Structured diff between two program fingerprints: per-input field
    changes plus added/removed inputs and changed tags."""
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
    if prev.get("tags") != now.get("tags"):
        out["meta"] = {"tags": {"was": prev.get("tags"), "now": now.get("tags")}}
    return out


def note_plan_miss(program_uid, sig):
    """Called on every signature-cache miss of a serving program. The first
    miss per program is the warm-up capture; each later miss is a
    recompile: the counter, and a warning with the fingerprint diff."""
    if not enabled():
        return
    fp = _fingerprint(sig)
    with _lock:
        prev = _last_fp.get(program_uid)
        _last_fp[program_uid] = fp
    if prev is None:
        return
    _C_RECOMPILES.inc()
    _LOG.warning("recompile: program=%s diff=%s", program_uid,
                 json.dumps(fingerprint_diff(prev, fp), sort_keys=True))
