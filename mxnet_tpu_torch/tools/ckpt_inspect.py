"""Inspect resilience checkpoints with the PyTorch port (counterpart of the
repo's ``tools/ckpt_inspect.py``, which imports the JAX package).

Operates on a checkpoint directory written by either package's
``resilience.CheckpointManager`` (one ``ckpt-<step>/`` subdir per
snapshot; the format is in docs/robustness.md). Three views:

* default — one line per checkpoint: step, size, validity;
* ``--verify`` — full verification including per-tensor CRC32 re-hash
  (exit code 1 if any checkpoint fails);
* ``--state <step|latest>`` — training-state summary of one checkpoint
  (epoch/batch/step position, tensor names+shapes, optimizer kind, RNG).

Usage::

    python -m mxnet_tpu_torch.tools.ckpt_inspect /runs/exp1/ckpts
    python -m mxnet_tpu_torch.tools.ckpt_inspect /runs/exp1/ckpts --verify
    python -m mxnet_tpu_torch.tools.ckpt_inspect /runs/exp1/ckpts --state latest
    python -m mxnet_tpu_torch.tools.ckpt_inspect --self-test
"""
from __future__ import annotations

import argparse
import os
import sys

from mxnet_tpu_torch.resilience import checkpoint as ck


def _dir_bytes(path):
    total = 0
    for name in os.listdir(path):
        try:
            total += os.path.getsize(os.path.join(path, name))
        except OSError:
            pass
    return total


def _topology_str(manifest):
    topo = manifest.get("topology")
    if not topo:
        return None
    return "dp=%s global_batch=%s per_replica_batch=%s mesh=%s" % (
        topo.get("dp"), topo.get("global_batch"),
        topo.get("per_replica_batch"), topo.get("mesh"))


def _health_str(manifest):
    """Render the guardrail ``health`` stamp: clean/ANOMALOUS, the last
    step the detector saw as clean, and the trip/skip tallies. None for
    unstamped (guardrail-off) checkpoints."""
    health = manifest.get("health")
    if not isinstance(health, dict):
        return None
    return "%s last_clean=%s trips=%s skips=%s" % (
        "clean" if health.get("clean") else "ANOMALOUS",
        health.get("last_clean_step"), health.get("trips"),
        health.get("skips"))


def topology_warnings(manifest, expect_dp=None, expect_batch=None):
    """Cross-world restore preflight: WARNINGS (never failures — the
    state format is layout-independent, so a dp/batch mismatch means an
    elastic resume, not a corrupt checkpoint) when the writer's recorded
    topology differs from what the restoring world expects."""
    topo = manifest.get("topology") or {}
    warnings = []
    if expect_dp is not None and topo.get("dp") not in (None, expect_dp):
        warnings.append(
            "WARNING: written at dp=%s but restoring world expects "
            "dp=%s — optimizer slabs will be re-sharded on resume "
            "(not bitwise vs the writer's world)"
            % (topo.get("dp"), expect_dp))
    if (expect_batch is not None
            and topo.get("global_batch") not in (None, expect_batch)):
        warnings.append(
            "WARNING: written at global batch %s but restoring world "
            "expects %s — the data cursor will be rescaled by global "
            "sample position on resume"
            % (topo.get("global_batch"), expect_batch))
    return warnings


def list_dir(directory, deep=False, expect_dp=None, expect_batch=None):
    """(lines, n_bad) listing every checkpoint and its verification
    status; ``deep`` re-hashes tensors too. ``expect_dp`` /
    ``expect_batch`` append cross-world restore warnings."""
    lines = []
    bad = 0
    steps = ck.list_checkpoints(directory)
    if not steps:
        return ["no checkpoints under %s" % directory], 0
    for step in steps:
        path = ck.step_dir(directory, step)
        try:
            manifest = ck.verify_checkpoint(path, deep=deep)
            n_tensors = len(manifest.get("tensors", {}))
            topo = _topology_str(manifest)
            health = _health_str(manifest)
            lines.append("ckpt-%012d  %9d bytes  %3d tensors  OK%s%s%s"
                         % (step, _dir_bytes(path), n_tensors,
                            " (deep)" if deep else "",
                            "  [%s]" % topo if topo else "",
                            "  [health: %s]" % health if health else ""))
            for warning in topology_warnings(
                    manifest, expect_dp, expect_batch):
                lines.append("  %s" % warning)
        except ck.CheckpointError as exc:
            bad += 1
            lines.append("ckpt-%012d  CORRUPT: %s" % (step, exc))
    return lines, bad


def last_good(directory):
    """Path of the newest healthy checkpoint (verifies AND health stamp
    is clean or absent) — the guardrail rewind target. Raises
    SystemExit when nothing qualifies so the shell sees exit 1."""
    path = ck.CheckpointManager(directory).last_good()
    if path is None:
        raise SystemExit("no known-good checkpoint under %s" % directory)
    return path


def state_summary(directory, which):
    """Human-readable training-state summary of one checkpoint."""
    if which == "latest":
        mgr = ck.CheckpointManager(directory)
        path = mgr.latest_valid()
        if path is None:
            raise SystemExit("no valid checkpoint under %s" % directory)
    else:
        path = ck.step_dir(directory, int(which))
    manifest = ck.verify_checkpoint(path)
    with open(os.path.join(path, ck.TRAIN_FILE), "rb") as f:
        train = ck.restricted_loads(f.read(), ck.TRAIN_FILE)
    with open(os.path.join(path, ck.OPT_FILE), "rb") as f:
        opt = ck.restricted_loads(f.read(), ck.OPT_FILE)
    lines = [
        "checkpoint : %s" % path,
        "step       : %s" % manifest.get("step"),
        "epoch      : %s  (next batch %s)"
        % (train.get("epoch"), train.get("nbatch")),
        "global_step: %s" % train.get("global_step"),
        "optimizer  : %s" % (opt.get("kind") if isinstance(opt, dict)
                             else type(opt).__name__),
        "metric     : %s" % ("saved (%d bytes)" % len(train["metric"])
                             if train.get("metric") else "none"),
        "rng        : %s" % ", ".join(sorted(
            (train.get("rng") or {}).keys())),
        "topology   : %s" % (_topology_str(manifest)
                             or "not recorded (pre-elastic checkpoint)"),
        "health     : %s" % (_health_str(manifest)
                             or "not stamped (guardrails off)"),
        "tensors    :",
    ]
    arrays = ck._read_params(path)
    for key in sorted(arrays):
        arr = arrays[key]
        lines.append("  %-28s %-14s %s"
                     % (key, str(arr.dtype).replace("torch.", ""),
                        tuple(arr.shape)))
    return "\n".join(lines)


def _self_test():
    """Write, corrupt, and inspect synthetic checkpoints end to end."""
    import tempfile

    import numpy as np

    d = tempfile.mkdtemp(prefix="ckpt_inspect_test_")
    mgr = ck.CheckpointManager(d, keep=5)
    state = {
        "module": {
            "arg": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "aux": {"m": np.ones(3, dtype=np.float64)},
            "opt": {"kind": "none"},
        },
        "epoch": 1, "nbatch": 2, "global_step": 10,
        "metric": None, "rng": {"numpy": np.random.get_state()},
        "topology": {"dp": 4, "mesh": {"dp": 4}, "global_batch": 16,
                     "per_replica_batch": 4},
    }
    mgr.save(state, 10)
    mgr.save(state, 20)
    lines, bad = list_dir(d, deep=True)
    assert bad == 0 and len(lines) == 2, lines
    assert all("OK" in ln for ln in lines), lines
    assert all("dp=4" in ln and "global_batch=16" in ln
               for ln in lines), lines

    # cross-world preflight: mismatches WARN (extra lines), never fail
    lines, bad = list_dir(d, expect_dp=2, expect_batch=32)
    assert bad == 0, lines
    assert sum("WARNING" in ln for ln in lines) == 4, lines
    lines, bad = list_dir(d, expect_dp=4, expect_batch=16)
    assert bad == 0 and not any("WARNING" in ln for ln in lines), lines

    text = state_summary(d, "latest")
    assert "global_step: 10" in text, text
    assert "topology   : dp=4" in text, text
    assert "arg:w" in text and "(3, 4)" in text, text

    # tear the newest one; the lister must flag it and --state latest
    # must fall back to the older valid snapshot
    with open(os.path.join(ck.step_dir(d, 20), ck.PARAMS_FILE),
              "r+b") as f:
        f.truncate(16)
    lines, bad = list_dir(d)
    assert bad == 1, lines
    assert any("CORRUPT" in ln for ln in lines), lines
    text = state_summary(d, "latest")
    assert "ckpt-%012d" % 10 in text, text
    # unstamped checkpoints: summary says so, --last-good still finds
    # the newest VALID one (absence of a stamp is not an anomaly)
    assert "not stamped (guardrails off)" in text, text
    assert last_good(d) == ck.step_dir(d, 10), last_good(d)

    # guardrail health stamps: clean shows in the listing; an
    # ANOMALOUS newest checkpoint is skipped by --last-good
    state_clean = dict(state)
    state_clean["health"] = {"clean": True, "step": 30,
                             "last_clean_step": 30, "trips": 0,
                             "skips": 0}
    mgr.save(state_clean, 30)
    state_bad = dict(state)
    state_bad["health"] = {"clean": False, "step": 40,
                           "last_clean_step": 30, "trips": 3, "skips": 2}
    mgr.save(state_bad, 40)
    lines, _ = list_dir(d)
    assert any("health: clean last_clean=30" in ln for ln in lines), lines
    assert any("health: ANOMALOUS last_clean=30 trips=3 skips=2" in ln
               for ln in lines), lines
    text = state_summary(d, "latest")
    assert "health     : ANOMALOUS" in text, text
    assert last_good(d) == ck.step_dir(d, 30), last_good(d)
    print("self-test passed")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="List, verify, and summarize resilience checkpoints")
    parser.add_argument("directory", nargs="?",
                        help="checkpoint directory (CheckpointManager root)")
    parser.add_argument("--verify", action="store_true",
                        help="re-hash every file AND every tensor "
                             "(exit 1 if any checkpoint fails)")
    parser.add_argument("--state", metavar="STEP",
                        help="print the training-state summary of one "
                             "checkpoint ('latest' or a step number)")
    parser.add_argument("--last-good", action="store_true",
                        help="print the path of the newest HEALTHY "
                             "checkpoint (verifies, and its guardrail "
                             "health stamp — when present — says clean); "
                             "exit 1 when none qualifies")
    parser.add_argument("--self-test", action="store_true",
                        help="run built-in checks on synthetic checkpoints")
    parser.add_argument("--expect-dp", type=int, default=None,
                        help="warn when a checkpoint's recorded dp degree "
                             "differs from the restoring world's "
                             "(elastic-resume preflight; never an error)")
    parser.add_argument("--expect-batch", type=int, default=None,
                        help="warn when a checkpoint's recorded global "
                             "batch differs from the restoring world's")
    args = parser.parse_args(argv)
    if args.self_test:
        return _self_test()
    if not args.directory:
        parser.error("directory required (or --self-test)")
    if args.last_good:
        print(last_good(args.directory))
        return 0
    if args.state:
        print(state_summary(args.directory, args.state))
        return 0
    lines, bad = list_dir(args.directory, deep=args.verify,
                          expect_dp=args.expect_dp,
                          expect_batch=args.expect_batch)
    print("\n".join(lines))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
