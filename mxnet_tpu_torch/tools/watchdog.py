"""Supervise a training command: restart it on a crash or a heartbeat
stall, shrink it when a replica is lost (counterpart of the repo's
``tools/watchdog.py``, whose decisions and records this one keeps).

It launches the command and watches two signals:

  * the exit code: a code other than 0 restarts it (up to
    ``--max-restarts``);
  * liveness: with ``--num-workers N`` the workers' heartbeat files in the
    run dir (``mxnet_tpu_torch/parallel/heartbeat.py`` through
    ``MXTPU_RUN_DIR``); a stall longer than ``--heartbeat-timeout`` kills
    the job's process group and restarts it, which catches hangs that
    exit codes never show.

Recovery is the training script's checkpoint and resume (``fit``'s
``checkpoint_dir`` with ``resume="auto"``): the command runs again as it
is. ``find_latest_checkpoint`` finds the newest ``<prefix>-NNNN.params``
for scripts that pick their ``--load-epoch``.

``--elastic`` turns restart-at-the-same-size into shrink-and-continue: the
job runs with ``MXTPU_ELASTIC=1`` and ``MXTPU_WORLD_SIZE``, and when it
exits because a replica was declared lost (exit 76, or the watchdog saw the
dead rank or its ``lost_<rank>`` tombstone), it is relaunched at the
surviving world size without using the restart budget, which stays for
transient failures (exit 75, a preemption, retries at the same size).
``python -m mxnet_tpu_torch.tools.launch`` reads ``MXTPU_WORLD_SIZE`` when
it has no ``-n``, so a launched job shrinks with it. Usage::

    python -m mxnet_tpu_torch.tools.watchdog --max-restarts 2 -- python train.py ...
    python -m mxnet_tpu_torch.tools.watchdog --elastic --world 2 -- \
        python -m mxnet_tpu_torch.tools.launch python train.py ...
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import shutil
import subprocess
import sys
import tempfile
import time

# Literal mirrors of resilience/checkpoint.py EXIT_PREEMPTED/EXIT_RESHAPE
# and resilience/guardrail.py EXIT_GUARDRAIL (sysexits-adjacent contract
# codes; kept literal so the decision table below reads standalone).
EXIT_PREEMPTED = 75
EXIT_RESHAPE = 76
EXIT_GUARDRAIL = 78

GUARDRAIL_VERDICT_FILE = "guardrail_verdict.json"


def find_latest_checkpoint(prefix):
    """Latest epoch number among ``<prefix>-NNNN.params``, or None."""
    best = None
    for path in glob.glob("%s-*.params" % prefix):
        m = re.match(r".*-(\d+)\.params$", path)
        if m:
            epoch = int(m.group(1))
            best = epoch if best is None else max(best, epoch)
    return best


def _terminate(proc, grace=15):
    """Terminate the supervised job AND its whole process group: the
    command is typically a launcher whose workers must not survive the
    kill (an orphan would keep heartbeating into the reused run dir and
    hold the coordinator port against the restart)."""
    def _signal_group(sig):
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            if proc.poll() is None:
                proc.send_signal(sig)

    _signal_group(signal.SIGTERM)
    try:
        proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        _signal_group(signal.SIGKILL)
        proc.wait()


def decide(rc, lost, restarts, max_restarts, world, elastic):
    """The elastic restart decision table, as a pure function so the
    self-test (and the tests) can pin every row without spawning
    processes. Returns ``(action, new_world)`` with action one
    of ``"done" | "shrink" | "retry" | "fail"``.

    * ``rc == 0`` — done.
    * ``rc == EXIT_GUARDRAIL`` (78) — fail immediately, whatever the
      remaining budget: the training process itself declared the run
      numerically unrecoverable (rewind budget exhausted). Replaying
      the same data through the same model diverges the same way —
      restarts cannot fix poisoned data.
    * elastic, with lost rank(s) and at least one survivor — shrink to
      the surviving world. Shrinking does NOT consume the restart
      budget: losing capacity is the expected steady state of a
      preemptible fleet, and burning the budget on it would turn every
      shrink into one fewer recovery from a genuinely transient failure.
    * restart budget remaining — same-size retry (this is the exit-75
      preemption path, and any other transient crash).
    * otherwise — fail.
    """
    if rc == 0:
        return ("done", world)
    if rc == EXIT_GUARDRAIL:
        return ("fail", world)
    lost = set(lost)
    if elastic and lost and world - len(lost) >= 1:
        return ("shrink", world - len(lost))
    if restarts < max_restarts:
        return ("retry", world)
    return ("fail", world)


def fleet_evidence(run_dir):
    """Cross-rank evidence for a decision record: straggler and bottleneck
    attribution, skew, per-rank liveness, from the fleet aggregator
    (``mxnet_tpu_torch/telemetry/fleet.py``) over the per-rank telemetry
    streams in the run dir. Advisory: when no rank wrote telemetry the
    aggregator is never imported and the record says so."""
    out = {"telemetry_ranks": 0}
    if not run_dir or not os.path.isdir(run_dir):
        return out
    if not glob.glob(os.path.join(run_dir, "telemetry_r*.jsonl")):
        return out
    try:
        from ..telemetry import fleet as _fleet

        out = _fleet.FleetAggregator(run_dir).refresh().evidence()
    except Exception as exc:  # noqa: BLE001 — evidence must not kill
        out["aggregator_error"] = str(exc)  # the supervisor
    return out


def _record_guardrail(run_dir, rc):
    """On an ``EXIT_GUARDRAIL`` death, lift the structured verdict the
    training process published (``guardrail_verdict.json``) into
    ``decisions.jsonl`` as its own ``{"type": "guardrail"}`` line, so
    the terminal ``fail`` decision that follows sits next to the reason
    the run was declared unrecoverable. Returns the record, or None."""
    if not run_dir or rc != EXIT_GUARDRAIL:
        return None
    try:
        with open(os.path.join(run_dir, GUARDRAIL_VERDICT_FILE)) as f:
            verdict = json.load(f)
    except (OSError, ValueError):
        verdict = None
    record = dict(verdict) if isinstance(verdict, dict) else {}
    record["type"] = "guardrail"
    record["rc"] = rc
    record.setdefault("t", time.time())
    try:
        with open(os.path.join(run_dir, "decisions.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        pass
    return record


def _record_decision(run_dir, action, rc, stalled, lost, restarts, world,
                     new_world):
    """Append one ``{"type": "decision"}`` line to
    ``<run_dir>/decisions.jsonl`` — every supervision outcome carries
    the aggregated per-rank evidence that justified it."""
    if not run_dir:
        return
    record = {
        "type": "decision", "t": time.time(), "action": action,
        "rc": rc, "stalled": bool(stalled), "lost": sorted(lost),
        "restarts": restarts, "world": world, "new_world": new_world,
        "evidence": fleet_evidence(run_dir),
    }
    try:
        with open(os.path.join(run_dir, "decisions.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        pass


def supervise(command, max_restarts=2, num_workers=0,
              heartbeat_timeout=60.0, poll_interval=1.0, run_dir=None,
              startup_timeout=300.0, progress_timeout=None, elastic=False,
              world=None, log=print):
    """Run ``command`` under supervision; returns the final exit code
    (0 success, positive failure — signal deaths are normalized to 1 so
    callers see a stable code).

    ``num_workers > 0`` enables liveness monitoring with three stall
    classes (mxnet_tpu_torch/parallel/heartbeat.py):
      * process death/freeze — ``hb_<rank>`` stale past
        ``heartbeat_timeout`` (only once every rank beat at least once,
        so slow startup is not a false positive);
      * pre-first-heartbeat wedge (e.g. stuck distributed init) —
        ``startup_timeout`` deadline;
      * wedged-in-a-collective — process alive but no training progress
        (``prog_<rank>``) for ``progress_timeout`` seconds. Off by
        default: set it ABOVE the longest legitimate step gap,
        first-compile included.

    ``elastic=True`` (with ``world`` = the initial world size, default
    ``num_workers``) makes a lost replica shrink the restart world
    instead of burning the budget: see :func:`decide`.
    """
    from ..parallel import heartbeat as hb

    restarts = 0
    own_run_dir = None
    if elastic and not world:
        world = num_workers
    if elastic and not world:
        raise ValueError("elastic supervision needs world (or num_workers)")
    while True:
        mon_workers = world if (elastic and num_workers > 0) else num_workers
        env = dict(os.environ)
        if mon_workers > 0 or elastic:
            if run_dir is None:
                run_dir = own_run_dir = tempfile.mkdtemp(
                    prefix="mxtpu_watchdog_")
            os.makedirs(run_dir, exist_ok=True)
            # fresh staleness baseline per attempt; tombstones were read
            # into the previous attempt's shrink decision, so clearing
            # them here is what stops one lost rank shrinking every
            # subsequent restart too
            for p in (glob.glob(os.path.join(run_dir, "hb_*"))
                      + glob.glob(os.path.join(run_dir, "prog_*"))
                      + glob.glob(os.path.join(run_dir, "lost_*"))
                      + glob.glob(os.path.join(run_dir, "stall_*"))):
                os.unlink(p)
            env[hb.RUN_DIR_ENV] = run_dir
        if elastic:
            # the job sees its (possibly shrunken) world and arms fit's
            # in-loop shrink driver (module/base_module.py)
            env["MXTPU_WORLD_SIZE"] = str(world)
            env["MXTPU_ELASTIC"] = "1"
        # own process group so a stall-kill reaps the launcher's workers
        proc = subprocess.Popen(command, env=env, start_new_session=True)
        started_at = time.time()
        stalled = False
        lost_seen = set()
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            if mon_workers > 0:
                all_started = not hb.dead_nodes(
                    run_dir, mon_workers, timeout=float("inf"))
                reason = None
                if not all_started:
                    if time.time() - started_at > startup_timeout:
                        reason = ("no heartbeat from every rank within "
                                  "%.0fs of start" % startup_timeout)
                else:
                    dead = hb.dead_nodes(run_dir, mon_workers,
                                         heartbeat_timeout)
                    if dead:
                        reason = ("heartbeat stall (> %.0fs)"
                                  % heartbeat_timeout)
                        if elastic and len(dead) < mon_workers:
                            # a strict subset went silent: that is a
                            # lost-replica vote, not a wholesale hang
                            lost_seen.update(dead)
                    elif progress_timeout and hb.stalled_nodes(
                            run_dir, mon_workers, progress_timeout):
                        reason = ("alive but no training progress "
                                  "(> %.0fs) — wedged collective?"
                                  % progress_timeout)
                if reason is not None:
                    log("[watchdog] %s: killing job" % reason)
                    _terminate(proc)
                    stalled = True
                    rc = proc.returncode
                    break
            time.sleep(poll_interval)
        if rc == 0 and not stalled:
            _record_decision(run_dir, "done", 0, False, [], restarts,
                             world or 0, world or 0)
            if own_run_dir:
                shutil.rmtree(own_run_dir, ignore_errors=True)
            return 0
        lost = []
        if elastic and run_dir:
            lost = sorted(hb.tombstoned(run_dir) | lost_seen)
        _record_guardrail(run_dir, rc)
        action, new_world = decide(rc if not stalled else (rc or 1),
                                   lost, restarts, max_restarts,
                                   world or 0, elastic)
        _record_decision(run_dir, action, rc, stalled, lost, restarts,
                         world or 0, new_world)
        if action == "shrink":
            log("[watchdog] elastic shrink: rank(s) %s lost, restarting "
                "at world %d (was %d)" % (lost, new_world, world))
            world = new_world
            continue
        if action == "fail":
            log("[watchdog] giving up after %d restarts (rc=%s)"
                % (restarts, rc))
            # minted run dir intentionally left behind: it is the
            # post-mortem evidence (which ranks stopped beating when)
            return rc if rc and rc > 0 else 1
        restarts += 1
        log("[watchdog] restart %d/%d (rc=%s%s)"
            % (restarts, max_restarts, rc, ", stalled" if stalled else ""))


def _self_test():
    """Pin the elastic restart decision table, then drive supervise()
    end to end with stub jobs."""
    # -- decision table -----------------------------------------------------
    assert decide(0, [], 9, 2, 8, True) == ("done", 8)
    # dead rank -> shrink, budget untouched (even when exhausted)
    assert decide(EXIT_RESHAPE, [3], 0, 2, 8, True) == ("shrink", 7)
    assert decide(EXIT_RESHAPE, [3], 2, 2, 8, True) == ("shrink", 7)
    assert decide(1, [2, 5], 0, 2, 8, True) == ("shrink", 6)
    assert decide(EXIT_RESHAPE, [3, 3], 0, 2, 8, True) == ("shrink", 7)
    # transient exit 75 (preemption) -> same-size retry
    assert decide(EXIT_PREEMPTED, [], 0, 2, 8, True) == ("retry", 8)
    assert decide(EXIT_PREEMPTED, [], 1, 2, 8, False) == ("retry", 8)
    # budget exhausted -> fail
    assert decide(1, [], 2, 2, 8, True) == ("fail", 8)
    assert decide(EXIT_PREEMPTED, [], 2, 2, 8, False) == ("fail", 8)
    # every rank lost: nothing to shrink to -> ordinary retry/fail
    assert decide(EXIT_RESHAPE, list(range(8)), 0, 2, 8, True) == \
        ("retry", 8)
    assert decide(EXIT_RESHAPE, list(range(8)), 2, 2, 8, True) == \
        ("fail", 8)
    # elastic off: a tombstone changes nothing
    assert decide(EXIT_RESHAPE, [3], 0, 2, 8, False) == ("retry", 8)
    # guardrail verdict (exit 78): terminal no matter the budget, and
    # it outranks a simultaneous lost-rank shrink vote
    assert decide(EXIT_GUARDRAIL, [], 0, 5, 8, False) == ("fail", 8)
    assert decide(EXIT_GUARDRAIL, [3], 0, 5, 8, True) == ("fail", 8)

    # -- end-to-end: lose a rank, shrink, finish ------------------------
    tmp = tempfile.mkdtemp(prefix="mxtpu_watchdog_selftest_")
    try:
        script = os.path.join(tmp, "job.py")
        with open(script, "w") as f:
            f.write(
                "import os, sys\n"
                "world = int(os.environ['MXTPU_WORLD_SIZE'])\n"
                "assert os.environ.get('MXTPU_ELASTIC') == '1'\n"
                "marker = sys.argv[1]\n"
                "if not os.path.exists(marker):\n"
                "    open(marker, 'w').close()\n"
                "    assert world == 4, world\n"
                "    run = os.environ['MXTPU_RUN_DIR']\n"
                "    open(os.path.join(run, 'lost_2'), 'w').close()\n"
                "    sys.exit(%d)\n"
                "assert world == 3, world\n"
                "sys.exit(0)\n" % EXIT_RESHAPE)
        msgs = []
        rc = supervise([sys.executable, script,
                        os.path.join(tmp, "attempted")],
                       max_restarts=0, world=4, elastic=True,
                       run_dir=os.path.join(tmp, "run"),
                       poll_interval=0.05, log=msgs.append)
        joined = "\n".join(msgs)
        assert rc == 0, (rc, joined)
        assert "elastic shrink" in joined and "world 3" in joined, joined

        # every outcome left a decision record with attached evidence
        with open(os.path.join(tmp, "run", "decisions.jsonl")) as f:
            decisions = [json.loads(line) for line in f if line.strip()]
        actions = [d["action"] for d in decisions]
        assert actions == ["shrink", "done"], actions
        assert decisions[0]["lost"] == [2], decisions[0]
        assert decisions[0]["world"] == 4, decisions[0]
        assert decisions[0]["new_world"] == 3, decisions[0]
        assert all("evidence" in d for d in decisions), decisions
        # no rank wrote telemetry in the stub job: evidence says so
        # (and the aggregator was never imported)
        assert decisions[0]["evidence"]["telemetry_ranks"] == 0, decisions[0]

        # -- end-to-end: transient exit 75 retries same-size ------------
        script2 = os.path.join(tmp, "job2.py")
        with open(script2, "w") as f:
            f.write(
                "import os, sys\n"
                "assert os.environ['MXTPU_WORLD_SIZE'] == '4'\n"
                "marker = sys.argv[1]\n"
                "if not os.path.exists(marker):\n"
                "    open(marker, 'w').close()\n"
                "    sys.exit(%d)\n"
                "sys.exit(0)\n" % EXIT_PREEMPTED)
        msgs = []
        rc = supervise([sys.executable, script2,
                        os.path.join(tmp, "attempted2")],
                       max_restarts=1, world=4, elastic=True,
                       run_dir=os.path.join(tmp, "run2"),
                       poll_interval=0.05, log=msgs.append)
        assert rc == 0, (rc, msgs)
        assert any("restart 1/1" in m for m in msgs), msgs

        # -- end-to-end: budget exhausted fails with the job's rc -------
        script3 = os.path.join(tmp, "job3.py")
        with open(script3, "w") as f:
            f.write("import sys\nsys.exit(7)\n")
        msgs = []
        rc = supervise([sys.executable, script3], max_restarts=1,
                       world=4, elastic=True,
                       run_dir=os.path.join(tmp, "run3"),
                       poll_interval=0.05, log=msgs.append)
        assert rc == 7, (rc, msgs)
        assert any("giving up" in m for m in msgs), msgs

        # -- end-to-end: guardrail verdict stops retries cold -----------
        script4 = os.path.join(tmp, "job4.py")
        with open(script4, "w") as f:
            f.write(
                "import json, os, sys\n"
                "run = os.environ['MXTPU_RUN_DIR']\n"
                "with open(os.path.join(run, %r), 'w') as fh:\n"
                "    json.dump({'type': 'guardrail', 'action': 'abort',\n"
                "               'reason': 'loss anomaly at step 9',\n"
                "               'step': 9, 'rewinds': 2, 'budget': 2},\n"
                "              fh)\n"
                "sys.exit(%d)\n"
                % (GUARDRAIL_VERDICT_FILE, EXIT_GUARDRAIL))
        msgs = []
        rc = supervise([sys.executable, script4], max_restarts=3,
                       world=4, elastic=True,
                       run_dir=os.path.join(tmp, "run4"),
                       poll_interval=0.05, log=msgs.append)
        assert rc == EXIT_GUARDRAIL, (rc, msgs)
        assert any("giving up" in m for m in msgs), msgs
        with open(os.path.join(tmp, "run4", "decisions.jsonl")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        kinds = [r["type"] for r in records]
        assert kinds == ["guardrail", "decision"], kinds
        assert records[0]["reason"] == "loss anomaly at step 9", records[0]
        assert records[0]["rc"] == EXIT_GUARDRAIL, records[0]
        assert records[1]["action"] == "fail", records[1]
        # the budget was never touched: one launch, zero restarts
        assert records[1]["restarts"] == 0, records[1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("watchdog self-test passed")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--max-restarts", type=int, default=2)
    parser.add_argument("--num-workers", type=int, default=0,
                        help="enable heartbeat-stall detection for N ranks")
    parser.add_argument("--heartbeat-timeout", type=float, default=60.0)
    parser.add_argument("--progress-timeout", type=float, default=None,
                        help="kill if a live rank makes no training "
                             "progress for this long (catches wedged "
                             "collectives; set above the longest "
                             "legitimate step gap incl. first compile)")
    parser.add_argument("--elastic", action="store_true",
                        help="restart at the surviving world size when a "
                             "replica is lost (exit 76 / lost_<rank> "
                             "tombstone / observed dead heartbeat) "
                             "instead of burning the restart budget")
    parser.add_argument("--world", type=int, default=None,
                        help="initial world size for --elastic (default: "
                             "--num-workers)")
    parser.add_argument("--self-test", action="store_true",
                        help="run the built-in decision-table and "
                             "supervision self-test, then exit")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="-- command to supervise")
    args = parser.parse_args(argv)
    if args.self_test:
        sys.exit(_self_test())
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given")
    rc = supervise(command, max_restarts=args.max_restarts,
                   num_workers=args.num_workers,
                   heartbeat_timeout=args.heartbeat_timeout,
                   progress_timeout=args.progress_timeout,
                   elastic=args.elastic, world=args.world)
    sys.exit(rc)


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    main()
