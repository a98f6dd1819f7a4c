"""MXTPU_FAULT_INJECT: deterministic fault injection for resilience tests
(counterpart of ``mxnet_tpu/resilience/fault.py``: the same grammar, the
same points and the same per-spec budgets).

The production fault-tolerance story (atomic checkpoints, retry with
backoff, preemption handling) is only trustworthy if it is exercised by
the same classes of failure it claims to survive. This module is the
single switchboard: instrumented sites call ``fire(point, ...)`` and the
``MXTPU_FAULT_INJECT`` spec decides whether that call dies, raises, or
delays. With the env var unset every ``fire`` is a one-dict-lookup no-op,
so the hooks are safe to leave in hot paths.

Spec grammar: comma-separated ``directive=value`` pairs, e.g.::

    MXTPU_FAULT_INJECT="kill_at_step=7,enospc_at_ckpt_write=1"

Directives (value is always an integer):

=======================  ====================================================
``kill_at_step=K``       SIGKILL this process when optimizer step K completes
                         (fit's ``step`` point) — the preemptible-pool worker
                         loss that leaves NO chance to clean up.
``exit_at_step=K``       ``os._exit(77)`` at step K — abrupt but signal-free.
``preempt_at_step=K``    SIGTERM self at step K — drives the graceful
                         preemption drain instead of the hard kill.
``enospc_at_ckpt_write=N``  The N-th checkpoint file write raises
                         ``OSError(ENOSPC)`` (non-retryable: the atomic
                         writer must abort and leave prior checkpoints
                         intact).
``fail_ckpt_write=N``    The first N checkpoint file writes raise a
                         transient ``OSError(EIO)`` — the retry wrapper is
                         expected to absorb them.
``truncate_ckpt=1``      After the next checkpoint finalizes, truncate its
                         params file in place — the torn-storage case
                         resume must skip.
``delay_collective_ms=M``  Sleep M ms inside every cross-process collective
                         (the delayed-collective hang class).
``fail_recordio_read=N`` First N recordio reads raise transient EIO.
``fail_kv_push=N``       First N kvstore push bodies raise transient EIO.
``fail_kv_pull=N``       First N kvstore pull bodies raise transient EIO.
``replica_lost=R@K``     At step K, declare rank R lost: ``lost_R``
                         tombstone + back-dated ``hb_R`` in MXTPU_RUN_DIR
                         (that rank's HeartbeatWriter goes silent for
                         good), and if THIS process is rank R (DMLC_RANK)
                         it vanishes from subsequent host collectives —
                         the elastic shrink trigger, deterministic like
                         kill_at_step.
``heartbeat_stall=R@K``  At step K, freeze rank R's PROGRESS mark only
                         (``stall_R`` tombstone + back-dated ``prog_R``):
                         the alive-but-wedged-in-a-collective signature
                         stalled_nodes()/--progress-timeout catch.
``nan_grad_at_step=K``   Poison the batch feeding optimizer step K with
                         NaNs (fit's ``batch_poison`` hook) — the
                         gradient goes non-finite and the guardrail's
                         in-graph finite gate must skip it bitwise.
``loss_spike_at_step=K`` Scale the batch feeding step K by 1e4 — a
                         finite but wildly out-of-distribution loss /
                         grad-norm spike for the robust z detector.
``bad_record=N``         The first N record decodes raise ValueError
                         (``record_decode`` point) — drives the
                         quarantine path in ``_decode_chunk_payloads``
                         instead of the transport-level
                         ``fail_recordio_read``.
``kill_at_rewind=1``     SIGKILL this process inside fit's
                         rewind-to-last-good handler, after the
                         last-good checkpoint was chosen but before
                         restore completes — the SIGKILL-during-rewind
                         chain (a relaunch must still converge).
=======================  ====================================================

The port's call sites fire ``step``, ``rewind``, ``ckpt_write``,
``ckpt_done``, ``kv_push`` and ``kv_pull`` (``Module.fit``, the checkpoint
writer, the kvstore), ``recordio_read`` (``MXRecordIO.read``, inside its
retry) and ``record_decode`` (the streaming pipeline's decode, in the
process that decodes: a decode worker has its own budget), and read
``batch_poison``. The multi-process mesh's ``collective`` point comes with
that mesh (ROADMAP Queue 1 step 8), so ``delay_collective_ms`` parses and
does nothing; so do ``replica_lost`` and ``heartbeat_stall``, whose
heartbeat files belong to the multi-process mesh.

Values are integers except ``replica_lost``/``heartbeat_stall``, whose
``<rank>@<step>`` pairs parse to (rank, step) tuples; malformed values
are still ignored. Counters are per-process and keyed by the raw spec
string, so a monkeypatched spec in tests starts fresh. Stdlib-only and
importable standalone (tools and subprocess test scripts load it by
path).
"""
from __future__ import annotations

import errno
import os
import signal

ENV = "MXTPU_FAULT_INJECT"

# (raw spec string, directive) -> times fired already
_fired = {}
_parse_cache = {}


def configured():
    """Whether any fault spec is active (the cheap hot-path guard)."""
    return bool(os.environ.get(ENV))


def _spec():
    raw = os.environ.get(ENV)
    if not raw:
        return None, None
    spec = _parse_cache.get(raw)
    if spec is None:
        spec = {}
        for part in raw.split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            key, _, val = part.partition("=")
            try:
                spec[key.strip()] = int(val)
            except ValueError:
                if "@" in val:  # <rank>@<step> pair (replica_lost & co)
                    rank, _, step = val.partition("@")
                    try:
                        spec[key.strip()] = (int(rank), int(step))
                    except ValueError:
                        pass
                # else malformed directive: ignore, never crash the host
        _parse_cache[raw] = spec
    return raw, spec


def _take(raw, directive, limit):
    """Consume one firing budget unit; True while under ``limit``."""
    key = (raw, directive)
    n = _fired.get(key, 0)
    if n >= limit:
        return False
    _fired[key] = n + 1
    return True


def _transient(msg):
    return OSError(errno.EIO, "injected transient fault: %s" % msg)


def fire(point, **ctx):
    """Hit a named fault point. No-op unless MXTPU_FAULT_INJECT matches.

    Points: ``step`` (ctx: step), ``ckpt_write`` (ctx: path),
    ``ckpt_done`` (ctx: path), ``rewind`` (ctx: step), ``kv_push`` /
    ``kv_pull`` (ctx: key), ``recordio_read`` (ctx: uri, offset),
    ``record_decode`` (ctx: uri, ordinal). The JAX package's
    ``collective`` point comes with the multi-process mesh.
    """
    raw, spec = _spec()
    if not spec:
        return
    if point == "step":
        step = ctx.get("step")
        if spec.get("kill_at_step") == step and _take(raw, "kill", 1):
            os.kill(os.getpid(), signal.SIGKILL)
        if spec.get("exit_at_step") == step and _take(raw, "exit", 1):
            os._exit(77)
        if spec.get("preempt_at_step") == step and _take(raw, "preempt", 1):
            os.kill(os.getpid(), signal.SIGTERM)
    elif point == "ckpt_write":
        n = spec.get("enospc_at_ckpt_write")
        if n is not None:
            key = (raw, "enospc_seen")
            seen = _fired.get(key, 0) + 1
            _fired[key] = seen
            if seen == n:
                raise OSError(errno.ENOSPC,
                              "injected ENOSPC: %s" % ctx.get("path"))
        n = spec.get("fail_ckpt_write", 0)
        if n and _take(raw, "fail_ckpt_write", n):
            raise _transient("ckpt_write %s" % ctx.get("path"))
    elif point == "ckpt_done":
        if spec.get("truncate_ckpt", 0) and _take(raw, "truncate_ckpt", 1):
            _truncate_params(ctx.get("path"))
    elif point == "rewind":
        if spec.get("kill_at_rewind", 0) and _take(raw, "kill_at_rewind", 1):
            os.kill(os.getpid(), signal.SIGKILL)
    elif point == "record_decode":
        n = spec.get("bad_record", 0)
        if n and _take(raw, "bad_record", n):
            raise ValueError("injected bad record: %s ordinal=%s"
                             % (ctx.get("uri"), ctx.get("ordinal")))
    elif point == "recordio_read":
        n = spec.get("fail_recordio_read", 0)
        if n and _take(raw, "fail_recordio_read", n):
            raise _transient("recordio read %s@%s" % (ctx.get("uri"), ctx.get("offset")))
    elif point == "kv_push":
        n = spec.get("fail_kv_push", 0)
        if n and _take(raw, "fail_kv_push", n):
            raise _transient("kv push key=%s" % ctx.get("key"))
    elif point == "kv_pull":
        n = spec.get("fail_kv_pull", 0)
        if n and _take(raw, "fail_kv_pull", n):
            raise _transient("kv pull key=%s" % ctx.get("key"))


def batch_poison(step):
    """Poison verdict for the batch feeding optimizer step ``step``:
    ``"nan"`` / ``"spike"`` / None. A separate entry point from
    :func:`fire` because the injection must ALTER the batch (fit
    rebuilds it poisoned), not raise or kill — each directive fires at
    most once per process, like the other ``*_at_step`` budgets."""
    raw, spec = _spec()
    if not spec:
        return None
    if (spec.get("nan_grad_at_step") == step
            and _take(raw, "nan_grad", 1)):
        return "nan"
    if (spec.get("loss_spike_at_step") == step
            and _take(raw, "loss_spike", 1)):
        return "spike"
    return None


def _truncate_params(ckpt_path):
    """Tear the params file of a finalized checkpoint in half — the
    storage-level corruption the manifest CRCs exist to catch."""
    if not ckpt_path:
        return
    target = os.path.join(ckpt_path, "state.params")
    if not os.path.isfile(target):
        return
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, size // 2))
