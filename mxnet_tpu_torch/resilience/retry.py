"""Retry with jittered backoff for transient I/O and transport faults
(counterpart of ``mxnet_tpu/resilience/retry.py``, the same policy).

Classification, not blanket retries: only errors that plausibly heal on
their own (EINTR/EAGAIN/EIO/ETIMEDOUT/... and an explicit
``TransientError``) are retried. Corruption (an ``MXNetError`` from a bad
magic), programming errors and ENOSPC are raised at once: retrying a full
disk only burns the preemption grace window. The kvstore's push and pull
bodies and the checkpoint writes share this one policy.

Collectives across processes are not retried anywhere: peers enter them in
lockstep, and one rank re-entering a collective its peers already left
deadlocks the mesh. Recovery there is process-level (restart and resume
from a checkpoint). Standard library only.
"""
from __future__ import annotations

import errno
import functools
import os
import random
import time

try:
    from .. import telemetry as _tm
except ImportError:  # standalone import by tools / subprocess scripts
    _tm = None


class TransientError(Exception):
    """Raise to mark an error as retryable regardless of its type."""


#: OS errors worth retrying: interrupted/busy/timeout/connection classes.
#: Notably absent: ENOSPC (disk full won't heal within a backoff window)
#: and ENOENT (a missing file is a logic error, not a blip).
RETRYABLE_ERRNOS = frozenset((
    errno.EINTR, errno.EAGAIN, errno.EBUSY, errno.EIO, errno.ETIMEDOUT,
    errno.ECONNRESET, errno.ECONNREFUSED, errno.EPIPE, errno.ESTALE,
))

ENV_MAX = "MXTPU_RETRY_MAX"
_DEF_MAX = 3


def is_retryable(exc):
    if isinstance(exc, TransientError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in RETRYABLE_ERRNOS
    return False


def _max_attempts():
    try:
        return max(1, int(os.environ.get(ENV_MAX, _DEF_MAX)))
    except ValueError:
        return _DEF_MAX


def _metrics():
    if _tm is None or not _tm.enabled():
        return None
    return (
        _tm.counter("retry.attempts", "Calls entering a retry wrapper"),
        _tm.counter("retry.retries", "Transient failures retried"),
        _tm.counter("retry.giveup",
                    "Retry wrappers that exhausted max attempts"),
    )


def call(fn, *args, max_attempts=None, base_delay=0.05, max_delay=2.0,
         jitter=0.5, retryable=is_retryable, name=None, sleep=time.sleep,
         **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying transient failures.

    Backoff: ``min(max_delay, base_delay * 2**(attempt-1))`` scaled by a
    uniform jitter factor in ``[1, 1+jitter]`` so a fleet of workers
    hitting the same flaky store doesn't re-stampede it in sync.
    ``max_attempts`` defaults to ``MXTPU_RETRY_MAX`` (3). The final
    failure is re-raised unchanged.
    """
    attempts = _max_attempts() if max_attempts is None else int(max_attempts)
    attempts = max(1, attempts)
    site = name or getattr(fn, "__name__", "call")
    mets = _metrics()
    if mets:
        mets[0].inc(site=site)
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:  # noqa: B036 - classified below
            if attempt >= attempts or not retryable(exc):
                if mets and attempt >= attempts and retryable(exc):
                    mets[2].inc(site=site)
                raise
            if mets:
                mets[1].inc(site=site)
            delay = min(max_delay, base_delay * (2.0 ** (attempt - 1)))
            sleep(delay * (1.0 + jitter * random.random()))


def retry(fn=None, **policy):
    """Decorator form of :func:`call`.

    ``@retry`` or ``@retry(max_attempts=5, name="kv.push")``.
    """
    if fn is not None:
        return retry()(fn)

    def deco(f):
        if "name" not in policy:
            policy["name"] = getattr(f, "__name__", "call")

        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            return call(f, *args, **policy, **kwargs)

        return wrapped

    return deco
