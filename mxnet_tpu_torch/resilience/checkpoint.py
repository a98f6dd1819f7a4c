"""Atomic full-state training checkpoints with manifest verification
(counterpart of ``mxnet_tpu/resilience/checkpoint.py``, byte-compatible
with it in both directions).

Format: one directory per checkpoint, ``<dir>/ckpt-<step 12 digits>/``::

    state.params     params + aux in the dmlc .params container (keys
                     "arg:<name>" / "aux:<name>", so ``mx.nd.load`` of
                     either package reads it)
    optimizer.state  pickled optimizer payload (fused host tree, updater
                     bytes, or {"kind": "none"})
    train_state.pkl  pickled loop position: epoch, nbatch, global_step,
                     metric state, RNG streams
    MANIFEST.json    written LAST: per-file byte counts + CRC32 and
                     per-tensor CRC32s. A directory without a readable,
                     matching manifest is torn and is never resumed from.

Atomicity: everything is built in a ``.tmp-*`` sibling, each file fsynced,
the manifest written last, the directory ``os.replace``d into its final
name and the parent fsynced. A crash at any byte leaves only a ``.tmp-*``
that retention sweeps away. Verification re-hashes on read, so silent
corruption after the rename is caught and skipped by ``latest_valid()``.

Payloads hold numpy arrays and Python values only, never a
``torch.Tensor``: the state a caller passes may hold tensors on the card
(``Module._capture_train_state`` clones them device to device on the train
thread), and :meth:`CheckpointManager._build` pulls them to the host on the
writer thread, under :data:`DEVICE_PULL_LOCK` so that no pull runs while a
fused step group is captured into a CUDA graph or warms up under sync debug
mode. Reading back unpickles with a restricted unpickler (numpy, the
standard containers, the port's own metric and NDArray classes); a class of
the JAX package (its executor-path updater pickles NDArrays of
``mxnet_tpu``) raises :class:`CheckpointError` naming the member and the
class.
"""
from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import pickle
import re
import shutil
import threading
import time
import zlib

import numpy as np

from . import fault, retry

try:
    from .. import telemetry as _tm
except ImportError:  # standalone import
    _tm = None

#: Exit code for "preempted after writing a final checkpoint" — EX_TEMPFAIL,
#: the sysexits.h "transient failure, retry the job" code.
EXIT_PREEMPTED = 75

#: Exit code for "a replica was declared lost, final checkpoint written,
#: restart me at the surviving world size" (fit's elastic shrink,
#: ``tools/watchdog.py --elastic``).
EXIT_RESHAPE = 76

ENV_INTERVAL = "MXTPU_CKPT_INTERVAL"
ENV_KEEP = "MXTPU_CKPT_KEEP"

MANIFEST = "MANIFEST.json"
PARAMS_FILE = "state.params"
OPT_FILE = "optimizer.state"
TRAIN_FILE = "train_state.pkl"
_FORMAT_VERSION = 1

_CKPT_RE = re.compile(r"^ckpt-(\d{12})$")

#: Held while device tensors are pulled to the host for a checkpoint, and
#: by ``ShardedTrainStep`` while it captures or warms up a step group: a
#: host copy from the writer thread must not run inside either.
DEVICE_PULL_LOCK = threading.RLock()

log = logging.getLogger(__name__)


def _metric(kind, name, help_):
    if _tm is None:
        return None
    return getattr(_tm, kind)(name, help_)


_H_WRITE_S = _metric("histogram", "checkpoint.write_seconds",
                     "Wall seconds to build+fsync+publish one checkpoint")
_C_BYTES = _metric("counter", "checkpoint.bytes",
                   "Bytes written into published checkpoints")
_C_WRITTEN = _metric("counter", "checkpoint.written",
                     "Checkpoints successfully published")
_C_FAILED = _metric("counter", "checkpoint.failed",
                    "Checkpoint attempts that aborted (no partial state "
                    "is ever published)")
_C_SKIPPED = _metric("counter", "resume.skipped_corrupt",
                     "Checkpoints skipped by latest_valid() for failing "
                     "manifest verification")


class CheckpointError(Exception):
    """A checkpoint exists but cannot be trusted (torn, corrupt, an
    incompatible format version, or a payload class this package cannot
    read)."""


@contextlib.contextmanager
def atomic_file(path, mode="wb"):
    """Write ``path`` all-or-nothing: temp file in the same directory,
    flush + fsync, then ``os.replace`` over the target and fsync the
    parent dir. On any error the temp file is removed and the previous
    ``path`` (if any) is left untouched."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(
        directory, ".tmp-%s-%d" % (os.path.basename(path), os.getpid()))
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
        _fsync_dir(directory)
    except BaseException:
        with contextlib.suppress(OSError):
            f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _fsync_dir(path):
    # Directory fsync makes the rename itself durable. Some filesystems
    # refuse O_RDONLY dir fsync; crash-consistency degrades gracefully.
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _crc_file(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _write_member(ckpt_dir, name, payload):
    """Write one checkpoint member durably; returns (bytes, crc32). The
    write goes through the shared retry policy: a transient EIO costs a
    backoff, ENOSPC aborts the attempt at once."""
    path = os.path.join(ckpt_dir, name)

    def _do():
        fault.fire("ckpt_write", path=path)
        with open(path, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())

    retry.call(_do, name="ckpt.write")
    return len(payload), zlib.crc32(payload) & 0xFFFFFFFF


def step_dir(directory, step):
    return os.path.join(directory, "ckpt-%012d" % int(step))


def list_checkpoints(directory):
    """All checkpoint step numbers present (valid or not), ascending."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for name in entries:
        m = _CKPT_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def read_manifest(path):
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("version") != _FORMAT_VERSION:
        raise CheckpointError(
            "%s: unsupported checkpoint format version %r"
            % (path, manifest.get("version")))
    return manifest


def verify_checkpoint(path, deep=False):
    """Check a checkpoint directory against its manifest.

    Shallow (default): every listed file exists with the recorded size
    and whole-file CRC32. ``deep`` also re-hashes every tensor payload
    against the per-tensor CRCs. Returns the manifest; raises
    :class:`CheckpointError`.
    """
    try:
        manifest = read_manifest(path)
    except CheckpointError:
        raise
    except (OSError, ValueError) as exc:
        raise CheckpointError("%s: unreadable manifest: %s" % (path, exc))
    for name, meta in manifest.get("files", {}).items():
        fpath = os.path.join(path, name)
        try:
            size = os.path.getsize(fpath)
        except OSError:
            raise CheckpointError("%s: missing member %s" % (path, name))
        if size != meta["bytes"]:
            raise CheckpointError(
                "%s: %s is %d bytes, manifest says %d (torn write)"
                % (path, name, size, meta["bytes"]))
        if _crc_file(fpath) != meta["crc32"]:
            raise CheckpointError(
                "%s: %s fails CRC32 (corrupt)" % (path, name))
    if deep:
        _verify_tensors(path, manifest)
    return manifest


def _read_params(path):
    """``state.params`` as name -> host tensor (its stored dtype)."""
    from .. import ndarray as nd
    from ..context import cpu

    with cpu():
        arrays = nd.load(os.path.join(path, PARAMS_FILE))
    return {k: v._data for k, v in arrays.items()}


def _verify_tensors(path, manifest):
    from ..ndarray import _raw_bytes

    arrays = _read_params(path)
    for key, want in manifest.get("tensors", {}).items():
        arr = arrays.get(key)
        if arr is None:
            raise CheckpointError("%s: tensor %s missing" % (path, key))
        got = zlib.crc32(_raw_bytes(arr)) & 0xFFFFFFFF
        if got != want:
            raise CheckpointError(
                "%s: tensor %s fails CRC32 (corrupt)" % (path, key))


# -- reading pickles back ----------------------------------------------------

_SAFE_BUILTINS = frozenset(("set", "frozenset", "bytearray", "complex"))


class _RestrictedUnpickler(pickle.Unpickler):
    """Numpy, the standard containers and this package's own metric and
    NDArray classes (a metric pickled by either package becomes this
    package's class of the same name); any other class raises
    :class:`CheckpointError` naming ``member`` and the class."""

    def __init__(self, data, member):
        super().__init__(io.BytesIO(data))
        self.member = member

    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if (module, name) == ("_codecs", "encode"):  # bytes under protocol 2
            return super().find_class(module, name)
        if module in ("mxnet_tpu.metric", "mxnet_tpu_torch.metric"):
            from .. import metric

            cls = getattr(metric, name, None)
            if isinstance(cls, type) and issubclass(cls, metric.EvalMetric):
                return cls
        if module == "mxnet_tpu_torch.ndarray" and name == "NDArray":
            from ..ndarray import NDArray

            return NDArray
        raise CheckpointError(
            "%s: holds an object of class %s.%s, which this package cannot "
            "read" % (self.member, module, name))


def restricted_loads(data, member):
    """Unpickle ``data`` (the bytes of checkpoint member ``member``) with
    the restricted unpickler."""
    return _RestrictedUnpickler(data, member).load()


def load_state(path, verify=True):
    """Read a checkpoint directory back into the state dict shape that
    :meth:`CheckpointManager.save` accepted, numpy arrays throughout."""
    import torch

    if verify:
        verify_checkpoint(path)
    arg = {}
    aux = {}
    for key, t in _read_params(path).items():
        kind, _, name = key.partition(":")
        host = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        (arg if kind == "arg" else aux)[name] = host
    with open(os.path.join(path, OPT_FILE), "rb") as f:
        opt = restricted_loads(f.read(), OPT_FILE)
    with open(os.path.join(path, TRAIN_FILE), "rb") as f:
        train = restricted_loads(f.read(), TRAIN_FILE)
    state = dict(train)
    state["module"] = {"arg": arg, "aux": aux, "opt": opt}
    return state


class CheckpointManager:
    """Owns one checkpoint directory: atomic writes, retention,
    background snapshots, and valid-checkpoint discovery.

    ``state`` dicts passed to :meth:`save` look like::

        {"module": {"arg": {name: array-like}, "aux": {...},
                    "opt": <picklable once on the host>},
         "epoch": int, "nbatch": int, "global_step": int,
         "metric": bytes|None, "rng": {...}}

    Array-likes are numpy arrays, NDArrays or tensors (on the card or the
    host); the writer pulls them to numpy.
    """

    def __init__(self, directory, keep=None):
        self.directory = directory
        if keep is None:
            try:
                keep = int(os.environ.get(ENV_KEEP, 3))
            except ValueError:
                keep = 3
        self.keep = max(1, int(keep))
        self.last_step = None
        self._thread = None
        self._last_error = None
        os.makedirs(directory, exist_ok=True)

    # -- write side -----------------------------------------------------

    def save(self, state, step):
        """Synchronously publish ``state`` as checkpoint ``step``.

        Returns the published directory. Raises on failure; a failed
        attempt never leaves a partial ``ckpt-*`` dir behind.
        """
        self.wait()
        step = int(step)
        final = step_dir(self.directory, step)
        if os.path.isdir(final):
            # step already checkpointed (an interval boundary on an epoch
            # end): publishing twice would tear the good copy for nothing
            return final
        t0 = time.monotonic()
        tmp = os.path.join(
            self.directory, ".tmp-%012d-%d" % (step, os.getpid()))
        try:
            total = self._build(tmp, state, step)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            if _C_FAILED:
                _C_FAILED.inc()
            raise
        dt = time.monotonic() - t0
        if _H_WRITE_S:
            _H_WRITE_S.observe(dt)
        if _C_BYTES:
            _C_BYTES.inc(total)
        if _C_WRITTEN:
            _C_WRITTEN.inc()
        self.last_step = step
        fault.fire("ckpt_done", path=final)
        self._retain()
        return final

    def save_async(self, state, step):
        """Publish on a background thread. Waits for any previous
        in-flight snapshot first (at most one outstanding). Failures are
        logged and kept in ``_last_error``, not raised: a flaky periodic
        snapshot must not kill the training loop; the final (preemption)
        checkpoint uses synchronous :meth:`save`, which raises."""
        self.wait()

        def _run():
            try:
                self.save(state, step)
            except BaseException as exc:  # noqa: B036 - logged, kept
                self._last_error = exc
                log.warning("async checkpoint at step %d failed: %s",
                            step, exc)

        self._thread = threading.Thread(
            target=_run, name="mxtpu-ckpt", daemon=True)
        self._thread.start()
        return self._thread

    def wait(self):
        """Block until any in-flight async snapshot has finished."""
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
            self._thread = None

    def _build(self, tmp, state, step):
        os.makedirs(tmp, exist_ok=True)
        module = state.get("module") or {}
        files = {}
        with DEVICE_PULL_LOCK:
            # the blocking device-to-host pulls, on the writer thread
            arg = _host_tree(module.get("arg") or {})
            aux = _host_tree(module.get("aux") or {})
            opt = _host_tree(module.get("opt") or {"kind": "none"})
        payload, tensors = _pack_params(arg, aux)
        files[PARAMS_FILE] = _member_meta(
            *_write_member(tmp, PARAMS_FILE, payload))
        files[OPT_FILE] = _member_meta(*_write_member(
            tmp, OPT_FILE, pickle.dumps(opt, protocol=2)))
        train = {k: v for k, v in state.items() if k != "module"}
        files[TRAIN_FILE] = _member_meta(
            *_write_member(tmp, TRAIN_FILE, pickle.dumps(train, protocol=2)))

        manifest = {
            "version": _FORMAT_VERSION,
            "step": step,
            "time": time.time(),
            "files": files,
            "tensors": tensors,
        }
        # informational: the writer's topology (dp, mesh, batch geometry)
        if state.get("topology"):
            manifest["topology"] = state["topology"]
        # the global sample position at snapshot time
        if state.get("sample_position") is not None:
            manifest["sample_position"] = int(state["sample_position"])
        # the guardrail health stamp, readable without the payload
        if state.get("health"):
            manifest["health"] = state["health"]
        payload = json.dumps(manifest, indent=1, sort_keys=True).encode()
        _write_member(tmp, MANIFEST, payload)
        return sum(m["bytes"] for m in files.values()) + len(payload)

    def _retain(self):
        steps = list_checkpoints(self.directory)
        evict = steps[:-self.keep] if len(steps) > self.keep else []
        if evict:
            # never evict the newest known-good snapshot: when every
            # checkpoint in the keep window is stamped unclean, the rewind
            # target lives in the evict range
            protected = self._newest_clean(steps)
            if protected is not None and protected in evict:
                evict = [s for s in evict if s != protected]
        for step in evict:
            shutil.rmtree(step_dir(self.directory, step),
                          ignore_errors=True)
        # sweep build dirs orphaned by crashed writers (other pids)
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        suffix = "-%d" % os.getpid()
        for name in entries:
            if name.startswith(".tmp-") and not name.endswith(suffix):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _newest_clean(self, steps):
        """Newest step whose MANIFEST health stamp says ``clean`` (None
        when no checkpoint carries a stamp). Manifest-only."""
        for step in reversed(steps):
            try:
                manifest = read_manifest(step_dir(self.directory, step))
            except (OSError, ValueError):
                continue
            health = manifest.get("health")
            if isinstance(health, dict) and health.get("clean"):
                return step
        return None

    # -- read side ------------------------------------------------------

    def last_good(self, deep=False):
        """Path of the newest checkpoint that verifies AND whose health
        stamp is clean, or None. An unstamped manifest counts as good."""
        for step in reversed(list_checkpoints(self.directory)):
            path = step_dir(self.directory, step)
            try:
                manifest = read_manifest(path)
            except (OSError, ValueError):
                continue
            health = manifest.get("health")
            if isinstance(health, dict) and not health.get("clean"):
                continue
            try:
                verify_checkpoint(path, deep=deep)
                return path
            except CheckpointError as exc:
                if _C_SKIPPED:
                    _C_SKIPPED.inc()
                log.warning("skipping corrupt checkpoint %s: %s", path, exc)
        return None

    def load_last_good(self):
        """Load the newest known-good checkpoint (rewind target), or
        None when no healthy checkpoint exists."""
        path = self.last_good()
        if path is None:
            return None
        return load_state(path)

    def latest_valid(self, deep=False):
        """Newest checkpoint that verifies, or None. Torn or corrupt
        candidates are skipped (logged ``skipping corrupt checkpoint``)
        and the scan falls back to the previous one."""
        for step in reversed(list_checkpoints(self.directory)):
            path = step_dir(self.directory, step)
            try:
                verify_checkpoint(path, deep=deep)
                return path
            except CheckpointError as exc:
                if _C_SKIPPED:
                    _C_SKIPPED.inc()
                log.warning("skipping corrupt checkpoint %s: %s", path, exc)
        return None

    def load(self, step=None):
        """Load checkpoint ``step`` (default: latest valid). Returns the
        state dict, or None when ``step`` is None and nothing valid
        exists."""
        if step is None:
            path = self.latest_valid()
            if path is None:
                return None
        else:
            path = step_dir(self.directory, step)
        return load_state(path)


def _member_meta(nbytes, crc):
    return {"bytes": nbytes, "crc32": crc}


def _host_tree(obj):
    """Recursively pull a state tree to picklable host values (tensors
    and NDArrays -> numpy, containers kept, scalars and bytes passed
    through). A bf16 tensor becomes float32, as ``NDArray.asnumpy`` gives
    it."""
    import torch

    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_host_tree(v) for v in obj)
    if isinstance(obj, list):
        return [_host_tree(v) for v in obj]
    if hasattr(obj, "_data") and torch.is_tensor(obj._data):
        obj = obj._data
    if torch.is_tensor(obj):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    if hasattr(obj, "asnumpy"):
        return np.asarray(obj.asnumpy())
    return np.asarray(obj)


class _HostTensor:
    """A host tensor behind the ``_data`` attribute the .params writer
    reads, so snapshots serialize without device-backed NDArrays."""

    __slots__ = ("_data",)

    def __init__(self, t):
        self._data = t


def _pack_params(arg, aux):
    """Serialize {name: numpy array} dicts to dmlc .params bytes plus
    per-tensor CRC32s over each payload's bytes."""
    import torch

    from .. import ndarray as nd
    from ..ndarray import _raw_bytes

    data = {}
    tensors = {}
    for prefix, source in (("arg", arg), ("aux", aux)):
        for name, value in source.items():
            host = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
            key = "%s:%s" % (prefix, name)
            data[key] = _HostTensor(host)
            tensors[key] = zlib.crc32(_raw_bytes(host)) & 0xFFFFFFFF
    return nd.save_buffer(data), tensors
