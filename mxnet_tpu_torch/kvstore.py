"""KVStore of the PyTorch port, one process (counterpart of
``mxnet_tpu/kvstore.py``): ``create("local" / "device" / ...)``,
``init`` / ``push`` / ``pull``, ``set_optimizer``, ``type``, ``rank``,
``num_workers`` and the optimizer-state files.

``push`` sums the per-device values where the first one lives (the
reference's Comm::Reduce), then applies the updater or stores the sum;
``pull`` writes the stored value into every output array. The JAX package
runs both as ordered ops on a communication engine; here they run in
program order on the caller's thread, which orders them the same way.
Both bodies are ``MXTPU_FAULT_INJECT`` points (``kv_push`` / ``kv_pull``)
and run under ``resilience.retry.call``, as in the JAX package.
The multi-process types (``dist_*``) and the gradient bucketer wait for
the multi-card slice (NCCL across cards).
"""
from __future__ import annotations

from . import optimizer as opt
from .base import MXNetError
from .resilience import fault as _fault
from .resilience import retry as _retry
from .ndarray import NDArray

_LOCAL_TYPES = ("local", "local_allreduce_cpu", "local_allreduce_device", "device")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async", "dist")


def _ctype_key_value(keys, vals):
    if isinstance(keys, (int, str)):
        keys = [keys]
        vals = [vals]
    out = []
    for k, v in zip(keys, vals):
        if isinstance(v, NDArray):
            v = [v]
        out.append((k, list(v)))
    return out


class KVStore:
    """A single-process store of named values with an optional updater."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._str_key_map = {}

    def init(self, key, value):
        for k, vals in _ctype_key_value(key, value):
            if k in self._store:
                raise MXNetError("key %s already initialized" % str(k))
            self._store[k] = vals[0].copy()

    def push(self, key, value, priority=0):
        """Sum the value(s) of each key, then update the stored value with
        the updater, or overwrite it when there is none."""
        for k, vals in _ctype_key_value(key, value):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            upd_key = k if isinstance(k, int) else self._str_key(k)

            def _reduce_body(vals=vals, k=k):
                _fault.fire("kv_push", key=k)
                return self._reduce(vals)

            # the retry covers the reduce only (it reads the pushed values,
            # so a re-run is exact); the updater runs once, after it
            merged = _retry.call(_reduce_body, name="kv.push")
            if self._updater is not None:
                self._updater(upd_key, merged, self._store[k])
            else:
                merged.copyto(self._store[k])

    def pull(self, key, out=None, priority=0):
        """Write each key's stored value into its output array(s)."""
        assert out is not None
        for k, outs in _ctype_key_value(key, out):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))

            def _body(k=k, outs=outs):
                _fault.fire("kv_pull", key=k)
                stored = self._store[k]._data
                for o in outs:
                    o._write(stored.to(o._data.device))

            _retry.call(_body, name="kv.pull")

    def _str_key(self, k):
        """Stable string key -> updater index (first-seen order)."""
        if k not in self._str_key_map:
            self._str_key_map[k] = len(self._str_key_map)
        return self._str_key_map[k]

    def _reduce(self, vals):
        if len(vals) == 1:
            return vals[0]
        merged = vals[0].copy()
        for v in vals[1:]:
            merged += v.as_in_context(merged.context)
        return merged

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        self._updater = opt.get_updater(optimizer)

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def save_optimizer_states(self, fname):
        from .resilience.checkpoint import atomic_file

        if self._updater is None:
            raise MXNetError("Cannot save states: no updater on this store")
        with atomic_file(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states: no updater on this store")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


class GradBucketer:
    """Not ported: it coalesces the multi-process stores' collectives."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GradBucketer is not ported to PyTorch yet: it serves the multi-process "
            "kvstore types (mxnet_tpu/kvstore.py:107)")


def create(name="local"):
    """Create a KVStore. ``local`` / ``device`` (and the local allreduce
    aliases) run in this process; the ``dist_*`` types raise until the
    multi-card slice is ported."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _DIST_TYPES:
        raise NotImplementedError(
            "kvstore %r is not ported to PyTorch yet: the multi-process types wait for "
            "NCCL across cards (mxnet_tpu/kvstore.py:182)" % name)
    if name not in _LOCAL_TYPES:
        raise MXNetError("unknown kvstore type %s" % name)
    return KVStore(name)
