"""KVStore of the PyTorch port (counterpart of ``mxnet_tpu/kvstore.py``):
``create("local" / "device" / "dist_sync" / "dist_device_sync" /
"dist_async" / "dist")``, ``init`` / ``push`` / ``pull``, ``set_optimizer``,
``type``, ``rank``, ``num_workers``, ``_barrier``, ``get_num_dead_node``
and the optimizer-state files.

``push`` sums the per-device values where the first one lives (the
reference's Comm::Reduce), then applies the updater or stores the sum;
``pull`` writes the stored value into every output array. The JAX package
runs both as ordered ops on a communication engine; here they run in
program order on the caller's thread, which orders them the same way, and
on a dist store keeps every rank's collectives in one order (what the JAX
package's chain var exists for). Both bodies are ``MXTPU_FAULT_INJECT``
points (``kv_push`` / ``kv_pull``) and run under ``resilience.retry.call``,
as in the JAX package; a local reduce is also the ``collective`` point
with ``local=True``.

The ``dist_*`` types join the job's process group at creation
(``parallel.mesh.init_distributed``, from the launcher's environment);
``rank`` and ``num_workers`` come from the group, and without a launcher
the store is a one-worker store, as the JAX package's is. ``init``
broadcasts rank 0's value. ``push`` reduces locally, then defers the
cross-worker sum into a :class:`GradBucketer`: a flush (at the byte cap,
at any ``pull``, at a barrier or an updater change) packs the pending
values into same-dtype buckets under ``MXTPU_BUCKET_BYTES``, one
``allreduce_sum`` a bucket (``MXTPU_BUCKET_TWO_PHASE=1``: a reduce-scatter
and an all-gather), and applies the updater to each key's carved-out sum.
Collectives are never retried: a rank that re-entered one its peers had
left would deadlock the group. Under ``MXTPU_RUN_DIR`` a dist store
starts the rank's heartbeat writer (``parallel/heartbeat.py``).
"""
from __future__ import annotations

import copy
import os
import pickle
import time

import numpy as np
import torch

from . import optimizer as opt
from . import telemetry as _tm
from .base import MXNetError, bucket_bytes_env
from .resilience import fault as _fault
from .resilience import retry as _retry
from .ndarray import NDArray

_M_PUSH_BYTES = _tm.counter(
    "kvstore.push_bytes", "Bytes pushed into the kvstore")
_M_PULL_BYTES = _tm.counter(
    "kvstore.pull_bytes", "Bytes pulled out of the kvstore")
_H_PUSH_SECONDS = _tm.histogram(
    "kvstore.push_seconds", "Latency of the push body (reduce + updater), "
    "per key")
_H_PULL_SECONDS = _tm.histogram(
    "kvstore.pull_seconds", "Latency of the pull body, per key")
_H_ALLREDUCE_SECONDS = _tm.histogram(
    "kvstore.allreduce_seconds", "Cross-process allreduce+update stage "
    "latency (dist stores)")
_H_BUCKET_BYTES = _tm.histogram(
    "kvstore.bucket_bytes", "Payload bytes per coalesced gradient bucket "
    "(kvstore GradBucketer flushes and fused flat-update plan buckets)")
_M_BUCKET_FLUSHES = _tm.counter(
    "kvstore.bucket_flushes", "GradBucketer flushes (one count per "
    "collective issued on the dist deferred-reduce queue)")
# the name the JAX package's collectives share: the one-process reduce is
# this run's collective, the anatomy's 'collective' phase
_H_COLLECTIVE_SECONDS = _tm.histogram(
    "parallel.collective_seconds",
    "Wall time inside collective operations, by op")

#: this process's bucket flushes: {"flushes", "bytes"} (kept whether
#: telemetry is on or not)
bucket_stats = {"flushes": 0, "bytes": 0}


def _nbytes(vals):
    return sum(v._data.numel() * v._data.element_size() for v in vals)


_LOCAL_TYPES = ("local", "local_allreduce_cpu", "local_allreduce_device", "device")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async", "dist")


def _dtype_name(dtype):
    """A dtype's name (numpy or torch): ``float32``, ``bfloat16`` ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _itemsize(name):
    return torch.empty((), dtype=getattr(torch, name)).element_size()


class _PendingPush:
    """One deferred cross-worker sum: a key whose local reduce is done."""

    __slots__ = ("priority", "seq", "key", "upd_key", "box", "shape", "dtype", "nbytes",
                 "apply_fn")

    def __init__(self, priority, seq, key, upd_key, box, snap0, apply_fn):
        self.priority = priority
        self.seq = seq
        self.key = key
        self.upd_key = upd_key
        self.box = box  # the local reduce's result ("merged")
        self.shape = tuple(snap0.shape)
        self.dtype = _dtype_name(snap0.dtype)
        size = int(np.prod(self.shape)) if self.shape else 1
        self.nbytes = size * _itemsize(self.dtype)
        self.apply_fn = apply_fn


class GradBucketer:
    """The deferred-reduce queue of a dist store (the JAX package's
    ``GradBucketer``): pushes accumulate here on the caller's thread, and
    :meth:`drain` orders them higher priority first, then in push order,
    and packs them into same-dtype buckets of at most ``bucket_bytes``
    (counted at each value's own itemsize: a bf16 model packs twice the
    keys an f32 one does), one collective a bucket. Every rank runs the
    same script, so every rank builds the same buckets and issues the same
    collectives in the same order."""

    def __init__(self, bucket_bytes):
        self.bucket_bytes = bucket_bytes
        self.pending = []
        self.pending_bytes = 0
        self._seq = 0

    def add(self, priority, key, upd_key, box, snap0, apply_fn):
        """Queue one push; True when the pending bytes reach the cap."""
        self.pending.append(_PendingPush(priority, self._seq, key, upd_key, box, snap0,
                                         apply_fn))
        self._seq += 1
        self.pending_bytes += self.pending[-1].nbytes
        return self.pending_bytes >= max(self.bucket_bytes, 1)

    def drain(self):
        """The pending pushes as a list of buckets (lists of entries)."""
        entries = self.pending
        self.pending = []
        self.pending_bytes = 0
        entries.sort(key=lambda e: (-e.priority, e.seq))
        buckets = []
        cur, cur_bytes = [], 0
        for e in entries:
            if cur and (cur[0].dtype != e.dtype or cur_bytes + e.nbytes > self.bucket_bytes):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(e)
            cur_bytes += e.nbytes
        if cur:
            buckets.append(cur)
        return buckets


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
    """A store of named values with an optional updater; the dist types
    sum pushes across the processes of the group."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._str_key_map = {}
        self._barrier_count = 0
        self._heartbeat = None
        self._bucketer = GradBucketer(bucket_bytes_env())
        # the launcher's names, as the JAX package reads them for every type;
        # a dist store takes both from its process group below
        from .parallel import mesh as _mesh

        self._rank = _mesh._env_int(("DMLC_RANK",), 0)
        self._size = _mesh._env_int(("DMLC_NUM_WORKER",), 1)
        if "dist" in kv_type:
            from .parallel import heartbeat as _hb

            # the reference joins the cluster when the store is created
            # (KVStore::InitPSEnv); so does this one
            env_size = _mesh._env_int(("DMLC_NUM_WORKER",), 1)
            _mesh.init_distributed()
            self._rank, self._size = _mesh.process_index(), _mesh.process_count()
            if env_size > 1 and self._size == 1:
                raise MXNetError(
                    "kvstore %s: the launcher's environment promises %d workers but this "
                    "process joined no process group; refusing to train unsynchronized"
                    % (kv_type, env_size))
            if _hb.run_dir() is not None and self._size > 1:
                self._heartbeat = _hb.HeartbeatWriter(_hb.run_dir(), self._rank).start()

    @property
    def _is_dist(self):
        return "dist" in self.type and self._size > 1

    def init(self, key, value):
        for k, vals in _ctype_key_value(key, value):
            if k in self._store:
                raise MXNetError("key %s already initialized" % str(k))
            v = vals[0]
            if self._is_dist:
                # rank 0's value on every worker, whatever its own seeding did
                from .parallel import mesh as _mesh

                v = NDArray(_mesh.broadcast_from_root(v._data))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Sum the value(s) of each key (and, on a dist store, across the
        workers), then update the stored value with the updater, or
        overwrite it when there is none."""
        if self._heartbeat is not None:
            self._heartbeat.progress()
        for k, vals in _ctype_key_value(key, value):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            upd_key = k if isinstance(k, int) else self._str_key(k)
            if _tm.enabled():
                _M_PUSH_BYTES.inc(_nbytes(vals))
            t0 = time.perf_counter()
            if not self._is_dist:
                _fault.fire("collective", key=k, local=True)

            def _reduce_body(vals=vals, k=k):
                _fault.fire("kv_push", key=k)
                return self._reduce(vals)

            # the retry covers the reduce only (it reads the pushed values,
            # so a re-run is exact); the updater runs once, after it
            merged = _retry.call(_reduce_body, name="kv.push")
            if not self._is_dist:
                _H_COLLECTIVE_SECONDS.observe(time.perf_counter() - t0, op="local_reduce")
                self._apply(merged, k, upd_key)
                _H_PUSH_SECONDS.observe(time.perf_counter() - t0)
                continue
            if merged is vals[0]:
                merged = merged.copy()  # the caller may overwrite its gradient
            _H_PUSH_SECONDS.observe(time.perf_counter() - t0)
            if self._bucketer.add(priority, k, upd_key, {"merged": merged}, merged._data,
                                  self._apply):
                self._flush_buckets()

    def _apply(self, merged, k, upd_key):
        store = self._store[k]
        if merged.context != store.context:
            # the stored value, and so the updater's state, follows the
            # reduced gradients onto their device, whatever the type
            self._store[k] = store = store.as_in_context(merged.context)
        if self._updater is not None:
            self._updater(upd_key, merged, store)
        else:
            merged.copyto(store)

    def _flush_buckets(self):
        """Drain the deferred-reduce queue: one cross-worker sum a bucket,
        then each key's updater on its part. Runs on the caller's thread,
        so every rank's buckets and collectives come in one order."""
        if not self._bucketer.pending:
            return
        from .parallel import mesh as _mesh

        two_phase = os.environ.get("MXTPU_BUCKET_TWO_PHASE", "0") != "0"
        rdt = os.environ.get("MXTPU_BUCKET_REDUCE_DTYPE")
        for entries in self._bucketer.drain():
            t0 = time.perf_counter()
            parts = [e.box.pop("merged")._data.reshape(-1) for e in entries]
            sizes = [p.numel() for p in parts]
            flat = torch.cat(parts) if len(parts) > 1 else parts[0]
            if rdt and _dtype_name(flat.dtype) != rdt:
                # the sum only in a wider type (bf16 loses ~log2(W) of its
                # 8 mantissa bits over W workers); each key is cast back
                flat = flat.to(getattr(torch, rdt))
            nbytes = flat.numel() * flat.element_size()
            _H_BUCKET_BYTES.observe(nbytes, path="dist")
            _M_BUCKET_FLUSHES.inc()
            bucket_stats["flushes"] += 1
            bucket_stats["bytes"] += nbytes
            if two_phase:
                nproc = self._size
                padded = -(-flat.numel() // nproc) * nproc
                buf = torch.zeros(padded, dtype=flat.dtype, device=flat.device)
                buf[:flat.numel()] = flat
                summed = _mesh.all_gather(_mesh.reduce_scatter_sum(buf))[:flat.numel()]
            else:
                summed = _mesh.allreduce_sum(flat)
            off = 0
            for e, n, p in zip(entries, sizes, parts):
                merged = summed[off:off + n].reshape(e.shape).to(p.dtype)
                off += n
                e.apply_fn(NDArray(merged), e.key, e.upd_key)
            _H_ALLREDUCE_SECONDS.observe(time.perf_counter() - t0)

    def pull(self, key, out=None, priority=0):
        """Write each key's stored value into its output array(s)."""
        assert out is not None
        if self._heartbeat is not None:
            self._heartbeat.progress()
        # a pull orders after its key's deferred update; buckets mix keys
        self._flush_buckets()
        for k, outs in _ctype_key_value(key, out):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))

            def _body(k=k, outs=outs):
                _fault.fire("kv_pull", key=k)
                stored = self._store[k]._data
                for o in outs:
                    o._write(stored.to(o._data.device))

            t0 = time.perf_counter()
            _retry.call(_body, name="kv.pull")
            if _tm.enabled():
                _M_PULL_BYTES.inc(_nbytes(outs))
                _H_PULL_SECONDS.observe(time.perf_counter() - t0)

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
        self._flush_buckets()  # deferred pushes use the old updater
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """The updater of ``optimizer``. On a dist store of several workers
        the optimizer goes through pickle first, as the reference ships it
        to its servers (an unpicklable one fails here); the bound symbol is
        spent by then and travels as None."""
        if self._is_dist:
            clone = copy.copy(optimizer)
            clone.sym = None
            optimizer = pickle.loads(pickle.dumps(clone))
        self._flush_buckets()
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    def _barrier(self):
        """A barrier of every worker (``ps::Postoffice::Barrier``); it fails,
        never passes, when a peer is gone."""
        if self._heartbeat is not None:
            self._heartbeat.progress()
        self._flush_buckets()
        if self._size > 1:
            from .parallel import mesh as _mesh

            self._barrier_count += 1
            _mesh.barrier("kvstore-barrier-%d" % self._barrier_count)

    def get_num_dead_node(self, node_id, timeout=60):
        """Peers whose heartbeat went stale (``kvstore.h:235-244``), read
        from the launcher's run dir; 0 outside a launched job."""
        from .parallel import heartbeat as _hb

        directory = _hb.run_dir()
        if directory is None or self._size <= 1:
            return 0
        return len(_hb.dead_nodes(directory, self._size, timeout))

    @property
    def barrier_before_exit(self):
        return True

    def save_optimizer_states(self, fname):
        from .resilience.checkpoint import atomic_file

        if self._updater is None:
            raise MXNetError("Cannot save states: no updater on this store")
        self._flush_buckets()
        with atomic_file(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states: no updater on this store")
        self._flush_buckets()
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def create(name="local"):
    """Create a KVStore: ``local`` / ``device`` (and the local allreduce
    aliases) in this process, ``dist_sync`` / ``dist_device_sync`` /
    ``dist_async`` / ``dist`` across the processes of the job."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL_TYPES + _DIST_TYPES:
        raise MXNetError("unknown kvstore type %s" % name)
    return KVStore(name)
