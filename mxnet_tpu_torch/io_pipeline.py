"""Parallel streaming input pipeline of the PyTorch port (counterpart of
``mxnet_tpu/io_pipeline.py``).

Chunked RecordIO reads sharded by ``(host_rank, num_hosts)`` so every host
reads disjoint data; a spawn-safe multi-**process** decode pool
(``MXTPU_INPUT_WORKERS``) that moves decode and augmentation off the GIL;
a shuffle buffer (``MXTPU_SHUFFLE_BUFFER``) that mixes across chunk
boundaries without a barrier; and a cursor kept as the sample position,
so ``skip()``, ``seek_sample()`` and a resume after SIGKILL reposition the
sharded pipeline exactly, by replaying integer schedule state (no IO, no
decode). Undecodable records are ledgered in a quarantine JSONL and
charged to ``MXTPU_BAD_RECORD_BUDGET``.

Decode children are host machinery: they run with
``CUDA_VISIBLE_DEVICES=""`` and telemetry off, and never initialise CUDA.

Ordering contract
-----------------
With ``strict_order`` on (the default, ``MXTPU_INPUT_STRICT_ORDER``),
batch contents are a pure function of (seed, shard, shuffle buffer size),
independent of worker count and completion timing: samples are assembled
by global record ordinal from a deterministic schedule, and every
sample's augmentation RNG is seeded from its ordinal (``_mix_seed``, the
JAX package's, so one seed gives both packages the same batches). With it
off, chunks are consumed in completion order and determinism is not
guaranteed.

Feed ``StreamingImageRecordIter`` into ``io.DeviceFeedIter`` (``fit`` does
so on the fused path with ``MXTPU_DEVICE_FEED=1``): decode runs in the
pool, the host-to-device copy overlaps compute.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import random as _pyrandom
import time
import weakref
from collections import deque

import numpy as np
import torch

from . import recordio
from . import telemetry as _tm
from .base import MXNetError
from .io import DataBatch, DataDesc, DataIter

logger = logging.getLogger(__name__)

ENV_WORKERS = "MXTPU_INPUT_WORKERS"
ENV_SHUFFLE_BUFFER = "MXTPU_SHUFFLE_BUFFER"
ENV_CHUNK_BYTES = "MXTPU_INPUT_CHUNK_BYTES"
ENV_STRICT_ORDER = "MXTPU_INPUT_STRICT_ORDER"
ENV_BAD_RECORD_BUDGET = "MXTPU_BAD_RECORD_BUDGET"
ENV_QUARANTINE_FILE = "MXTPU_QUARANTINE_FILE"

_H_DECODE = _tm.histogram(
    "io.decode_seconds",
    "Per-chunk decode+augment wall time inside input workers (labelled "
    "by worker mode) — compare against io.feed_wait_seconds: decode "
    "belongs here, never in the feed path")
_G_QDEPTH = _tm.gauge(
    "io.queue_depth",
    "Streaming input pipeline backpressure: chunk tasks in flight "
    "(queue=\"tasks\") and decoded-but-unconsumed chunks "
    "(queue=\"ready\")")
_C_BYTES = _tm.counter(
    "io.bytes_read",
    "Raw .rec bytes pulled through the streaming input pipeline")
_C_BAD = _tm.counter(
    "io.bad_records",
    "Undecodable records quarantined by the streaming input pipeline "
    "(skipped and logged; the run fails once MXTPU_BAD_RECORD_BUDGET "
    "is exceeded)")
_C_RESUB = _tm.counter(
    "io.worker_resubmits",
    "Chunk tasks resubmitted to surviving decode workers after a "
    "worker died with tasks in flight")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def input_workers(default=0):
    """``MXTPU_INPUT_WORKERS``: decode processes. 0 keeps the classic
    in-process thread-pool path."""
    return max(0, _env_int(ENV_WORKERS, default))


def shuffle_buffer_size(default=0):
    """``MXTPU_SHUFFLE_BUFFER``: samples held by the streaming shuffle
    buffer (<=1 disables cross-chunk mixing)."""
    return max(0, _env_int(ENV_SHUFFLE_BUFFER, default))


def chunk_bytes(default=4 << 20):
    """``MXTPU_INPUT_CHUNK_BYTES``: target chunk size for the
    record-aligned byte-range splits."""
    return max(1, _env_int(ENV_CHUNK_BYTES, default))


def strict_order(default=True):
    """``MXTPU_INPUT_STRICT_ORDER``: resequence completed chunks so
    batches are worker-count-independent (default on)."""
    raw = os.environ.get(ENV_STRICT_ORDER)
    if raw is None or raw == "":
        return bool(default)
    return raw not in ("0", "false", "no")


def _batch_array(arr):
    """A freshly assembled host batch as an NDArray on the current context:
    on the host it is wrapped without a copy."""
    from . import ndarray as nd
    from .context import Context

    if Context.current_context().device_type == "cpu":
        return nd.NDArray(torch.from_numpy(arr))
    return nd.array(arr)


# ---------------------------------------------------------------------------
# Worker side (runs in spawned child processes — keep picklable/top-level)

#: CreateAugmenter kwargs a declarative recipe may carry (closures cannot
#: cross a process boundary; workers rebuild the chain from this).
AUG_RECIPE_KEYS = (
    "resize", "rand_crop", "rand_resize", "rand_mirror", "mean", "std",
    "brightness", "contrast", "saturation", "pca_noise", "inter_method",
)


def _mix_seed(seed, ordinal):
    """Stable 32-bit per-sample seed from (pipeline seed, global record
    ordinal) — splitmix64-style so neighboring ordinals decorrelate."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (int(ordinal) + 1)
         * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    return x & 0x7FFFFFFF


def _build_augmenters(data_shape, recipe):
    from .image import CreateAugmenter

    recipe = dict(recipe or {})
    scale = recipe.pop("scale", 1.0)
    aug = CreateAugmenter(
        data_shape,
        **{k: v for k, v in recipe.items() if k in AUG_RECIPE_KEYS})
    if scale != 1.0:
        aug.append(lambda src: [src * scale])
    return aug


def _decode_chunk_payloads(payloads, ordinal0, cfg, auglist):
    """Decode+augment one chunk's record payloads into contiguous batch
    slabs: ``(data[n,c,h,w] f32, label[n(,label_width)] f32, valid[n],
    bad)`` where ``bad`` lists ``(global_ordinal, reason)`` for every
    record that failed to decode — the quarantine ledger. A bad record
    is a counted, budgeted event, never a silent skip (the caller
    charges it against ``MXTPU_BAD_RECORD_BUDGET``).

    Per-sample determinism: when ``cfg['seed']`` is set, the global RNGs
    are seeded from the record's global ordinal before its augment chain
    runs (and restored afterwards), so the draw sequence depends only on
    WHICH sample is augmented — never on which worker got it or how the
    chunk was batched."""
    fault = None
    if os.environ.get("MXTPU_FAULT_INJECT"):
        from .resilience import fault
    c, h, w = cfg["data_shape"]
    lw = int(cfg.get("label_width", 1))
    n = len(payloads)
    data = np.zeros((n, c, h, w), np.float32)  # NCHW: the parent copies, never transposes
    label = np.zeros((n,) if lw == 1 else (n, lw), np.float32)
    valid = np.zeros((n,), np.bool_)
    bad = []
    seed = cfg.get("seed")
    saved = None
    if seed is not None:
        saved = (_pyrandom.getstate(), np.random.get_state())
    try:
        for j, s in enumerate(payloads):
            try:
                if fault is not None:
                    fault.fire("record_decode", uri=cfg.get("uri"),
                               ordinal=ordinal0 + j)
                header, img = recordio.unpack(s)
                if seed is not None:
                    sj = _mix_seed(seed, ordinal0 + j)
                    _pyrandom.seed(sj)
                    np.random.seed(sj & 0xFFFFFFFF)
                arr = recordio._imdecode_np(bytes(img), 1)
                if arr is None or arr.size == 0:
                    bad.append((ordinal0 + j, "empty or undecodable image"))
                    continue
                arr = np.asarray(arr, np.float32)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                outs = [arr]
                for aug in auglist:
                    outs = [r for src in outs for r in aug(src)]
                # streaming slabs are strictly 1:1 — fan-out augmenters
                # belong to the classic ImageIter path
                d = outs[0]
                data[j] = np.asarray(
                    d.asnumpy() if hasattr(d, "asnumpy") else d,
                    np.float32).transpose(2, 0, 1)
                lab = np.ravel(np.asarray(header.label, np.float32))
                if lw == 1:
                    label[j] = lab[0] if lab.size else 0.0
                else:
                    label[j, :min(lw, lab.size)] = lab[:lw]
                valid[j] = True
            except (MXNetError, OSError, ValueError) as exc:
                # undecodable record: the assembler pulls a replacement
                # from the schedule — but the event is LEDGERED, never
                # silently swallowed (quarantine JSONL + budget)
                bad.append((ordinal0 + j,
                            "%s: %s" % (type(exc).__name__, exc)))
                continue
    finally:
        if saved is not None:
            _pyrandom.setstate(saved[0])
            np.random.set_state(saved[1])
    return data, label, valid, bad


def _worker_main(task_r, result_w, cfg):
    """Decode-worker loop (spawned child). Tasks are chunk descriptors
    ``(seq, start, end, ordinal, n_records)`` arriving on this worker's
    OWN task pipe; decoded slabs leave on its own result pipe. ``None``
    (or the parent closing the pipe) is the shutdown signal. Per-worker
    pipes — never shared queues — so this process dying mid-read or
    mid-write can corrupt nobody else's channel."""
    auglist = _build_augmenters(cfg["data_shape"], cfg.get("recipe"))
    handle = open(cfg["uri"], "rb")
    while True:
        try:
            task = task_r.recv()
        except (EOFError, OSError):
            break
        if task is None:
            break
        seq, start, end, ordinal, n_records = task
        t0 = time.perf_counter()
        try:
            payloads = recordio.read_chunk(
                handle, recordio.RecordChunk(start, end, ordinal,
                                             n_records),
                uri=cfg["uri"])
            data, label, valid, bad = _decode_chunk_payloads(
                payloads, ordinal, cfg, auglist)
            out = (seq, data, label, valid, bad, end - start,
                   time.perf_counter() - t0, None)
        except BaseException as e:  # noqa: BLE001 — surfaced in parent
            out = (seq, None, None, None, [], 0,
                   time.perf_counter() - t0,
                   "%s: %s" % (type(e).__name__, e))
        try:
            result_w.send(out)
        except (BrokenPipeError, OSError):
            break  # parent is gone — nothing left to report to


def _child_env():
    """Env overrides for decode children: a worker never sees the card (it
    runs libjpeg / libz, not CUDA), and its own telemetry registry would
    shadow the parent's."""
    return {"CUDA_VISIBLE_DEVICES": "", "MXTPU_TELEMETRY": "0",
            "MXTPU_TELEMETRY_FILE": ""}


_LIVE_POOLS = weakref.WeakSet()


def shutdown_all():
    """Reap every live decode pool (test teardown / atexit safety net —
    spawn children are daemonic, but an explicit terminate beats
    relying on interpreter teardown ordering)."""
    for pool in list(_LIVE_POOLS):
        pool.close()


atexit.register(shutdown_all)


class DecodePool:
    """Spawn-safe process pool moving chunk decode off the GIL.

    Every worker gets its OWN task pipe and result pipe (parent sole
    writer / sole reader respectively) instead of queues shared across
    workers: a SIGKILLed worker holding a shared queue's lock — or dead
    mid-write into a shared pipe — would wedge every survivor, while a
    private channel dies with its owner and the parent simply stops
    reading it. Death is detected by pipe EOF (the child's fd copies
    close with it), so recovery needs no polling.

    Backpressure is preserved: the parent's ``_pump`` never submits
    past ``capacity`` chunks in flight, and a worker whose result
    outruns the consumer blocks in ``send`` on its own pipe.
    """

    def __init__(self, workers, cfg, capacity=None):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.capacity = int(capacity or max(2 * workers, 4))
        self.inflight = 0
        self._procs = []
        self._task_w = []    # parent->worker send ends (None = dead)
        self._result_r = []  # worker->parent recv ends (None = dead)
        self._assigned = []  # per-worker {seq: task} not yet delivered
        self._resub_count = {}  # seq -> resubmissions (cap 1)
        self._resubmitted = False
        saved = {}
        try:
            for k, v in _child_env().items():
                saved[k] = os.environ.get(k)
                os.environ[k] = v
            for _ in range(int(workers)):
                task_r, task_w = ctx.Pipe(duplex=False)
                result_r, result_w = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_worker_main,
                                args=(task_r, result_w, cfg),
                                daemon=True)
                p.start()
                # drop the parent's copies of the child's ends so the
                # child dying closes the last write fd of its result
                # pipe — that EOF is the death signal
                task_r.close()
                result_w.close()
                self._procs.append(p)
                self._task_w.append(task_w)
                self._result_r.append(result_r)
                self._assigned.append({})
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _LIVE_POOLS.add(self)

    def _live(self):
        return [i for i, c in enumerate(self._result_r) if c is not None]

    def submit(self, task):
        self._route(task)
        self.inflight += 1

    def _route(self, task):
        """Hand a task to the least-loaded live worker; a send that
        hits a broken pipe reaps that worker (resubmitting its
        orphans) and retries on the survivors."""
        while True:
            live = self._live()
            if not live:
                raise MXNetError(
                    "input pipeline: all decode workers exited with "
                    "%d chunk(s) outstanding" % self.inflight)
            i = min(live, key=lambda j: len(self._assigned[j]))
            try:
                self._task_w[i].send(task)
            except (BrokenPipeError, OSError):
                self._mark_dead(i)
                continue
            self._assigned[i][task[0]] = task
            return

    def _mark_dead(self, i):
        """Close a dead worker's channels and resubmit its undelivered
        tasks to the survivors — each task at most ONCE: a chunk whose
        second host also died is evidence of a poison chunk (or a sick
        box), not bad luck, and retrying it forever would loop."""
        if self._result_r[i] is None:
            return
        for conn in (self._result_r[i], self._task_w[i]):
            try:
                conn.close()
            except OSError:
                pass
        self._result_r[i] = None
        self._task_w[i] = None
        orphans, self._assigned[i] = self._assigned[i], {}
        if not orphans:
            return
        twice = [s for s in orphans if self._resub_count.get(s)]
        if twice:
            raise MXNetError(
                "input pipeline: decode worker died re-running "
                "resubmitted chunk(s) %s — giving up rather than "
                "looping on a poison chunk" % sorted(twice))
        self._resubmitted = True
        _C_RESUB.inc(len(orphans))
        logger.warning(
            "input pipeline: decode worker %d died; resubmitting its "
            "%d in-flight chunk(s) to %d survivor(s)",
            i, len(orphans), len(self._live()))
        for seq, task in orphans.items():
            self._resub_count[seq] = 1
            self._route(task)

    def get(self, timeout=300.0):
        """One result tuple, surfacing worker-side failures. The
        timeout is a deadlock guard, not a latency bound: it only
        expires when no worker answers at all.

        Worker death shows up as EOF on that worker's result pipe
        (buffered complete results still arrive first); its
        undelivered tasks are resubmitted once to the survivors. Death
        of every worker — or a resubmitted task dying again — fails
        the epoch."""
        from multiprocessing import connection as _mpc

        deadline = time.monotonic() + timeout
        while True:
            conns = [c for c in self._result_r if c is not None]
            if not conns:
                raise MXNetError(
                    "input pipeline: all decode workers exited with "
                    "%d chunk(s) outstanding" % self.inflight)
            ready = _mpc.wait(conns, timeout=1.0)
            if not ready:
                if time.monotonic() > deadline:
                    raise MXNetError(
                        "input pipeline: no decode result within %.0fs "
                        "(%d in flight)" % (timeout, self.inflight))
                continue
            conn = ready[0]
            i = self._result_r.index(conn)
            try:
                out = conn.recv()
            except (EOFError, OSError):
                self._mark_dead(i)
                continue
            seq = out[0]
            self._assigned[i].pop(seq, None)
            self._resub_count.pop(seq, None)
            self.inflight -= 1
            return out

    def poll(self):
        """One result already waiting on a pipe, or None (no blocking)."""
        from multiprocessing import connection as _mpc

        while True:
            conns = [c for c in self._result_r if c is not None]
            ready = _mpc.wait(conns, timeout=0) if conns else []
            if not ready:
                return None
            conn = ready[0]
            i = self._result_r.index(conn)
            try:
                out = conn.recv()
            except (EOFError, OSError):
                self._mark_dead(i)
                continue
            self._assigned[i].pop(out[0], None)
            self._resub_count.pop(out[0], None)
            self.inflight -= 1
            return out

    def close(self):
        procs, self._procs = self._procs, []
        if not procs:
            return
        for w in self._task_w:
            if w is None:
                continue
            try:
                w.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in procs:
            p.join(timeout=2.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        for conn in self._task_w + self._result_r:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        self._task_w = []
        self._result_r = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ---------------------------------------------------------------------------
# Parent side


class StreamingImageRecordIter(DataIter):
    """Chunk-sharded, process-parallel RecordIO image iterator.

    Sample schedule (strict mode): the epoch's chunk order (seeded
    shuffle when ``shuffle``), each chunk's records in file order, run
    through a streaming shuffle buffer of ``shuffle_buffer`` samples —
    all in *index space*, so repositioning by sample count replays
    pure integer state without touching bytes or decoders (the O(1)
    cursor: no decode, no IO, just the schedule RNG).

    ``workers=0`` decodes chunks inline (same schedule, same per-ordinal
    augment seeding) — the determinism baseline the parity tests compare
    the pool against.
    """

    def __init__(self, batch_size, data_shape, path_imgrec,
                 path_imgidx=None, label_width=1, shuffle=False, seed=0,
                 aug_recipe=None, workers=None, shuffle_buffer=None,
                 strict_order=None, chunk_bytes=None, host_rank=None,
                 num_hosts=None, data_name="data",
                 label_name="softmax_label"):
        super().__init__()
        from .parallel import mesh as _mesh

        if workers is None:
            workers = input_workers()
        if shuffle_buffer is None:
            shuffle_buffer = shuffle_buffer_size()
        if strict_order is None:
            strict_order = globals()["strict_order"]()
        if chunk_bytes is None:
            chunk_bytes = globals()["chunk_bytes"]()
        if num_hosts is None:
            num_hosts = _mesh.host_count()
        if host_rank is None:
            host_rank = _mesh.host_rank()
        if not (0 <= host_rank < num_hosts):
            raise MXNetError(
                "host_rank %d outside [0, %d)" % (host_rank, num_hosts))
        self.batch_size = int(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.workers = int(workers)
        self.shuffle_buffer = int(shuffle_buffer)
        self.strict = bool(strict_order)
        self.host_rank = int(host_rank)
        self.num_hosts = int(num_hosts)
        self.uri = path_imgrec
        if path_imgidx is None and path_imgrec.endswith(".rec"):
            cand = path_imgrec[:-4] + ".idx"
            if os.path.exists(cand):
                path_imgidx = cand
        # the host's shard: every num_hosts-th chunk — fixed for the
        # whole run so hosts always read disjoint byte ranges; only the
        # ORDER within the shard reshuffles per epoch
        all_chunks = recordio.build_chunks(
            path_imgrec, path_imgidx, chunk_bytes)
        while (len(all_chunks) < 2 * num_hosts and chunk_bytes > 1
               and all_chunks
               and any(c.n_records > 1 for c in all_chunks)):
            # small file vs. big chunks would starve trailing hosts —
            # halve until every host owns data (record granularity floor)
            chunk_bytes = max(1, chunk_bytes // 2)
            all_chunks = recordio.build_chunks(
                path_imgrec, path_imgidx, chunk_bytes)
        self._chunks = all_chunks[host_rank::num_hosts]
        self.num_samples = sum(c.n_records for c in self._chunks)
        c, h, w = self.data_shape
        self.provide_data = [DataDesc(data_name,
                                      (self.batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(
            label_name,
            (self.batch_size,) if self.label_width == 1
            else (self.batch_size, self.label_width))]
        self._cfg = {
            "uri": path_imgrec,
            "data_shape": self.data_shape,
            "label_width": self.label_width,
            "recipe": dict(aug_recipe or {}),
            "seed": self.seed,
        }
        self._auglist = None  # lazy, for inline decode
        self._pool = None
        self._epoch = 0
        self._closed = False
        # poison-data quarantine: undecodable records are counted,
        # named in the quarantine JSONL, and budgeted — a dataset rot
        # past MXTPU_BAD_RECORD_BUDGET fails the run instead of
        # silently training on less data
        self.bad_records = 0
        self._bad_budget = max(0, _env_int(ENV_BAD_RECORD_BUDGET, 100))
        self._start_epoch()

    # -- epoch schedule ------------------------------------------------

    def _epoch_rng(self):
        return np.random.RandomState(
            _mix_seed(self.seed, 0x5EED0000 + self._epoch))

    def _schedule_gen(self):
        """Yield ``(chunk_index, record_offset_in_chunk)`` in emission
        order for this epoch: chunk-order shuffle, then the streaming
        buffer mixing across chunk boundaries — no barrier, ever: one
        sample leaves for every sample that enters once the buffer is
        warm, and the tail drains randomly."""
        rng = self._epoch_rng()
        order = list(range(len(self._chunks)))
        if self.shuffle:
            rng.shuffle(order)
        self._chunk_order = order

        def stream():
            for ci in order:
                for j in range(self._chunks[ci].n_records):
                    yield (ci, j)

        size = self.shuffle_buffer if self.shuffle else 0
        if size <= 1:
            return stream()

        def mixed():
            buf = []
            for item in stream():
                if len(buf) < size:
                    buf.append(item)
                    continue
                k = int(rng.randint(len(buf)))
                yield buf[k]
                buf[k] = item
            while buf:
                k = int(rng.randint(len(buf)))
                buf[k], buf[-1] = buf[-1], buf[k]
                yield buf.pop()

        return mixed()

    def _start_epoch(self):
        self._sched = self._schedule_gen()
        self._sched_buf = deque()
        self._remaining = {ci: c.n_records
                           for ci, c in enumerate(self._chunks)}
        self._cache = {}        # chunk index -> (data, label, valid)
        self._seq_meta = {}     # seq -> (epoch, chunk index)
        self._dispatched = set()
        self._dispatch_order = deque()  # chunk indices, first-need order
        self._cursor = 0        # schedule entries consumed this epoch
        # relaxed mode: per-epoch arrival state
        self._rx_rows = deque()
        self._rx_rng = self._epoch_rng()
        self._rx_next_chunk = 0
        self._seq = getattr(self, "_seq", 0)

    # -- pool / dispatch ----------------------------------------------

    def _ensure_pool(self):
        if self.workers > 0 and self._pool is None:
            self._pool = DecodePool(self.workers, self._cfg)
        return self._pool

    def _refill_lookahead(self):
        """Pull schedule entries into the lookahead buffer and extend
        the first-need dispatch order. The window covers one batch plus
        the pool's pipeline depth so workers always have chunks queued
        ahead of the assembler."""
        pool_depth = max(2 * self.workers, 2)
        want = self.batch_size + pool_depth * max(
            1, self._chunks[0].n_records if self._chunks else 1)
        while len(self._sched_buf) < want:
            try:
                entry = next(self._sched)
            except StopIteration:
                break
            self._sched_buf.append(entry)
            ci = entry[0]
            if (ci not in self._dispatched and ci not in self._cache):
                self._dispatched.add(ci)
                self._dispatch_order.append(ci)

    def _pump(self):
        """Keep the task queue primed (strict mode): submit chunks in
        first-need order while the pool has capacity."""
        pool = self._ensure_pool()
        if pool is None:
            return
        while self._dispatch_order and pool.inflight < pool.capacity:
            ci = self._dispatch_order.popleft()
            if self._remaining.get(ci, 0) <= 0:
                continue
            ch = self._chunks[ci]
            self._seq_meta[self._seq] = (self._epoch, ci)
            pool.submit((self._seq, ch.start, ch.end, ch.ordinal,
                         ch.n_records))
            self._seq += 1
        _G_QDEPTH.set(pool.inflight, queue="tasks")

    def _accept(self, seq, data, label, valid, bad, nbytes, secs, err):
        """Fold one pool result into the cache (dropping stale epochs
        and already-skipped chunks). Bad records are ledgered BEFORE
        the staleness check — the decode failure happened on real file
        bytes regardless of whether the schedule still wants them."""
        if err is not None:
            raise MXNetError("input pipeline worker failed: %s" % err)
        epoch, ci = self._seq_meta.pop(seq, (None, None))
        if bad:
            self._record_bad(ci, bad)
        _H_DECODE.observe(secs, mode="process")
        _C_BYTES.inc(nbytes)
        if epoch != self._epoch or self._remaining.get(ci, 0) <= 0:
            return None  # superseded by reset()/skip()
        self._cache[ci] = (data, label, valid)
        _G_QDEPTH.set(len(self._cache), queue="ready")
        return ci

    def _quarantine_path(self):
        path = os.environ.get(ENV_QUARANTINE_FILE)
        if path:
            return path
        run_dir = os.environ.get("MXTPU_RUN_DIR")
        if run_dir:
            return os.path.join(run_dir, "quarantine.jsonl")
        return None

    def _record_bad(self, ci, bad):
        """Quarantine bookkeeping for undecodable records: bump the
        ``io.bad_records`` counter, name each one in the quarantine
        JSONL (uri/chunk/ordinal/reason — a rewind or a data audit can
        point at the exact record), and raise once the budget is spent:
        silently training on less data than scheduled is an outage."""
        self.bad_records += len(bad)
        _C_BAD.inc(len(bad))
        path = self._quarantine_path()
        if path:
            try:
                with open(path, "a") as f:
                    for ordinal, reason in bad:
                        f.write(json.dumps({
                            "type": "quarantine",
                            "uri": self.uri,
                            "chunk": None if ci is None else int(ci),
                            "ordinal": int(ordinal),
                            "reason": str(reason),
                            "t": time.time(),
                        }) + "\n")
            except OSError:
                pass  # the counter and the budget still stand
        if self.bad_records > self._bad_budget:
            raise MXNetError(
                "input pipeline: %d undecodable record(s) in %s exceeds "
                "MXTPU_BAD_RECORD_BUDGET=%d (quarantine log: %s)"
                % (self.bad_records, self.uri, self._bad_budget,
                   path or "<none>"))

    def _decode_inline(self, ci):
        if self._auglist is None:
            self._auglist = _build_augmenters(
                self.data_shape, self._cfg.get("recipe"))
        ch = self._chunks[ci]
        t0 = time.perf_counter()
        if getattr(self, "_handle", None) is None:
            self._handle = open(self.uri, "rb")
        payloads = recordio.read_chunk(self._handle, ch, uri=self.uri)
        data, label, valid, bad = _decode_chunk_payloads(
            payloads, ch.ordinal, self._cfg, self._auglist)
        _H_DECODE.observe(time.perf_counter() - t0, mode="inline")
        _C_BYTES.inc(ch.end - ch.start)
        if bad:
            self._record_bad(ci, bad)
        return data, label, valid

    def _get_chunk(self, ci):
        """The chunk's decoded slabs — from cache, the pool (blocking on
        results until this chunk lands; strict mode tolerates
        out-of-order completion by caching early arrivals), or inline
        decode when there is no pool."""
        while ci not in self._cache:
            pool = self._ensure_pool()
            if pool is None or ci not in self._dispatched:
                self._cache[ci] = self._decode_inline(ci)
                break
            self._accept(*pool.get())
            self._pump()
        return self._cache[ci]

    def _consume_entry(self, ci):
        self._remaining[ci] -= 1
        self._cursor += 1
        if self._remaining[ci] <= 0 and self._cache.pop(ci, None) is not None:
            _G_QDEPTH.set(len(self._cache), queue="ready")

    # -- iteration -----------------------------------------------------

    def next(self):
        if self._closed:
            raise StopIteration
        return (self._next_strict() if self.strict
                else self._next_relaxed())

    def _next_strict(self):
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.zeros(
            (self.batch_size,) if self.label_width == 1
            else (self.batch_size, self.label_width), np.float32)
        rows = 0
        while rows < self.batch_size:
            if not self._sched_buf:
                self._refill_lookahead()
                if not self._sched_buf:
                    break
            self._pump()
            ci, j = self._sched_buf.popleft()
            cdata, clabel, cvalid = self._get_chunk(ci)
            self._consume_entry(ci)
            if not cvalid[j]:
                continue
            data[rows] = cdata[j]
            label[rows] = clabel[j]
            rows += 1
        if rows == 0:
            raise StopIteration
        return self._emit(data, label, rows)

    def _next_relaxed(self):
        """Completion-order assembly: decoded chunks are consumed as
        they arrive, their samples pooled through the shuffle buffer —
        a straggler chunk never stalls the feed."""
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.zeros(
            (self.batch_size,) if self.label_width == 1
            else (self.batch_size, self.label_width), np.float32)
        order = getattr(self, "_chunk_order", None)
        if order is None or self._rx_next_chunk == 0:
            # materialize this epoch's chunk order without the strict
            # scheduler (chunk-level only; samples mix in _rx_rows)
            rng = self._epoch_rng()
            order = list(range(len(self._chunks)))
            if self.shuffle:
                rng.shuffle(order)
            self._chunk_order = order
        pool = self._ensure_pool()
        target = max(self.shuffle_buffer, 1)
        rows = 0
        while rows < self.batch_size:
            # prime the pool with upcoming chunks
            while (pool is not None
                   and self._rx_next_chunk < len(order)
                   and pool.inflight < pool.capacity):
                ci = order[self._rx_next_chunk]
                self._rx_next_chunk += 1
                ch = self._chunks[ci]
                self._seq_meta[self._seq] = (self._epoch, ci)
                pool.submit((self._seq, ch.start, ch.end, ch.ordinal,
                             ch.n_records))
                self._seq += 1
            if pool is not None:
                _G_QDEPTH.set(pool.inflight, queue="tasks")
            # refill the sample buffer to the shuffle window
            while len(self._rx_rows) < target:
                got = None
                if pool is not None and pool.inflight > 0:
                    got = self._accept(*pool.get())
                elif self._rx_next_chunk < len(order):
                    ci = order[self._rx_next_chunk]
                    self._rx_next_chunk += 1
                    self._cache[ci] = self._decode_inline(ci)
                    got = ci
                if got is None and (pool is None
                                    or pool.inflight == 0) \
                        and self._rx_next_chunk >= len(order):
                    break
                if got is not None:
                    cdata, clabel, cvalid = self._cache.pop(got, (None,) * 3)
                    if cdata is None:
                        continue
                    for j in range(len(cvalid)):
                        if cvalid[j]:
                            self._rx_rows.append((cdata[j], clabel[j]))
            if not self._rx_rows:
                break
            if self.shuffle and self.shuffle_buffer > 1:
                k = int(self._rx_rng.randint(len(self._rx_rows)))
                self._rx_rows[k], self._rx_rows[-1] = (
                    self._rx_rows[-1], self._rx_rows[k])
                d, lab = self._rx_rows.pop()
            else:
                d, lab = self._rx_rows.popleft()
            data[rows] = d
            label[rows] = lab
            rows += 1
            self._cursor += 1
        if rows == 0:
            raise StopIteration
        return self._emit(data, label, rows)

    def _emit(self, data, label, rows):
        return DataBatch([_batch_array(data)], [_batch_array(label)],
                         self.batch_size - rows,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    # -- cursor --------------------------------------------------------

    @property
    def sample_position(self):
        """Schedule entries consumed this epoch (the per-host sample
        cursor the resume math multiplies back to a global position)."""
        return self._cursor

    def skip(self, num_batches):
        """Reposition by ``num_batches`` without decoding: replay the
        deterministic schedule in index space (strict mode) — pure
        integer ops, no IO, so a resume lands exactly where the
        interrupted run stopped. Relaxed mode has no deterministic
        schedule to replay; it falls back to consume-and-drop."""
        if not self.strict:
            DataIter.skip(self, num_batches)
            return
        n = int(num_batches) * self.batch_size
        while n > 0:
            if not self._sched_buf:
                self._refill_lookahead()
                if not self._sched_buf:
                    break
            ci, _j = self._sched_buf.popleft()
            self._consume_entry(ci)
            n -= 1

    def seek_sample(self, sample_pos):
        """Absolute within-epoch repositioning to ``sample_pos``
        (same index-space replay as :meth:`skip`; rewinding restarts
        the epoch schedule first)."""
        sample_pos = int(sample_pos)
        if sample_pos < self._cursor:
            self._restart_epoch()
        whole, rem = divmod(sample_pos - self._cursor, self.batch_size)
        if whole:
            self.skip(whole)
        n = rem
        while n > 0:
            if not self._sched_buf:
                self._refill_lookahead()
                if not self._sched_buf:
                    break
            ci, _j = self._sched_buf.popleft()
            self._consume_entry(ci)
            n -= 1

    def _restart_epoch(self):
        """Rebuild the CURRENT epoch's schedule from the top (seek
        support) — unlike :meth:`reset`, the epoch number (and so the
        shuffle order) is unchanged."""
        self._drain_stale()
        self._start_epoch()

    def seek_epoch(self, epoch):
        """Reposition to the START of absolute epoch ``epoch``
        (guardrail rewind support): unlike :meth:`reset` the epoch
        counter is SET, not incremented, so the schedule RNG — and with
        it the shuffle order — replays that epoch's original pass
        exactly. O(1): pure schedule state, no decode, no IO."""
        self._drain_stale()
        self._epoch = int(epoch)
        self._start_epoch()

    def _drain_stale(self):
        """Non-blocking drain of the results already delivered, so stale
        chunks from a superseded schedule never pin queue capacity (later
        ones are dropped on arrival by their epoch tag)."""
        pool = self._pool
        if pool is None:
            return
        while pool.inflight > 0:
            out = pool.poll()
            if out is None:
                break
            try:
                self._accept(*out)
            except MXNetError:
                pass  # stale failure: its schedule is gone

    def reset(self):
        """Advance to the next epoch (fresh chunk order under
        ``shuffle``). In-flight chunks from the previous epoch are
        dropped on arrival via their epoch tag."""
        self._drain_stale()
        self._epoch += 1
        self._start_epoch()

    def close(self):
        self._closed = True
        if getattr(self, "_handle", None) is not None:
            self._handle.close()
            self._handle = None
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
