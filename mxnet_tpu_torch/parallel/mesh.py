"""Device meshes and the process group of the PyTorch port (counterpart of
``mxnet_tpu/parallel/mesh.py``): ``make_mesh`` / ``dp_sharding`` /
``replicated_sharding``, ``init_distributed`` and the host collectives
``barrier`` / ``allreduce_sum`` / ``reduce_scatter_sum`` / ``all_gather`` /
``broadcast_from_root``.

A :class:`Mesh` has the JAX axis names (dp, tp, pp, sp, ep), a ``shape``
dict and a ``torch.device`` per rank of this process. Several ranks may
name the same device: they are logical ranks, as the JAX package's ranks on
the virtual host devices of its tests are. The fused trainer runs the batch
of those ranks as one pass on that device; the dp shards of its flat update
are contiguous chunks of each slab.

A mesh's dp axis may span processes (``processes`` > 1): each process holds
its own logical ranks on its one device, as the JAX package's
``tests/dist_worker.py`` holds 2 local ranks in each of 2 processes for
dp = 4. The processes form one ``torch.distributed`` **gloo** group
(:func:`init_distributed`, from the launcher's ``DMLC_*`` environment).
Gloo runs on the host: a CUDA tensor is copied into a reused pinned host
buffer after its stream's work, the collective runs on that copy and the
result is copied back. That is deliberate and visible: every collective
records its wall time in ``parallel.collective_seconds`` and its bytes in
``parallel.collective_bytes`` by op (and in :data:`collective_stats`, kept
whether telemetry is on or not), and :func:`backend` names the group's
backend. A gloo collective cannot be captured into a CUDA graph.

Ranks on several devices of one process need collectives across cards
(NCCL), the multi-card half of ROADMAP Queue 1 step 8; such a mesh raises.
"""
from __future__ import annotations

import datetime
import logging
import math
import os
import threading
import time
from collections import namedtuple
from collections.abc import Mapping

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from ..context import Context
from ..resilience import fault as _fault

AXES = ("dp", "tp", "pp", "sp", "ep")

Sharding = namedtuple("Sharding", ["mesh", "spec"])

_LOG = logging.getLogger(__name__)

_H_COLLECTIVE_SECONDS = _tm.histogram(
    "parallel.collective_seconds",
    "Wall time inside collective operations, by op")
_M_COLLECTIVE_BYTES = _tm.counter(
    "parallel.collective_bytes",
    "Bytes each process contributes to cross-process collectives, by op")

#: op -> {"calls", "seconds", "bytes"} of this process's cross-process
#: collectives, counted whether telemetry is on or not (see
#: :func:`reset_collective_stats`)
collective_stats = {}

#: Seconds a collective may wait for its peers before it fails.
ENV_TIMEOUT = "MXTPU_DIST_TIMEOUT"
#: host:port of the group's rendezvous (``tools/launch.py`` sets it).
ENV_COORDINATOR = "MXTPU_COORDINATOR_ADDRESS"


class Mesh:
    """Logical ranks over devices: ``shape`` maps each axis to its size,
    ``devices`` holds one ``torch.device`` per rank of this process
    (rank-major over dp, tp, pp, sp, ep), ``device`` the one device they
    all name; ``processes`` is how many processes the dp axis spans and
    ``process_rank`` this one's place among them."""

    axis_names = AXES

    def __init__(self, devices, shape, processes=1, process_rank=None):
        self.devices = list(devices)
        self.shape = dict(shape)
        self.processes = max(1, int(processes))
        self.process_rank = (process_index() if process_rank is None else int(process_rank))
        if math.prod(self.shape.values()) != len(self.devices) * self.processes:
            raise MXNetError("mesh %s over %d process(es) needs %d devices in each, got %d"
                             % (self.shape, self.processes,
                                math.prod(self.shape.values()) // self.processes,
                                len(self.devices)))
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) > 1:
            raise NotImplementedError(
                "a mesh whose ranks in one process span %d devices (%s) needs collectives "
                "across cards (NCCL), the multi-card half of ROADMAP Queue 1 step 8; the port "
                "runs meshes whose ranks share one device in each process "
                "(mxnet_tpu/parallel/mesh.py:127 spans devices)" % (len(distinct),
                                                                     ", ".join(distinct)))
        if self.processes > 1 and any(n != 1 for ax, n in self.shape.items() if ax != "dp"):
            raise NotImplementedError(
                "a mesh with tp/pp/sp/ep > 1 across processes needs the multi-card half of "
                "ROADMAP Queue 1 step 8; across processes only the dp axis is ported")

    @property
    def device(self):
        return self.devices[0]

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        if self.processes > 1:
            return "Mesh(%s on %s, process %d of %d)" % (self.shape, self.device,
                                                         self.process_rank, self.processes)
        return "Mesh(%s on %s)" % (self.shape, self.device)


def _as_torch_device(d):
    if isinstance(d, Context):
        return d.torch_device
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, devices=None, processes=None):
    """A Mesh with axes (dp, tp, pp, sp, ep); dp defaults to what is left
    after tp*pp*sp*ep. ``devices`` is this process's list of Contexts or
    torch devices and may repeat one device (``[mx.gpu(0)] * 4`` gives four
    logical dp ranks on one card); None spans every visible CUDA device and
    raises without a card. ``processes`` is how many processes the mesh
    spans: by default every process of the group when ``devices`` is None
    (as the JAX package's mesh over ``jax.devices()`` does), else 1. Each
    process then holds dp / ``processes`` of the dp ranks."""
    if processes is None:
        processes = process_count() if devices is None else 1
    processes = max(1, int(processes))
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise MXNetError("make_mesh: no CUDA device visible; pass devices= (e.g. "
                             "[mx.cpu()] * 4) to build a mesh on the host")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_as_torch_device(d) for d in devices]
    n = len(devices) * processes
    rest = tp * pp * sp * ep
    if dp is None:
        if n % rest:
            raise MXNetError("devices (%d) not divisible by tp*pp*sp*ep (%d)" % (n, rest))
        dp = n // rest
    need = dp * rest
    if need > n:
        raise MXNetError("mesh %dx%dx%dx%dx%d needs %d devices, have %d"
                         % (dp, tp, pp, sp, ep, need, n))
    if need % processes:
        raise MXNetError("mesh of %d ranks does not split over %d processes"
                         % (need, processes))
    return Mesh(devices[:need // processes], dict(zip(AXES, (dp, tp, pp, sp, ep))),
                processes=processes)


def axis_size(mesh, axis):
    """The size of ``axis`` in a :class:`Mesh` or a mapping of axis sizes
    (1 where the axis is absent)."""
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError("mesh must map axis names to sizes, got %r" % (mesh,))
    return int(shape.get(axis, 1))


def dp_sharding(mesh):
    """The batch sharding: leading axis over dp."""
    return Sharding(mesh, ("dp",))


def replicated_sharding(mesh):
    return Sharding(mesh, ())


def host_count(default=1):
    """How many host processes share the input dataset: the divisor of the
    streaming input pipeline's chunk shards (``io_pipeline``). In order:
    ``MXTPU_NUM_HOSTS``, ``DMLC_NUM_WORKER``, the world size of an
    initialized ``torch.distributed`` group."""
    for name in ("MXTPU_NUM_HOSTS", "DMLC_NUM_WORKER"):
        raw = os.environ.get(name)
        if raw:
            try:
                return max(1, int(raw))
            except ValueError:
                pass
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return max(1, dist.get_world_size())
    return max(1, int(default))


def host_rank(default=0):
    """This process's rank within :func:`host_count` (``MXTPU_HOST_RANK``,
    ``DMLC_RANK``, then the ``torch.distributed`` rank)."""
    for name in ("MXTPU_HOST_RANK", "DMLC_RANK"):
        raw = os.environ.get(name)
        if raw:
            try:
                return max(0, int(raw))
            except ValueError:
                pass
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return max(0, dist.get_rank())
    return max(0, int(default))


# -- the process group --------------------------------------------------------
def _group_ready():
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_count():
    """Processes in the group (1 without one)."""
    return torch.distributed.get_world_size() if _group_ready() else 1


def process_index():
    """This process's rank in the group (0 without one)."""
    return torch.distributed.get_rank() if _group_ready() else 0


def backend():
    """The group's backend (``"gloo"``), or None without a group."""
    return str(torch.distributed.get_backend()) if _group_ready() else None


def _env_int(names, default):
    for name in names:
        raw = os.environ.get(name)
        if raw:
            try:
                return int(raw)
            except ValueError:
                pass
    return default


def coordinator_from_env():
    """host:port of the rendezvous: :data:`ENV_COORDINATOR`, else the
    reference's ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT``; None when
    neither is set."""
    addr = os.environ.get(ENV_COORDINATOR)
    if addr:
        return addr
    host, port = os.environ.get("DMLC_PS_ROOT_URI"), os.environ.get("DMLC_PS_ROOT_PORT")
    return "%s:%s" % (host, port) if host and port else None


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     timeout=None):
    """Join the job's process group (the worker side of ``tools/launch.py``;
    the reference's ``DMLC_PS_ROOT_URI`` bootstrap). Reads the coordinator
    (:func:`coordinator_from_env`), ``DMLC_NUM_WORKER`` and ``DMLC_RANK``
    when the arguments are None. A one-process job does nothing and
    returns False; a second call returns True. The group is **gloo**, with
    a timeout of ``timeout`` seconds (:data:`ENV_TIMEOUT`, 300 by
    default): a collective whose peer is gone fails after it instead of
    hanging."""
    coordinator_address = coordinator_address or coordinator_from_env()
    num_processes = int(num_processes if num_processes is not None
                        else _env_int(("DMLC_NUM_WORKER",), 1))
    process_id = int(process_id if process_id is not None else _env_int(("DMLC_RANK",), 0))
    if num_processes <= 1:
        return False
    if _group_ready():
        return True
    if not coordinator_address:
        raise MXNetError("init_distributed: %d processes but no coordinator address (%s, or "
                         "DMLC_PS_ROOT_URI and DMLC_PS_ROOT_PORT)" % (num_processes,
                                                                      ENV_COORDINATOR))
    if timeout is None:
        timeout = float(os.environ.get(ENV_TIMEOUT, "300"))
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    _LOG.info("process group: rank %d of %d, backend gloo (host collectives staged through "
              "pinned memory), coordinator %s, timeout %.0f s", process_id, num_processes,
              coordinator_address, timeout)
    return True


def shutdown_distributed():
    """Leave the process group (a no-op without one)."""
    if _group_ready():
        torch.distributed.destroy_process_group()
    _PINNED.clear()


# -- host staging ---------------------------------------------------------------
class _PinnedSlot:
    __slots__ = ("buf", "event")

    def __init__(self, buf):
        self.buf = buf
        self.event = None  # the last copy out of ``buf``


_PINNED = {}  # (numel, dtype, tag) -> _PinnedSlot
_PINNED_LOCK = threading.Lock()


def _host_view(t, tag):
    """``t`` on the host: a CUDA tensor is copied into a reused pinned
    buffer after the work its stream queued (the copy is queued behind it,
    and the host waits for the copy); a host tensor is used as it is.
    Returns (host tensor, slot or None)."""
    if t.device.type != "cuda":
        return t.contiguous(), None
    key = (t.numel(), t.dtype, tag)
    with _PINNED_LOCK:
        slot = _PINNED.get(key)
        if slot is None:
            slot = _PINNED[key] = _PinnedSlot(torch.empty(t.numel(), dtype=t.dtype,
                                                          pin_memory=True))
    if slot.event is not None:
        slot.event.synchronize()  # the last copy out of this buffer is done
    with torch.cuda.device(t.device):
        slot.buf.copy_(t.reshape(-1), non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
    return slot.buf.view(t.shape), slot


def _back(host, slot, like):
    """A collective's host result as a tensor on ``like``'s device."""
    if slot is None or like.device.type != "cuda":
        return host.to(like.device) if host.device != like.device else host
    out = torch.empty(host.shape, dtype=host.dtype, device=like.device)
    with torch.cuda.device(like.device):
        out.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    slot.event = ev
    return out


_INJECT_WARNED = False


def _injected_latency_ms():
    """``MXNET_KVSTORE_INJECT_LATENCY_MS`` (a bench and test knob) as a
    float, or 0; warns once a process while it is set."""
    global _INJECT_WARNED
    raw = os.environ.get("MXNET_KVSTORE_INJECT_LATENCY_MS")
    if not raw:
        return 0.0
    try:
        ms = float(raw)
    except ValueError:
        return 0.0
    if ms > 0.0 and not _INJECT_WARNED:
        _INJECT_WARNED = True
        _LOG.warning("MXNET_KVSTORE_INJECT_LATENCY_MS=%s: %.1f ms of artificial latency in "
                     "every cross-process collective (unset it for real runs)", raw, ms)
    return ms


def _preamble():
    """The injected latency and the ``collective`` fault point. Collectives
    are never retried (every rank issues them in one order; re-entering one
    a peer has left deadlocks the group), so a delay is the only fault
    injected here, besides the lost rank that stops in it."""
    ms = _injected_latency_ms()
    if ms:
        time.sleep(ms / 1000.0)
    if _fault.configured():
        _fault.fire("collective")


def _record(op, seconds, nbytes):
    st = collective_stats.setdefault(op, {"calls": 0, "seconds": 0.0, "bytes": 0})
    st["calls"] += 1
    st["seconds"] += seconds
    st["bytes"] += int(nbytes)
    _H_COLLECTIVE_SECONDS.observe(seconds, op=op)
    _M_COLLECTIVE_BYTES.inc(int(nbytes), op=op)


def reset_collective_stats():
    """Zero :data:`collective_stats`."""
    collective_stats.clear()


def _as_tensor(value):
    """The tensor of a tensor or an NDArray."""
    return getattr(value, "_data", value)


def barrier(tag="mxnet-tpu-barrier"):
    """A barrier of every process of the group (the reference's
    ``ps::Postoffice::Barrier``); a one-process job returns at once. It
    fails after the group's timeout when a peer never arrives."""
    if process_count() <= 1:
        return
    _preamble()
    with _tm.span("mesh.barrier", tag=tag):
        t0 = time.perf_counter()
        torch.distributed.barrier()
        _record("barrier", time.perf_counter() - t0, 0)


def allreduce_sum(value):
    """The sum of ``value`` (a tensor or an NDArray) over every process, as a
    new tensor on its device. One process: ``value`` back as it is."""
    if process_count() <= 1:
        return value
    t = _as_tensor(value)
    _preamble()
    with _tm.span("mesh.allreduce_sum", nbytes=t.numel() * t.element_size()):
        t0 = time.perf_counter()
        host, slot = _host_view(t, "ar")
        if slot is None:
            host = host.clone()
        torch.distributed.all_reduce(host)
        out = _back(host, slot, t)
        _record("allreduce_sum", time.perf_counter() - t0, t.numel() * t.element_size())
    return out


def _reduce_scatter_into(out, inp):
    fn = (getattr(torch.distributed, "reduce_scatter_single", None)
          or torch.distributed.reduce_scatter_tensor)
    fn(out, inp)


def _all_gather_into(out, inp):
    fn = (getattr(torch.distributed, "all_gather_single", None)
          or torch.distributed.all_gather_into_tensor)
    fn(out, inp)


def reduce_scatter_sum(value):
    """The sum of ``value`` over every process, of which this process gets
    its contiguous row block ``[rank·R/P, (rank+1)·R/P)`` (the first phase
    of the sharded update; ``value.shape[0]`` must divide by the process
    count). One process: the whole sum, ``value`` itself."""
    nproc = process_count()
    if nproc <= 1:
        return value
    t = _as_tensor(value)
    if t.dim() < 1 or t.shape[0] % nproc:
        raise MXNetError("reduce_scatter_sum: leading dim of %s does not divide by %d "
                         "processes" % (tuple(t.shape), nproc))
    _preamble()
    with _tm.span("mesh.reduce_scatter_sum", nbytes=t.numel() * t.element_size()):
        t0 = time.perf_counter()
        host, _ = _host_view(t, "rs_in")
        mine = torch.empty((t.shape[0] // nproc,) + tuple(t.shape[1:]), dtype=t.dtype)
        _reduce_scatter_into(mine, host)
        out = mine.to(t.device)  # from pageable memory: the host waits for the copy
        _record("reduce_scatter_sum", time.perf_counter() - t0, t.numel() * t.element_size())
    return out


def all_gather(value):
    """Every process's equal-shaped ``value`` concatenated along axis 0 in
    process order, on every process (the publish phase of the sharded
    update). One process: ``value`` back as it is."""
    nproc = process_count()
    if nproc <= 1:
        return value
    t = _as_tensor(value)
    _preamble()
    with _tm.span("mesh.all_gather", nbytes=t.numel() * t.element_size()):
        t0 = time.perf_counter()
        host, _ = _host_view(t, "ag_in")
        full = torch.empty((t.shape[0] * nproc,) + tuple(t.shape[1:]), dtype=t.dtype)
        _all_gather_into(full, host)
        out = full.to(t.device)
        _record("all_gather", time.perf_counter() - t0, t.numel() * t.element_size())
    return out


def broadcast_from_root(value):
    """Process 0's ``value`` on every process (the dist kvstore's ``init``:
    every worker starts from rank 0's weights). One process: ``value``."""
    if process_count() <= 1:
        return value
    t = _as_tensor(value)
    _preamble()
    t0 = time.perf_counter()
    host, slot = _host_view(t, "bc")
    if slot is None:
        host = host.clone()
    torch.distributed.broadcast(host, 0)
    out = _back(host, slot, t)
    _record("broadcast", time.perf_counter() - t0, t.numel() * t.element_size())
    return out


# -- batch statistics that span the processes -------------------------------
_SPAN = threading.local()


class spanning_batch_stats:
    """Within this context, BatchNorm in training mode sums its per-channel
    Σx and Σx² (and its backward's two per-channel sums) over every
    process of the group, so its statistics are those of the global batch,
    as in the JAX package's one GSPMD step (``ShardedTrainStep`` enters it
    around its forward and backward when its mesh spans processes)."""

    def __init__(self, active=True):
        self.active = bool(active) and process_count() > 1

    def __enter__(self):
        self._prev = getattr(_SPAN, "on", False)
        _SPAN.on = self.active
        return self

    def __exit__(self, *exc):
        _SPAN.on = self._prev
        return False


def batch_stats_span():
    """Whether BatchNorm's statistics span the processes here."""
    return getattr(_SPAN, "on", False)
