"""Device meshes and the process group of the PyTorch port (counterpart of
``mxnet_tpu/parallel/mesh.py``): ``make_mesh`` / ``dp_sharding`` /
``replicated_sharding``, ``init_distributed`` and the host collectives
``barrier`` / ``allreduce_sum`` / ``reduce_scatter_sum`` / ``all_gather`` /
``broadcast_from_root``, each over the whole group or over one axis of a
mesh (:func:`axis_group`), and ``ppermute``, the point-to-point transfers
between the positions of one axis (the pipeline's sends and receives).

A :class:`Mesh` has the JAX axis names (dp, tp, pp, sp, ep), a ``shape``
dict and a ``torch.device`` per rank of this process. Several ranks may
name the same device: they are logical ranks, as the JAX package's ranks on
the virtual host devices of its tests are. The fused trainer runs the batch
of those ranks as one pass on that device; the dp shards of its flat update
are contiguous chunks of each slab.

A mesh may span processes (``processes`` > 1): each process holds its own
logical ranks on its one device, as the JAX package's
``tests/dist_worker.py`` holds 2 local ranks in each of 2 processes for
dp = 4. The global rank order is JAX's: the process-major list of every
process's ranks, reshaped to (dp, tp, pp, sp, ep) (``mxnet_tpu/parallel/
mesh.py:127-152``), so with two processes a dp = 1, tp = 2 mesh puts tp 0
in process 0 and tp 1 in process 1, and a dp = 2, tp = 2 mesh keeps both tp
ranks in each process and spans the processes with dp.
:func:`axis_group` gives, for one axis, the processes that hold this
process's peers on it (a gloo sub-group, made once an axis and kept with
the mesh) and the axis positions this process holds itself; the
collectives take it (or an axis name and the mesh) as ``axis=`` and then
run over that sub-group only. The processes form one ``torch.distributed`` **gloo** group
(:func:`init_distributed`, from the launcher's ``DMLC_*`` environment).
Gloo runs on the host: a CUDA tensor is copied into a reused pinned host
buffer after its stream's work, the collective runs on that copy and the
result is copied back. That is deliberate and visible: every collective
records its wall time in ``parallel.collective_seconds`` and its bytes in
``parallel.collective_bytes`` by op (and in :data:`collective_stats`, kept
whether telemetry is on or not), and :func:`backend` names the group's
backend. A collective over an axis records under ``op@axis``. A gloo
collective cannot be captured into a CUDA graph.

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
        self._axis_groups = {}  # axis -> AxisGroup, made on first use

    @property
    def device(self):
        return self.devices[0]

    def coords(self, local_rank=0):
        """The (dp, tp, pp, sp, ep) coordinates of this process's
        ``local_rank``-th rank: JAX's reshape of the process-major rank
        list."""
        grank = self.process_rank * len(self.devices) + int(local_rank)
        return dict(zip(AXES, _unravel(grank, [self.shape.get(ax, 1) for ax in AXES])))

    def positions(self, axis):
        """The positions on ``axis`` that this process's ranks hold, in
        order."""
        return sorted({self.coords(i)[axis] for i in range(len(self.devices))})

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


def _unravel(index, sizes):
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return list(reversed(out))


class AxisGroup:
    """One axis of a mesh as this process sees it: ``positions``, the axis
    positions its own ranks hold (contiguous); ``ranks``, the processes that
    hold the other positions of its line along the axis, in axis order
    (this one among them, at ``index``); ``size``, their count; ``group``,
    their gloo sub-group (None when ``size`` is 1 or the group is the whole
    world, which the default group serves)."""

    __slots__ = ("axis", "positions", "ranks", "index", "group")

    def __init__(self, axis, positions, ranks, index, group):
        self.axis, self.positions, self.ranks = axis, list(positions), list(ranks)
        self.index, self.group = int(index), group

    @property
    def size(self):
        return len(self.ranks)

    @property
    def local(self):
        """How many positions of the axis this process holds."""
        return len(self.positions)

    def __repr__(self):
        return "AxisGroup(%s: positions %s, processes %s)" % (self.axis, self.positions,
                                                              self.ranks)


def _axis_layout(mesh, axis):
    """For every process: (the line it lies on along ``axis`` as the tuple
    of its ranks' other coordinates, the axis positions it holds). Raises
    where a process's ranks do not cover whole, contiguous runs of lines."""
    sizes = [mesh.shape.get(ax, 1) for ax in AXES]
    a = AXES.index(axis)
    per = len(mesh.devices)
    layout = []
    for proc in range(mesh.processes):
        lines, pos = {}, set()
        for r in range(proc * per, (proc + 1) * per):
            c = _unravel(r, sizes)
            lines.setdefault(tuple(c[:a] + c[a + 1:]), set()).add(c[a])
            pos.add(c[a])
        held = {frozenset(v) for v in lines.values()}
        pos = sorted(pos)
        if len(held) != 1 or pos != list(range(pos[0], pos[0] + len(pos))):
            raise MXNetError("mesh %s over %d processes: process %d's ranks do not hold "
                             "contiguous runs of the %s axis" % (mesh.shape, mesh.processes,
                                                                 proc, axis))
        layout.append((frozenset(lines), tuple(pos)))
    return layout


def axis_group(mesh, axis):
    """The :class:`AxisGroup` of ``axis`` in ``mesh`` for this process.
    Across processes the first call for an axis makes its gloo sub-groups
    (``torch.distributed.new_group``, on every process in one order, so
    every process must make it at the same point of the program) and keeps
    them with the mesh; a mesh of one process has groups of size 1."""
    if axis not in AXES:
        raise MXNetError("unknown mesh axis %r (axes %s)" % (axis, AXES))
    cached = getattr(mesh, "_axis_groups", None)
    if cached is not None and axis in cached:
        return cached[axis]
    if getattr(mesh, "processes", 1) <= 1:
        n = axis_size(mesh, axis)
        grp = AxisGroup(axis, range(n), [process_index()], 0, None)
    else:
        layout = _axis_layout(mesh, axis)
        lines = {}
        for proc, (line, pos) in enumerate(layout):
            lines.setdefault(line, []).append((pos[0], proc))
        me = mesh.process_rank
        mine = None
        for line in sorted(lines, key=lambda ln: min(p for _, p in lines[ln])):
            ranks = [p for _, p in sorted(lines[line])]
            pg = None
            if 1 < len(ranks) < mesh.processes:
                pg = torch.distributed.new_group(ranks)  # every process makes every group
            if me in ranks:
                mine = AxisGroup(axis, layout[me][1], ranks, ranks.index(me), pg)
        grp = mine
    if cached is not None:
        cached[axis] = grp
    return grp


def dp_rows(mesh, rows):
    """This process's rows of a global batch of ``rows``: the block of its
    dp positions. Every process of one dp position (its tp / sp / ep peers)
    gets the same rows: the batch is replicated over the other axes."""
    dp = axis_size(mesh, "dp")
    if rows % dp:
        raise MXNetError("a batch of %d rows does not split over dp = %d" % (rows, dp))
    pos = axis_group(mesh, "dp").positions
    per = rows // dp
    return slice(pos[0] * per, (pos[-1] + 1) * per)


def _resolve_axis(axis, mesh):
    """An ``axis=`` argument as an AxisGroup (None: the whole group)."""
    if axis is None or isinstance(axis, AxisGroup):
        return axis
    if mesh is None:
        raise MXNetError("a collective over axis %r needs mesh=" % (axis,))
    return axis_group(mesh, axis)


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


def _pinned_slot(like, tag):
    """The reused pinned host buffer for ``like``'s element count and dtype
    under ``tag``, once the last copy out of it is done."""
    key = (like.numel(), like.dtype, tag)
    with _PINNED_LOCK:
        slot = _PINNED.get(key)
        if slot is None:
            slot = _PINNED[key] = _PinnedSlot(torch.empty(like.numel(), dtype=like.dtype,
                                                          pin_memory=True))
    if slot.event is not None:
        slot.event.synchronize()
    return slot


def _host_view(t, tag):
    """``t`` on the host: a CUDA tensor is copied into a reused pinned
    buffer after the work its stream queued (the copy is queued behind it,
    and the host waits for the copy); a host tensor is used as it is.
    Returns (host tensor, slot or None)."""
    if t.device.type != "cuda":
        return t.contiguous(), None
    slot = _pinned_slot(t, tag)
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
    """Count one collective under ``op`` (``name@axis`` for an axis's)."""
    st = collective_stats.setdefault(op, {"calls": 0, "seconds": 0.0, "bytes": 0})
    st["calls"] += 1
    st["seconds"] += seconds
    st["bytes"] += int(nbytes)
    name, _, axis = op.partition("@")
    labels = {"op": name, "axis": axis} if axis else {"op": name}
    _H_COLLECTIVE_SECONDS.observe(seconds, **labels)
    _M_COLLECTIVE_BYTES.inc(int(nbytes), **labels)


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


def _group_of(axis, mesh):
    """(AxisGroup or None, process count of the collective, label suffix)."""
    grp = _resolve_axis(axis, mesh)
    if grp is None:
        return None, process_count(), ""
    return grp, grp.size, "@" + grp.axis


def _kw(grp):
    return {} if grp is None or grp.group is None else {"group": grp.group}


def allreduce_sum(value, axis=None, mesh=None):
    """The sum of ``value`` (a tensor or an NDArray) over every process, or
    over the processes of one mesh axis (``axis``: an :class:`AxisGroup`,
    or an axis name with ``mesh``), as a new tensor on its device. One
    process: ``value`` back as it is."""
    grp, n, tag = _group_of(axis, mesh)
    if n <= 1:
        return value
    t = _as_tensor(value)
    _preamble()
    with _tm.span("mesh.allreduce_sum", nbytes=t.numel() * t.element_size()):
        t0 = time.perf_counter()
        host, slot = _host_view(t, "ar")
        if slot is None:
            host = host.clone()
        torch.distributed.all_reduce(host, **_kw(grp))
        out = _back(host, slot, t)
        _record("allreduce_sum" + tag, time.perf_counter() - t0, t.numel() * t.element_size())
    return out


def _reduce_scatter_into(out, inp, grp=None):
    fn = (getattr(torch.distributed, "reduce_scatter_single", None)
          or torch.distributed.reduce_scatter_tensor)
    fn(out, inp, **_kw(grp))


def _all_gather_into(out, inp, grp=None):
    fn = (getattr(torch.distributed, "all_gather_single", None)
          or torch.distributed.all_gather_into_tensor)
    fn(out, inp, **_kw(grp))


def reduce_scatter_sum(value, axis=None, mesh=None):
    """The sum of ``value`` over every process (or over one axis's
    processes, as :func:`allreduce_sum`), of which this process gets its
    contiguous row block ``[i·R/P, (i+1)·R/P)``, i its place among them
    (the first phase of the sharded update; ``value.shape[0]`` must divide
    by their count). One process: the whole sum, ``value`` itself."""
    grp, nproc, tag = _group_of(axis, mesh)
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
        _reduce_scatter_into(mine, host, grp)
        out = mine.to(t.device)  # from pageable memory: the host waits for the copy
        _record("reduce_scatter_sum" + tag, time.perf_counter() - t0,
                t.numel() * t.element_size())
    return out


def all_gather(value, axis=None, mesh=None):
    """Every process's (or every process of one axis's, as
    :func:`allreduce_sum`) equal-shaped ``value`` concatenated along axis 0
    in their order, on every one of them (the publish phase of the sharded
    update). One process: ``value`` back as it is."""
    grp, nproc, tag = _group_of(axis, mesh)
    if nproc <= 1:
        return value
    t = _as_tensor(value)
    _preamble()
    with _tm.span("mesh.all_gather", nbytes=t.numel() * t.element_size()):
        t0 = time.perf_counter()
        host, _ = _host_view(t, "ag_in")
        full = torch.empty((t.shape[0] * nproc,) + tuple(t.shape[1:]), dtype=t.dtype)
        _all_gather_into(full, host, grp)
        out = full.to(t.device)
        _record("all_gather" + tag, time.perf_counter() - t0, t.numel() * t.element_size())
    return out


def broadcast_from_root(value, axis=None, mesh=None):
    """Process 0's ``value`` on every process (the dist kvstore's ``init``:
    every worker starts from rank 0's weights); over one axis (as
    :func:`allreduce_sum`), its first process's. One process: ``value``."""
    grp, nproc, tag = _group_of(axis, mesh)
    if nproc <= 1:
        return value
    t = _as_tensor(value)
    _preamble()
    t0 = time.perf_counter()
    host, slot = _host_view(t, "bc")
    if slot is None:
        host = host.clone()
    torch.distributed.broadcast(host, 0 if grp is None else grp.ranks[0], **_kw(grp))
    out = _back(host, slot, t)
    _record("broadcast" + tag, time.perf_counter() - t0, t.numel() * t.element_size())
    return out


# -- point to point over one axis ---------------------------------------------
def _check_perm(perm, n):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or any(
            not (0 <= i < n) for i in srcs + dsts):
        raise MXNetError("ppermute: %s is not a partial permutation of %d positions"
                         % (perm, n))
    return tuple(perm)


def _ppermute(t, perm, grp, tag):
    """:func:`ppermute` without autograd."""
    pos = grp.positions
    lo = pos[0]
    out = torch.zeros_like(t)
    sends, recvs = [], []
    for s, d in perm:
        if s in pos and d in pos:
            out[d - lo] = t[s - lo]
        elif s in pos:
            sends.append((d, t[s - lo]))
        elif d in pos:
            recvs.append((s, d))
    if not sends and not recvs:
        return out
    owner = lambda p: grp.ranks[p // grp.local]  # noqa: E731 (the process holding p)
    nbytes = sum(v.numel() * v.element_size() for _, v in sends)
    _preamble()
    with _tm.span("mesh.ppermute", nbytes=nbytes):
        t0 = time.perf_counter()
        reqs, into = [], []
        for i, (d, v) in enumerate(sends):
            host, _ = _host_view(v, ("pp_send", i))
            reqs.append(torch.distributed.isend(host, owner(d), tag=int(tag), **_kw(grp)))
        for i, (s, d) in enumerate(recvs):
            if out.device.type == "cuda":
                slot = _pinned_slot(out[d - lo], ("pp_recv", i))
                host = slot.buf.view(out.shape[1:])
            else:
                host, slot = torch.empty(out.shape[1:], dtype=out.dtype), None
            reqs.append(torch.distributed.irecv(host, owner(s), tag=int(tag), **_kw(grp)))
            into.append((d - lo, host, slot))
        for r in reqs:  # every send and receive of the call completes here
            r.wait()
        for j, host, slot in into:
            out[j] = _back(host, slot, out)
        _record("ppermute@" + grp.axis, time.perf_counter() - t0, nbytes)
    return out


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` forward; backward, the reverse permute of the
    gradient (JAX's ``ppermute`` vjp)."""

    @staticmethod
    def forward(ctx, x, perm, grp, tag):
        ctx.perm, ctx.grp, ctx.tag = perm, grp, tag
        return _ppermute(x, perm, grp, tag)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g.contiguous(), inverse, ctx.grp, ctx.tag), None, None, None


def ppermute(value, perm, axis="pp", mesh=None, tag=0):
    """JAX's ``lax.ppermute`` over the positions of one mesh axis
    (``axis``: an :class:`AxisGroup`, or an axis name with ``mesh``).
    ``value`` leads with one entry per position this process holds on the
    axis (``AxisGroup.local`` of them, in order: the whole axis in a mesh of
    one process); ``perm`` is a list of (source, destination) positions, each
    at most once on either side. Returns ``value``'s layout in which each
    destination's entry holds its source's and every other entry zeros.
    Pairs within this process are copies; a pair across processes is a gloo
    send and receive (``isend`` / ``irecv``, all posted before any is waited
    on, so neighbours cannot deadlock on their order) of the entry staged
    through pinned host memory, tagged ``tag``. Every process of a pair must
    call with the same ``perm`` and ``tag``; a process on no pair returns at
    once. Differentiable: the gradient is the reverse permute."""
    grp = _resolve_axis(axis, mesh)
    if grp is None:
        raise MXNetError("ppermute needs an axis")
    t = _as_tensor(value)
    if t.dim() < 1 or t.shape[0] != grp.local:
        raise MXNetError("ppermute: value of shape %s must lead with this process's %d "
                         "position(s) on %s" % (tuple(t.shape), grp.local, grp.axis))
    perm = _check_perm(perm, grp.size * grp.local)
    if torch.is_grad_enabled() and t.requires_grad:
        return _PPermute.apply(t, perm, grp, int(tag))
    return _ppermute(t, perm, grp, int(tag))


# -- batch statistics that span the processes -------------------------------
_SPAN = threading.local()


class spanning_batch_stats:
    """Within this context, BatchNorm in training mode sums its per-channel
    Σx and Σx² (and its backward's two per-channel sums) over every
    process of the group, so its statistics are those of the global batch,
    as in the JAX package's one GSPMD step (``ShardedTrainStep`` enters it
    around its forward and backward when its mesh spans processes). With
    ``axis`` (an :class:`AxisGroup`, the dp axis of a mesh whose other axes
    replicate the batch) the sums run over that axis's processes only."""

    def __init__(self, active=True, axis=None):
        self.active = bool(active) and process_count() > 1
        if self.active and axis is not None:
            self.active = axis if axis.size > 1 else False

    def __enter__(self):
        self._prev = getattr(_SPAN, "on", False)
        _SPAN.on = self.active
        return self

    def __exit__(self, *exc):
        _SPAN.on = self._prev
        return False


def batch_stats_span():
    """Whether BatchNorm's statistics span the processes here: False, True
    (every process) or the :class:`AxisGroup` whose processes they span."""
    return getattr(_SPAN, "on", False)


# -- Megatron's two region functions over one axis -------------------------------
class _CopyToAxis(torch.autograd.Function):
    """Megatron's *f*: the identity forward, the all-reduce of the gradient
    over the axis's processes backward."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce_sum(g.contiguous(), axis=ctx.grp), None


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's *g*: the all-reduce over the axis's processes forward, the
    identity backward."""

    @staticmethod
    def forward(ctx, x, grp):
        return allreduce_sum(x.contiguous(), axis=grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x, grp):
    """``x`` entering a region whose partial results the axis's processes
    sum (Megatron's *f*: each process's gradient of ``x`` is partial, so
    backward sums it over them). The identity when ``grp`` spans one
    process."""
    if grp is None or grp.size <= 1 or not torch.is_grad_enabled():
        return x
    return _CopyToAxis.apply(x, grp)


def reduce_from_axis(x, grp):
    """The sum over the axis's processes of their partial ``x`` (Megatron's
    *g*: the gradient of the sum is every partial's, so backward is the
    identity). ``x`` itself when ``grp`` spans one process."""
    if grp is None or grp.size <= 1:
        return x
    if not torch.is_grad_enabled():
        return allreduce_sum(x.contiguous(), axis=grp)
    return _ReduceFromAxis.apply(x, grp)
