"""Device meshes of the PyTorch port (counterpart of
``mxnet_tpu/parallel/mesh.py`` ``make_mesh`` / ``dp_sharding`` /
``replicated_sharding``), for one process on one device.

A :class:`Mesh` has the JAX axis names (dp, tp, pp, sp, ep), a ``shape``
dict and a ``torch.device`` per rank. Several ranks may name the same
device: they are logical ranks, as the JAX package's ranks on the virtual
host devices of its tests are. The fused trainer runs the whole global
batch of such a mesh as one pass on that device; the dp shards of its
flat update are contiguous chunks of each slab. A mesh whose ranks span
more than one device needs collectives across cards (NCCL), which the
multi-card slice will bring; until then it raises.
"""
from __future__ import annotations

import math
import os
from collections import namedtuple

import torch

from ..base import MXNetError
from ..context import Context

AXES = ("dp", "tp", "pp", "sp", "ep")

Sharding = namedtuple("Sharding", ["mesh", "spec"])


class Mesh:
    """Logical ranks over devices: ``shape`` maps each axis to its size,
    ``devices`` holds one ``torch.device`` per rank (rank-major over
    dp, tp, pp, sp, ep), ``device`` the one device they all name."""

    axis_names = AXES

    def __init__(self, devices, shape):
        self.devices = list(devices)
        self.shape = dict(shape)
        if math.prod(self.shape.values()) != len(self.devices):
            raise MXNetError("mesh %s needs %d devices, got %d"
                             % (self.shape, math.prod(self.shape.values()), len(self.devices)))
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) > 1:
            raise NotImplementedError(
                "a mesh whose ranks span %d devices (%s) needs collectives across cards "
                "(NCCL), which the multi-card slice of the port will bring; the port runs "
                "meshes whose ranks share one device (mxnet_tpu/parallel/mesh.py:127 spans "
                "devices)" % (len(distinct), ", ".join(distinct)))

    @property
    def device(self):
        return self.devices[0]

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return "Mesh(%s on %s)" % (self.shape, self.device)


def _as_torch_device(d):
    if isinstance(d, Context):
        return d.torch_device
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, devices=None):
    """A Mesh with axes (dp, tp, pp, sp, ep); dp defaults to what is left
    after tp*pp*sp*ep. ``devices`` is a list of Contexts or torch devices
    and may repeat one device (``[mx.gpu(0)] * 4`` gives four logical dp
    ranks on one card); None spans every visible CUDA device and raises
    without a card."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise MXNetError("make_mesh: no CUDA device visible; pass devices= (e.g. "
                             "[mx.cpu()] * 4) to build a mesh on the host")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_as_torch_device(d) for d in devices]
    n = len(devices)
    rest = tp * pp * sp * ep
    if dp is None:
        if n % rest:
            raise MXNetError("devices (%d) not divisible by tp*pp*sp*ep (%d)" % (n, rest))
        dp = n // rest
    need = dp * rest
    if need > n:
        raise MXNetError("mesh %dx%dx%dx%dx%d needs %d devices, have %d"
                         % (dp, tp, pp, sp, ep, need, n))
    return Mesh(devices[:need], dict(zip(AXES, (dp, tp, pp, sp, ep))))


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
