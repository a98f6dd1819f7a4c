"""The fused training step of the PyTorch port (counterpart of
``mxnet_tpu/parallel/train_step.py``): forward, backward and optimizer
update of a Symbol over a data-parallel :class:`~.mesh.Mesh` whose ranks
share one device in each process.

The JAX step is one GSPMD program over a dp-sharded batch with replicated
parameters, so its batch statistics and gradient sums span the global
batch. On one device the port runs that global batch through one
``_GraphProgram`` pass, and the gradients of every parameter come from
``torch.autograd.grad`` of the summed outputs (the loss heads carry their
own backward). The update then takes one of three paths, as in JAX:

- per parameter (``_apply_optimizer``): dp = 1, a zero bucket cap, or an
  optimizer that is not elementwise; ``Optimizer.update`` on NDArrays;
- flat, f32 (``_apply_optimizer_flat``): ``_FlatUpdatePlan`` packs the
  parameters into size-capped buckets, padded to a dp multiple; each
  bucket's update runs on the flat slab of its weights and gradients;
- flat, bf16 AMP (``_apply_optimizer_flat_amp``, ``MXTPU_AMP=bf16``):
  bf16 working parameters and data, f32 master slabs and state slabs, a
  dynamic loss scale, one global finite flag that skips the whole step
  bit for bit, and kernel K1 (``ops/kernels.fused_slab_update_multi``)
  for SGD and Adam, one launch a step over every bucket.

The dp shards of a slab are its dp contiguous chunks, so the masters and
state slabs have the JAX layout. In "shard" mode (``MXTPU_SHARD_UPDATE``,
the default) the ranks, sharing one device, share one update over the
whole slab: one K1 table entry per bucket. "replicated" mode runs the
update chunk by chunk, as JAX's scan does (one entry per chunk);
elementwise updates give the same bits either way. The step's ``lr`` and
update count ``t`` are host numbers passed each call;
``Optimizer._index_update_count`` and ``num_update`` end as the JAX
package leaves them.

A mesh whose dp axis spans processes (``Mesh.processes`` > 1) takes each
process's rows of the global batch (its own logical ranks) through the same
pass, and sums what the JAX program sums over the global batch across the
processes of the gloo group (``parallel/mesh.py``): BatchNorm's per-channel
sums (``mesh.spanning_batch_stats`` around the forward and backward, so the
batch statistics are the global batch's) and the gradients. The
per-parameter path all-reduces the gradients (one collective a dtype); the
flat f32 and AMP paths in "shard" mode reduce-scatter each bucket's
gradient slab (bf16 under AMP), run the update (kernel K1 under AMP) over
this process's contiguous 1/P of the bucket, and all-gather the new weights
(bf16 under AMP, one collective for every bucket); "replicated" mode
all-reduces each slab and runs the whole update on every process. The AMP
finite flag, so the loss scaler's decision, and the guard's grad-norm² are
summed across the processes in one small all-reduce, so every rank takes
the same decision. ``zero1=True`` (the per-parameter path) updates, across
processes, only this process's row block of each parameter whose leading
dimension divides dp, with the optimizer state of those rows, then
all-gathers the weight rows; on logical ranks of one device it is the
replicated update. In "shard" mode and under ``zero1`` each process holds
only its block of the master and state slabs (of the state rows under
``zero1``), 1/P of them (``state_sharded``): the state's builders
(``make_state``, ``build_amp_master_state``, ``named_state_to_flat``,
``place_state``) keep this process's block, and
:meth:`ShardedTrainStep.gather_state` (a collective, which ``Module`` calls
wherever the whole state is read: the AMP masters of ``get_params``, a
checkpoint, the optimizer-state file) returns the whole state.
K-step groups (``call_multi``) over such a mesh raise :class:`MXNetError`:
a gloo collective cannot be captured into a CUDA graph.

``call_multi`` runs K steps at once, the port of JAX's ``lax.scan`` of the
step (``compile_multi``). Each micro-step is the step above on static
buffers, one set a (K, batch signature): the state (params, aux,
optimizer state) is copied in when it is not already those buffers, the K
batches are staged into (K, ...) inputs, and each micro-step's lr for every
parameter (``Optimizer.fused_lr`` under its lr and ``t``, worked out on the
host as an eager step does) goes into one (K, n) f32 table whose row the
micro-step reads through device views (``_patched_optimizer``'s
``row``; K1's ``lr`` pointers); each micro-step's new state is copied back into the
buffers. On a CUDA device the first group of a signature runs so, eagerly
(its results stand; it does the lazy set-up, and its micro-steps after the
first run under ``torch.cuda.set_sync_debug_mode("error")``, so a host read
raises); the second is captured into one ``torch.cuda.CUDAGraph`` (the
sampler generator registered with it) and replayed, and every later group
is one replay. A failed capture raises :class:`MXNetError`. On the CPU the
same body runs uncaptured. Only optimizers with a fused update (SGD,
SGD-momentum, Adam: ``fused_slab_kernel``) or none are grouped.

``param_specs`` (name -> a tuple of axis names and None, the entries of
JAX's ``PartitionSpec``, in the parameter's own layout) and meshes with
tp / pp / sp / ep axes (JAX ``mxnet_tpu/parallel/train_step.py:171-230``):
as in JAX, either turns the flat path off, so the update is the
per-parameter one (no K1; ``MXTPU_AMP=bf16`` warns and runs in f32). The
batch shards over dp only and is replicated over the other axes. Where a
spec's axis spans processes, each process keeps only its slice of that
parameter (the rows, along the spec's dimension, of its positions on the
axis) and of its optimizer state; the step all-gathers the parameter over
the axis's processes before the forward, keeps its slice of the gradient,
which is summed over the dp axis's processes as above, and updates its
slice. The compute is not split: every process of the axis runs the whole
graph on the whole parameter, where GSPMD splits each operation (ROADMAP
Queue 3 logs that difference; the values are the same).
:meth:`ShardedTrainStep.gather_params` and :meth:`gather_state` (both
collectives) return the whole parameters and state. ``zero1`` with such an
axis across processes raises.

The guardrail gate (``arm_guard``, JAX ``mxnet_tpu/parallel/train_step.py:
276-288, 1094-1175``): an armed step computes the global grad-norm² from the
gradients it holds (on the AMP path from the scaled bf16 slabs, unscaled by
1/scale²), and ``ok = isfinite(gn2) and gn2 <= threshold`` selects every
update: on the AMP path ``ok`` (and the finite flag) is the flag kernel K1
reads from device memory, so a gated launch keeps every master, state and
bf16 bit while the loss scaler's bookkeeping follows the finite flag alone,
as in JAX; the f32 flat and per-parameter paths update copies and select
them into the state; the aux states are selected too. The step appends a
``(loss, grad_norm², gate_ok)`` diag output. The threshold is a device
scalar (``guard_threshold`` writes it with ``fill_``), so a captured group
reads the new value at its next replay: re-thresholding never recaptures.

Memory mirroring (``MXNET_BACKWARD_DO_MIRROR=1`` when the step is built;
JAX ``mxnet_tpu/parallel/train_step.py:1058-1092``): the step's forward and
loss run as the executor's mirrored regions (``executor._mirrored``), on
every update path and inside a captured group, where the policy keeps the
random draws rather than setting the generator back.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from .. import operator as _operator
from .. import random as _random
from .. import telemetry as _tm
from . import mesh as _mesh
from ..base import MXNetError, bucket_bytes_env, graph_capture, release_for_capture
from ..executor import _GraphProgram, _mirror_enabled, _mirror_ops, resolve_creation_shapes
from ..ndarray import NDArray
from ..ops import kernels
from ..resilience.checkpoint import DEVICE_PULL_LOCK

_LOG = logging.getLogger(__name__)

_M_STEPS = _tm.counter(
    "train_step.steps", "Optimizer steps dispatched through the fused "
    "ShardedTrainStep path")
_M_FLAT_BUCKETS = _tm.counter(
    "train_step.flat_buckets", "Flat update buckets planned by the "
    "sharded/bucketed fused-update path (one count per bucket per plan)")
_H_BUCKET_BYTES = _tm.histogram(
    "kvstore.bucket_bytes", "Payload bytes per coalesced gradient bucket "
    "(fused flat-update plan buckets)")


class _FlatBucket:
    """One size-capped flat slab of the parameter space: contiguous
    per-key views of one padded 1-D buffer, all sharing one (dtype,
    lr_mult, wd_mult) signature, so one set of optimizer scalars serves
    the whole slab."""

    __slots__ = ("rep_index", "dtype", "views", "size", "padded")

    def __init__(self, rep_index, dtype, views, dp):
        self.rep_index = rep_index  # the index whose _fused_kwargs apply
        self.dtype = dtype
        self.views = views  # [(index, name, offset, size, shape)]
        self.size = sum(v[3] for v in views)
        self.padded = -(-self.size // dp) * dp  # splits evenly into dp shards


class _FlatUpdatePlan:
    """The JAX package's bucket layout: parameters grouped by (dtype,
    lr_mult, wd_mult), each group walked in reverse key order and packed
    into buckets of at most ``bucket_bytes`` (counted at
    ``comm_itemsize`` bytes an element under AMP: the bf16 gradient)."""

    def __init__(self, param_names, shapes, dtypes, optimizer, dp, bucket_bytes,
                 comm_itemsize=None):
        groups, order = {}, []
        for i, name in enumerate(param_names):
            key = (dtypes[name], optimizer._mult_for(i, optimizer.lr_mult),
                   optimizer._mult_for(i, optimizer.wd_mult))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append((i, name))
        self.buckets = []
        for key in order:
            dtype = key[0]
            itemsize = comm_itemsize or np.dtype(dtype).itemsize
            cap = max(1, bucket_bytes // itemsize)
            pending, pending_elems = [], 0
            for i, name in reversed(groups[key]):
                size = int(np.prod(shapes[name])) if shapes[name] else 1
                if pending and pending_elems + size > cap:
                    self._close(pending, dtype, dp)
                    pending, pending_elems = [], 0
                pending.append((i, name, size, shapes[name]))
                pending_elems += size
            if pending:
                self._close(pending, dtype, dp)
        self.by_name = {}
        for bi, b in enumerate(self.buckets):
            for (i, name, off, size, shape) in b.views:
                self.by_name[name] = (bi, off, size, shape)

    def _close(self, pending, dtype, dp):
        views, off = [], 0
        for (i, name, size, shape) in pending:
            views.append((i, name, off, size, shape))
            off += size
        self.buckets.append(_FlatBucket(pending[0][0], dtype, views, dp))


class _EveryKeyCount(dict):
    """Stands in for ``Optimizer._index_update_count`` during the update:
    every parameter reads the step's count ``t`` (the fused step updates
    each parameter once a step), and nothing is recorded."""

    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, key):
        return self._t

    def __setitem__(self, key, value):
        pass

    def __contains__(self, key):
        return True


def _map_state(fn, state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_map_state(fn, s) for s in state)
    return fn(state)


def _wrap_state(state):
    return _map_state(NDArray, state)


def _unwrap_state(state):
    return _map_state(lambda s: s._data, state)


def host_state(tree):
    """A state tree (None, tensor, or nested tuples of them) as numpy
    arrays: the named-layout snapshot format the JAX package checkpoints,
    which either package's ``named_state_to_flat`` takes back."""
    return _map_state(lambda s: s.detach().float().cpu().numpy()
                      if s.dtype == torch.bfloat16 else s.detach().cpu().numpy(), tree)


def _tensor(v, device, dtype=None):
    """An NDArray, numpy array or tensor as a tensor on ``device``."""
    if isinstance(v, NDArray):
        v = v._data
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
    return v.detach().to(device=device, dtype=dtype or v.dtype, copy=True)


def _spec_tuple(spec):
    """A parameter's spec (a PartitionSpec-like sequence of axis names and
    None) as a tuple; one axis a dimension."""
    spec = tuple(spec)
    for entry in spec:
        if entry is not None and not isinstance(entry, str):
            raise NotImplementedError("a spec entry naming several axes (%r) is not ported; "
                                      "give one axis a dimension" % (entry,))
    return spec


def _store(dst, src):
    """Write the state dict ``src`` into the buffers of ``dst`` (same keys;
    tensors, tuples of them or None), skipping entries that already are
    those buffers."""
    for key, d in dst.items():
        _store_one(d, src[key])


def _store_one(d, s):
    if isinstance(d, tuple):
        for a, b in zip(d, s):
            _store_one(a, b)
    elif d is not None and d is not s:
        d.copy_(s)


def _select_into(ok, old, new):
    """``old`` (a state tree) becomes ``where(ok, new, old)`` in place."""
    if isinstance(old, tuple):
        for a, b in zip(old, new):
            _select_into(ok, a, b)
    elif old is not None:
        old.copy_(torch.where(ok, new, old))


def _same_layout(a, b):
    """Two state trees of the same structure, shapes and dtypes."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b)
                and all(_same_layout(x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is b
    return a is b or (a.shape == b.shape and a.dtype == b.dtype and a.device == b.device)


def _kernel_launches():
    """Every kernel wrapper's launch count, name -> count."""
    return {name: fn.launches for name, fn in vars(kernels).items()
            if callable(fn) and hasattr(fn, "launches")}


class _StepGroup:
    """The static buffers of K fused steps on one batch signature, and on a
    CUDA device their graph (see :meth:`ShardedTrainStep.call_multi`)."""

    def __init__(self, k, params, aux, opt_state, batch_shapes, n_lrs, device):
        clone = lambda t: _map_state(lambda x: x.detach().clone(), t)  # noqa: E731
        self.k = k
        self.params = {n: clone(v) for n, v in params.items()}
        self.aux = {n: clone(v) for n, v in aux.items()}
        self.opt = {n: clone(v) for n, v in opt_state.items()}
        self.batches = {n: torch.empty((k,) + shape, dtype=dtype, device=device)
                        for n, (shape, dtype) in batch_shapes.items()}
        cuda = device.type == "cuda"
        self.lrs = torch.zeros((k, n_lrs), dtype=torch.float32, device=device)
        self.lrs_host = torch.zeros((k, n_lrs), dtype=torch.float32, pin_memory=cuda)
        self.pinned = {}  # name -> pinned (K, ...) staging of host batches
        self.staged = None  # event after the last copies out of pinned memory
        self.graph = None
        self.outs = None  # the captured micro-steps' outputs (graph memory)
        self.stats = {"k": k, "groups": 0, "warmup_groups": 0, "captures": 0, "replays": 0,
                      "capture_ms": None, "pool_bytes": None, "captured_launches": None}

    def fits(self, params, aux, opt_state):
        """The state trees have this group's layout."""
        return all(mine.keys() == theirs.keys()
                   and all(_same_layout(mine[n], theirs[n]) for n in mine)
                   for mine, theirs in ((self.params, params), (self.aux, aux),
                                        (self.opt, opt_state)))


class ShardedTrainStep:
    """A Symbol's training step over a Mesh whose ranks share one device;
    see the module docstring."""

    AMP_SCALE_KEY = "__amp_scale__"
    AMP_GOOD_KEY = "__amp_good__"

    def __init__(self, symbol, mesh, optimizer=None, param_specs=None, data_names=("data",),
                 label_names=("softmax_label",), dtype=None, zero1=False, flat_update=None):
        non_dp = 1
        for ax, n in mesh.shape.items():
            if ax != "dp":
                non_dp *= n
        self.param_specs = {n: _spec_tuple(sp) for n, sp in dict(param_specs or {}).items()}
        self.symbol = symbol
        self.mesh = mesh
        self.device = mesh.device
        self.nproc = getattr(mesh, "processes", 1)
        self.prank = getattr(mesh, "process_rank", 0)
        if self.nproc > 1 and self.nproc != _mesh.process_count():
            raise MXNetError("the mesh spans %d processes but the process group has %d; "
                             "call parallel.init_distributed() under the launcher first"
                             % (self.nproc, _mesh.process_count()))
        # ZeRO-1: across processes each updates its row block of the
        # parameters whose leading dimension divides dp (the JAX layout)
        self.zero1 = bool(zero1)
        self.optimizer = optimizer
        self.program = _GraphProgram(symbol)
        # the recompile detector's program for the K-step groups (each a
        # CUDA graph on the card); the eager single step reports under
        # self.program's uid, so the single steps of a trailing partial
        # group are that program's warm-up, not a recompile (in the JAX
        # package they share the groups' dispatch plan)
        self._group_uid = next(_GraphProgram._uid_counter)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.param_names = [n for n in self.arg_names
                            if n not in self.data_names + self.label_names]
        self._needs_rng = self.program.needs_rng
        self.mirror = _mirror_enabled()
        self._shape_sig = None
        self.flat_bucket_bytes = bucket_bytes_env()
        dp = mesh.shape.get("dp", 1)
        eligible = (optimizer is not None and getattr(optimizer, "elementwise_update", False)
                    and dp > 1 and non_dp == 1 and not self.param_specs
                    and self.flat_bucket_bytes > 0 and not self.zero1)
        self._shard = self._plan_shards()
        # the dp axis's processes where other axes span processes too (else
        # None: the dp axis is every process, the default group)
        self._dp_axis = None
        if self.nproc > 1 and non_dp > 1:
            grp = _mesh.axis_group(mesh, "dp")
            self._dp_axis = grp if grp.size < self.nproc else None
            if self.zero1 and grp.size < self.nproc:
                raise NotImplementedError(
                    "zero1 over a mesh whose non-dp axes span processes: its row blocks are "
                    "cut over every process, not over the dp axis's")
        if flat_update is False or not eligible:
            self.flat_mode = None
        else:
            self.flat_mode = ("shard" if os.environ.get("MXTPU_SHARD_UPDATE", "1") != "0"
                              else "replicated")
            _LOG.info("fused update path: flat bucketed (%s, dp=%d, MXTPU_BUCKET_BYTES=%d)",
                      self.flat_mode, dp, self.flat_bucket_bytes)
        self._flat_plan = None
        self._groups = {}  # (K, batch signature) -> _StepGroup
        self.last_stage_seconds = 0.0  # host staging of the last group (call_multi)
        amp_req = os.environ.get("MXTPU_AMP", "").lower()
        self.amp = False
        if amp_req in ("bf16", "bfloat16"):
            if self.flat_mode is not None:
                self.amp = True
                _LOG.info("AMP: bf16 compute + fp32 master slabs (%s mode)", self.flat_mode)
            else:
                _LOG.warning("MXTPU_AMP=bf16 ignored: requires the flat fused-update path "
                             "(elementwise optimizer, dp>1, MXTPU_BUCKET_BYTES>0, no tp/zero1)")
        elif amp_req not in ("", "0", "off", "none", "fp32", "f32", "float32"):
            _LOG.warning("MXTPU_AMP=%s not understood (only bf16); running fp32", amp_req)
        self.amp_cast_data = os.environ.get("MXTPU_AMP_CAST_DATA", "1") != "0"
        self.amp_scale_init = float(os.environ.get("MXTPU_LOSS_SCALE", str(2.0 ** 15)))
        self.amp_scale_window = int(os.environ.get("MXTPU_LOSS_SCALE_WINDOW", "2000"))
        self.amp_scale_max = 2.0 ** 24
        # -- the guardrail gate (armed by fit(guardrails="auto")) ----------
        self.guard = False
        self._guard_thr = None  # device f32 scalar, made by arm_guard
        self._guard_thr_host = float("inf")

    # -- flat layout -----------------------------------------------------
    @staticmethod
    def _flat_key(bucket_index):
        """Optimizer-state key of one bucket's state slab."""
        return "__flat__%d" % bucket_index

    @staticmethod
    def _master_key(bucket_index):
        """Optimizer-state key of one bucket's f32 master slab (AMP)."""
        return "__master__%d" % bucket_index

    @property
    def _flat_sharded(self):
        """Across processes in "shard" mode: each holds its 1/P of every
        master and state slab."""
        return self.nproc > 1 and self.flat_mode == "shard"

    @property
    def state_sharded(self):
        """Whether each process holds only its block of the masters and
        optimizer state (see :meth:`gather_state`)."""
        return bool(self._shard) or self._flat_sharded or (
            self.nproc > 1 and self.zero1 and getattr(self.optimizer, "elementwise_update",
                                                      False))

    def _own_block(self, t):
        """A copy of this process's contiguous 1/P of ``t`` (rows of its
        first dimension)."""
        return t[self._own(t.shape[0])].clone()

    # -- parameters sharded across processes (param_specs) --------------------
    def _plan_shards(self):
        """name -> (AxisGroup, dim, axis size) of every parameter whose
        spec names an axis that spans processes: this process holds the
        slice of its positions on that axis."""
        out = {}
        for name, spec in self.param_specs.items():
            for dim, axis in enumerate(spec):
                if axis is None:
                    continue
                if axis not in self.mesh.shape:
                    raise MXNetError("param_specs[%r] names axis %r, not one of the mesh's %s"
                                     % (name, axis, tuple(self.mesh.shape)))
                n = self.mesh.shape[axis]
                if self.nproc > 1 and n > 1:
                    grp = _mesh.axis_group(self.mesh, axis)
                    if grp.size > 1:
                        if name in out:
                            raise NotImplementedError(
                                "param_specs[%r] shards two dimensions across processes; "
                                "one is ported" % (name,))
                        out[name] = (grp, dim, n)
        return out

    def _slice_of(self, name, t):
        """This process's slice of the whole parameter (or state tensor)
        ``t`` of ``name``: ``t`` itself where nothing of it is sharded."""
        if name not in self._shard:
            return t
        grp, dim, n = self._shard[name]
        if t.dim() <= dim or t.shape[dim] % n:
            raise MXNetError("%s: dim %d of %s does not split into %d shards"
                             % (name, dim, tuple(t.shape), n))
        per = t.shape[dim] // n
        return t.narrow(dim, grp.positions[0] * per, grp.local * per)

    def _whole_of(self, name, t):
        """The whole parameter (or state tensor) of which ``t`` is this
        process's slice: an all-gather over the axis's processes (every one
        of them calls it at the same point)."""
        if name not in self._shard:
            return t
        grp, dim, _ = self._shard[name]
        whole = _mesh.all_gather(t.transpose(0, dim).contiguous(), axis=grp)
        return whole.transpose(0, dim).contiguous()

    def gather_params(self, params):
        """The whole parameters: the sharded ones gathered from the
        processes of their axes (a collective), the others as they are."""
        return {n: self._whole_of(n, v) for n, v in params.items()}

    def _sharded_gn2(self, grads):
        """The global grad-norm² of per-parameter gradients of which the
        sharded ones are this process's slices: each axis's slices summed
        over its processes, the replicated ones once."""
        rep = [grads[n] for n in self.param_names if n not in self._shard]
        total = self._grad_norm2(rep) if rep else torch.zeros((), device=self.device)
        by_axis = {}
        for n, (grp, _, _) in self._shard.items():
            by_axis.setdefault(grp.axis, (grp, []))[1].append(grads[n])
        for grp, gs in by_axis.values():
            total = total + _mesh.allreduce_sum(self._grad_norm2(gs), axis=grp)
        return total

    def _ensure_flat_plan(self, params):
        if self._flat_plan is None:
            shapes = {n: tuple(params[n].shape) for n in self.param_names}
            dtypes = {n: str(params[n].dtype).split(".")[-1] for n in self.param_names}
            comm_itemsize = None
            if self.amp:
                # the plan describes the f32 masters whether it is built
                # from them or from their bf16 working copies; the cap
                # counts bf16 gradient bytes
                dtypes = {n: ("float32" if d == "bfloat16" else d) for n, d in dtypes.items()}
                comm_itemsize = 2
            self._flat_plan = _FlatUpdatePlan(
                self.param_names, shapes, dtypes, self.optimizer, self.mesh.shape["dp"],
                self.flat_bucket_bytes, comm_itemsize=comm_itemsize)
            for b in self._flat_plan.buckets:
                _M_FLAT_BUCKETS.inc()
                _H_BUCKET_BYTES.observe(b.size * (comm_itemsize or np.dtype(b.dtype).itemsize))
        return self._flat_plan

    def _pack(self, parts, padded, dtype):
        """One flat slab of ``padded`` elements from the flattened
        ``parts``, zero-padded at the end."""
        flats = [p.reshape(-1).to(dtype) for p in parts]
        size = sum(f.numel() for f in flats)
        if padded > size:
            flats.append(torch.zeros(padded - size, dtype=dtype, device=self.device))
        return torch.cat(flats)

    # -- placement and state ---------------------------------------------
    def place_params(self, arg_arrays_by_name, aux_arrays_by_name):
        """Copies of the parameters and aux states (NDArrays, numpy arrays
        or tensors) on the mesh's device, name -> tensor; of a parameter
        sharded across processes, this process's slice."""
        params = {n: _tensor(arg_arrays_by_name[n], self.device) for n in self.param_names}
        params = {n: (self._slice_of(n, t).clone() if n in self._shard else t)
                  for n, t in params.items()}
        aux = {n: _tensor(aux_arrays_by_name[n], self.device) for n in self.aux_names}
        return params, aux

    def make_state(self, params):
        """Optimizer state from the optimizer's own create_state (flat slabs
        on the flat path, plus the AMP masters and loss scaler)."""
        from ..context import Context

        if self.optimizer is None:
            return {}
        ctx = Context(self.device)
        state = {}
        if self.flat_mode is not None:
            plan = self._ensure_flat_plan(params)
            for bi, b in enumerate(plan.buckets):
                size = b.padded // self.nproc if self._flat_sharded else b.padded
                st = self.optimizer.create_state_flat(b.rep_index, size, dtype=b.dtype, ctx=ctx)
                if st is not None:
                    state[self._flat_key(bi)] = _unwrap_state(st)
            if self.amp:
                # params are the f32 truth here; they become the masters
                state.update(self.build_amp_master_state(params))
            return state
        from .. import ndarray as nd

        rows = self._zero1_rows(params)
        for i, name in enumerate(self.param_names):
            p = params[name][rows.get(name, slice(None))]
            st = self.optimizer.create_state(i, nd.zeros(tuple(p.shape), ctx=ctx,
                                                         dtype=p.dtype))
            state[name] = _unwrap_state(st)
        return state

    def place_state(self, named, params):
        """A per-parameter state tree (host arrays or tensors) on the mesh's
        device in this step's layout: under ``zero1`` across processes the
        state of each sharded parameter is this process's row block."""
        rows = self._zero1_rows(params)

        def place(s, name):
            t = _tensor(s, self.device)
            if name in self._shard:
                return self._slice_of(name, t).clone()
            return self._own_block(t) if name in rows else t

        return {k: _map_state(lambda s, k=k: place(s, k), v) for k, v in named.items()}

    def init(self, arg_shapes_by_name, initializer, seed=0):
        """Parameters from ``initializer`` (on host arrays, numpy's global
        generator as in JAX), aux states (ones for *var, zeros else) and
        optimizer state, on the mesh's device."""

        class _Arr:
            def __init__(self, a):
                self._a = a
                self.shape = a.shape
                self.size = a.size
                self.dtype = a.dtype

            def __setitem__(self, k, v):
                self._a[k] = v

            def asnumpy(self):
                return self._a

        host_params = {}
        for name in self.param_names:
            host = np.zeros(arg_shapes_by_name[name], np.float32)
            initializer(name, _Arr(host))
            host_params[name] = host
        _, _, aux_shapes = self.symbol.infer_shape(**arg_shapes_by_name)
        host_aux = {n: (np.ones(s, np.float32) if n.endswith("var") else np.zeros(s, np.float32))
                    for n, s in zip(self.aux_names, aux_shapes)}
        params, aux = self.place_params(host_params, host_aux)
        opt_state = self.make_state(params)
        if self.amp:
            params = self.amp_cast_params(params)
        return params, aux, opt_state

    def amp_cast_params(self, params):
        """bf16 working copies of f32 params; other entries pass through."""
        if not self.amp:
            return params
        return {n: (p.to(torch.bfloat16) if p.dtype == torch.float32 else p)
                for n, p in params.items()}

    def build_amp_master_state(self, params_by_name, scale=None, good=0.0):
        """Master slabs packed from f32 params (host or device), this
        process's block of each when the state is sharded, and the two
        scaler scalars (a fresh scale unless ``scale`` is given)."""
        plan = self._flat_plan
        assert plan is not None, "flat plan not built yet"
        state = {}
        for bi, b in enumerate(plan.buckets):
            parts = [_tensor(params_by_name[name], self.device, torch.float32)
                     for (_i, name, _o, _s, _sh) in b.views]
            slab = self._pack(parts, b.padded, torch.float32)
            state[self._master_key(bi)] = self._own_block(slab) if self._flat_sharded else slab
        state[self.AMP_SCALE_KEY] = torch.full(
            (), self.amp_scale_init if scale is None else float(scale), dtype=torch.float32,
            device=self.device)
        state[self.AMP_GOOD_KEY] = torch.full((), float(good), dtype=torch.float32,
                                              device=self.device)
        return state

    def master_params_named(self, opt_state):
        """The f32 masters as per-parameter views (the weights' truth) of a
        whole state (:meth:`gather_state`'s where the state is sharded)."""
        plan = self._flat_plan
        assert plan is not None, "flat plan not built yet"
        out = {}
        for bi, b in enumerate(plan.buckets):
            m = opt_state[self._master_key(bi)]
            for (_i, name, off, size, shape) in b.views:
                out[name] = m[off:off + size].view(shape)
        return out

    def master_params_placed(self, opt_state):
        """Copies of the masters, what a demoted (non-flat, f32) run
        continues from (across processes a collective where the state is
        sharded)."""
        whole = self.master_params_named(self.gather_state(opt_state))
        return {n: v.clone() for n, v in whole.items()}

    def amp_state_blob(self, opt_state):
        """Host values of the scaler for checkpoints."""
        return {"scale": float(opt_state[self.AMP_SCALE_KEY]),
                "good": float(opt_state[self.AMP_GOOD_KEY])}

    def flat_state_to_named(self, opt_state):
        """The flat state slabs of a whole state carved back into
        per-parameter trees (views): the layout checkpoints store, whatever
        the bucketing."""
        plan = self._flat_plan
        assert plan is not None, "flat plan not built yet"
        named = {}
        for bi, b in enumerate(plan.buckets):
            st = opt_state.get(self._flat_key(bi))
            for (_i, name, off, size, shape) in b.views:
                named[name] = _map_state(lambda s, o=off, n=size, sh=shape: s[o:o + n].view(sh),
                                         st)
        return named

    def named_state_to_flat(self, named):
        """Inverse of :meth:`flat_state_to_named`: per-parameter trees
        (numpy arrays or tensors) packed into this plan's slabs, pads zero;
        this process's block of each where the state is sharded."""
        plan = self._flat_plan
        assert plan is not None, "flat plan not built yet"

        def pack(parts, padded):
            if all(p is None for p in parts):
                return None
            if isinstance(parts[0], tuple):
                return tuple(pack([p[j] for p in parts], padded) for j in range(len(parts[0])))
            ts = [_tensor(p, self.device) for p in parts]
            return self._pack(ts, padded, ts[0].dtype)

        state = {}
        for bi, b in enumerate(plan.buckets):
            try:
                parts = [named[name] for (_i, name, _o, _s, _sh) in b.views]
            except KeyError as exc:
                raise KeyError("optimizer state for param %s missing from the named snapshot: "
                               "it does not match this symbol's parameters" % (exc,))
            st = pack(parts, b.padded)
            if st is not None:
                state[self._flat_key(bi)] = (_map_state(self._own_block, st)
                                             if self._flat_sharded else st)
        return state

    def disable_flat_update(self, opt_state):
        """Demote to the per-parameter update (a borrowing module shares a
        subset of the parameters, which flat slabs cannot express); returns
        the state in the per-parameter layout. Under AMP, callers first take
        the masters (``master_params_placed``) as the new f32 params."""
        if self.flat_mode is None:
            return opt_state
        named = self.flat_state_to_named(self.gather_state(opt_state))
        placed = {n: _map_state(lambda s: s.clone(), s) for n, s in named.items()}
        self.flat_mode = None
        self.amp = False
        self._groups.clear()
        return placed

    # -- the update --------------------------------------------------------
    @contextlib.contextmanager
    def _patched_optimizer(self, lr, t, row=None):
        """The step's lr (host-scheduled) and update count ``t`` for every
        parameter, for the duration of one update; the optimizer's own
        counters are restored after, as the JAX trace leaves them. Both are
        numpy f32 scalars: the JAX step traces them as f32, so Adam's bias
        correction (``1 - beta2 ** t`` cancels most of its digits) and the
        lr multipliers round in f32 there, and here alike. Under a grouped
        micro-step, ``row`` is its row of the device lr table: the update
        operators then read ``row[index]`` (``Optimizer._op_lr``), which
        the host wrote before the step ran."""
        opt = self.optimizer
        saved = (opt.lr, opt.lr_scheduler, opt._index_update_count, opt.num_update)
        opt.lr = np.float32(lr)
        opt.lr_scheduler = None
        opt._index_update_count = _EveryKeyCount(np.float32(t))
        opt._update_count = lambda index: None  # instance shadows
        if row is not None:
            opt._op_lr = lambda index, lr: row[index]
        try:
            yield opt
        finally:
            del opt.__dict__["_update_count"]
            opt.__dict__.pop("_op_lr", None)
            opt.lr, opt.lr_scheduler, opt._index_update_count, opt.num_update = saved

    def _apply_optimizer(self, params, grads, opt_state, lr, t, row=None, gate=None):
        """Optimizer.update for every parameter, in place (the per-key
        layout). Across processes the gradients are all-reduced first, and
        under ``zero1`` each process updates its row block of the sharded
        parameters, then the blocks are all-gathered. Under the guard
        (``gate``) each update runs on copies that ``ok`` then selects into
        the parameter and its state."""
        opt = self.optimizer
        if self.nproc > 1:
            grads = dict(zip(self.param_names,
                             self._allreduce_each([grads[n] for n in self.param_names],
                                                  axis=self._dp_axis)))
        ok = None
        if gate is not None:
            gn2 = self._sharded_gn2(grads) if self._shard else None
            ok = self._gate(gate, [grads[n] for n in self.param_names], gn2=gn2)
        if opt is None:
            for name in self.param_names:
                new = params[name] - lr * grads[name]
                params[name].copy_(new if ok is None else torch.where(ok, new, params[name]))
            return params, opt_state
        rows = self._zero1_rows(params)
        with self._patched_optimizer(lr, t, row):
            for i, name in enumerate(self.param_names):
                sl = rows.get(name, slice(None))
                # under zero1 the state of a sharded parameter is its row block
                w_v, g_v, st_v = params[name][sl], grads[name][sl], opt_state.get(name)
                if ok is None:
                    opt.update(i, NDArray(w_v), NDArray(g_v), _wrap_state(st_v))
                    continue
                w = w_v.clone()
                st = _map_state(torch.clone, st_v)
                opt.update(i, NDArray(w), NDArray(g_v), _wrap_state(st))
                _select_into(ok, w_v, w)
                _select_into(ok, st_v, st)
        if rows:
            # each process updated its row blocks: the whole weights from their owners
            for name, whole in zip(rows, self._gather_full([params[n][sl]
                                                            for n, sl in rows.items()])):
                params[name].copy_(whole)
        return params, opt_state

    def _flat_body(self, bucket, w_c, g_c, st_c):
        """One optimizer step on a chunk of a flat f32 bucket, in place."""
        self.optimizer.update(bucket.rep_index, NDArray(w_c), NDArray(g_c), _wrap_state(st_c))

    def _chunks(self, bucket):
        """The (weight slab slice, state slice, gradient slice) triples of a
        bucket's update: the whole slab in "shard" mode (the ranks of a
        process share its device, so they share one update), across
        processes only this process's contiguous 1/P of the weights (its
        state and masters are that block, its gradient the reduce-scattered
        block); the dp chunks one by one in "replicated" mode."""
        if self.flat_mode == "shard":
            if self.nproc > 1:
                return [(self._own(bucket.padded), slice(None), slice(None))]
            return [(slice(0, bucket.padded),) * 3]
        dp = self.mesh.shape["dp"]
        s = bucket.padded // dp
        return [(slice(c * s, (c + 1) * s),) * 3 for c in range(dp)]

    # -- across processes ----------------------------------------------------
    def _own(self, n):
        """This process's contiguous block of ``n`` elements."""
        s = n // self.nproc
        return slice(self.prank * s, (self.prank + 1) * s)

    def _reduce_slabs(self, flat_gs):
        """Each bucket's gradient slab summed across processes: this
        process's reduce-scattered block in "shard" mode, the whole sum in
        "replicated" mode (one collective a bucket)."""
        if self.nproc <= 1:
            return flat_gs
        if self.flat_mode == "shard":
            return [_mesh.reduce_scatter_sum(g) for g in flat_gs]
        return [_mesh.allreduce_sum(g) for g in flat_gs]

    def _allreduce_each(self, tensors, axis=None):
        """Every tensor summed across processes (of one axis), one
        collective a dtype."""
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            summed = _mesh.allreduce_sum(torch.cat([tensors[i].reshape(-1) for i in idx]),
                                         axis=axis)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = summed[off:off + n].view(tensors[i].shape)
                off += n
        return out

    def _gather_full(self, blocks):
        """The whole tensors of which every process holds the block at its
        rank (contiguous rows of the first dimension), new, in rank order;
        one all-gather a dtype."""
        out = [None] * len(blocks)
        by_dtype = {}
        for i, t in enumerate(blocks):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            full = _mesh.all_gather(torch.cat([blocks[i].reshape(-1) for i in idx]))
            full = full.view(self.nproc, -1)
            off = 0
            for i in idx:
                b = blocks[i]
                out[i] = full[:, off:off + b.numel()].reshape(
                    (self.nproc * b.shape[0],) + tuple(b.shape[1:]))
                off += b.numel()
        return out

    def _zero1_rows(self, params):
        """name -> this process's row block, for the parameters ``zero1``
        shards across processes (leading dimension divisible by dp, an
        elementwise optimizer); empty otherwise."""
        if not self.zero1 or self.nproc <= 1 or not getattr(
                self.optimizer, "elementwise_update", False):
            return {}
        dp = self.mesh.shape["dp"]
        return {n: self._own(params[n].shape[0]) for n in self.param_names
                if params[n].dim() >= 1 and params[n].shape[0] % dp == 0}

    def gather_state(self, opt_state, params=None):
        """The whole masters and optimizer state: where each process holds
        its block (``state_sharded``), a new dict whose sharded entries are
        gathered from every process (a collective: every process calls it
        at the same point; ``params`` names the ``zero1`` rows); else
        ``opt_state`` itself."""
        if not self.state_sharded:
            return opt_state
        if self._shard:
            out = dict(opt_state)
            for name in self._shard:
                if out.get(name) is not None:
                    out[name] = _map_state(lambda t, n=name: self._whole_of(n, t), out[name])
            return out
        if self._flat_sharded:
            keys = [k for bi in range(len(self._flat_plan.buckets))
                    for k in (self._master_key(bi), self._flat_key(bi))]
        else:
            keys = list(self._zero1_rows(params))
        keys = [k for k in keys if opt_state.get(k) is not None]
        blocks = []
        for k in keys:
            _map_state(blocks.append, opt_state[k])
        whole = iter(self._gather_full(blocks))
        out = dict(opt_state)
        for k in keys:
            out[k] = _map_state(lambda _b: next(whole), opt_state[k])
        return out

    def _apply_optimizer_flat(self, params, grads, opt_state, lr, t, row=None, gate=None):
        """The f32 flat update: per bucket, the optimizer on the flat slab of
        weights and gradients, then per-parameter views of the new slab.
        Under the guard the state slabs update as copies, and ``ok`` selects
        the new weight slab and those copies (the old weight slab is the
        packed copy of the old params)."""
        if self.optimizer is None or self.flat_mode is None:
            return self._apply_optimizer(params, grads, opt_state, lr, t, row, gate)
        plan = self._ensure_flat_plan(params)
        new_params = dict(params)
        flat_ws, flat_gs = [], []
        for b in plan.buckets:
            names = [v[1] for v in b.views]
            dtype = params[names[0]].dtype
            flat_ws.append(self._pack([params[n] for n in names], b.padded, dtype))
            flat_gs.append(self._pack([grads[n] for n in names], b.padded, dtype))
        flat_gs = self._reduce_slabs(flat_gs)
        partial = self._flat_sharded
        ok = None if gate is None else self._gate(gate, flat_gs, partial=partial)
        new_ws = []
        with self._patched_optimizer(lr, t, row):
            for bi, b in enumerate(plan.buckets):
                flat_w, st = flat_ws[bi], opt_state.get(self._flat_key(bi))
                if ok is not None:
                    flat_w, st_old, st = flat_w.clone(), st, _map_state(torch.clone, st)
                for cw, cs, cg in self._chunks(b):
                    self._flat_body(b, flat_w[cw], flat_gs[bi][cg],
                                    _map_state(lambda s, cs=cs: s[cs], st))
                if ok is not None:
                    flat_w = torch.where(ok, flat_w, flat_ws[bi])
                    _select_into(ok, st_old, st)
                new_ws.append(flat_w)
        if partial:
            # each process updated its block: the new weights from their owners
            new_ws = self._gather_full([w[self._own(w.shape[0])] for w in new_ws])
        for b, flat_w in zip(plan.buckets, new_ws):
            for (_i, name, off, size, shape) in b.views:
                new_params[name] = flat_w[off:off + size].view(shape)
        return new_params, opt_state

    def _slab_kind(self):
        opt = self.optimizer
        kind = getattr(opt, "fused_slab_kernel", None)
        if kind == "sgd" and getattr(opt, "momentum", 0.0):
            kind = "sgd_mom"
        return kind

    def _slab_entry(self, kind, bucket, m_c, g_c, st_c, w16_c):
        """K1's table entry for one chunk of an AMP bucket: the bucket's
        ``lr`` (Adam's times its bias correction) and ``wd`` as the
        optimizer gives them (numpy f32 under ``_patched_optimizer``), the
        f32 master and state chunks updated in place, the bf16 weight chunk
        written to ``w16_c``; and the static hyperparameters, the same for
        every bucket."""
        opt = self.optimizer
        states = () if st_c is None else (st_c if isinstance(st_c, tuple) else (st_c,))
        kwargs = opt._fused_kwargs(bucket.rep_index)
        lr_eff = opt._op_lr(bucket.rep_index, kwargs["lr"])
        statics = dict(rescale_grad=kwargs["rescale_grad"], clip_gradient=kwargs["clip_gradient"],
                       momentum=getattr(opt, "momentum", 0.0), beta1=getattr(opt, "beta1", 0.9),
                       beta2=getattr(opt, "beta2", 0.999), epsilon=getattr(opt, "epsilon", 1e-8))
        entry = kernels.SlabEntry(m_c, g_c, states, lr_eff, kwargs["wd"], (m_c, states, w16_c))
        return entry, statics

    def _flat_body_amp(self, bucket, m_c, g_c, st_c, inv_scale, finite, w16_c):
        """One AMP step on a chunk for an elementwise optimizer without a
        ``fused_slab_kernel``: its own update on the unscaled f32 gradient,
        then the finite select (a non-finite step keeps every old bit) and
        the bf16 copy into ``w16_c``."""
        opt = self.optimizer
        states = () if st_c is None else (st_c if isinstance(st_c, tuple) else (st_c,))
        w = NDArray(m_c.clone())
        new_states = tuple(s.clone() for s in states)
        st = None if st_c is None else _wrap_state(
            new_states if isinstance(st_c, tuple) else new_states[0])
        opt.update(bucket.rep_index, w, NDArray(g_c.float() * inv_scale), st)
        keep = finite > 0.5
        m_c.copy_(torch.where(keep, w._data, m_c))
        for old, new in zip(states, new_states):
            old.copy_(torch.where(keep, new, old))
        w16_c.copy_(m_c.to(torch.bfloat16))

    def _apply_optimizer_flat_amp(self, params, grads, opt_state, lr, t, row=None, gate=None):
        """The AMP flat update: per bucket the bf16 gradient slab; one
        finite flag over every slab gates every bucket alike; masters and
        states updated in place, new bf16 working params as views of each
        bucket's new bf16 slab; then the loss scaler, ×2 after
        ``amp_scale_window`` finite steps in a row and ×0.5 (at least 1)
        on a non-finite one, all on the device (no host sync). Optimizers
        with a ``fused_slab_kernel`` update every (bucket, chunk) in one
        K1 call (``kernels.fused_slab_update_multi``, its plain version on
        the CPU): one launch a step for up to ``SLAB_TABLE_CAP`` chunks,
        after the finite flag is known. Other elementwise optimizers take
        ``_flat_body_amp`` chunk by chunk. Under the guard the flag K1 (or
        ``_flat_body_amp``) reads is ``finite and ok``; the scaler still
        follows ``finite``."""
        plan = self._ensure_flat_plan(params)
        scale = opt_state[self.AMP_SCALE_KEY]
        good = opt_state[self.AMP_GOOD_KEY]
        flat_gs = []
        for b in plan.buckets:
            names = [v[1] for v in b.views]
            flat_gs.append(self._pack([grads[n] for n in names], b.padded, grads[names[0]].dtype))
        flat_gs = self._reduce_slabs(flat_gs)
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        for flat_g in flat_gs:
            finite = finite & torch.isfinite(flat_g).all()
        inv_scale = torch.reciprocal(scale)
        partial = self._flat_sharded
        gn2 = None
        if partial:
            # each process holds a block of the summed gradients: the finite
            # flag (so the scaler's decision) and the guard's grad-norm² are
            # the whole sum's, one small all-reduce for both
            parts = [(~finite).to(torch.float32)]
            if gate is not None:
                parts.append(self._grad_norm2(flat_gs))
            summed = _mesh.allreduce_sum(torch.stack(parts))
            finite = summed[0] == 0
            gn2 = summed[1] if gate is not None else None
        flag = finite if gate is None else finite & self._gate(gate, flat_gs, inv_scale, gn2=gn2)
        finite_f = flag.to(torch.float32)
        new_params = dict(params)
        kind = self._slab_kind()
        entries, statics, w16s = [], None, []
        with self._patched_optimizer(lr, t, row):
            for bi, b in enumerate(plan.buckets):
                master = opt_state[self._master_key(bi)]
                st = opt_state.get(self._flat_key(bi))
                # the masters, state and new bf16 weights of this process's
                # block where the state is sharded; the weight slice is theirs
                w16 = torch.empty(master.shape[0], dtype=torch.bfloat16, device=self.device)
                for _cw, cs, cg in self._chunks(b):
                    st_c = _map_state(lambda s, cs=cs: s[cs], st)
                    if kind is None:
                        self._flat_body_amp(b, master[cs], flat_gs[bi][cg], st_c, inv_scale,
                                            finite_f, w16[cs])
                    else:
                        entry, statics = self._slab_entry(kind, b, master[cs], flat_gs[bi][cg],
                                                          st_c, w16[cs])
                        entries.append(entry)
                w16s.append(w16)
            if entries:
                kernels.fused_slab_update_multi(kind, entries, inv_scale, finite_f, **statics)
        if partial:
            # the new bf16 weights of every block from its owner
            w16s = self._gather_full(w16s)
        for b, w16 in zip(plan.buckets, w16s):
            for (_i, name, off, size, shape) in b.views:
                new_params[name] = w16[off:off + size].view(shape)
        grown = (good + 1.0) >= float(self.amp_scale_window)
        zero = torch.zeros_like(good)
        opt_state[self.AMP_SCALE_KEY] = torch.where(
            finite, torch.where(grown, torch.clamp_max(scale * 2.0, self.amp_scale_max), scale),
            torch.clamp_min(scale * 0.5, 1.0))
        opt_state[self.AMP_GOOD_KEY] = torch.where(
            finite, torch.where(grown, zero, good + 1.0), zero)
        return new_params, opt_state

    # -- the step ----------------------------------------------------------
    def _step(self, params, aux, opt_state, batch, rng, lr, t, row=None):
        amp = self.amp
        if amp and self.amp_cast_data:
            # bf16 activations from the first op: floating DATA feeds only
            # (loss heads compare labels exactly)
            batch = {n: (v.to(torch.bfloat16) if n in self.data_names and v.is_floating_point()
                         else v) for n, v in batch.items()}
        whole = self.gather_params(params) if self._shard else params
        leaves = {n: whole[n].detach().requires_grad_(whole[n].is_floating_point())
                  for n in self.param_names}
        # the mirror rematerialises the cheap ops in backward and keeps the
        # dot/conv outputs (executor._GraphProgram._run_regions)
        mirror = ([rng] if rng is not None else [], _mirror_ops()) if self.mirror else None
        with torch.enable_grad(), _mesh.spanning_batch_stats(self.nproc > 1, self._dp_axis):
            outs, new_aux = self.program({**leaves, **batch}, aux, rng, True, mirror=mirror)
            loss = sum((o.float() if amp else o).sum() for o in outs)
            diff = [n for n in self.param_names if leaves[n].requires_grad]
            got = torch.autograd.grad(loss, [leaves[n] for n in diff], allow_unused=True)
        grads = {n: self._slice_of(n, torch.zeros_like(leaves[n]) if g is None else g)
                 for n, g in zip(diff, got)}
        outs = [o.detach() for o in outs]
        if amp:
            # the loss scale rides the gradient stream: every loss head
            # ignores its incoming gradient, so scaling the loss would not
            # reach them; the scaler's powers of two multiply exactly
            scale = opt_state[self.AMP_SCALE_KEY]
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
            outs = [o.float() for o in outs]
        if amp:
            apply = self._apply_optimizer_flat_amp
        elif self.flat_mode is not None:
            apply = self._apply_optimizer_flat
        else:
            apply = self._apply_optimizer
        gate = {} if self.guard else None
        with torch.no_grad():
            new_params, new_opt = apply(params, grads, opt_state, lr, t, row, gate)
        new_aux = {**aux, **{k: v.detach() for k, v in new_aux.items()}}
        if amp:  # BN moving stats keep their f32 dtype
            new_aux = {k: (v.to(aux[k].dtype) if k in aux and v.dtype != aux[k].dtype else v)
                       for k, v in new_aux.items()}
        if gate is not None:
            ok = gate["ok"]
            new_aux = {k: (torch.where(ok, v, aux[k]) if k in aux else v)
                       for k, v in new_aux.items()}
            # every process's guard observes the global batch's loss
            diag_loss = (_mesh.allreduce_sum(loss.detach().float(), axis=self._dp_axis)
                         if self.nproc > 1 else loss.detach().float())
            outs = outs + [torch.stack([diag_loss, gate["gn2"], ok.float()])]
        return new_params, new_aux, new_opt, outs

    def compile(self, data_shapes_by_name=None):
        """Kept for the JAX surface: eager PyTorch has nothing to compile.
        Registers the programs' mesh with the anatomy's fingerprints."""
        for uid in (self.program._program_uid, self._group_uid):
            _tm.anatomy.register_program(uid, mesh=str(dict(self.mesh.shape)))
        return self

    def step_cost(self, batch_shapes):
        """``{"flops", "bytes_accessed"}`` of one step at ``batch_shapes``
        (name -> shape of the global batch): the analytic count
        (``telemetry.costmodel.analytic_step_cost``), at bf16 activations
        under AMP. Runs nothing."""
        slab = self._slab_kind() if self.optimizer is not None else None
        return _tm.costmodel.analytic_step_cost(
            self.symbol, dtype_bytes=2 if self.amp else 4,
            state_slots=kernels.SLAB_STATE_SLOTS.get(slab, 1), amp=self.amp,
            **{n: tuple(s) for n, s in batch_shapes.items()})

    def _note_dispatch(self, sig, batch_shapes, k):
        """The anatomy's accounting of one dispatch of ``k`` steps: the
        signature and the step's cost, counted once a signature. Groups
        report to their own detector program: a new depth or batch is a new
        capture on the card, a recompile after the first; the single step's
        first signature is its own warm-up."""
        multi = sig[0] == "multi"
        self.program.note_signature(sig, self._group_uid if multi else None)
        if _tm.anatomy.wants_cost():
            _tm.anatomy.capture_cost(
                self.program._program_uid, sig,
                lambda: {n: k * v for n, v in self.step_cost(batch_shapes).items()},
                steps=k, dtype="bf16" if self.amp else "f32")
        _M_STEPS.inc(k, path="multi" if multi else "single")

    def release_groups(self, keep_k):
        """Drop the K-step groups of every depth but ``keep_k``: their CUDA
        graphs and graph pools at once, their static buffers as soon as the
        state no longer refers to them (``fit``'s auto tuner, when K
        grows)."""
        for key in [key for key in self._groups if key[0] != keep_k]:
            del self._groups[key]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def arm_guard(self):
        """Turn the guardrail gate and diag head on (``fit(guardrails=...)``).
        Groups built before are dropped, since their graphs hold the
        unguarded step; idempotent."""
        if not self.guard:
            self.guard = True
            self._guard_thr = torch.full((), self._guard_thr_host, dtype=torch.float32,
                                         device=self.device)
            self._groups.clear()
        return self

    @property
    def guard_threshold(self):
        """The gate's grad-norm² bound (``inf``: gate on non-finite only)."""
        return self._guard_thr_host

    @guard_threshold.setter
    def guard_threshold(self, value):
        # written into the device scalar in stream order: a replayed group
        # reads it, no recapture
        self._guard_thr_host = float(value)
        if self._guard_thr is not None:
            self._guard_thr.fill_(self._guard_thr_host)

    @staticmethod
    def _grad_norm2(grads):
        return torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32).square()
                            for g in grads]).sum()

    def _gate(self, gate, grads, inv_scale=None, partial=False, gn2=None):
        """``ok`` of the guard from ``grads`` (tensors whose squares sum to
        the global grad-norm², scaled by ``1/inv_scale`` under AMP; with
        ``partial`` each process holds a block, and the sums are added
        across processes) or from a ``gn2`` already summed; records ``gn2``
        and ``ok`` in ``gate``."""
        if gn2 is None:
            gn2 = self._grad_norm2(grads)
            if partial:
                gn2 = _mesh.allreduce_sum(gn2)
        if inv_scale is not None:
            gn2 = gn2 * inv_scale * inv_scale
        ok = torch.isfinite(gn2) & (gn2 <= self._guard_thr)
        gate.update(gn2=gn2, ok=ok)
        return ok

    def _set_shapes(self, params, sig):
        """Creation-op shapes for one step's batch signature ``sig`` ((name,
        shape) pairs), resolved when it changes."""
        if sig != self._shape_sig:
            shapes = {n: tuple(v.shape) for n, v in params.items()}
            shapes.update(dict(sig))
            self.program.shape_overrides = resolve_creation_shapes(self.symbol, shapes)
            self._shape_sig = sig

    # -- K steps at once ---------------------------------------------------
    def compile_multi(self, k):
        """The K-step function ``(params, aux, opt_state, batches, lrs, ts)
        -> (params, aux, opt_state, outs)`` (see :meth:`call_multi`; its
        buffers and graph are kept per K and batch signature). Raises
        NotImplementedError for an optimizer whose update does not read its
        lr through ``Optimizer._op_lr``."""
        if self.nproc > 1:
            raise MXNetError(
                "K fused steps at once over a mesh that spans %d processes: the gloo "
                "collectives of the step run on the host and cannot be captured into a CUDA "
                "graph (capture over processes needs NCCL, the multi-card half of ROADMAP "
                "Queue 1 step 8); use MXNET_FIT_MULTISTEP=1" % self.nproc)
        opt = self.optimizer
        if opt is not None and getattr(opt, "fused_slab_kernel", None) is None:
            raise NotImplementedError(
                "MXNET_FIT_MULTISTEP > 1 groups SGD, SGD-momentum and Adam steps; %s is not "
                "grouped yet (ROADMAP.md, Queue 1 step 2)" % type(opt).__name__)
        if k < 1:
            raise MXNetError("compile_multi: K must be at least 1, got %r" % (k,))
        return lambda *args: self._run_multi(k, *args)

    def call_multi(self, params, aux, opt_state, batches, lrs, ts):
        """K = ``len(lrs)`` fused steps at once, each the arithmetic of one
        :meth:`__call__`: ``batches`` name -> a (K, batch, ...) tensor or K
        tensors of the global batch, ``lrs`` / ``ts`` the K micro-steps'
        host-scheduled lrs and update counts. Returns (params, aux,
        opt_state, outs), the state dicts holding the group's static
        buffers (the next group reads them in place, or copies in what
        differs) and ``outs`` one (K, ...) tensor an output, a copy. See
        the module docstring for the CUDA graph."""
        return self.compile_multi(len(lrs))(params, aux, opt_state, batches, lrs, ts)

    def group_stats(self):
        """Per (K, batch signature): the groups run, those run eagerly on
        the card (the warm-up), captures, replays, the capture's ms, the
        graph pool's bytes and the launches each kernel wrapper counted
        while the graph was captured (its launches a replay)."""
        return [dict(g.stats) for g in self._groups.values()]

    def _lr_rows(self, lrs, ts):
        """The (K, n) table of each micro-step's lr for each parameter index
        (one column when there is no optimizer), in the f32 arithmetic of an
        eager step: ``Optimizer.fused_lr`` under ``_patched_optimizer``."""
        opt = self.optimizer
        rows = np.zeros((len(lrs), max(1, len(self.param_names))), np.float32)
        if self.flat_mode is not None:
            cols = sorted({b.rep_index for b in self._flat_plan.buckets})
        else:
            cols = range(len(self.param_names))
        for k, (lr, t) in enumerate(zip(lrs, ts)):
            if opt is None:
                rows[k] = lr
                continue
            with self._patched_optimizer(lr, t):
                for i in cols:
                    rows[k, i] = opt.fused_lr(i, opt._fused_kwargs(i)["lr"])
        return rows

    def _stage(self, group, batches):
        """The K batches into the group's (K, ...) inputs: host tensors
        through one pinned buffer a name (non-blocking), device ones
        directly."""
        k = group.k
        for name, src in batches.items():
            dst = group.batches[name]
            parts = [src[i] for i in range(k)]
            if dst.device.type == "cuda" and parts[0].device.type == "cpu":
                pinned = group.pinned.get(name)
                if pinned is None:
                    pinned = group.pinned[name] = torch.empty(dst.shape, dtype=dst.dtype,
                                                              pin_memory=True)
                torch.stack([p.to(dst.dtype) for p in parts], out=pinned)
                dst.copy_(pinned, non_blocking=True)
            else:
                for i, p in enumerate(parts):
                    dst[i].copy_(p)

    def _micro_step(self, group, i, rng, lr, t):
        """Micro-step ``i`` of a group on its buffers: the eager step with
        every lr read from row ``i`` of the device table, its new state
        written back into the buffers. Returns its outputs."""
        row = group.lrs[i]
        batch = {n: v[i] for n, v in group.batches.items()}
        if self.optimizer is None:
            lr, row = row[0], None
        p, a, s, outs = self._step(group.params, group.aux, dict(group.opt), batch, rng, lr, t,
                                   row)
        _store(group.params, p)
        _store(group.aux, a)
        _store(group.opt, s)
        return outs

    def _warmup(self, group, lrs, ts, rng):
        """A group run eagerly on a CUDA device: micro-step 0 does the lazy
        set-up, the rest run under sync debug mode "error"."""
        outs = [self._micro_step(group, 0, rng, lrs[0], ts[0])]
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs += [self._micro_step(group, i, rng, lrs[i], ts[i])
                     for i in range(1, group.k)]
        except RuntimeError as exc:
            # sync debug mode's own error ("called a synchronizing CUDA
            # operation"); any other error goes on as it is
            if "synchronizing CUDA operation" not in str(exc):
                raise
            raise MXNetError("a grouped step waited for the device (a host read), which a "
                             "CUDA graph cannot capture: %s" % exc) from exc
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        group.stats["warmup_groups"] += 1
        return outs

    def _capture(self, group, lrs, ts, rng):
        """Capture the group's K micro-steps into one CUDA graph (nothing
        runs); its pool's bytes, the capture ms and the launches each
        wrapper counted go into ``group.stats``. A graph that holds a Custom
        or ROIPooling node is refused (``operator.refuse_capture``)."""
        _operator.refuse_capture(self.program, "%d fused steps" % group.k)
        dev = self.device
        graph = torch.cuda.CUDAGraph()
        if rng is not None:
            graph.register_generator_state(rng)
        release_for_capture(dev)
        reserved, before = torch.cuda.memory_reserved(dev), _kernel_launches()
        t0 = time.perf_counter()
        try:
            with graph_capture(graph):
                outs = [self._micro_step(group, i, rng, lrs[i], ts[i]) for i in range(group.k)]
        except Exception as exc:
            raise MXNetError("capturing %d fused steps into a CUDA graph failed: %s"
                             % (group.k, exc)) from exc
        torch.cuda.synchronize(dev)
        after = _kernel_launches()
        group.stats.update(
            captures=group.stats["captures"] + 1, capture_ms=1e3 * (time.perf_counter() - t0),
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
            captured_launches={n: after[n] - before[n] for n in after if after[n] != before[n]})
        group.graph, group.outs = graph, outs

    def _run_multi(self, k, params, aux, opt_state, batches, lrs, ts):
        dev = self.device
        if len(lrs) != k or len(ts) != k:
            raise MXNetError("a %d-step group takes %d lrs and ts, got %d and %d"
                             % (k, k, len(lrs), len(ts)))
        batches = {n: (v if torch.is_tensor(v) else list(v)) for n, v in batches.items()}
        step_shapes = {n: (tuple(v[0].shape), v[0].dtype) for n, v in batches.items()}
        for n, v in batches.items():
            if len(v) != k or any(tuple(v[i].shape) != step_shapes[n][0] for i in range(k)):
                raise MXNetError("a %d-step group takes %d batches of one shape for %s"
                                 % (k, k, n))
        sig = tuple((n, shape) for n, (shape, _) in step_shapes.items())
        self._set_shapes(params, sig)
        if self.flat_mode is not None:
            self._ensure_flat_plan(params)
        key = (k, tuple((n, shape, str(dtype)) for n, (shape, dtype) in step_shapes.items()))
        if _tm.enabled():
            self._note_dispatch(("multi",) + tuple((n, (k,) + shape, dtype, str(dev))
                                                   for n, shape, dtype in key[1]),
                                {n: shape for n, (shape, _) in step_shapes.items()}, k)
        group = self._groups.get(key)
        if group is not None and not group.fits(params, aux, opt_state):
            group = None  # the state's layout changed: new buffers, a new graph
        if group is None:
            group = self._groups[key] = _StepGroup(
                k, params, aux, opt_state, step_shapes, max(1, len(self.param_names)), dev)
        else:
            _store(group.params, params)
            _store(group.aux, aux)
            _store(group.opt, opt_state)
        t_stage = time.perf_counter()
        if group.staged is not None:
            group.staged.synchronize()  # the last group's copies out of pinned memory
        self._stage(group, batches)
        group.lrs_host.copy_(torch.from_numpy(self._lr_rows(lrs, ts)))
        group.lrs.copy_(group.lrs_host, non_blocking=True)
        self.last_stage_seconds = time.perf_counter() - t_stage
        if dev.type == "cuda":
            group.staged = torch.cuda.Event()
            group.staged.record()
        rng = _random.generator(dev) if self._needs_rng else None
        group.stats["groups"] += 1
        with _tm.span("train_step.dispatch", k=k):
            if dev.type != "cuda":
                outs = [self._micro_step(group, i, rng, lrs[i], ts[i]) for i in range(k)]
            elif group.graph is None and not group.stats["warmup_groups"]:
                with DEVICE_PULL_LOCK:  # no checkpoint's host pull under sync debug mode
                    outs = self._warmup(group, lrs, ts, rng)
            else:
                if group.graph is None:
                    with DEVICE_PULL_LOCK:  # nor inside the capture
                        self._capture(group, lrs, ts, rng)
                group.graph.replay()
                group.stats["replays"] += 1
                outs = group.outs
        stacked = [torch.stack([o[j] for o in outs]) for j in range(len(outs[0]))]
        return dict(group.params), dict(group.aux), dict(group.opt), stacked

    def __call__(self, params, aux, opt_state, batch, rng=None, lr=None, t=1):
        """One step: ``params`` / ``aux`` / ``opt_state`` as made by
        :meth:`init` (or place_params / make_state), ``batch`` name ->
        tensor of the global batch. Returns (params, aux, opt_state,
        outputs); master and state slabs are updated in place."""
        self._set_shapes(params, tuple((n, tuple(v.shape)) for n, v in batch.items()))
        if lr is None:
            opt = self.optimizer
            if opt is not None and opt.lr_scheduler is not None:
                lr = float(opt.lr_scheduler(opt.num_update))
            else:
                lr = float(getattr(opt, "lr", 0.01))
        if rng is None and self._needs_rng:
            rng = _random.generator(self.device)
        batch = {n: v.to(self.device) for n, v in batch.items()}
        if _tm.enabled():
            self._note_dispatch(("single",) + tuple((n, tuple(v.shape), v.dtype, str(v.device))
                                                    for n, v in batch.items()),
                                {n: tuple(v.shape) for n, v in batch.items()}, 1)
        with _tm.span("train_step.dispatch", t=t):
            return self._step(params, aux, opt_state, batch, rng, lr, t)
