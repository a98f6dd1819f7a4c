"""Graph evaluation and the bound Executor of the PyTorch port (counterpart
of ``mxnet_tpu/executor.py``).

``_GraphProgram`` runs a Symbol's nodes in topological order on torch
tensors: a function of (args, aux, rng, is_train) returning (outputs, new
aux). Autograd records the run, so ``torch.autograd.grad`` over the
outputs gives the gradients the JAX package takes with ``jax.vjp``.
Operators with auxiliary state (BatchNorm's moving stats) return the
updated aux values after their outputs, and the program collects them by
the aux variables' names. Sampling operators draw from the
``torch.Generator`` passed as ``rng``, in topological order.

``Executor`` binds a symbol (``bind`` / ``simple_bind``):
``forward(is_train=True)`` runs the program with the gradient arguments
as fresh leaves and keeps the recorded graph; ``backward`` takes
``torch.autograd.grad`` of it and writes each gradient by grad_req
(write / add / null). The JAX package traces forward and backward into one
XLA program instead.

Placement (``group2ctx``): nodes whose ``ctx_group`` maps to a context
other than the bind context make the executor run a ``_PlacedProgram``,
maximal contiguous runs of one context in topological order with an
explicit copy of each value that crosses into another device. One
autograd tape spans the devices: the backward of each boundary's
``Tensor.to`` carries the cotangent back, and each gradient lands on its
parameter's device. The JAX package instead runs a jitted backward per
segment that recomputes the segment's forward (``_PlacedProgram``,
``mxnet_tpu/executor.py:289``); the gradients are the same, but the port
keeps every segment's activations until the backward.
A context is logical: ``cpu(1)`` and ``cpu(2)`` are two segments on the
one host device.

Memory mirroring (``MXNET_BACKWARD_DO_MIRROR=1``, read when the executor
or trainer is built, or ``__force_mirroring__`` on a node): the graph
runs as a chain of regions, or that node as one, each under a
non-reentrant ``torch.utils.checkpoint`` with a selective policy
(``_mirror_ops``) that keeps the outputs of the operations
``MXNET_MIRROR_SAVE`` names (JAX's primitive names) and recomputes the
rest in backward. A region ends after the node that ran a kept op, so a
backward recomputes one region at a time: one region over the whole graph
would recompute every activation at the backward's first op and save
nothing at the peak. ``_mirrored`` also keeps the graph's random draws
equal in the recompute.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import os
import time

import torch
from torch.utils import checkpoint as _checkpoint

from . import ndarray as nd
from . import random as _random
from . import telemetry as _tm
from .base import MXNetError
from .context import as_context
from .ndarray import NDArray, _own
from .symbol import Symbol, _topo_order

__all__ = ["Executor"]

_H_STEP_SECONDS = _tm.histogram(
    "executor.step_seconds", "executor forward / backward host time (the "
    "call returns once the card's work is enqueued), by phase")
_M_PLAN_HITS = _tm.counter(
    "executor.dispatch_plan_hits",
    "Dispatches whose input signature the program has seen before")
_M_PLAN_MISSES = _tm.counter(
    "executor.dispatch_plan_misses",
    "Dispatch-plan cache misses: a new input signature (on the card, a "
    "new CUDA-graph capture)")


def _ctx_group(node):
    """A node's placement group: the in-memory attr name or the reference's
    serialized ``__ctx_group__`` spelling (``mxnet_tpu/executor.py:97``)."""
    return node.attrs.get("ctx_group") or node.attrs.get("__ctx_group__")


# ---------------------------------------------------------------------------
# memory mirroring (counterpart of ``mxnet_tpu/executor.py:103-154``)
# ---------------------------------------------------------------------------
def _mirror_enabled():
    """Whole-graph mirroring: the env flag only (reference
    MXNET_BACKWARD_DO_MIRROR), read when a backward is built."""
    return os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0").strip() not in ("", "0")


def _force_mirrored(node):
    return node.attrs.get("__force_mirroring__") in ("True", "true", "1")


_MIRROR_SAVE_DEFAULT = "dot_general,conv_general_dilated"
# MXNET_MIRROR_SAVE keeps the JAX package's primitive names, so one value
# means the same in both packages; each maps to the aten ops that compute
# it here (what the dispatcher shows under a checkpoint's policy). The
# kernels launched through ctypes (K4f, the K4 backward's split pass) are no
# dispatcher ops: a mirrored graph recomputes them, as JAX recomputes a
# ``pallas_call``, which is in no saved set.
_MIRROR_SAVE_OPS = {
    "dot_general": ("mm", "addmm", "bmm"),
    "conv_general_dilated": ("convolution",),
    "reduce_window_max": ("max_pool2d_with_indices",),
    "reduce_window_sum": ("avg_pool2d",),
    "concatenate": ("cat",),
}


@functools.lru_cache(maxsize=8)
def _mirror_save_set(names):
    ops = set()
    for name in (n.strip() for n in names.split(",")):
        if not name:
            continue
        if name not in _MIRROR_SAVE_OPS:
            raise MXNetError("MXNET_MIRROR_SAVE: %r is no operation the mirror can keep "
                             "(known: %s)" % (name, ", ".join(sorted(_MIRROR_SAVE_OPS))))
        ops.update(getattr(torch.ops.aten, op) for op in _MIRROR_SAVE_OPS[name])
    return frozenset(ops)


def _mirror_ops():
    """The aten op packets whose outputs the whole-graph mirror keeps, from
    ``MXNET_MIRROR_SAVE`` (default: the reference's need_mirror, which keeps
    Convolution and FullyConnected). Read per call, so a sweep can change it
    between steps."""
    return _mirror_save_set(os.environ.get("MXNET_MIRROR_SAVE", _MIRROR_SAVE_DEFAULT))


# the mirrored region running in this context: "forced" while a
# ``__force_mirroring__`` node of a whole-graph region runs (its ops are
# recomputed whatever they are), "kept" once the policy has kept an output
# (a whole-graph region ends after that node)
_REGION = contextvars.ContextVar("mxnet_tpu_torch_mirror_region", default=None)


def _policy(save_ops, save_draws):
    keep = _checkpoint.CheckpointPolicy.MUST_SAVE
    drop = _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE

    def policy(ctx, func, *args, **kwargs):
        if save_draws and torch.Tag.nondeterministic_seeded in func.tags:
            return keep
        region = _REGION.get()
        if func.overloadpacket not in save_ops or (region is not None and region["forced"]):
            return drop
        if region is not None:
            region["kept"] = True
        return keep

    return policy


def _capturing():
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _mirrored(fn, generators, save_ops):
    """``fn()`` under a non-reentrant ``torch.utils.checkpoint`` whose
    selective policy keeps the outputs of ``save_ops`` and recomputes the
    rest in backward. The sampling operators draw from explicit generators,
    which the checkpoint's ``preserve_rng_state`` does not stash: eagerly,
    each generator's state is taken before the region and put back for the
    recompute (and the state after it restored), so a recomputed mask is
    the forward's. Inside a CUDA graph capture a generator's state cannot
    be set back (the capture's draws advance the graph's own offset), so
    there the policy keeps the draws themselves instead."""
    capturing = _capturing()
    snaps = [] if capturing else [(g, g.get_state()) for g in generators]
    calls = [0]

    def region():
        calls[0] += 1
        token = _REGION.set({"forced": False, "kept": False})
        try:
            if calls[0] == 1 or not snaps:
                return fn()
            now = [g.get_state() for g, _ in snaps]
            for g, state in snaps:
                g.set_state(state)
            try:
                return fn()
            finally:
                for (g, _), state in zip(snaps, now):
                    g.set_state(state)
        finally:
            _REGION.reset(token)

    context_fn = functools.partial(_checkpoint.create_selective_checkpoint_contexts,
                                   _policy(save_ops, capturing))
    return _checkpoint.checkpoint(region, use_reentrant=False, preserve_rng_state=False,
                                  context_fn=context_fn)


@contextlib.contextmanager
def _forced_in_region(region):
    region["forced"] = True
    try:
        yield
    finally:
        region["forced"] = False


def _compute_node(node, attrs, in_vals, is_train):
    """One node's fcompute. A training node with ``__force_mirroring__``
    recomputes (only) itself in backward (``mxnet_tpu/executor.py:118``):
    its own mirrored region, or inside a whole-graph region its ops marked
    for recompute."""
    if not (is_train and torch.is_grad_enabled() and _force_mirrored(node)):
        return node.op.fcompute(attrs, in_vals, is_train)
    region = _REGION.get()
    if region is not None:
        with _forced_in_region(region):
            return node.op.fcompute(attrs, in_vals, is_train)
    gen = attrs.get("__rng__")
    return _mirrored(lambda: node.op.fcompute(attrs, in_vals, is_train),
                     [gen] if gen is not None else [], frozenset())


class _GraphProgram:
    """A symbol as a function of (args, aux, rng, is_train) on torch tensors."""

    _uid_counter = itertools.count()

    def __init__(self, symbol: Symbol, shape_overrides=None):
        self.symbol = symbol
        # id(node) -> resolved out shape, for creation ops whose attr shape
        # has unknown (0) dims
        self.shape_overrides = shape_overrides or {}
        self.nodes = _topo_order([n for n, _ in symbol._outputs])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_entries = list(symbol._outputs)
        self._var_nodes = {n.name: n for n in self.nodes if n.is_variable}
        self.needs_rng = any(not n.is_variable and n.op.needs_rng for n in self.nodes)
        self._creates = any(not n.is_variable and not n.inputs for n in self.nodes)
        # each node's parsed attrs and output count, once (JAX parses them
        # once a trace); a mirrored region's recompute reads them again
        ops = [n for n in self.nodes if not n.is_variable]
        self._attrs = {id(n): n.canon_attrs() for n in ops}
        self._n_outs = {id(n): n.num_outputs() for n in ops}
        self._program_uid = next(_GraphProgram._uid_counter)
        # (id(node), output) -> index in ``nodes`` of its last reader (past
        # the end for the graph's outputs): what a mirrored region returns
        self._last_use = {(id(c), j): i for i, n in enumerate(self.nodes) for c, j in n.inputs}
        self._last_use.update({(id(n), j): len(self.nodes) for n, j in self.output_entries})
        self.boundary_copies = 0  # values copied across devices by the last placed run
        self._signatures = set()  # input signatures dispatched (note_signature)

    def note_signature(self, sig, program_uid=None):
        """Count a dispatch of input signature ``sig`` (the JAX package's
        ``dispatch_plan`` accounting): a hit, or a miss reported to the
        anatomy recompile detector under ``program_uid`` (default this
        program's; the first per program is its warm-up, each later one a
        recompile)."""
        if sig in self._signatures:
            _M_PLAN_HITS.inc()
            return
        self._signatures.add(sig)
        _M_PLAN_MISSES.inc()
        _tm.anatomy.note_plan_miss(
            self._program_uid if program_uid is None else program_uid, sig)

    def _device(self, values, rng):
        for v in values:
            if torch.is_tensor(v):
                return v.device
        return rng.device if rng is not None else as_context(None).torch_device

    def __call__(self, arg_values, aux_values, rng, is_train, node_device=None, mirror=None):
        """arg_values / aux_values: dicts name -> tensor; ``rng`` a
        ``torch.Generator`` for the sampling operators (None when the graph
        has none). ``node_device`` (the placed program's): id(node) ->
        ``torch.device`` each node runs on; a value used on another device
        than its own is copied there (once a region). ``mirror``: None, or
        (generators, kept aten ops) to run the graph as mirrored regions,
        each ending after the node that ran a kept op, so that a backward
        recomputes one region at a time. Returns (outputs list, new_aux
        dict)."""
        env = {}
        for values in (arg_values, aux_values):
            for name, v in values.items():
                node = self._var_nodes.get(name)
                if node is not None:
                    env[(id(node), 0)] = v
        run = {"rng": rng, "is_train": is_train, "node_device": node_device, "device": None}
        if self._creates:  # the device of the creation ops with no placement
            run["device"] = self._device(list(arg_values.values()) + list(aux_values.values()),
                                         rng)
        if mirror is None:
            part = {"values": env, "new_aux": {}, "moved": {}}
            self._run_nodes(0, env, run, part)
            new_aux, copies = part["new_aux"], len(part["moved"])
        else:
            new_aux, copies = self._run_regions(env, run, *mirror)
        self.boundary_copies = copies
        outputs = [env[(id(n), i)] for (n, i) in self.output_entries]
        for name in self.aux_names:
            if name not in new_aux:
                new_aux[name] = aux_values[name]
        return outputs, new_aux

    def _run_regions(self, env, run, generators, save_ops):
        """The nodes as a chain of mirrored regions (``_mirrored``). A region
        runs from where the last one ended until a node runs an op whose
        output the policy keeps, and returns the values read after it: the
        kept outputs (and anything a later branch reads), which are the
        next regions' inputs and what the backward keeps. Returns (new_aux,
        boundary copies)."""
        new_aux, copies, start = {}, 0, 0
        while start < len(self.nodes):
            def region(start=start):
                part = {"values": {}, "new_aux": {}, "moved": {}}
                end = self._run_nodes(start, env, run, part, _REGION.get())
                live = {k: v for k, v in part["values"].items() if self._last_use.get(k, -1) >= end}
                return end, live, part["new_aux"], len(part["moved"])

            start, live, aux, moved = _mirrored(region, generators, save_ops)
            env.update(live)
            new_aux.update(aux)
            copies += moved
        return new_aux, copies

    def _run_nodes(self, start, env, run, part, region=None):
        """Nodes from index ``start`` on, reading ``env`` and
        ``part["values"]`` and writing into ``part``; inside a region, up to
        the node that ran a kept op. Returns the index after the last node
        run."""
        values, node_device = part["values"], run["node_device"]
        i = start
        while i < len(self.nodes):
            node = self.nodes[i]
            i += 1
            if node.is_variable:
                if (id(node), 0) not in env:
                    raise MXNetError("executor: missing input %s" % node.name)
                continue
            attrs = dict(self._attrs[id(node)])
            if id(node) in self.shape_overrides:
                attrs["shape"] = self.shape_overrides[id(node)]
            dev = node_device[id(node)] if node_device is not None else None
            if node.op.needs_rng:
                rng = run["rng"]
                if rng is None:
                    raise MXNetError("executor: %s (%s) needs an rng" % (node.name, node.op.name))
                attrs["__rng__"] = (rng if dev is None or rng.device == dev
                                    else _random.generator(dev))
            if not node.inputs:
                attrs["__device__"] = dev or run["device"]
            in_vals = []
            for key in node.inputs:
                key = (id(key[0]), key[1])
                v = values[key] if key in values else env[key]
                if dev is not None and v.device != dev:
                    # the _CrossDeviceCopy: autograd carries the cotangent back
                    if (key, dev) not in part["moved"]:
                        part["moved"][(key, dev)] = v.to(dev)
                    v = part["moved"][(key, dev)]
                in_vals.append(v)
            results = _compute_node(node, attrs, in_vals, run["is_train"])
            n_outs = self._n_outs[id(node)]
            for j, v in enumerate(results[:n_outs]):
                values[(id(node), j)] = v
            # trailing results update this node's aux-state variables
            n_args = node._extra.get("n_args", len(node.inputs))
            for (c, _), v in zip(node.inputs[n_args:], results[n_outs:]):
                part["new_aux"][c.name] = v
            if region is not None and region["kept"]:
                break
        return i


class _PlacedProgram:
    """Model-parallel execution of a ``_GraphProgram`` over contexts
    (counterpart of ``mxnet_tpu/executor.py:289-500``, the reference's
    PlaceDevice + ``_CrossDeviceCopy``): ``segments`` are the maximal
    contiguous runs of one context in topological order, as (Context,
    nodes); a value that a segment reads from another device is copied
    there once (``boundary_copies`` of the last run). One autograd tape
    spans them, so the backward needs no code here: cotangents cross the
    same boundaries in reverse, and only inputs on a path to a gradient
    variable get one. The executor path captures no CUDA graph, so no copy
    between the host and the card is ever captured."""

    def __init__(self, program, node_ctx):
        self.program = program
        segs = []
        for node in program.nodes:
            if node.is_variable:
                continue
            ctx = node_ctx[id(node)]
            if segs and segs[-1][0] == ctx:
                segs[-1][1].append(node)
            else:
                segs.append((ctx, [node]))
        self.segments = segs
        # resolves every context now: gpu(i) past the visible cards raises
        devices = {ctx: ctx.torch_device for ctx, _ in segs}
        self._node_device = {id(n): devices[ctx] for ctx, nodes in segs for n in nodes}
        self.devices = list(dict.fromkeys(devices.values()))
        self.boundary_copies = 0

    def __call__(self, arg_values, aux_values, rng, is_train, mirror=None):
        out = self.program(arg_values, aux_values, rng, is_train,
                           node_device=self._node_device, mirror=mirror)
        self.boundary_copies = self.program.boundary_copies
        return out


def resolve_creation_shapes(symbol, shapes_by_name):
    """For creation ops (_zeros/_ones) whose shape attr has unknown (0)
    dims, the concrete shapes from graph-wide inference given the input
    shapes: a ``_GraphProgram`` shape_overrides dict."""
    from .ops.utils import as_tuple

    nodes = _topo_order([n for n, _ in symbol._outputs])
    pending = [
        n for n in nodes
        if not n.is_variable and not n.inputs
        and 0 in (as_tuple(n.canon_attrs().get("shape")) or ())
    ]
    if not pending:
        return {}
    env = symbol._infer_shape_impl(False, **shapes_by_name)[3]
    return {id(n): env[(id(n), 0)] for n in pending if (id(n), 0) in env}


class Executor:
    """Bound computation: the arg / grad / aux NDArrays of a symbol, with
    forward / backward; placed over contexts by ``group2ctx``.

    Parity: reference ``include/mxnet/executor.h`` —
    Forward/Backward/outputs/arg_dict/grad_dict/aux_dict/reshape/
    copy_params_from/set_monitor_callback.
    """

    def __init__(self, symbol, ctx, arg_arrays, grad_arrays, grad_req,
                 aux_arrays, group2ctx=None):
        self._symbol = symbol
        self._ctx = as_context(ctx)
        self._group2ctx = {k: as_context(v) for k, v in (group2ctx or {}).items()}
        arg_names = symbol.list_arguments()
        shapes = {n: a.shape for n, a in zip(arg_names, arg_arrays) if a is not None}
        self._program = _GraphProgram(symbol, resolve_creation_shapes(symbol, shapes))
        self.arg_arrays = list(arg_arrays)
        self.grad_arrays = list(grad_arrays)
        self.aux_arrays = list(aux_arrays)
        self._arg_names = self._program.arg_names
        self._aux_names = self._program.aux_names
        self._output_names = symbol.list_outputs()
        self._monitor_callback = None
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = grad_req
        # names we differentiate wrt (grad buffer attached + req != null)
        self._grad_names = [
            n
            for n, g in zip(self._arg_names, self.grad_arrays)
            if g is not None and self._grad_req.get(n, "null") != "null"
        ]
        self._outputs_list = [None] * len(self._output_names)
        self._graph = None  # (leaves, outputs) recorded by forward(is_train=True)
        # the context each argument is allocated for (logical: cpu(1) and
        # cpu(2) are one host device, so an NDArray's own context reads cpu(0))
        var_ctx = Executor._var_contexts(symbol, self._group2ctx)
        self._arg_contexts = {n: var_ctx.get(n, self._ctx) for n in self._arg_names}
        self._placed = self._build_placed()
        self._mirror = _mirror_enabled()

    def _build_placed(self):
        """ctx_group placement (``mxnet_tpu/executor.py:575``): a
        ``_PlacedProgram`` when a node's group, or a variable's own, maps to
        a context other than the bind context; else None, and the bind
        context's program stays the fast path."""
        if not self._group2ctx:
            return None
        node_ctx, distinct = {}, False
        for node in self._program.nodes:
            grp = _ctx_group(node)
            ctx = self._group2ctx.get(grp, self._ctx) if grp else self._ctx
            distinct = distinct or ctx != self._ctx
            if not node.is_variable:
                node_ctx[id(node)] = ctx
        return _PlacedProgram(self._program, node_ctx) if distinct else None

    def _run(self, args, aux, gen, is_train):
        """The program (placed or not), run as mirrored regions for a
        recorded training run when MXNET_BACKWARD_DO_MIRROR was set at
        bind."""
        program = self._placed or self._program
        if not (self._mirror and is_train and torch.is_grad_enabled()):
            return program(args, aux, gen, is_train)
        gens = []
        if gen is not None:
            gens = [gen] + [_random.generator(d) for d in getattr(program, "devices", ())
                            if d != gen.device]
        return program(args, aux, gen, is_train, mirror=(gens, _mirror_ops()))

    # ------------------------------------------------------------------
    # forward / backward
    # ------------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Parity: Executor::Forward. ``kwargs`` are written into the
        matching argument arrays first. A training forward keeps the
        recorded graph for :meth:`backward` and writes the updated aux
        states (BatchNorm's moving stats) into the aux arrays."""
        arg_dict = self.arg_dict
        for k, v in kwargs.items():
            if k not in arg_dict:
                raise MXNetError("unknown input %s" % k)
            arg_dict[k][:] = v
        gen = _random.generator(self._ctx.torch_device) if self._program.needs_rng else None
        args = {n: a._data for n, a in zip(self._arg_names, self.arg_arrays)}
        aux = {n: a._data for n, a in zip(self._aux_names, self.aux_arrays)}
        with _tm.span("executor.forward", train=bool(is_train)):
            t0 = time.perf_counter()
            if is_train and self._grad_names:
                leaves = {n: args[n].detach().requires_grad_(args[n].is_floating_point())
                          for n in self._grad_names}
                with torch.enable_grad():
                    outs, new_aux = self._run({**args, **leaves}, aux, gen, True)
                self._graph = (leaves, outs)
            else:
                with torch.no_grad():
                    outs, new_aux = self._run(args, aux, gen, bool(is_train))
                self._graph = None
            _H_STEP_SECONDS.observe(time.perf_counter() - t0, phase="fwd")
        with torch.no_grad():
            self._set_outputs(outs, list(args.values()))
            if is_train:
                for name, a in zip(self._aux_names, self.aux_arrays):
                    a._write(new_aux[name])
        self._run_monitor()
        return self.outputs

    @property
    def outputs(self):
        return self._outputs_list

    def _set_outputs(self, outs, args):
        for i, v in enumerate(outs):
            v = _own(v.detach(), args)
            o = self._outputs_list[i]
            if o is None or o.shape != tuple(v.shape) or o._data.dtype != v.dtype:
                self._outputs_list[i] = NDArray(v)
            else:
                o._data.copy_(v)

    def backward(self, out_grads=None):
        """Gradients of the last training forward (one is run first if
        there was none) written into grad_arrays by grad_req: write, add or
        null (kWriteTo / kAddTo / kNullOp). ``out_grads`` are the head
        gradients, ones when omitted."""
        if not self._grad_names:
            return
        if self._graph is None:
            self.forward(is_train=True)
        leaves, outs = self._graph
        self._graph = None
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cts = [(g._data if isinstance(g, NDArray) else torch.as_tensor(g)).to(o.device)
                   for g, o in zip(out_grads, outs)]
        live = [(o, c.to(o.dtype)) for o, c in zip(outs, cts) if o.requires_grad]
        diff = [n for n in self._grad_names if leaves[n].requires_grad]
        with _tm.span("executor.fwdbwd"):
            t0 = time.perf_counter()
            grads = torch.autograd.grad([o for o, _ in live], [leaves[n] for n in diff],
                                        [c for _, c in live], allow_unused=True) if live else ()
            _H_STEP_SECONDS.observe(time.perf_counter() - t0, phase="bwd")
        gmap = dict(zip(diff, grads))
        with torch.no_grad():
            for name, garr in zip(self._arg_names, self.grad_arrays):
                if garr is None or name not in self._grad_names:
                    continue
                g = gmap.get(name)
                req = self._grad_req.get(name, "write")
                if req == "add":
                    if g is not None:
                        garr._data.add_(g.to(garr._data.device))
                elif g is None:
                    garr._data.zero_()
                else:
                    garr._write(g)
        self._run_monitor()

    # ------------------------------------------------------------------
    # dict views (parity executor.py:248-298)
    # ------------------------------------------------------------------
    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    def copy_params_from(self, arg_params, aux_params=None, allow_extra_params=False):
        arg_dict = self.arg_dict
        for name, array in arg_params.items():
            if name in arg_dict:
                array.copyto(arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" not in executor arguments" % name)
        if aux_params is not None:
            aux_dict = self.aux_dict
            for name, array in aux_params.items():
                if name in aux_dict:
                    array.copyto(aux_dict[name])
                elif not allow_extra_params:
                    raise MXNetError("Found name \"%s\" not in executor aux states" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new input shapes, sharing the parameter arrays
        whose shapes are unchanged (parity executor.py:360); it keeps
        ``group2ctx``, and a new array goes to its argument's context."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = []
        new_grads = []
        for name, arr, garr, shp in zip(
            self._arg_names, self.arg_arrays, self.grad_arrays, arg_shapes
        ):
            if name in kwargs or tuple(arr.shape) != tuple(shp):
                ctx = self._arg_contexts[name]
                new_args.append(nd.zeros(shp, ctx=ctx, dtype=arr.dtype))
                new_grads.append(
                    None if garr is None else nd.zeros(shp, ctx=ctx, dtype=arr.dtype)
                )
            else:
                new_args.append(arr)
                new_grads.append(garr)
        new_aux = []
        for arr, shp in zip(self.aux_arrays, aux_shapes):
            if tuple(arr.shape) != tuple(shp):
                new_aux.append(nd.zeros(shp, ctx=self._ctx, dtype=arr.dtype))
            else:
                new_aux.append(arr)
        return Executor(
            self._symbol, self._ctx, new_args, new_grads, self._grad_req,
            new_aux, self._group2ctx
        )

    def set_monitor_callback(self, callback):
        self._monitor_callback = callback

    def _run_monitor(self):
        if self._monitor_callback is None:
            return
        for name, out in zip(self._output_names, self.outputs):
            if out is not None:
                self._monitor_callback(name, out)

    def debug_str(self):
        return self._symbol.debug_str()

    # ------------------------------------------------------------------
    # binding entry points
    # ------------------------------------------------------------------
    @staticmethod
    def bind(symbol, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        ctx = as_context(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_arrays = _check_arguments(args, arg_names, "args")
        if args_grad is None:
            grad_arrays = [None] * len(arg_names)
        elif isinstance(args_grad, dict):
            grad_arrays = [args_grad.get(n) for n in arg_names]
        else:
            grad_arrays = list(args_grad)
            grad_arrays += [None] * (len(arg_names) - len(grad_arrays))
        if aux_states is None:
            aux_arrays = []
            if aux_names:
                _, _, aux_shapes = symbol.infer_shape(
                    **{n: a.shape for n, a in zip(arg_names, arg_arrays)}
                )
                aux_arrays = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
        elif isinstance(aux_states, dict):
            aux_arrays = [aux_states[n] for n in aux_names]
        else:
            aux_arrays = list(aux_states)
        return Executor(
            symbol, ctx, arg_arrays, grad_arrays, grad_req, aux_arrays, group2ctx
        )

    @staticmethod
    def _var_contexts(symbol, group2ctx):
        """name -> Context of the inputs (aux states included) with a
        ctx_group placement: a variable's own group wins, else its first
        consumer's (``mxnet_tpu/executor.py:948``, the reference's
        AssignContext)."""
        if not group2ctx:
            return {}
        out = {}
        nodes = _topo_order([n for n, _ in symbol._outputs])
        for n in nodes:
            if n.is_variable and _ctx_group(n) in group2ctx:
                out[n.name] = group2ctx[_ctx_group(n)]
        for n in nodes:
            grp = None if n.is_variable else _ctx_group(n)
            if grp not in group2ctx:
                continue
            for (c, _i) in n.inputs:
                if c.is_variable and c.name not in out:
                    out[c.name] = group2ctx[grp]
        return out

    @staticmethod
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Infer shapes and types, allocate zero arg / grad / aux arrays on
        ``ctx`` (sharing ``shared_exec``'s arrays of the same name and
        shape), bind. Parity: symbol.py:1114. With ``group2ctx`` an input,
        its gradient and an aux state go to its group's context (its own
        ctx_group, else its first consumer's)."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        ctx = as_context(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        arg_types, _, aux_types = symbol.infer_type(**(type_dict or {}))
        arg_names = symbol.list_arguments()
        var_ctx = Executor._var_contexts(
            symbol, {k: as_context(v) for k, v in (group2ctx or {}).items()})
        shared = shared_exec.arg_dict if shared_exec is not None else {}
        arg_arrays = []
        for name, shape, dtype in zip(arg_names, arg_shapes, arg_types):
            if name in shared and tuple(shared[name].shape) == tuple(shape):
                arg_arrays.append(shared[name])
            else:
                arg_arrays.append(nd.zeros(shape, ctx=var_ctx.get(name, ctx), dtype=dtype))
        if isinstance(grad_req, str):
            req_of = lambda n: grad_req  # noqa: E731
        elif isinstance(grad_req, dict):
            req_of = lambda n: grad_req.get(n, "null")  # noqa: E731
        else:
            req_of = dict(zip(arg_names, grad_req)).get
        grad_arrays = [
            nd.zeros(shape, ctx=var_ctx.get(name, ctx), dtype=dtype)
            if req_of(name) not in (None, "null") else None
            for name, shape, dtype in zip(arg_names, arg_shapes, arg_types)
        ]
        shared_aux = shared_exec.aux_dict if shared_exec is not None else {}
        aux_arrays = []
        for name, shape, dtype in zip(symbol.list_auxiliary_states(), aux_shapes, aux_types):
            if name in shared_aux and tuple(shared_aux[name].shape) == tuple(shape):
                aux_arrays.append(shared_aux[name])
            else:
                aux_arrays.append(nd.zeros(shape, ctx=var_ctx.get(name, ctx), dtype=dtype))
        return Executor(
            symbol, ctx, arg_arrays, grad_arrays, grad_req, aux_arrays, group2ctx
        )


def _check_arguments(args, names, kind):
    if isinstance(args, dict):
        out = []
        for n in names:
            if n not in args:
                raise MXNetError("missing %s: %s" % (kind, n))
            out.append(args[n])
        return out
    args = list(args)
    if len(args) != len(names):
        raise MXNetError(
            "%s length %d != expected %d (%s)" % (kind, len(args), len(names), names)
        )
    return args
