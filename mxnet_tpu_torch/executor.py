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

``Executor`` binds a symbol on one device (``bind`` / ``simple_bind``):
``forward(is_train=True)`` runs the program with the gradient arguments
as fresh leaves and keeps the recorded graph; ``backward`` takes
``torch.autograd.grad`` of it and writes each gradient by grad_req
(write / add / null). The JAX package traces forward and backward into one
XLA program instead. Not ported: model-parallel placement over several
devices (``_PlacedProgram``, ``mxnet_tpu/executor.py:289``) and memory
mirroring (``_mirror_policy``, ``:132``); both raise.
"""
from __future__ import annotations

import itertools
import os

import torch

from . import ndarray as nd
from . import random as _random
from . import telemetry as _tm
from .base import MXNetError
from .context import as_context
from .ndarray import NDArray, _own
from .symbol import Symbol, _topo_order

__all__ = ["Executor"]

_M_PLAN_HITS = _tm.counter(
    "executor.dispatch_plan_hits",
    "Dispatches whose input signature the program has seen before")
_M_PLAN_MISSES = _tm.counter(
    "executor.dispatch_plan_misses",
    "Dispatch-plan cache misses: a new input signature (on the card, a "
    "new CUDA-graph capture)")


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
        self._program_uid = next(_GraphProgram._uid_counter)
        self._signatures = set()  # input signatures dispatched (note_signature)

    def note_signature(self, sig):
        """Count a dispatch of input signature ``sig`` (the JAX package's
        ``dispatch_plan`` accounting): a hit, or a miss reported to the
        anatomy recompile detector (the first per program is its warm-up,
        each later one a recompile)."""
        if sig in self._signatures:
            _M_PLAN_HITS.inc()
            return
        self._signatures.add(sig)
        _M_PLAN_MISSES.inc()
        _tm.anatomy.note_plan_miss(self._program_uid, sig)

    def _device(self, values, rng):
        for v in values:
            if torch.is_tensor(v):
                return v.device
        return rng.device if rng is not None else as_context(None).torch_device

    def __call__(self, arg_values, aux_values, rng, is_train):
        """arg_values / aux_values: dicts name -> tensor; ``rng`` a
        ``torch.Generator`` for the sampling operators (None when the graph
        has none). Returns (outputs list, new_aux dict)."""
        env = {}
        for values in (arg_values, aux_values):
            for name, v in values.items():
                node = self._var_nodes.get(name)
                if node is not None:
                    env[(id(node), 0)] = v
        device = None
        new_aux = {}
        for node in self.nodes:
            if node.is_variable:
                if (id(node), 0) not in env:
                    raise MXNetError("executor: missing input %s" % node.name)
                continue
            attrs = node.canon_attrs()
            if id(node) in self.shape_overrides:
                attrs["shape"] = self.shape_overrides[id(node)]
            if node.op.needs_rng:
                if rng is None:
                    raise MXNetError("executor: %s (%s) needs an rng" % (node.name, node.op.name))
                attrs["__rng__"] = rng
            if not node.inputs:
                if device is None:
                    device = self._device(list(arg_values.values()) + list(aux_values.values()),
                                          rng)
                attrs["__device__"] = device
            in_vals = [env[(id(c), i)] for (c, i) in node.inputs]
            results = node.op.fcompute(attrs, in_vals, is_train)
            n_outs = node.num_outputs()
            for i, v in enumerate(results[:n_outs]):
                env[(id(node), i)] = v
            # trailing results update this node's aux-state variables
            n_args = node._extra.get("n_args", len(node.inputs))
            for (c, _), v in zip(node.inputs[n_args:], results[n_outs:]):
                new_aux[c.name] = v
        outputs = [env[(id(n), i)] for (n, i) in self.output_entries]
        for name in self.aux_names:
            if name not in new_aux:
                new_aux[name] = aux_values[name]
        return outputs, new_aux


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


def _check_single_device(symbol, ctx, group2ctx):
    """Refuse what this port does not run: placement over several devices
    and memory mirroring."""
    if group2ctx:
        devices = {as_context(c) for c in group2ctx.values()} | {ctx}
        if len(devices) > 1:
            raise NotImplementedError(
                "executor: group2ctx over %d devices needs model-parallel placement, "
                "not ported to PyTorch yet (_PlacedProgram, mxnet_tpu/executor.py:289)"
                % len(devices))
    mirror = os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0").strip() not in ("", "0")
    forced = [n.name for n in _topo_order([n for n, _ in symbol._outputs])
              if n.attrs.get("__force_mirroring__") in ("True", "true", "1")]
    if mirror or forced:
        raise NotImplementedError(
            "executor: memory mirroring (%s) is not ported to PyTorch yet "
            "(_mirror_policy, mxnet_tpu/executor.py:132)"
            % ("MXNET_BACKWARD_DO_MIRROR" if mirror else "__force_mirroring__ on %s" % forced))


class Executor:
    """Bound computation: the arg / grad / aux NDArrays of a symbol on one
    device, with forward / backward.

    Parity: reference ``include/mxnet/executor.h`` —
    Forward/Backward/outputs/arg_dict/grad_dict/aux_dict/reshape/
    copy_params_from/set_monitor_callback.
    """

    def __init__(self, symbol, ctx, arg_arrays, grad_arrays, grad_req,
                 aux_arrays, group2ctx=None):
        self._symbol = symbol
        self._ctx = as_context(ctx)
        self._group2ctx = group2ctx or {}
        _check_single_device(symbol, self._ctx, self._group2ctx)
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
        if is_train and self._grad_names:
            leaves = {n: args[n].detach().requires_grad_(args[n].is_floating_point())
                      for n in self._grad_names}
            with torch.enable_grad():
                outs, new_aux = self._program({**args, **leaves}, aux, gen, True)
            self._graph = (leaves, outs)
        else:
            with torch.no_grad():
                outs, new_aux = self._program(args, aux, gen, bool(is_train))
            self._graph = None
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
            cts = [g._data if isinstance(g, NDArray) else torch.as_tensor(g, device=o.device)
                   for g, o in zip(out_grads, outs)]
        live = [(o, c.to(o.dtype)) for o, c in zip(outs, cts) if o.requires_grad]
        diff = [n for n in self._grad_names if leaves[n].requires_grad]
        grads = torch.autograd.grad([o for o, _ in live], [leaves[n] for n in diff],
                                    [c for _, c in live], allow_unused=True) if live else ()
        gmap = dict(zip(diff, grads))
        with torch.no_grad():
            for name, garr in zip(self._arg_names, self.grad_arrays):
                if garr is None or name not in self._grad_names:
                    continue
                g = gmap.get(name)
                req = self._grad_req.get(name, "write")
                if req == "add":
                    if g is not None:
                        garr._data.add_(g)
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
        whose shapes are unchanged (parity executor.py:360)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = []
        new_grads = []
        for name, arr, garr, shp in zip(
            self._arg_names, self.arg_arrays, self.grad_arrays, arg_shapes
        ):
            if name in kwargs or tuple(arr.shape) != tuple(shp):
                new_args.append(nd.zeros(shp, ctx=self._ctx, dtype=arr.dtype))
                new_grads.append(
                    None if garr is None else nd.zeros(shp, ctx=self._ctx, dtype=arr.dtype)
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
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Infer shapes and types, allocate zero arg / grad / aux arrays on
        ``ctx`` (sharing ``shared_exec``'s arrays of the same name and
        shape), bind. Parity: symbol.py:1114."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        ctx = as_context(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        arg_types, _, aux_types = symbol.infer_type(**(type_dict or {}))
        arg_names = symbol.list_arguments()
        shared = shared_exec.arg_dict if shared_exec is not None else {}
        arg_arrays = []
        for name, shape, dtype in zip(arg_names, arg_shapes, arg_types):
            if name in shared and tuple(shared[name].shape) == tuple(shape):
                arg_arrays.append(shared[name])
            else:
                arg_arrays.append(nd.zeros(shape, ctx=ctx, dtype=dtype))
        if isinstance(grad_req, str):
            req_of = lambda n: grad_req  # noqa: E731
        elif isinstance(grad_req, dict):
            req_of = lambda n: grad_req.get(n, "null")  # noqa: E731
        else:
            req_of = dict(zip(arg_names, grad_req)).get
        grad_arrays = [
            nd.zeros(shape, ctx=ctx, dtype=dtype) if req_of(name) not in (None, "null") else None
            for name, shape, dtype in zip(arg_names, arg_shapes, arg_types)
        ]
        shared_aux = shared_exec.aux_dict if shared_exec is not None else {}
        aux_arrays = []
        for name, shape, dtype in zip(symbol.list_auxiliary_states(), aux_shapes, aux_types):
            if name in shared_aux and tuple(shared_aux[name].shape) == tuple(shape):
                aux_arrays.append(shared_aux[name])
            else:
                aux_arrays.append(nd.zeros(shape, ctx=ctx, dtype=dtype))
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
