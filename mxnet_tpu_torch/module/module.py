"""Module of the PyTorch port (counterpart of ``mxnet_tpu/module/module.py``):
the trainer over one Symbol.

``bind`` makes a ``DataParallelExecutorGroup`` over the contexts;
``init_optimizer`` decides the kvstore routing as the reference does. With
``kvstore="device"`` (and a mesh, or several contexts, whose dp divides the
batch) training takes the fused path: one ``ShardedTrainStep`` over a
mesh of logical dp ranks on one device, with the flat bucketed update and,
under ``MXTPU_AMP=bf16``, bf16 compute over f32 masters and kernel K1.
Otherwise ``update`` pushes and pulls through the KVStore and the
Updater. Evaluation and prediction always run the executor group, whose
weights are refreshed from the fused state first. On the fused path
``update_multi`` runs K batches as one group of K steps
(``ShardedTrainStep.call_multi``: on the card one CUDA graph replay), as
``fit`` does under ``MXNET_FIT_MULTISTEP=K``.

On the card the fused entry point is
``Module(sym, context=mx.gpu(0), mesh=mx.parallel.make_mesh(dp=4,
devices=[mx.gpu(0)] * 4))``; ``context=[mx.cpu(i) for i in range(4)]``
builds the same mesh of four ranks on the host. ``context=None`` is the
current context, ``gpu(0)`` unless one is entered.
"""
from __future__ import annotations

import logging
import pickle

import torch

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from ..parallel.train_step import host_state
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None, fixed_param_names=None,
                 mesh=None, param_specs=None):
        """``mesh`` (from ``mx.parallel.make_mesh``) sets the data-parallel
        degree of the fused path; the contexts then host the evaluation
        executors. ``param_specs`` (tensor parallelism) is not ported."""
        super().__init__(logger=logger)
        if param_specs:
            raise NotImplementedError(
                "Module(param_specs=...) is not ported to PyTorch yet: tensor-parallel "
                "parameter sharding (mxnet_tpu/module/module.py:81)")
        if context is None:
            context = [ctx_mod.current_context()]
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = list(context)
        if mesh is not None and "dp" not in mesh.axis_names:
            raise MXNetError("Module mesh must have a 'dp' axis (the batch dimension shards "
                             "over it); got axes %s" % (mesh.axis_names,))
        self._mesh = mesh
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param", True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        # the fused path: trainer, the module owning its state, and that
        # state (params, aux, optimizer state); the pending batch and the
        # last step's outputs
        self._fused_trainer = None
        self._fused_owner = None
        self._fused_params = None
        self._fused_aux = None
        self._fused_opt = None
        self._fused_batch = None
        self._fused_outputs = None
        self._fused_t = 0
        self._fused_exec_stale = False
        self._guard_pending = []  # (t, diag) of guarded fused steps, for fit

    # -- checkpoints -------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint's symbol and params (arrays on the
        host); fit or init_optimizer then restores the optimizer state when
        ``load_optimizer_states``."""
        with ctx_mod.cpu():
            sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` (under AMP the f32
        masters) and optionally ``prefix-%04d.states``, each written
        atomically."""
        from ..resilience.checkpoint import atomic_file

        with atomic_file("%s-symbol.json" % prefix, mode="w") as f:
            f.write(self._symbol.tojson())
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    # -- binding -----------------------------------------------------------
    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused_trainer = None
        self._fused_owner = None
        self._fused_batch = None
        self._fused_outputs = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._exec_group.get_output_shapes()

    def get_params(self):
        """(arg_params, aux_params) on the host; under AMP the f32 masters."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Per-name initializer dispatch on host arrays, then copies into
        the executors."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        cache_arr.copyto(arr)
                else:
                    if not allow_missing:
                        raise RuntimeError("%s is not presented" % name)
                    if initializer is not None:
                        initializer(name, arr)
            elif initializer is not None:
                initializer(InitDesc(name, attrs=self._arg_attrs.get(name, {})), arr)

        self._arg_attrs = self._symbol.attr_dict()
        host = ctx_mod.cpu()
        if self._arg_params is None:
            self._arg_params = {
                n: nd.zeros(x[0].shape, ctx=host, dtype=x[0].dtype)
                for n, x in zip(self._param_names, self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                n: nd.zeros(x[0].shape, ctx=host, dtype=x[0].dtype)
                for n, x in zip(self._aux_names, self._exec_group.aux_arrays)}
        for name, arr in self._arg_params.items():
            _impl(name, arr, arg_params)
        for name, arr in self._aux_params.items():
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = [x if isinstance(x, tuple) else tuple(x) for x in data_shapes]
        if label_shapes is not None and len(label_shapes) > 0:
            self._label_shapes = [x if isinstance(x, tuple) else tuple(x) for x in label_shapes]
        else:
            self._label_shapes = None
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and shared_module.binded \
                and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, self._data_shapes,
            self._label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group, logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, carrying the current weights."""
        assert self.binded
        if data_shapes == self._data_shapes and label_shapes == self._label_shapes:
            return
        if self.params_initialized:
            self._sync_params_from_devices()
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """The kvstore routing of the reference; the fused path when
        :meth:`_fusable`."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        # an explicit mesh is the device set: even dp = 1 keeps its store
        if self._mesh is not None and isinstance(kvstore, str):
            from ..kvstore import create as kv_create

            kvstore = kv_create(kvstore)
        kvstore, update_on_kvstore = _create_kvstore(kvstore, len(self._context),
                                                     self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._exec_group.param_names))
            else:
                for k in range(len(self._context)):
                    idx2name.update({i * len(self._context) + k: n
                                     for i, n in enumerate(self._exec_group.param_names)})
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol, param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore, param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params, param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        if self._fusable(kvstore):
            self._init_fused()
        elif self._mesh is not None:
            raise MXNetError(
                "Module was given a mesh but training cannot take the fused path: requires "
                "kvstore 'device' (got %r), for_training, no inputs_need_grad, no "
                "fixed_param_names, and batch_size %% dp == 0"
                % (getattr(kvstore, "type", kvstore),))
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _fusable(self, kvstore):
        """kvstore 'device' routes training through the fused step."""
        dp = self._mesh.shape.get("dp", 1) if self._mesh is not None else len(self._context)
        return (kvstore is not None and "device" in kvstore.type and self.for_training
                and not self.inputs_need_grad and not self._fixed_param_names
                and self._exec_group.batch_size % dp == 0)

    def _init_fused(self):
        from ..parallel.mesh import make_mesh
        from ..parallel.train_step import ShardedTrainStep

        mesh = self._mesh or make_mesh(dp=len(self._context), devices=self._context)
        self._fused_trainer = ShardedTrainStep(
            self._symbol, mesh, optimizer=self._optimizer, data_names=self._data_names,
            label_names=self._label_names).compile()
        self._fused_owner = self
        trainer = self._fused_trainer
        self._fused_params, self._fused_aux = trainer.place_params(self._arg_params,
                                                                   self._aux_params)
        self._fused_opt = trainer.make_state(self._fused_params)
        if trainer.amp:
            # make_state took the f32 params as the masters; the step runs
            # on their bf16 working copies (== bf16(masters) after each step)
            self._fused_params = trainer.amp_cast_params(self._fused_params)
        self._fused_t = 0
        self._fused_exec_stale = False

    def _fused_inputs(self, data_batch):
        """name -> tensor of one batch's data and labels as they are."""
        pairs = list(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            pairs += list(zip(self._label_names, data_batch.label))
        return {name: arr._data for name, arr in pairs}

    def _check_staged(self, data_batch):
        """A batch a DeviceFeedIter staged must already be on the trainer's
        device: its tensors are taken without a copy."""
        device = self._fused_trainer.device
        staged = getattr(data_batch, "staged_device", None)
        if staged is None:
            return False
        for name, t in self._fused_inputs(data_batch).items():
            if t.device != device:
                raise MXNetError("input %s was staged on %s but the fused trainer runs on %s"
                                 % (name, t.device, device))
        return True

    def _make_fused_batch(self, data_batch):
        """The step's inputs on the trainer's device: a staged batch as it
        is, any other copied there."""
        batch = self._fused_inputs(data_batch)
        if self._check_staged(data_batch):
            return batch
        device = self._fused_trainer.device
        return {name: t.to(device) for name, t in batch.items()}

    def _ensure_exec_params(self):
        """Refresh the executors' weights after fused updates."""
        if self._fused_trainer is not None and self._fused_exec_stale:
            self._sync_params_from_devices()
            self._exec_group.set_params(self._arg_params, self._aux_params)
            self._fused_exec_stale = False

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer; on the fused path join its
        state. A borrower updates a subset of the owner's parameters, which
        flat slabs cannot express, so the owner demotes to the
        per-parameter update first (under AMP, its masters become its f32
        params)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        if shared_module._fused_trainer is not None:
            from ..parallel.train_step import ShardedTrainStep

            owner = shared_module._fused_owner or shared_module
            self._fused_owner = owner
            trainer = owner._fused_trainer
            if trainer.flat_mode is not None:
                if trainer.amp:
                    owner._fused_params = trainer.master_params_placed(owner._fused_opt)
                owner._fused_opt = trainer.disable_flat_update(owner._fused_opt)
            self._fused_trainer = ShardedTrainStep(
                self._symbol, trainer.mesh, optimizer=self._optimizer,
                data_names=self._data_names, label_names=self._label_names,
                flat_update=False).compile()
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._fused_trainer is not None and (is_train is None or is_train) \
                and self.for_training:
            self._fused_batch = data_batch  # the fused step runs at update()
            self._fused_outputs = None
            return
        self._fused_outputs = None
        self._fused_batch = None
        self._ensure_exec_params()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._fused_trainer is not None and self._fused_batch is not None:
            assert out_grads is None, "fused path computes gradients in update()"
            return
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._params_dirty = True
        if self._fused_trainer is not None:
            assert self._fused_batch is not None, "forward() before update()"
            owner = self._fused_owner
            lr, t = self._next_step_schedule()
            self._bind_owner_state()
            p, a, s, outs = self._fused_trainer(
                owner._fused_params, owner._fused_aux, owner._fused_opt,
                self._make_fused_batch(self._fused_batch), lr=lr, t=t)
            owner._fused_params, owner._fused_aux, owner._fused_opt = p, a, s
            outs = list(outs)
            if self._fused_trainer.guard:
                # the last head is the guard's diag (loss, gn2, gate_ok): queued
                # for fit's monitor, kept out of the outputs and the metric
                owner._guard_pending.append((t, outs.pop()))
            self._fused_outputs = [nd.NDArray(o) for o in outs]
            self._fused_batch = None
            owner._fused_exec_stale = True
            self._fused_exec_stale = True
            return
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays, self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays, self._exec_group.grad_arrays,
                           updater=self._updater, num_device=len(self._context),
                           kvstore=self._kvstore)

    def _next_step_schedule(self):
        """Advance the fused update count and ``num_update`` by one step;
        returns the step's (scheduled lr for every parameter, at the
        post-increment count, and update count)."""
        owner = self._fused_owner
        optm = self._optimizer
        owner._fused_t += 1
        optm.num_update = max(owner._fused_t, optm.num_update)
        lr = optm.lr_scheduler(optm.num_update) if optm.lr_scheduler is not None else optm.lr
        return lr, owner._fused_t

    def _bind_owner_state(self):
        """A module borrowing the owner's fused trainer reads the owner's
        state from its first step on."""
        owner = self._fused_owner
        if self is not owner and self._fused_params is None:
            self._fused_params = owner._fused_params
            self._fused_aux = owner._fused_aux
            self._fused_opt = owner._fused_opt

    def update_multi(self, data_batches):
        """len(data_batches) fused training steps as one group
        (``ShardedTrainStep.call_multi``; on the card one replay of a CUDA
        graph of K steps). The per-step arithmetic, the lr schedule,
        ``num_update`` and the update count advance as K ``update()`` calls
        would. Returns K lists of that step's outputs (copies, not graph
        memory); the last step's stay readable through ``get_outputs``.
        Needs the fused path and batches of one shape."""
        assert self._fused_trainer is not None, "fused path required"
        assert self._fused_batch is None, "pending forward(); use update() for it first"
        owner = self._fused_owner
        k = len(data_batches)
        self._params_dirty = True
        for b in data_batches:
            self._check_staged(b)  # staged micro-batches go device to device
        batches = {name: [b.data[i]._data for b in data_batches]
                   for i, name in enumerate(self._data_names)}
        if self._label_names and data_batches[0].label:
            batches.update({name: [b.label[i]._data for b in data_batches]
                            for i, name in enumerate(self._label_names)})
        # advance the schedule exactly as K update() calls would
        lrs, ts = zip(*[self._next_step_schedule() for _ in range(k)])
        self._bind_owner_state()
        p, a, s, outs = self._fused_trainer.call_multi(
            owner._fused_params, owner._fused_aux, owner._fused_opt, batches, lrs, ts)
        owner._fused_params, owner._fused_aux, owner._fused_opt = p, a, s
        owner._fused_exec_stale = True
        self._fused_exec_stale = True
        steps = [[o[i] for o in outs] for i in range(k)]
        if self._fused_trainer.guard:
            for i in range(k):
                owner._guard_pending.append((ts[i], steps[i].pop()))
        self._install_step_outputs(steps[-1])
        return steps

    def _drain_guard_diag(self):
        """The queued (t, diag) samples of guarded steps, diag a numpy
        (loss, grad-norm², gate_ok) row, and clears the queue: one host
        transfer for all of them."""
        owner = self._fused_owner or self
        pending = owner._guard_pending
        if not pending:
            return []
        rows = torch.stack([d.detach().float() for _, d in pending]).cpu().numpy()
        out = [(int(t), row) for (t, _), row in zip(pending, rows)]
        pending.clear()
        return out

    def _install_step_outputs(self, outs_raw):
        """Publish one micro-step's outputs as the current fused outputs
        (``fit``'s group flush does so step by step, so that
        ``update_metric`` and ``get_outputs`` serve that step's results)."""
        self._fused_outputs = [nd.NDArray(o) for o in outs_raw]

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused_trainer is not None:
            if self._fused_outputs is not None:
                return self._fused_outputs
            if self._fused_batch is not None:
                # forward() was deferred and update() has not run: serve the
                # outputs through the executors
                self._ensure_exec_params()
                self._exec_group.forward(self._fused_batch, True)
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused_trainer is not None and self._fused_outputs is not None:
            eval_metric.update(labels, self._fused_outputs)
            return
        self._exec_group.update_metric(eval_metric, labels)

    def _metric_snapshot(self):
        """The fused path's outputs of the last step (fresh tensors each
        step, so holding them keeps them valid while later steps run), for
        an update of the metric later; None on the executor path, whose
        output arrays are reused."""
        if self._fused_trainer is not None and self._fused_outputs is not None:
            return list(self._fused_outputs)
        return None

    def _apply_metric_snapshot(self, eval_metric, labels, snapshot):
        """The metric update of one deferred step (its host read happens
        here)."""
        eval_metric.update(labels, snapshot)

    def _sync_params_from_devices(self):
        if self._fused_trainer is not None:
            owner = self._fused_owner
            trainer = owner._fused_trainer
            params_src = dict(owner._fused_params)
            if trainer.amp:
                # the working copies are bf16 casts; the masters are the truth
                params_src.update(trainer.master_params_named(owner._fused_opt))
            for name, arr in params_src.items():
                if name in self._arg_params:
                    self._arg_params[name][:] = arr
            for name, arr in owner._fused_aux.items():
                if name in self._aux_params:
                    self._aux_params[name][:] = arr
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # -- training state for checkpoints -----------------------------------
    def _topology(self):
        """The topology this module trains at, recorded in checkpoint
        manifests: dp degree, mesh shape and batch geometry (informational;
        the state itself is layout-independent)."""
        if not self.binded:
            return None
        global_batch = self._exec_group.batch_size
        mesh_shape = None
        if self._fused_trainer is not None:
            mesh = self._fused_owner._fused_trainer.mesh
            mesh_shape = {k: int(v) for k, v in mesh.shape.items()}
            dp = mesh_shape.get("dp", 1)
        else:
            dp = len(self._context)
        dp = max(1, int(dp))
        return {"dp": dp, "mesh": mesh_shape, "global_batch": int(global_batch),
                "per_replica_batch": int(global_batch) // dp}

    def _capture_train_state(self):
        """A consistent snapshot of params and optimizer state for the
        checkpointer (``resilience/checkpoint.py``).

        Fused path: device-to-device clones, queued on the stream before
        the next step (or graph replay), which overwrites the state in
        place; the checkpoint writer thread pulls them to the host. Under
        AMP the f32 masters are the ``arg`` payload and the loss scaler is
        ``opt["amp"]``; flat slabs are carved back to per-parameter trees,
        so the snapshot's layout never depends on ``MXTPU_SHARD_UPDATE`` or
        ``MXTPU_BUCKET_BYTES``. Executor path: host copies and the
        updater's pickled states."""
        from ..parallel.train_step import _map_state

        assert self.binded and self.params_initialized
        if self._fused_trainer is not None:
            def _clone(tree):
                return {k: _map_state(lambda x: x.detach().clone(), v)
                        for k, v in tree.items()}

            owner = self._fused_owner
            trainer = owner._fused_trainer
            opt_state = _clone(owner._fused_opt)  # whole slabs, then views of the clones
            arg_src = _clone(owner._fused_params)
            amp_blob = None
            if trainer.flat_mode is not None:
                if trainer.amp:
                    arg_src = trainer.master_params_named(opt_state)
                    amp_blob = {"scale": opt_state[trainer.AMP_SCALE_KEY],
                                "good": opt_state[trainer.AMP_GOOD_KEY]}
                opt_state = trainer.flat_state_to_named(opt_state)
            out = {"arg": arg_src, "aux": _clone(owner._fused_aux),
                   "opt": {"kind": "fused", "t": owner._fused_t, "state": opt_state}}
            if amp_blob is not None:
                out["opt"]["amp"] = amp_blob
            return out
        arg, aux = self.get_params()
        state = {"arg": {k: v.asnumpy().copy() for k, v in arg.items()},
                 "aux": {k: v.asnumpy().copy() for k, v in aux.items()},
                 "opt": {"kind": "none"}}
        if not self.optimizer_initialized:
            return state
        updater = self._kvstore._updater if self._update_on_kvstore else self._updater
        if updater is not None:
            state["opt"] = {"kind": "updater", "bytes": updater.get_states()}
        return state

    def _restore_train_state(self, blob):
        """Inverse of :meth:`_capture_train_state` over a host blob (numpy
        trees from ``load_state``): params onto the devices, the optimizer
        state re-placed, the executors marked stale. A blob written by the
        JAX package's executor path (its updater pickles ``mxnet_tpu``
        NDArrays) raises ``CheckpointError`` naming the class."""
        from ..resilience.checkpoint import restricted_loads

        assert self.binded and self.params_initialized
        host = ctx_mod.cpu()
        arg = {k: nd.array(v, ctx=host) for k, v in (blob.get("arg") or {}).items()}
        aux = {k: nd.array(v, ctx=host) for k, v in (blob.get("aux") or {}).items()}
        self.set_params(arg, aux)
        if self._fused_trainer is not None:
            owner = self._fused_owner
            trainer = owner._fused_trainer
            owner._fused_params, owner._fused_aux = trainer.place_params(self._arg_params,
                                                                         self._aux_params)
            if trainer.amp:
                # the blob's arg is the f32 truth; the working params are its
                # bf16 cast, the masters are rebuilt below
                owner._fused_params = trainer.amp_cast_params(owner._fused_params)
            if self is not owner:
                self._fused_params = owner._fused_params
                self._fused_aux = owner._fused_aux
            owner._fused_exec_stale = True
            self._fused_exec_stale = True
            owner._guard_pending.clear()
        opt_blob = blob.get("opt") or {"kind": "none"}
        kind = opt_blob.get("kind", "none")
        if kind == "fused":
            if self._fused_trainer is None:
                raise MXNetError(
                    "checkpoint carries fused optimizer state but this module trains on the "
                    "executor path: rebind with a device kvstore (or retrain) to resume it")
            self._place_fused_opt_state(opt_blob["t"], opt_blob["state"],
                                        amp_blob=opt_blob.get("amp"), sync_masters=False)
        elif kind == "updater":
            if self._fused_trainer is not None:
                raise MXNetError(
                    "checkpoint carries executor-path optimizer state but this module trains "
                    "on the fused path: resume with the kvstore type it was saved under")
            updater = self._kvstore._updater if self._update_on_kvstore else self._updater
            if updater is None:
                raise MXNetError("checkpoint carries optimizer state but no updater is "
                                 "initialized: call init_optimizer before restoring")
            updater.states = restricted_loads(opt_blob["bytes"], "optimizer.state")
        elif self._fused_trainer is not None:
            owner = self._fused_owner
            trainer = owner._fused_trainer
            if trainer.amp:
                # a params-only blob: the masters are the weights' truth, so
                # rebuild them from the restored params (scaler fresh)
                state = dict(owner._fused_opt)
                state.update(trainer.build_amp_master_state(self._arg_params))
                owner._fused_opt = state
                if self is not owner:
                    self._fused_opt = owner._fused_opt

    # -- optimizer state files ---------------------------------------------
    def _fused_opt_host_state(self):
        """{"t", "state": name -> numpy trees (per parameter, whatever the
        bucketing), "amp" (the scaler, under AMP)}: the JAX package's
        payload."""
        owner = self._fused_owner
        state = dict(owner._fused_opt)
        trainer = owner._fused_trainer
        out = {"t": owner._fused_t}
        if trainer.flat_mode is not None:
            if trainer.amp:
                out["amp"] = trainer.amp_state_blob(state)
            state = trainer.flat_state_to_named(state)
        out["state"] = {k: host_state(v) for k, v in state.items()
                        if not k.startswith("__")}
        return out

    def _place_fused_opt_state(self, t, state_tree, amp_blob=None, sync_masters=True):
        """A host optimizer-state tree back into the fused trainer's layout;
        under AMP the masters are rebuilt from ``self._arg_params`` (synced
        first from the current device masters when ``sync_masters``; a
        checkpoint resume has just restored them from its f32 ``arg``) and
        the scaler from ``amp_blob`` (fresh when None)."""
        from ..parallel.train_step import _map_state, _tensor

        owner = self._fused_owner
        trainer = owner._fused_trainer
        owner._fused_t = int(t)
        if trainer.flat_mode is not None:
            if trainer.amp and sync_masters:
                self._sync_params_from_devices()
            owner._fused_opt = trainer.named_state_to_flat(state_tree)
            if trainer.amp:
                blob = amp_blob or {}
                owner._fused_opt.update(trainer.build_amp_master_state(
                    self._arg_params, scale=blob.get("scale"), good=blob.get("good", 0.0)))
        else:
            owner._fused_opt = {k: _map_state(lambda s: _tensor(s, trainer.device), v)
                                for k, v in state_tree.items()}
        if self is not owner:
            self._fused_t = owner._fused_t
            self._fused_opt = owner._fused_opt

    def save_optimizer_states(self, fname):
        """The optimizer state file, written atomically."""
        from ..resilience.checkpoint import atomic_file

        assert self.optimizer_initialized
        if self._fused_trainer is not None:
            with atomic_file(fname) as fout:
                pickle.dump(self._fused_opt_host_state(), fout)
            return
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with atomic_file(fname) as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._fused_trainer is not None:
            with open(fname, "rb") as fin:
                blob = pickle.load(fin)
            self._place_fused_opt_state(blob["t"], blob["state"], amp_blob=blob.get("amp"))
            return
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as fin:
                self._updater.set_states(fin.read())
