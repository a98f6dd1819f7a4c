"""SequentialModule of the PyTorch port (counterpart of
``mxnet_tpu/module/sequential_module.py``): a pipeline of modules run in
order. Forward threads each stage's outputs into the next stage's data,
backward threads the input gradients back, and each stage's meta
(``take_labels``, ``auto_wiring``) routes the labels and renames the
wired data at bind time.
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule

# reference-compatible meta key names
META_TAKE_LABELS = "take_labels"
META_AUTO_WIRING = "auto_wiring"
_KNOWN_META = (META_TAKE_LABELS, META_AUTO_WIRING)


class SequentialModule(BaseModule):
    META_TAKE_LABELS = META_TAKE_LABELS
    META_AUTO_WIRING = META_AUTO_WIRING

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []  # (module, meta dict)
        self._label_shapes = None

    # -- construction ---------------------------------------------------
    def add(self, module, **meta):
        for key in meta:
            if key not in _KNOWN_META:
                raise ValueError('Unknown meta "%s", a typo?' % key)
        self._stages.append((module, meta))
        # adding a stage invalidates any previous bind
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def _modules(self):  # introspection convenience (tests use it)
        return [m for m, _meta in self._stages]

    def _takes_labels(self, meta):
        return bool(meta.get(META_TAKE_LABELS))

    # -- introspection --------------------------------------------------
    @property
    def data_names(self):
        return self._stages[0][0].data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1][0].output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0][0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1][0].output_shapes

    # -- parameters -----------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for module, _meta in self._stages:
            a, x = module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        owners = {}
        for i, (module, _meta) in enumerate(self._stages):
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init)
            a, x = module.get_params()
            for name in list(a) + list(x):
                if name in owners:
                    raise ValueError(
                        'Duplicated parameter names: "%s" in layer %d (%s) '
                        "is already used in layer %d (%s)."
                        % (name, i, type(module), owners[name],
                           type(self._stages[owners[name]][0])))
                owners[name] = i
        self.params_initialized = True

    # -- binding --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._stages, "Attempting to bind an empty SequentialModule"
        self.binded = True

        feed = data_shapes
        label_used = False
        for i, (module, meta) in enumerate(self._stages):
            stage_labels = label_shapes if self._takes_labels(meta) else None
            label_used = label_used or stage_labels is not None
            if meta.get(META_AUTO_WIRING):
                names = module.data_names
                assert len(names) == len(feed)
                feed = [(new, shape)
                        for new, (_old, shape) in zip(names, feed)]
            module.bind(
                data_shapes=feed, label_shapes=stage_labels,
                for_training=for_training,
                # interior stages need input grads to keep backprop flowing
                inputs_need_grad=bool(inputs_need_grad
                                      or (for_training and i > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            feed = module.output_shapes
        self._label_shapes = label_shapes if label_used else None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module, _meta in self._stages:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # -- compute --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch

        batch = DataBatch(
            data=data_batch.data, label=data_batch.label,
            pad=data_batch.pad, index=data_batch.index,
            provide_data=data_batch.provide_data,
            provide_label=data_batch.provide_label)
        last = len(self._stages) - 1
        for i, (module, _meta) in enumerate(self._stages):
            module.forward(batch, is_train=is_train)
            if i == last:
                break
            # thread outputs into the next stage's data slots
            batch.data = module.get_outputs()
            names = [n for n, _s in module.output_shapes]
            assert len(names) == len(batch.data)
            batch.provide_data = [
                (n, x.shape) for n, x in zip(names, batch.data)]

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in range(len(self._stages) - 1, -1, -1):
            module = self._stages[i][0]
            module.backward(out_grads=out_grads)
            if i:
                out_grads = module.get_input_grads()

    def update(self):
        assert (self.binded and self.params_initialized
                and self.optimizer_initialized)
        for module, _meta in self._stages:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1][0].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert (self.binded and self.params_initialized
                and self.inputs_need_grad)
        return self._stages[0][0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for module, meta in self._stages:
            if self._takes_labels(meta):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module, _meta in self._stages:
            module.install_monitor(mon)
