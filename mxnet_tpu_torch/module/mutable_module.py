"""MutableModule of the PyTorch port (counterpart of
``mxnet_tpu/module/mutable_module.py``): a module whose input shapes may
change from batch to batch (the reference RCNN example's module). It
binds once on the merged maximum shapes (the given ones and
``max_data_shapes`` / ``max_label_shapes``); a batch of a new shape key
binds one more Module with ``shared_module`` set to that base module, so
parameters and optimizer state are shared, never copied.
"""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module


class MutableModule(BaseModule):
    def __init__(self, symbol, data_names, label_names, logger=logging,
                 context=None, work_load_list=None, max_data_shapes=None,
                 max_label_shapes=None, fixed_param_prefix=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names) if label_names else []
        self._context = context if context is not None else ctx_mod.current_context()
        self._work_load_list = work_load_list
        self._max_data_shapes = list(max_data_shapes or [])
        self._max_label_shapes = list(max_label_shapes or [])
        self._fixed_param_prefix = list(fixed_param_prefix or [])

        fixed = []
        for name in symbol.list_arguments():
            if any(name.startswith(p) for p in self._fixed_param_prefix):
                fixed.append(name)
        self._fixed_param_names = fixed
        self._base_module = None   # bound with the max shapes
        self._curr_module = None   # bound with the current batch's shapes
        self._shape_modules = {}   # (data shapes, label shapes) → Module

    # -- properties ----------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    # -- params --------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        return self._curr_module.get_params()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init)
        self.params_initialized = True

    # -- bind ----------------------------------------------------------
    @staticmethod
    def _shape_key(data_shapes, label_shapes):
        return (tuple(data_shapes), tuple(label_shapes or ()))

    def _merged_max_shapes(self, data_shapes, label_shapes):
        """Elementwise max of the provided shapes and the declared
        max_*_shapes (reference binds the base module on these)."""
        max_d = dict(self._max_data_shapes)
        max_l = dict(self._max_label_shapes)

        def merge(pairs, maxes):
            out = []
            for name, shape in pairs:
                m = maxes.get(name)
                if m is not None:
                    shape = tuple(max(a, b) for a, b in zip(shape, m))
                out.append((name, tuple(shape)))
            return out

        merged_d = merge(data_shapes, max_d)
        merged_l = merge(label_shapes, max_l) if label_shapes else None
        return merged_d, merged_l

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        # capture trained params BEFORE tearing anything down so a
        # force_rebind carries them into the new executors
        if self.params_initialized:
            arg_params, aux_params = self.get_params()
        else:
            arg_params, aux_params = (None, None)
        if force_rebind:
            self.binded = False
            self.optimizer_initialized = False
            self._base_module = None
            self._curr_module = None
            self._shape_modules = {}
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module is not supported for MutableModule"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        max_d, max_l = self._merged_max_shapes(data_shapes, label_shapes)
        module = Module(self._symbol, self._data_names, self._label_names,
                        logger=self.logger, context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names)
        module.bind(max_d, max_l, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._base_module = module
        self._curr_module = module
        self._shape_modules = {
            self._shape_key(max_d, max_l): module}
        if arg_params is not None:
            module.init_params(arg_params=arg_params, aux_params=aux_params,
                               allow_missing=False, force_init=True)
            self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        self.optimizer_initialized = True

    # -- compute -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        shape_changed = False
        current = dict(self._curr_module.data_shapes)
        for name, arr in zip(self._data_names, data_batch.data):
            if tuple(arr.shape) != current.get(name):
                shape_changed = True
        if self._label_names and data_batch.label:
            current_l = dict(self._curr_module.label_shapes or [])
            for name, arr in zip(self._label_names, data_batch.label):
                if tuple(arr.shape) != current_l.get(name):
                    shape_changed = True

        if shape_changed:
            d_shapes = [
                (name, tuple(arr.shape))
                for name, arr in zip(self._data_names, data_batch.data)
            ]
            l_shapes = None
            if self._label_names and data_batch.label:
                l_shapes = [
                    (name, tuple(arr.shape))
                    for name, arr in zip(self._label_names, data_batch.label)
                ]
            key = self._shape_key(d_shapes, l_shapes)
            module = self._shape_modules.get(key)
            if module is None:
                module = Module(self._symbol, self._data_names,
                                self._label_names, logger=self.logger,
                                context=self._context,
                                work_load_list=self._work_load_list,
                                fixed_param_names=self._fixed_param_names)
                module.bind(d_shapes, l_shapes,
                            self._curr_module.for_training,
                            self._curr_module.inputs_need_grad,
                            force_rebind=False,
                            shared_module=self._base_module)
                self._shape_modules[key] = module
            self._curr_module = module

        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._curr_module.install_monitor(mon)
