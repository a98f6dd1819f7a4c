"""Executor manager of the PyTorch port (counterpart of
``mxnet_tpu/executor_manager.py``): the pre-Module data-parallel layer
that drives a symbol's executors over several contexts with sliced
batches, for scripts that drive executors directly. It delegates to
``module.executor_group.DataParallelExecutorGroup`` and re-exports its
batch helpers (``_split_input_slice``, ``_load_data``, ``_load_label``,
``_load_general``), as the JAX package does.
"""
from __future__ import annotations

import logging

from .base import MXNetError
from .module.executor_group import (  # noqa: F401  (re-exported)
    DataParallelExecutorGroup,
    _load_data,
    _load_general,
    _load_label,
    _split_input_slice,
)


class DataParallelExecutorManager:
    """Drive a symbol over several contexts with sliced batches (the
    reference's executor_manager.py:196, FeedForward's trainer)."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names, aux_names,
                 work_load_list=None, logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        self._symbol = symbol
        self._ctx = ctx
        self._arg_names = arg_names
        self._param_names = param_names
        self._aux_names = aux_names
        if work_load_list is None:
            work_load_list = [1] * len(ctx)
        if len(work_load_list) != len(ctx):
            raise MXNetError("Invalid settings for work load.")
        self._work_load_list = work_load_list
        self._data_shapes = [(name, tuple(shape)) for name, shape in train_data.provide_data]
        self._label_shapes = [(name, tuple(shape)) for name, shape in train_data.provide_label]
        self._exec_group = DataParallelExecutorGroup(
            symbol, ctx, work_load_list, self._data_shapes, self._label_shapes, param_names,
            for_training=True, inputs_need_grad=False, shared_group=None, logger=logger)
        self.slices = self._exec_group.slices
        self._curr_batch = None

    @property
    def param_arrays(self):
        return self._exec_group.param_arrays

    @property
    def grad_arrays(self):
        return self._exec_group.grad_arrays

    @property
    def aux_arrays(self):
        return self._exec_group.aux_arrays

    def install_monitor(self, monitor):
        """Install ``monitor`` (a :class:`~mxnet_tpu_torch.monitor.Monitor`)
        on every executor of the group."""
        self._exec_group.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self._exec_group.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """The current params (the mean of the devices' copies) into the
        given dicts."""
        self._exec_group.get_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self._curr_batch = data_batch

    def forward(self, is_train=False):
        self._exec_group.forward(self._curr_batch, is_train=is_train)

    def backward(self):
        self._exec_group.backward()

    def update_metric(self, metric, labels):
        self._exec_group.update_metric(metric, labels)
