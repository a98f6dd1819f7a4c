"""PythonModule and PythonLossModule of the PyTorch port (counterpart of
``mxnet_tpu/module/python_module.py``): modules written in Python. The
parameter and optimizer surface is inert (a Python module owns no
learnable state unless a subclass adds it); bind records the input shapes
and asks the subclass for the output shapes. The loss module passes its
scores through and its backward is ``grad_func(scores, labels)``.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule


class PythonModule(BaseModule):
    """Base for computation written in python rather than symbols.

    The parameter-facing API (get/init params, update, optimizer,
    monitor) is intentionally inert — subclasses with state override
    what they need."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names)
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # shapes/names are plain recorded state
    data_names = property(lambda self: self._data_names)
    output_names = property(lambda self: self._output_names)
    data_shapes = property(lambda self: self._data_shapes)
    label_shapes = property(lambda self: self._label_shapes)
    output_shapes = property(lambda self: self._output_shapes)

    # -- stateless surface ----------------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        pass

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        pass

    def install_monitor(self, mon):
        pass

    # -- binding: record inputs, derive outputs -------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert grad_req == "write"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()


class PythonLossModule(PythonModule):
    """A loss head in python: forward passes scores through; backward
    produces d(loss)/d(scores) via ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        assert len(data_names) == 1 and len(label_names) == 1
        super().__init__(list(data_names), list(label_names),
                         [name + "_output"], logger=logger)
        self._name = name
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "For a loss module, out_grads should be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        """Subclass extension point (reference contract): compute
        self._scores_grad from self._scores/self._labels."""
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        self._scores_grad = (grad if isinstance(grad, nd.NDArray)
                             else nd.array(grad))

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
