"""DataParallelExecutorGroup of the PyTorch port (counterpart of
``mxnet_tpu/module/executor_group.py``): one bound ``Executor`` per
context, each batch split across them by ``work_load_list``, gradients
combined through the KVStore by ``model._update_params*``. It serves
``Module``'s non-fused path (one context, or ``kvstore="local"``) and every
evaluation / prediction forward."""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import ndarray as nd
from ..executor import Executor


def _split_input_slice(batch_size, work_load_list):
    """The batch's per-device slices, proportional to the work load."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum != batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _load_general(data, targets):
    """Write a batch into the executors' input arrays, in place. On one
    device a batch of another size than the bound one (a smaller last
    batch of ``predict`` or ``score``) rebinds the input array to a copy
    of it instead, as the JAX package's ``copyto`` rebinds, so the
    executor runs on its rows."""
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, nd.NDArray):
            d_src.copyto(d_targets)
            continue
        if len(d_targets) == 1 and tuple(d_src.shape) != tuple(d_targets[0][1].shape):
            d_dst = d_targets[0][1]
            d_dst._data = d_src._data.to(device=d_dst._data.device, dtype=d_dst._data.dtype,
                                         copy=True)
            continue
        for slice_idx, d_dst in d_targets:
            if slice_idx.stop - slice_idx.start == d_src.shape[0]:
                d_src.copyto(d_dst)
            else:
                d_src[slice_idx].copyto(d_dst)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


def _merge_multi_context(outputs):
    """Per-device outputs concatenated along the batch on the first
    device."""
    def _gather(tensors):
        if len(tensors) == 1:
            return tensors[0]
        home = tensors[0].context
        return nd.concatenate([t.as_in_context(home) for t in tensors], axis=0)

    return [_gather(tensors) for tensors in outputs]


class DataParallelExecutorGroup:
    """Per-context executors sharing one symbol; see the module docstring."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes, param_names,
                 for_training, inputs_need_grad, shared_group=None, logger=logging,
                 fixed_param_names=None, grad_req="write"):
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.shared_group = shared_group

        data_names = [x[0] for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" if k in self.fixed_param_names else grad_req
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")

        self.execs = []
        self.data_arrays = self.label_arrays = None
        self.param_arrays = self.grad_arrays = self.aux_arrays = None
        self.batch_size = None
        self.slices = None
        self.data_shapes = self.label_shapes = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def decide_slices(self, data_shapes):
        assert len(data_shapes) > 0
        major_axis = [0] * len(data_shapes)
        for (name, shape), axis in zip(data_shapes, major_axis):
            batch_size = shape[axis]
            if self.batch_size is not None:
                assert batch_size == self.batch_size, "all data must have the same batch size"
            else:
                self.batch_size = batch_size
                self.slices = _split_input_slice(self.batch_size, self.workload)
        return major_axis

    def bind_exec(self, data_shapes, label_shapes, shared_group=None, reshape=False):
        self.batch_size = None
        self.data_layouts = self.decide_slices(data_shapes)
        if label_shapes is not None:
            self.label_layouts = self.decide_slices(label_shapes)
        self.execs = [self._bind_ith_exec(i, data_shapes, label_shapes, shared_group)
                      for i in range(len(self.contexts))]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self._output_shapes_cache = None
        self._collect_arrays()

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def _collect_arrays(self):
        self.data_arrays = [[(self.slices[i], e.arg_dict[name]) for i, e in enumerate(self.execs)]
                            for name, _ in self.data_shapes]
        if self.label_shapes is not None:
            self.label_arrays = [[(self.slices[i], e.arg_dict[name])
                                  for i, e in enumerate(self.execs)]
                                 for name, _ in self.label_shapes]
        else:
            self.label_arrays = None
        self.param_arrays = [[e.arg_arrays[i] for e in self.execs]
                             for i, name in enumerate(self.arg_names) if name in self.param_names]
        if self.for_training:
            self.grad_arrays = [[e.grad_arrays[i] for e in self.execs]
                                for i, name in enumerate(self.arg_names)
                                if name in self.param_names]
        else:
            self.grad_arrays = None
        data_names = [x[0] for x in self.data_shapes]
        if self.inputs_need_grad:
            self.input_grad_arrays = [[e.grad_arrays[self.arg_names.index(name)]
                                       for e in self.execs] for name in data_names]
        else:
            self.input_grad_arrays = None
        self.aux_arrays = [[e.aux_arrays[i] for e in self.execs]
                           for i in range(len(self.aux_names))]

    def _sliced_shape(self, shapes, i):
        return [(name, tuple([self.slices[i].stop - self.slices[i].start] + list(shape[1:])))
                for name, shape in shapes]

    def _bind_ith_exec(self, i, data_shapes, label_shapes, shared_group):
        data_shapes_i = self._sliced_shape(data_shapes, i)
        label_shapes_i = self._sliced_shape(label_shapes, i) if label_shapes is not None else []
        shared_exec = None if shared_group is None else shared_group.execs[i]
        input_shapes = dict(data_shapes_i)
        input_shapes.update(dict(label_shapes_i))
        return Executor.simple_bind(self.symbol, self.contexts[i], grad_req=self.grad_req,
                                    shared_exec=shared_exec, **input_shapes)

    def set_params(self, arg_params, aux_params):
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params, allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """The mean of the devices' copies, written into the host params."""
        for name, block in zip(self.param_names, self.param_arrays):
            weight = sum(w.copyto(ctx_mod.cpu()) for w in block) / len(block)
            weight.astype(arg_params[name].dtype).copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            weight = sum(w.copyto(ctx_mod.cpu()) for w in block) / len(block)
            weight.astype(aux_params[name].dtype).copyto(aux_params[name])

    def forward(self, data_batch, is_train=None):
        _load_general(data_batch.data, self.data_arrays)
        if is_train is None:
            is_train = self.for_training
        if self.label_arrays is not None and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)
        for exec_ in self.execs:
            exec_.forward(is_train=is_train)

    def get_output_shapes(self):
        if self._output_shapes_cache is None:
            exe0 = self.execs[0]
            input_shapes = {name: exe0.arg_dict[name].shape
                            for name, _ in self.data_shapes + (self.label_shapes or [])}
            _, out_shapes, _ = self.symbol.infer_shape(**input_shapes)
            self._output_shapes_cache = [
                (key, (self.batch_size,) + tuple(shape[1:]))
                for key, shape in zip(self.symbol.list_outputs(), out_shapes)]
        return self._output_shapes_cache

    def get_outputs(self, merge_multi_context=True):
        outputs = [[e.outputs[i] for e in self.execs] for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            outputs = _merge_multi_context(outputs)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays)
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        assert self.for_training, "re-bind with for_training=True to run backward"
        out_grads = out_grads or []
        for i, exec_ in enumerate(self.execs):
            slices = [g[self.slices[i]].as_in_context(self.contexts[i]) for g in out_grads]
            exec_.backward(out_grads=slices if slices else None)

    def update_metric(self, eval_metric, labels):
        for texec, islice in zip(self.execs, self.slices):
            eval_metric.update([label[islice] for label in labels], texec.outputs)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
