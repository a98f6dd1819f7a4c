"""Kvstore routing helpers and the checkpoint format of the PyTorch port
(counterpart of ``mxnet_tpu/model.py:34-141``): ``_create_kvstore``,
``_initialize_kvstore``, ``_update_params_on_kvstore``, ``_update_params``
(the update routing ``Module.init_optimizer`` / ``update`` rely on: a
``dist_*`` type keeps its store even on one device, and updates on it) and
``save_checkpoint`` / ``load_checkpoint`` (``prefix-symbol.json`` plus the
dmlc ``.params`` bytes, readable by either package, written atomically) and
the deprecated ``FeedForward`` trainer over ``Module`` (``model.py:142-288``
there)."""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import initializer as init
from . import io as mxio
from . import metric as metric_mod
from . import ndarray as nd
from . import symbol as sym
from . import telemetry as _tm
from .context import Context, current_context
from .kvstore import KVStore
from .ndarray import NDArray

BatchEndParam = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): one device and a non-dist type needs
    no store; ``local`` updates off the store when a parameter exceeds
    16 M elements."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            from .kvstore import create as kv_create

            kv = kv_create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape) for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names, update_on_kvstore):
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push every gradient, then pull every weight (the optimizer runs on
    the store)."""
    with _tm.span("model.update_params", path="kvstore"):
        for index, (_, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
            if grad_list[0] is None:
                continue
            kvstore.push(index, grad_list, priority=-index)
        for index, (arg_list, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
            if grad_list[0] is None:
                continue
            kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device, kvstore=None):
    """Local updater: reduce through the store when there is one, then
    update each device's copy with its own index."""
    with _tm.span("model.update_params", path="local"):
        for index, (arg_list, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
            if grad_list[0] is None:
                continue
            if kvstore:
                kvstore.push(index, grad_list, priority=-index)
                kvstore.pull(index, grad_list, priority=-index)
            for k, (w, g) in enumerate(zip(arg_list, grad_list)):
                updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` and ``prefix-%04d.params``, each through the
    atomic writer (temp + fsync + rename): a kill mid-save leaves the
    previous file, never a truncated one. In a job of several processes
    rank 0 writes them; the others return."""
    from .parallel.mesh import process_index
    from .resilience.checkpoint import atomic_file

    if process_index() != 0:
        return
    if symbol is not None:
        with atomic_file("%s-symbol.json" % prefix, mode="w") as f:
            f.write(symbol.tojson())
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    with atomic_file(param_name) as f:
        nd._save_fileobj(f, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint, arrays on the
    current context."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


class FeedForward:
    """The deprecated high-level trainer, a thin veneer over ``Module``:
    ``fit`` / ``predict`` / ``score`` on numpy arrays or a DataIter,
    ``save`` / ``load`` through the checkpoint format and ``create``.
    Keyword arguments it does not name are the optimizer's parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None, optimizer="sgd",
                 initializer=init.Uniform(0.01), numpy_batch_size=128, arg_params=None,
                 aux_params=None, allow_extra_params=False, begin_epoch=0, **kwargs):
        self.symbol = symbol
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _make_module(self, data):
        from .module import Module

        data_names = [d[0] for d in data.provide_data]
        label_names = [lab[0] for lab in data.provide_label] or ["softmax_label"]
        self._module = Module(self.symbol, data_names=data_names, label_names=label_names,
                              context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc", epoch_end_callback=None,
            batch_end_callback=None, kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None, eval_batch_end_callback=None):
        data = self._init_iter(X, y, is_train=True)
        mod = self._make_module(data)
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback, batch_end_callback=batch_end_callback,
                kvstore=kvstore, optimizer=self.optimizer, optimizer_params=dict(self.kwargs),
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=self.allow_extra_params,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch or 1, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()

    def _bound_for_inference(self, data, label_shapes):
        """The trained module, or a new one bound for inference with this
        model's params (or fresh ones from its initializer)."""
        if self._module is None or not self._module.binded:
            mod = self._make_module(data)
            mod.bind(data.provide_data, label_shapes, for_training=False)
            if self.arg_params is not None:
                mod.set_params(self.arg_params, self.aux_params or {}, allow_missing=False)
            else:
                mod.init_params(self.initializer)
        return self._module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output over ``X``, as one numpy array (padding rows
        dropped)."""
        data = self._init_iter(X, None, is_train=False)
        if reset:
            data.reset()
        mod = self._bound_for_inference(data, data.provide_label or None)
        outputs = []
        for nbatch, batch in enumerate(data):
            if num_batch is not None and nbatch == num_batch:
                break
            mod.forward(batch, is_train=False)
            out = mod.get_outputs()[0]
            outputs.append(out.asnumpy()[:out.shape[0] - (batch.pad or 0)])
        return np.concatenate(outputs)

    def score(self, X, eval_metric="acc", num_batch=None, batch_end_callback=None, reset=True):
        data = self._init_iter(X, None, is_train=False)
        if reset:
            data.reset()
        mod = self._bound_for_inference(data, data.provide_label)
        em = metric_mod.create(eval_metric)
        res = mod.score(data, em, num_batch=num_batch)
        return [v for _, v in res]

    def _init_iter(self, X, y, is_train):
        if isinstance(X, mxio.DataIter):
            return X
        if isinstance(X, (np.ndarray, NDArray)):
            if y is None:
                y = np.zeros(X.shape[0])
            return mxio.NDArrayIter(
                X if isinstance(X, np.ndarray) else X.asnumpy(),
                y if isinstance(y, np.ndarray) else y.asnumpy(),
                batch_size=self.numpy_batch_size, shuffle=is_train,
                last_batch_handle="roll_over" if is_train else "pad")
        raise TypeError("X must be DataIter or numpy/NDArray")

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params, aux_params=aux_params,
                           begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None, optimizer="sgd",
               initializer=init.Uniform(0.01), eval_data=None, eval_metric="acc",
               epoch_end_callback=None, batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None, eval_batch_end_callback=None,
               **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, epoch_size=epoch_size,
                            optimizer=optimizer, initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback, batch_end_callback=batch_end_callback,
                  kvstore=kvstore, logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
