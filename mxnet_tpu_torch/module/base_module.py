"""BaseModule of the PyTorch port (counterpart of
``mxnet_tpu/module/base_module.py``): the ``fit`` loop, ``score`` /
``predict`` / ``iter_predict``, ``forward_backward`` and the parameter
file codec.

``fit`` runs the JAX package's loop in its order: bind, init_params,
init_optimizer, then per epoch reset the metric, per batch forward /
backward / update / update_metric and the batch callbacks, then the epoch
callbacks with the synced params and the validation score, then reset the
data. Not ported yet, and raising when asked for: ``checkpoint_dir`` /
``resume`` (``mxnet_tpu/resilience/checkpoint.py``), ``guardrails``
(``mxnet_tpu/resilience/guardrail.py``) and ``monitor``
(``mxnet_tpu/monitor.py``).

``MXNET_FIT_MULTISTEP=K`` (K > 1) on the fused path groups K batches into
one ``Module.update_multi`` (on the card one replay of a CUDA graph of K
steps), which gives the bits of K single steps; the metric and
``batch_end_callback`` still see every batch, with its own ``nbatch`` and
the normal ``locals`` keys, after its group. A trailing partial group, or a
batch whose shape breaks the group, takes the single-step path. Without a
fused trainer the knob changes nothing. ``MXNET_FIT_MULTISTEP=auto`` (the
JAX package's tuner, steered by telemetry the port does not record)
raises. ``MXTPU_DEVICE_FEED`` and ``MXTPU_METRIC_INTERVAL`` change no
result in the JAX package and are not read.
"""
from __future__ import annotations

import logging
import os
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..initializer import Uniform
from ..io import DataDesc  # noqa: F401  (re-exported for subclasses)
from ..model import BatchEndParam


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, epoch, nbatch, eval_metric, local_vars):
    """Invoke batch/epoch callbacks with the reference's BatchEndParam."""
    if callbacks is None:
        return
    params = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                           locals=local_vars)
    for cb in _as_list(callbacks):
        cb(params)


def _fit_multistep():
    """K of ``MXNET_FIT_MULTISTEP`` (1 when unset or not a number)."""
    raw = os.environ.get("MXNET_FIT_MULTISTEP", "1").strip()
    if raw.lower() == "auto":
        raise NotImplementedError(
            "MXNET_FIT_MULTISTEP=auto is not ported to PyTorch yet: its tuner "
            "(mxnet_tpu/module/base_module.py:95) steers by telemetry the port does not "
            "record (ROADMAP.md, Queue 1 step 10); set a number")
    try:
        return int(raw)
    except ValueError:
        return 1


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in [n for n in names if n not in args]:
        candidates = [a for a in args if not a.endswith(("_weight", "_bias", "_gamma", "_beta"))]
        msg = ("You created Module with Module(..., %s_names=%s) but input with name '%s' is "
               "not found in symbol.list_arguments(). Did you mean one of:\n\t%s"
               % (typename, str(names), name, "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- inference ---------------------------------------------------------
    def _infer_batches(self, eval_data, num_batch, reset, want_outputs=True):
        """Yield (nbatch, batch, unpadded outputs) over an eval iterator."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                return
            self.forward(batch, is_train=False)
            outs = None
            if want_outputs:
                pad = batch.pad or 0
                outs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield nbatch, batch, outs

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0):
        """Run inference over eval_data, accumulating eval_metric."""
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        n_seen = 0
        for nbatch, batch, _outs in self._infer_batches(eval_data, num_batch, reset,
                                                        want_outputs=False):
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback, epoch, nbatch, eval_metric, locals())
            n_seen = nbatch + 1
        _fire(score_end_callback, epoch, n_seen, eval_metric, locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Generator over (outputs, nbatch, batch)."""
        for nbatch, batch, outs in self._infer_batches(eval_data, num_batch, reset):
            yield outs, nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False):
        """Outputs over an iterator, merged across batches by default."""
        collected = [[o.copy() for o in outs]
                     for _n, _b, outs in self._infer_batches(eval_data, num_batch, reset)]
        if not collected or not merge_batches:
            return collected
        arity = len(collected[0])
        if any(len(outs) != arity for outs in collected):
            raise AssertionError("Cannot merge batches, as num of outputs is not the same in "
                                 "mini-batches. Maybe bucketing is used?")
        merged = [nd.concatenate([outs[i] for outs in collected]) for i in range(arity)]
        if arity == 1 and not always_output_list:
            return merged[0]
        return merged

    # -- training ----------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc", epoch_end_callback=None,
            batch_end_callback=None, kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), eval_end_callback=None,
            eval_batch_end_callback=None, initializer=Uniform(0.01), arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            checkpoint_dir=None, resume=None, guardrails=None):
        """The training loop; see the module docstring."""
        assert num_epoch is not None, "please specify number of epochs"
        for what, value, where in (
                ("checkpoint_dir", checkpoint_dir, "mxnet_tpu/resilience/checkpoint.py"),
                ("resume", resume, "mxnet_tpu/resilience/checkpoint.py"),
                ("guardrails", guardrails, "mxnet_tpu/resilience/guardrail.py"),
                ("monitor", monitor, "mxnet_tpu/monitor.py")):
            if value is not None:
                raise NotImplementedError(
                    "fit(%s=...) is not ported to PyTorch yet (%s)" % (what, where))
        self.bind(data_shapes=train_data.provide_data, label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        fit_k = _fit_multistep()
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = metric_mod.create(eval_metric)
        if validation_metric is None:
            validation_metric = eval_metric
        use_multi = (fit_k > 1 and monitor is None
                     and getattr(self, "_fused_trainer", None) is not None
                     and hasattr(self, "update_multi"))
        if use_multi:
            self._fused_trainer.compile_multi(fit_k)  # raises for an ungrouped optimizer

        def _single(epoch, nbatch, data_batch, local_vars):
            self.forward_backward(data_batch)
            self.update()
            self.update_metric(eval_metric, data_batch.label)
            _fire(batch_end_callback, epoch, nbatch, eval_metric, local_vars)

        def _flush_group(pending, epoch):
            def _cb_locals(nbatch, data_batch):
                # the single-step path's locals keys, for callbacks that
                # read locals["self"] or locals["data_batch"]
                return dict(self=self, train_data=train_data, data_batch=data_batch,
                            epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                            monitor=monitor)

            if len(pending) < fit_k:
                # a partial trailing group: the single-step path
                for nbatch, db in pending:
                    _single(epoch, nbatch, db, _cb_locals(nbatch, db))
                return
            steps = self.update_multi([db for _, db in pending])
            for (nbatch, db), outs in zip(pending, steps):
                self._install_step_outputs(outs)
                self.update_metric(eval_metric, db.label)
                _fire(batch_end_callback, epoch, nbatch, eval_metric, _cb_locals(nbatch, db))

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            pending = []  # (nbatch, data_batch) awaiting a K-group flush
            for nbatch, data_batch in enumerate(train_data):
                if not use_multi:
                    _single(epoch, nbatch, data_batch, locals())
                    continue
                if pending and any(tuple(p.shape) != tuple(d.shape)
                                   for p, d in zip(pending[0][1].data, data_batch.data)):
                    # a shape break: flush what is pending first
                    _flush_group(pending, epoch)
                    pending = []
                pending.append((nbatch, data_batch))
                if len(pending) == fit_k:
                    _flush_group(pending, epoch)
                    pending = []
            if pending:
                _flush_group(pending, epoch)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            # sync params (and multi-device aux) back to the host copies
            arg_now, aux_now = self.get_params()
            self.set_params(arg_now, aux_now)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_now, aux_now)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()

    # -- symbol and params -------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        self.init_params(initializer=None, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def save_params(self, fname):
        """``arg:`` / ``aux:`` arrays in the dmlc ``.params`` bytes."""
        arg_params, aux_params = self.get_params()
        blob = {"arg:" + k: v for k, v in arg_params.items()}
        blob.update({"aux:" + k: v for k, v in aux_params.items()})
        nd.save(fname, blob)

    def load_params(self, fname):
        split = {"arg": {}, "aux": {}}
        for key, value in nd.load(fname).items():
            kind, _, name = key.partition(":")
            if kind not in split or not name:
                raise ValueError("Invalid param file " + fname)
            split[kind][name] = value
        self.set_params(split["arg"], split["aux"])

    # -- computation interface ---------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError(
            "Monitor is not ported to PyTorch yet (mxnet_tpu/monitor.py)")
