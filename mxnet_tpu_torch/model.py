"""Kvstore routing helpers and the checkpoint format of the PyTorch port
(counterpart of ``mxnet_tpu/model.py:34-141``): ``_create_kvstore``,
``_initialize_kvstore``, ``_update_params_on_kvstore``, ``_update_params``
(the update routing ``Module.init_optimizer`` / ``update`` rely on) and
``save_checkpoint`` / ``load_checkpoint`` (``prefix-symbol.json`` plus the
dmlc ``.params`` bytes, readable by either package, written atomically). ``FeedForward`` is
not ported yet."""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from . import symbol as sym
from .kvstore import KVStore

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
    previous file, never a truncated one."""
    from .resilience.checkpoint import atomic_file

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
    """Not ported yet: the deprecated trainer over Module."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FeedForward is not ported to PyTorch yet (mxnet_tpu/model.py:142); "
            "use mx.mod.Module")
