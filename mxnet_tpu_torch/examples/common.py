"""Shared example plumbing of the PyTorch port (counterpart of
``examples/common.py``, the reference's example/image-classification
common/fit.py): ``add_fit_args`` and the canonical ``Module.fit`` call.

Examples run on the card (``--ctx gpu``, the default) or on the host
(``--ctx cpu``). ``--num-devices N`` > 1 trains on the fused data-parallel
path: on the card over a mesh of N logical ranks sharing ``gpu(0)``, on
the host over N CPU contexts; the kvstore is then ``device``.
"""
from __future__ import annotations

import logging

from .. import callback, kvstore, lr_scheduler, model
from .. import initializer as init
from ..context import cpu, gpu
from ..module import Module
from ..parallel import make_mesh


def add_fit_args(parser):
    """The reference's fit arguments (common/fit.py:45)."""
    parser.add_argument("--network", type=str, default=None)
    parser.add_argument("--num-layers", type=int, default=50)
    parser.add_argument("--num-group", type=int, default=32, help="resnext cardinality")
    parser.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    parser.add_argument("--num-devices", type=int, default=1)
    # "auto": one device -> no kvstore; several -> 'device' (the fused path)
    parser.add_argument("--kv-store", type=str, default="auto")
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--lr-factor", type=float, default=0.1)
    parser.add_argument("--lr-step-epochs", type=str, default="")
    parser.add_argument("--optimizer", type=str, default="sgd")
    parser.add_argument("--mom", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--disp-batches", type=int, default=20)
    parser.add_argument("--model-prefix", type=str, default=None)
    parser.add_argument("--load-epoch", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="float32")
    return parser


def get_module(args, network, **kwargs):
    """A Module on ``--ctx`` with ``--num-devices`` data-parallel ranks
    (``kwargs`` to Module: data_names, label_names)."""
    n = args.num_devices
    if args.ctx == "cpu":
        return Module(network, context=[cpu(i) for i in range(n)] if n > 1 else cpu(), **kwargs)
    if n > 1:
        return Module(network, context=gpu(0), mesh=make_mesh(dp=n, devices=[gpu(0)] * n),
                      **kwargs)
    return Module(network, context=gpu(0), **kwargs)


def fit(args, network, train, val=None, **kwargs):
    """The canonical ``Module.fit`` call (common/fit.py:89)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)-15s %(message)s")
    kv_name = args.kv_store
    if kv_name == "auto":
        kv_name = "device" if args.num_devices > 1 else "local"
    mod = get_module(args, network)
    optimizer_params = {"learning_rate": args.lr, "wd": args.wd}
    if args.optimizer == "sgd":
        optimizer_params["momentum"] = args.mom
    if args.lr_step_epochs:
        epoch_size = kwargs.get("epoch_size") or 1
        steps = [int(e) * epoch_size for e in args.lr_step_epochs.split(",") if e]
        optimizer_params["lr_scheduler"] = lr_scheduler.MultiFactorScheduler(
            steps, factor=args.lr_factor)
    arg_params = aux_params = None
    begin_epoch = 0
    if args.model_prefix and args.load_epoch is not None:
        _, arg_params, aux_params = model.load_checkpoint(args.model_prefix, args.load_epoch)
        begin_epoch = args.load_epoch
    checkpoint = callback.do_checkpoint(args.model_prefix) if args.model_prefix else None
    mod.fit(train, eval_data=val, eval_metric=kwargs.get("eval_metric", "acc"),
            optimizer=args.optimizer, optimizer_params=optimizer_params,
            initializer=init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2),
            arg_params=arg_params, aux_params=aux_params, begin_epoch=begin_epoch,
            num_epoch=args.num_epochs,
            batch_end_callback=callback.Speedometer(args.batch_size, args.disp_batches),
            epoch_end_callback=checkpoint, kvstore=kvstore.create(kv_name))
    return mod

