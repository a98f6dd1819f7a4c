"""Train ResNet / Inception / VGG / AlexNet on ImageNet RecordIO files with
the PyTorch port (counterpart of ``examples/train_imagenet.py``, the
reference's example/image-classification/train_imagenet.py).

    python -m mxnet_tpu_torch.examples.train_imagenet --data-train train.rec \\
        [--data-val val.rec] [--num-devices 4] [--ctx cpu] [flags]
    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 50

Pack a dataset with ``python -m mxnet_tpu_torch.tools.im2rec``. The
training iterator is ``ImageRecordIter`` (shuffle, random crop and mirror,
the ImageNet mean; ``--data-nthreads`` decode threads, or with
``--input-workers`` N > 0 the streaming pipeline's N decode processes).
On the card, with ``--num-devices`` > 1, ``fit`` trains on the fused path
(staging batches through ``DeviceFeedIter`` with ``MXTPU_DEVICE_FEED=1``);
``MXTPU_AMP=bf16`` turns on bf16 AMP. ``--benchmark N`` trains N synthetic
batches instead. Under the port's launcher ``--kv-store dist_sync`` or
``dist_device_sync`` trains across the processes (``examples/common.py``;
the streaming pipeline of ``--input-workers`` gives each process its
share of the records)::

    python -m mxnet_tpu_torch.tools.launch -n 2 python -m \
        mxnet_tpu_torch.examples.train_imagenet --benchmark 20 --kv-store dist_device_sync
"""
from __future__ import annotations

import argparse
import contextlib
import importlib

import numpy as np

from .. import io
from ..context import cpu
from .common import add_fit_args, fit


_NETWORKS = {"resnet": "resnet", "resnext": "resnext", "inception-v3": "inception_v3",
             "inception-bn": "inception_bn", "googlenet": "googlenet",
             "inception-resnet-v2": "inception_resnet_v2", "vgg": "vgg", "alexnet": "alexnet"}


def get_symbol(args):
    name = args.network or "resnet"
    if name not in _NETWORKS:
        raise ValueError("unknown network %s" % name)
    mod = importlib.import_module("mxnet_tpu_torch.models." + _NETWORKS[name])
    return mod.get_symbol(num_classes=args.num_classes, num_layers=args.num_layers,
                          num_group=args.num_group, image_shape=args.image_shape,
                          dtype=args.dtype)


def get_iters(args):
    shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark:
        # synthetic data at the training shape: one batch cycled N times
        rng = np.random.RandomState(0)
        X = rng.rand(args.batch_size, *shape).astype(np.float32)
        y = rng.randint(0, args.num_classes, args.batch_size).astype(np.float32)
        inner = io.NDArrayIter(X, y, batch_size=args.batch_size)
        return io.ResizeIter(inner, args.benchmark), None
    train = io.ImageRecordIter(
        path_imgrec=args.data_train, data_shape=shape, batch_size=args.batch_size,
        shuffle=True, rand_crop=True, rand_mirror=True, mean_r=123.68, mean_g=116.779,
        mean_b=103.939, preprocess_threads=args.data_nthreads,
        input_workers=args.input_workers, seed=args.seed)
    val = None
    if args.data_val:
        val = io.ImageRecordIter(
            path_imgrec=args.data_val, data_shape=shape, batch_size=args.batch_size,
            mean_r=123.68, mean_g=116.779, mean_b=103.939,
            preprocess_threads=args.data_nthreads)
    return train, val


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(parser)
    parser.add_argument("--data-train", type=str, default=None)
    parser.add_argument("--data-val", type=str, default=None)
    parser.add_argument("--image-shape", type=str, default="3,224,224")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--data-nthreads", type=int, default=4)
    parser.add_argument("--input-workers", type=int, default=0,
                        help="decode processes of the streaming pipeline (0: threads)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--benchmark", type=int, default=0,
                        help="train N synthetic batches instead of a dataset")
    parser.set_defaults(network="resnet", num_layers=50, batch_size=32,
                        lr_step_epochs="30,60,90")
    args = parser.parse_args(argv)
    if not args.data_train and not args.benchmark:
        parser.error("either --data-train or --benchmark is required")
    np.random.seed(args.seed)
    with cpu() if args.ctx == "cpu" else contextlib.nullcontext():
        train, val = get_iters(args)
        return fit(args, get_symbol(args), train, val)


if __name__ == "__main__":
    main()
