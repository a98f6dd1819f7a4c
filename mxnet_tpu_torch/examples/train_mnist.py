"""Train an MLP or LeNet on MNIST with the PyTorch port (counterpart of
``examples/train_mnist.py``; reference example/image-classification/
train_mnist.py)::

    python -m mxnet_tpu_torch.examples.train_mnist [--network lenet] [--ctx cpu]

Runs on the card (``gpu(0)``) unless ``--ctx cpu``. MNIST is read from
``--data-dir`` if the idx files are there, else a synthetic digits-like set
is generated so the example runs offline. Prints and returns the validation
accuracy.
"""
from __future__ import annotations

import argparse
import gzip
import os
import struct
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, fit


def read_mnist(path, label_path):
    with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, h, w)
    with (gzip.open(label_path) if label_path.endswith(".gz") else open(label_path, "rb")) as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    return images.astype(np.float32) / 255.0, labels.astype(np.float32)


def synthetic_mnist(n=6000, seed=0):
    """Offline stand-in: well-separated class blobs shaped like MNIST."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 28, 28) > 0.7
    X = np.empty((n, 28, 28), np.float32)
    y = np.empty((n,), np.float32)
    for i in range(n):
        c = i % 10
        X[i] = protos[c] * (0.7 + 0.3 * rng.rand(28, 28)) + 0.1 * rng.rand(28, 28)
        y[i] = c
    return X, y


def get_iters(args):
    ddir = args.data_dir
    train_img = os.path.join(ddir, "train-images-idx3-ubyte")
    if os.path.exists(train_img) or os.path.exists(train_img + ".gz"):
        sfx = "" if os.path.exists(train_img) else ".gz"
        Xtr, ytr = read_mnist(train_img + sfx,
                              os.path.join(ddir, "train-labels-idx1-ubyte" + sfx))
        Xte, yte = read_mnist(os.path.join(ddir, "t10k-images-idx3-ubyte" + sfx),
                              os.path.join(ddir, "t10k-labels-idx1-ubyte" + sfx))
    else:
        X, y = synthetic_mnist()
        Xtr, ytr, Xte, yte = X[:5000], y[:5000], X[5000:], y[5000:]
    shape = (-1, 1, 28, 28) if args.network == "lenet" else (-1, 784)
    train = mx.io.NDArrayIter(Xtr.reshape(shape), ytr, batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(Xte.reshape(shape), yte, batch_size=args.batch_size)
    return train, val


def get_symbol(args):
    if args.network == "lenet":
        from ..models.lenet import get_symbol as lenet
        return lenet(num_classes=10)
    from ..models.mlp import get_symbol as mlp
    return mlp(num_classes=10)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(parser)
    parser.add_argument("--data-dir", type=str, default="data/mnist")
    parser.set_defaults(network="mlp", batch_size=64, num_epochs=5, lr=0.05)
    return parser.parse_args(argv)


def run(args):
    """Train and score; returns {"accuracy": validation accuracy}."""
    train, val = get_iters(args)
    mod = fit(args, get_symbol(args), train, val)
    val.reset()
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    print("validation accuracy: %.3f" % acc)
    return {"accuracy": acc}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
