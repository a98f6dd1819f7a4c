"""SVM head on the digits with the PyTorch port (counterpart of
``examples/svm_digits.py``; reference example/svm_mnist: the SVMOutput loss
head, a multiclass hinge loss with margin and the regularization baked into
its gradient)::

    python -m mxnet_tpu_torch.examples.svm_digits [--ctx cpu] [--use-linear]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits


def build_net(use_linear):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SVMOutput(net, mx.sym.Variable("svm_label"), margin=1.0,
                            regularization_coefficient=1.0, use_linear=use_linear, name="svm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--use-linear", action="store_true",
                   help="L1 hinge (reference use_linear=1) instead of squared hinge")
    p.set_defaults(num_epochs=12, batch_size=100, lr=0.1)
    return p.parse_args(argv)


def run(args):
    """Train and score; returns {"accuracy": ...} (asserts >= 0.9)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    d = load_digits()
    X = (d.images / 16.0).astype(np.float32).reshape(-1, 64)
    y = d.target.astype(np.float32)
    n = 1500
    it = mx.io.NDArrayIter(X[:n], y[:n], batch_size=args.batch_size, shuffle=True,
                           label_name="svm_label")
    val = mx.io.NDArrayIter(X[n:], y[n:], batch_size=args.batch_size, label_name="svm_label")
    mod = mx.mod.Module(build_net(args.use_linear), context=ctx, label_names=["svm_label"])
    mod.fit(it, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9, "wd": 1e-4},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs)
    val.reset()
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    print("svm accuracy: %.3f (%s hinge)" % (acc, "L1" if args.use_linear else "squared"))
    assert acc >= 0.9, acc
    return {"accuracy": acc}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
