"""MLP autoencoder with the PyTorch port (counterpart of
``examples/autoencoder.py``; reference example/autoencoder, its finetuning
stage): the encoder / decoder stack trained end to end with
``LinearRegressionOutput`` to reconstruct the digits, the input fed as the
label::

    python -m mxnet_tpu_torch.examples.autoencoder [--ctx cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits

DIMS = (64, 32, 8)  # input -> hidden -> code


def build_ae():
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("recon_label")
    x = data
    for i, h in enumerate(DIMS[1:], 1):
        x = mx.sym.FullyConnected(x, num_hidden=h, name="enc%d" % i)
        x = mx.sym.Activation(x, act_type="relu")
    for i, h in enumerate(reversed(DIMS[:-1]), 1):
        x = mx.sym.FullyConnected(x, num_hidden=h, name="dec%d" % i)
        if i < len(DIMS) - 1:
            x = mx.sym.Activation(x, act_type="relu")
    return mx.sym.LinearRegressionOutput(x, label, name="recon")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.set_defaults(num_epochs=20, batch_size=100, lr=0.02)
    return p.parse_args(argv)


def run(args):
    """Train and score; returns {"mse", "variance"} (asserts the mse is
    below half the input variance)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    X = (load_digits().images / 16.0).astype(np.float32).reshape(-1, 64)
    it = mx.io.NDArrayIter(X, X, batch_size=args.batch_size, shuffle=True,
                           label_name="recon_label")
    mod = mx.mod.Module(build_ae(), context=ctx, label_names=["recon_label"])
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Xavier(), eval_metric=mx.metric.MSE(),
            num_epoch=args.num_epochs)
    it.reset()
    mse = dict(mod.score(it, mx.metric.MSE()))["mse"]
    print("reconstruction mse: %.5f (input variance %.5f)" % (mse, float(X.var())))
    assert mse < X.var() * 0.5, "autoencoder failed to beat 50%% variance reduction: %r" % mse
    return {"mse": mse, "variance": float(X.var())}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
