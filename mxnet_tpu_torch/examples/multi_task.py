"""Multi-task training with the PyTorch port (counterpart of
``examples/multi_task.py``; reference example/multi-task): one trunk, two
loss heads in a Group symbol, head A classifying the digit (10-way) and
head B its parity (2-way)::

    python -m mxnet_tpu_torch.examples.multi_task [--ctx cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits


def build_sym():
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mx.sym.Activation(net, act_type="relu")
    digit = mx.sym.FullyConnected(net, num_hidden=10, name="digit_fc")
    digit = mx.sym.SoftmaxOutput(digit, mx.sym.Variable("digit_label"), name="digit")
    parity = mx.sym.FullyConnected(net, num_hidden=2, name="parity_fc")
    parity = mx.sym.SoftmaxOutput(parity, mx.sym.Variable("parity_label"), name="parity")
    return mx.sym.Group([digit, parity])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.set_defaults(num_epochs=15, batch_size=50, lr=0.1)
    return p.parse_args(argv)


def run(args):
    """Train and score each head; returns {"digit", "parity"} accuracies
    (asserts both reach 0.9, 0.85 below 12 epochs)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    d = load_digits()
    X = (d.images / 16.0).astype(np.float32).reshape(-1, 64)
    y = d.target.astype(np.float32)
    n = 1500
    it = mx.io.NDArrayIter(X[:n], {"digit_label": y[:n], "parity_label": y[:n] % 2},
                           batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(X[n:], {"digit_label": y[n:], "parity_label": y[n:] % 2},
                            batch_size=args.batch_size)
    mod = mx.mod.Module(build_sym(), context=ctx, label_names=["digit_label", "parity_label"])
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs)
    val.reset()
    hits = np.zeros(2)
    count = 0
    for b in val:
        mod.forward(b, is_train=False)
        # drop the iterator's wrap-around pad rows
        keep = b.data[0].shape[0] - getattr(b, "pad", 0)
        outs = [o.asnumpy()[:keep] for o in mod.get_outputs()]
        labs = [lab.asnumpy()[:keep] for lab in b.label]
        hits[0] += (outs[0].argmax(1) == labs[0]).sum()
        hits[1] += (outs[1].argmax(1) == labs[1]).sum()
        count += keep
    acc_digit, acc_parity = hits / count
    print("digit accuracy : %.3f" % acc_digit)
    print("parity accuracy: %.3f" % acc_parity)
    bar = 0.85 if args.num_epochs < 12 else 0.90
    assert acc_digit >= bar, acc_digit
    assert acc_parity >= bar, acc_parity
    return {"digit": float(acc_digit), "parity": float(acc_parity)}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
