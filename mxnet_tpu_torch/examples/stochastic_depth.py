"""Stochastic-depth residual training with the PyTorch port (counterpart of
``examples/stochastic_depth.py``; reference example/stochastic-depth)::

    python -m mxnet_tpu_torch.examples.stochastic_depth [--ctx cpu]

Each residual block computes x + gate * branch(x), where gate is a
per-batch Bernoulli(p_survive) draw from ``mx.sym.uniform`` at train time
and the constant p_survive at test time. Gates are zeroed, not skipped (the
graph is static). The expectation-scaled deterministic net must score
``--min-acc`` on held-out digits from the stochastically trained weights.
The blocks' 16 -> 16 channel 3 x 3 convolutions lie in the envelope of the
hand-written convolution-backward kernels, so on the card their gradients
run K2 and K3; the stem's one input channel does not.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits


def res_block(x, nf, name, p_survive, stochastic):
    branch = mx.sym.Convolution(x, kernel=(3, 3), num_filter=nf, pad=(1, 1), name=name + "_c1")
    branch = mx.sym.BatchNorm(branch, name=name + "_bn")
    branch = mx.sym.Activation(branch, act_type="relu")
    branch = mx.sym.Convolution(branch, kernel=(3, 3), num_filter=nf, pad=(1, 1),
                                name=name + "_c2")
    if stochastic:
        # one Bernoulli(p_survive) gate a batch: keep the branch with
        # probability p, else the block is the identity this step
        u = mx.sym.uniform(low=0.0, high=1.0, shape=(1,))
        gate = mx.sym._lesser_scalar(u, scalar=p_survive)
        branch = mx.sym.broadcast_mul(branch, gate)
    else:
        branch = branch * p_survive  # inference: the expectation's scale
    return x + branch


def build(depth, p_survive, stochastic):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=16, pad=(1, 1), name="stem")
    net = mx.sym.Activation(net, act_type="relu")
    for i in range(depth):
        net = res_block(net, 16, "blk%d" % i, p_survive, stochastic)
    net = mx.sym.Pooling(net, global_pool=True, pool_type="avg", kernel=(1, 1))
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10, name="cls")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--p-survive", type=float, default=0.75)
    p.add_argument("--min-acc", type=float, default=0.85)
    p.set_defaults(num_epochs=22, batch_size=100, lr=0.1)
    return p.parse_args(argv)


def run(args):
    """Train stochastically, score deterministically; returns
    {"accuracy", "params"} (asserts ``--min-acc``)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    d = load_digits()
    X = (d.images / 16.0).astype(np.float32).reshape(-1, 1, 8, 8)
    y = d.target.astype(np.float32)
    n = 1500
    it = mx.io.NDArrayIter(X[:n], y[:n], batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(X[n:], y[n:], batch_size=args.batch_size)
    mod = mx.mod.Module(build(args.depth, args.p_survive, True), context=ctx)
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2),
            num_epoch=args.num_epochs)
    args_p, aux_p = mod.get_params()
    infer = mx.mod.Module(build(args.depth, args.p_survive, False), context=ctx)
    infer.bind(data_shapes=val.provide_data, label_shapes=val.provide_label, for_training=False)
    infer.set_params(args_p, aux_p)
    val.reset()
    acc = dict(infer.score(val, mx.metric.Accuracy()))["accuracy"]
    print("stochastic-depth val accuracy (expectation-scaled): %.3f" % acc)
    assert acc >= args.min_acc, acc
    return {"accuracy": acc, "params": {k: v.asnumpy() for k, v in args_p.items()}}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
