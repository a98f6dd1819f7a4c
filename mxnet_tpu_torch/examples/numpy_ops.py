"""A custom Python operator in a training graph with the PyTorch port
(counterpart of ``examples/numpy_ops.py``; reference example/numpy-ops): a
softmax loss written as a numpy ``CustomOp``, trained like a built-in op::

    python -m mxnet_tpu_torch.examples.numpy_ops [--ctx cpu]

The operator's forward and backward run on the host; the gradients it
emits flow into the rest of the graph on the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits


class NumpySoftmax(mx.operator.CustomOp):
    """Softmax + cross-entropy loss head in numpy (reference
    example/numpy-ops/numpy_softmax.py)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].asnumpy()
        e = np.exp(x - x.max(axis=1, keepdims=True))
        self.assign(out_data[0], req[0], mx.nd.array(e / e.sum(axis=1, keepdims=True)))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        lab = in_data[1].asnumpy().astype(np.int64)
        y = out_data[0].asnumpy().copy()
        y[np.arange(lab.shape[0]), lab] -= 1.0
        # per-sample gradient, as SoftmaxOutput's: the optimizer's
        # rescale_grad (1 / batch from fit) makes the mean
        self.assign(in_grad[0], req[0], mx.nd.array(y))


@mx.operator.register("numpy_softmax_example")
class NumpySoftmaxProp(mx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return NumpySoftmax()


def build_net():
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.Custom(net, mx.sym.Variable("softmax_label"),
                         op_type="numpy_softmax_example", name="softmax")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.set_defaults(num_epochs=12, batch_size=100, lr=0.1)
    return p.parse_args(argv)


def run(args):
    """Train and score; returns {"accuracy"} (asserts >= 0.9)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    d = load_digits()
    X = (d.images / 16.0).astype(np.float32).reshape(-1, 64)
    y = d.target.astype(np.float32)
    n = 1500
    it = mx.io.NDArrayIter(X[:n], y[:n], batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    val = mx.io.NDArrayIter(X[n:], y[n:], batch_size=args.batch_size,
                            label_name="softmax_label")
    mod = mx.mod.Module(build_net(), context=ctx)
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs)
    val.reset()
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    print("custom-numpy-softmax accuracy: %.3f" % acc)
    assert acc >= 0.9, acc
    return {"accuracy": acc}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
