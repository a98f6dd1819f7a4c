"""Fast-gradient-sign adversarial examples with the PyTorch port
(counterpart of ``examples/adversary_fgsm.py``; reference
example/adversary): train a digit classifier, then perturb the inputs
along sign(dLoss/dInput), read through a Module bound with
``inputs_need_grad``, and watch the accuracy fall::

    python -m mxnet_tpu_torch.examples.adversary_fgsm [--ctx cpu] [--eps 0.15]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits


def build_net():
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=16, pad=(1, 1), name="c1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=64, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--eps", type=float, default=0.15,
                   help="L-inf perturbation size (inputs are in [0,1])")
    p.set_defaults(num_epochs=10, batch_size=100, lr=0.1)
    return p.parse_args(argv)


def run(args):
    """Train, then attack; returns {"clean", "adversarial"} accuracies
    (asserts the attack lowers it)."""
    ctx = get_context(args)
    one_ctx = ctx[0] if isinstance(ctx, list) else ctx
    np.random.seed(0)
    mx.random.seed(0)
    d = load_digits()
    X = (d.images / 16.0).astype(np.float32).reshape(-1, 1, 8, 8)
    y = d.target.astype(np.float32)
    n_train = 1500
    it = mx.io.NDArrayIter(X[:n_train], y[:n_train], batch_size=args.batch_size, shuffle=True)
    val_X, val_y = X[n_train:1700], y[n_train:1700]
    net = build_net()
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs)
    arg_params, aux_params = mod.get_params()

    # the adversarial pass: rebound with input gradients
    amod = mx.mod.Module(net, context=one_ctx)
    amod.bind(data_shapes=[("data", val_X.shape)], label_shapes=[("softmax_label", val_y.shape)],
              for_training=True, inputs_need_grad=True)
    amod.set_params(arg_params, aux_params)
    amod.forward(mx.io.DataBatch([mx.nd.array(val_X)], [mx.nd.array(val_y)]), is_train=True)
    clean_pred = amod.get_outputs()[0].asnumpy().argmax(axis=1)
    amod.backward()
    gsign = np.sign(amod.get_input_grads()[0].asnumpy())
    adv_X = np.clip(val_X + args.eps * gsign, 0.0, 1.0)
    amod.forward(mx.io.DataBatch([mx.nd.array(adv_X)], [mx.nd.array(val_y)]), is_train=False)
    adv_pred = amod.get_outputs()[0].asnumpy().argmax(axis=1)
    clean_acc = float((clean_pred == val_y).mean())
    adv_acc = float((adv_pred == val_y).mean())
    print("clean accuracy:       %.3f" % clean_acc)
    print("adversarial accuracy: %.3f (eps=%.2f)" % (adv_acc, args.eps))
    assert adv_acc < clean_acc, "FGSM produced no accuracy drop"
    return {"clean": clean_acc, "adversarial": adv_acc}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
