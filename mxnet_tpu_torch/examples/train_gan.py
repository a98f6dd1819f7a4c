"""Adversarial training with two Modules on the PyTorch port (counterpart of
``examples/train_gan.py``; reference example/gan/dcgan.py's loop)::

    python -m mxnet_tpu_torch.examples.train_gan [--cpu] [--steps N]

The discriminator binds with ``inputs_need_grad=True`` and the generator is
updated by feeding ``D.get_input_grads()`` into
``G.backward(out_grads=...)``: no loss symbol on G at all. The data is a
2-D gaussian, so the loop converges in seconds. Runs on the card unless
``--cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch

TARGET_MEAN = np.array([2.0, 3.0], np.float32)


def build_modules(batch, nz, lr, ctx):
    # generator: noise -> 2-D sample; no loss head (identity output)
    rand = mx.sym.Variable("rand")
    g = mx.sym.FullyConnected(rand, num_hidden=32, name="g_fc1")
    g = mx.sym.Activation(g, act_type="relu")
    g = mx.sym.FullyConnected(g, num_hidden=32, name="g_fc2")
    g = mx.sym.Activation(g, act_type="relu")
    g = mx.sym.FullyConnected(g, num_hidden=2, name="g_out")
    gen = mx.mod.Module(g, data_names=("rand",), label_names=None, context=ctx)
    gen.bind(data_shapes=[("rand", (batch, nz))], for_training=True)
    gen.init_params(mx.init.Normal(0.1))
    gen.init_optimizer(optimizer="adam", optimizer_params={"learning_rate": lr})

    # discriminator: sample -> real / fake logit; needs input gradients
    data = mx.sym.Variable("data")
    d = mx.sym.FullyConnected(data, num_hidden=32, name="d_fc1")
    d = mx.sym.Activation(d, act_type="relu")
    d = mx.sym.FullyConnected(d, num_hidden=32, name="d_fc2")
    d = mx.sym.Activation(d, act_type="relu")
    d = mx.sym.FullyConnected(d, num_hidden=1, name="d_out")
    d = mx.sym.LogisticRegressionOutput(d, name="dloss")
    disc = mx.mod.Module(d, data_names=("data",), label_names=("dloss_label",), context=ctx)
    disc.bind(data_shapes=[("data", (batch, 2))], label_shapes=[("dloss_label", (batch, 1))],
              for_training=True, inputs_need_grad=True)
    disc.init_params(mx.init.Normal(0.1))
    disc.init_optimizer(optimizer="adam", optimizer_params={"learning_rate": lr})
    return gen, disc


def train(steps=400, batch=64, nz=8, lr=0.01, seed=0, log=print, ctx=None):
    """The adversarial loop on ``ctx`` (default the card); returns 512
    generated samples as numpy."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(seed)
    with ctx:
        gen, disc = build_modules(batch, nz, lr, ctx)
        ones = mx.nd.ones((batch, 1))
        zeros = mx.nd.zeros((batch, 1))
        for step in range(steps):
            noise = mx.nd.array(rng.randn(batch, nz).astype(np.float32))
            real = mx.nd.array((TARGET_MEAN + 0.3 * rng.randn(batch, 2)).astype(np.float32))
            gen.forward(DataBatch(data=[noise], label=[]), is_train=True)
            fake = gen.get_outputs()[0]
            # D step: the real batch labelled 1, the fake batch 0
            disc.forward(DataBatch(data=[real], label=[ones]), is_train=True)
            disc.backward()
            disc.update()
            disc.forward(DataBatch(data=[fake], label=[zeros]), is_train=True)
            disc.backward()
            disc.update()
            # G step: the fake batch through D labelled real; the input
            # gradient of that lie is dL/d(fake), which drives G's backward
            disc.forward(DataBatch(data=[fake], label=[ones]), is_train=True)
            disc.backward()
            gen.backward([disc.get_input_grads()[0]])
            gen.update()
            if log and (step + 1) % 100 == 0:
                mean = fake.asnumpy().mean(axis=0)
                log("step %4d  generated mean (%.2f, %.2f)  target (%.1f, %.1f)"
                    % (step + 1, mean[0], mean[1], *TARGET_MEAN))
        noise = mx.nd.array(rng.randn(512, nz).astype(np.float32))
        gen.reshape(data_shapes=[("rand", (512, nz))])
        gen.forward(DataBatch(data=[noise], label=[]), is_train=False)
        return gen.get_outputs()[0].asnumpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    samples = train(steps=args.steps, ctx=mx.cpu() if args.cpu else mx.gpu(0))
    mean = samples.mean(axis=0)
    print("final generated mean: (%.3f, %.3f); target (%.1f, %.1f)"
          % (mean[0], mean[1], *TARGET_MEAN))
    return 0


if __name__ == "__main__":
    sys.exit(main())
