#!/usr/bin/env python
"""Model-parallel LSTM (counterpart of ``examples/model_parallel_lstm.py``,
the reference's example/model-parallel-lstm): layers placed on devices by
``ctx_group`` + ``group2ctx``.

The executor splits the graph into runs of one context with a copy at
each boundary (``executor._PlacedProgram``); one autograd tape spans the
devices. Training drives the bound executor directly, as the reference
example does (model-parallel-lstm/lstm.py:186-205).

    python -m mxnet_tpu_torch.examples.model_parallel_lstm [--ctx cpu]

On the card (``--ctx gpu``, the default) layer ``i`` goes to
``gpu(i % cards)``; on the host to ``cpu(i % 8)``, logical contexts of the
one host device.
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import add_fit_args


def build(seq_len, vocab, num_hidden, num_layers):
    """The unrolled LSTM LM with one ctx_group a layer, ``embed`` and
    ``decode`` (the embedding is ``num_hidden`` wide)."""
    import mxnet_tpu_torch as mx

    with mx.AttrScope(ctx_group="embed"):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=num_hidden, name="embed")
    outputs = embed
    for i in range(num_layers):
        with mx.AttrScope(ctx_group="layer%d" % i):
            cell = mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i)
            outputs, _ = cell.unroll(seq_len, inputs=outputs, merge_outputs=True)
    with mx.AttrScope(ctx_group="decode"):
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        net = mx.sym.SoftmaxOutput(pred, lab, name="softmax")
    return net


def plan(mx, ctx, num_layers):
    """The group -> context map (lstm.py:186-205): embed and decode on the
    first device, layer ``i`` on device ``i`` modulo the devices."""
    import torch

    if ctx == "cpu":
        dev, count = mx.cpu, 8
    else:
        dev, count = mx.gpu, max(1, torch.cuda.device_count())
    group2ctx = {"embed": dev(0), "decode": dev(0)}
    for i in range(num_layers):
        group2ctx["layer%d" % i] = dev(i % count)
    return dev(0), group2ctx


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(parser)
    parser.add_argument("--seq-len", type=int, default=12)
    parser.add_argument("--vocab", type=int, default=50)
    parser.add_argument("--num-hidden", type=int, default=64)
    parser.set_defaults(batch_size=16, num_epochs=3, lr=0.05, num_layers=2)
    args = parser.parse_args(argv)
    import mxnet_tpu_torch as mx

    net = build(args.seq_len, args.vocab, args.num_hidden, args.num_layers)
    bind_ctx, group2ctx = plan(mx, args.ctx, args.num_layers)

    rng = np.random.RandomState(0)
    seq = np.cumsum(rng.randint(1, 3, (256, args.seq_len)), axis=1) % args.vocab
    X, y = seq[:, :-1], seq[:, 1:]
    pad = np.zeros((X.shape[0], 1), X.dtype)
    X = np.concatenate([X, pad], axis=1)
    y = np.concatenate([y, pad], axis=1)
    with bind_ctx:
        it = mx.io.NDArrayIter(X.astype(np.float32), y.astype(np.float32),
                               batch_size=args.batch_size, shuffle=True,
                               label_name="softmax_label")
        exe = net.simple_bind(ctx=bind_ctx, group2ctx=group2ctx,
                              data=(args.batch_size, args.seq_len),
                              softmax_label=(args.batch_size, args.seq_len))
        if exe._placed is not None:
            segs = [(str(ctx), len(nodes)) for ctx, nodes in exe._placed.segments]
            print("placed segments (context, nodes):", segs)

        np.random.seed(0)
        init = mx.initializer.Xavier()
        for name, arr in exe.arg_dict.items():
            if name not in ("data", "softmax_label"):
                init(name, arr)
        opt = mx.optimizer.create("adam", learning_rate=args.lr,
                                  rescale_grad=1.0 / args.batch_size)
        updater = mx.optimizer.get_updater(opt)
        metric = mx.metric.Perplexity(ignore_label=None)
        param_names = [n for n in exe.arg_dict if n not in ("data", "softmax_label")]

        for epoch in range(args.num_epochs):
            it.reset()
            metric.reset()
            for batch in it:
                exe.arg_dict["data"][:] = batch.data[0]
                exe.arg_dict["softmax_label"][:] = batch.label[0]
                exe.forward(is_train=True)
                exe.backward()
                for i, name in enumerate(param_names):
                    updater(i, exe.grad_dict[name], exe.arg_dict[name])
                metric.update([batch.label[0].reshape((-1,))], exe.outputs)
            print("Epoch[%d] Train-%s=%.3f" % (epoch, *metric.get()))
    print("model-parallel LSTM example done; groups:", sorted(group2ctx))
    return exe, metric.get()


if __name__ == "__main__":
    main()
