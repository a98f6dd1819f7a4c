"""Sort digit sequences with a bidirectional LSTM on the PyTorch port
(counterpart of ``examples/bi_lstm_sort.py``; reference
example/bi-lstm-sort): the model reads the whole sequence both ways and
emits the sorted sequence position by position, which a unidirectional
model cannot::

    python -m mxnet_tpu_torch.examples.bi_lstm_sort [--ctx cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context

VOCAB = 10


def build_sym(seq_len, num_hidden, num_embed):
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=num_embed, name="embed")
    cell = mx.rnn.BidirectionalCell(mx.rnn.LSTMCell(num_hidden, prefix="l_"),
                                    mx.rnn.LSTMCell(num_hidden, prefix="r_"))
    outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, 2 * num_hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=VOCAB, name="cls")
    label = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label, name="softmax")


def make_data(n, seq_len, seed):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, VOCAB, (n, seq_len)).astype(np.float32)
    return X, np.sort(X, axis=1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--seq-len", type=int, default=6)
    p.add_argument("--num-hidden", type=int, default=64)
    p.add_argument("--num-embed", type=int, default=16)
    p.add_argument("--num-samples", type=int, default=4000)
    p.add_argument("--min-acc", type=float, default=0.85,
                   help="per-digit accuracy gate (smoke runs lower it)")
    p.set_defaults(num_epochs=15, batch_size=100, lr=0.01)
    return p.parse_args(argv)


def run(args):
    """Train and score; returns {"accuracy"} (asserts ``--min-acc``)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    X, Y = make_data(args.num_samples, args.seq_len, 1)
    Xv, Yv = make_data(500, args.seq_len, 2)
    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(Xv, Yv, batch_size=args.batch_size)
    mod = mx.mod.Module(build_sym(args.seq_len, args.num_hidden, args.num_embed), context=ctx)
    mod.fit(it, eval_data=val, optimizer="adam", optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 20))
    val.reset()
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    print("per-digit sort accuracy: %.3f" % acc)
    val.reset()
    b = next(iter(val))
    mod.forward(b, is_train=False)
    pred = mod.get_outputs()[0].asnumpy().argmax(axis=1).reshape(-1, args.seq_len)
    x0 = b.data[0].asnumpy()[0].astype(int)
    print("input :", x0, "-> model:", pred[0].astype(int), "(true:", np.sort(x0), ")")
    assert acc >= args.min_acc, "bi-LSTM failed to learn sorting: %r" % acc
    return {"accuracy": acc}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
