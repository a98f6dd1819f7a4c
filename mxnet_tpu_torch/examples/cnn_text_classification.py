"""Kim-style CNN for sentence classification with the PyTorch port
(counterpart of ``examples/cnn_text_classification.py``; reference
example/cnn_text_classification): embeddings, parallel convolutions of
n-gram widths 2, 3 and 4 over the token sequence, max-over-time pooling,
concat, dropout, softmax::

    python -m mxnet_tpu_torch.examples.cnn_text_classification [--ctx cpu]

Synthetic sentences: certain bigrams signal the label by their order only,
so a bag-of-words model cannot solve the task.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context

VOCAB = 40
SEQ = 20
# signal bigrams: (a, b) -> positive, (b, a) -> negative
PAIRS = [(3, 7), (11, 15), (21, 29)]


def make_data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, VOCAB, (n, SEQ))
    y = rng.randint(0, 2, n)
    for i in range(n):
        k = rng.randint(2, 5)  # plant k signal bigrams
        for _ in range(k):
            a, b = PAIRS[rng.randint(len(PAIRS))]
            pos = rng.randint(0, SEQ - 1)
            X[i, pos], X[i, pos + 1] = (a, b) if y[i] else (b, a)
    return X.astype(np.float32), y.astype(np.float32)


def build_sym(num_embed, num_filter, dropout):
    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=num_embed, name="embed")
    # (batch, seq, embed) -> (batch, 1, seq, embed): convolution over time
    x = mx.sym.Reshape(embed, shape=(-1, 1, SEQ, num_embed))
    pooled = []
    for width in (2, 3, 4):
        c = mx.sym.Convolution(x, kernel=(width, num_embed), num_filter=num_filter,
                               name="conv%d" % width)
        c = mx.sym.Activation(c, act_type="relu")
        c = mx.sym.Pooling(c, kernel=(SEQ - width + 1, 1), pool_type="max")
        pooled.append(mx.sym.Flatten(c))
    h = mx.sym.Concat(*pooled)
    if dropout > 0:
        h = mx.sym.Dropout(h, p=dropout)
    fc = mx.sym.FullyConnected(h, num_hidden=2, name="cls")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--num-embed", type=int, default=16)
    p.add_argument("--num-filter", type=int, default=32)
    p.add_argument("--dropout", type=float, default=0.25)
    p.add_argument("--min-acc", type=float, default=0.9)
    p.set_defaults(num_epochs=10, batch_size=100, lr=0.05)
    return p.parse_args(argv)


def run(args):
    """Train and score; returns {"accuracy"} (asserts ``--min-acc``)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    X, y = make_data(4000, 1)
    Xv, yv = make_data(800, 2)
    it = mx.io.NDArrayIter(X, y, batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(Xv, yv, batch_size=args.batch_size)
    mod = mx.mod.Module(build_sym(args.num_embed, args.num_filter, args.dropout), context=ctx)
    mod.fit(it, eval_data=val, optimizer="adam", optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 20))
    val.reset()
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    print("sentence accuracy: %.3f" % acc)
    assert acc >= args.min_acc, "n-gram CNN failed to beat the bigram task: %r" % acc
    return {"accuracy": acc}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
