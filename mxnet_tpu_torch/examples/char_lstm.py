"""Char-level LSTM with the PyTorch port (counterpart of
``examples/char_lstm.py``; reference example/rnn char-lstm): train with the
unrolled symbol on a tiny corpus (Python's Zen, from the standard
library), then sample text through a one-step graph whose LSTM states are
explicit inputs and outputs carried across the steps (the reference's
LSTMInferenceModel)::

    python -m mxnet_tpu_torch.examples.char_lstm [--ctx cpu] [--num-epochs 25]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context


def corpus():
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        import this as _this  # the Zen of Python; importing prints it

    text = "".join(_this.d.get(c, c) for c in _this.s)  # rot13 decode
    vocab = sorted(set(text))
    c2i = {c: i for i, c in enumerate(vocab)}
    return text, vocab, c2i


def train_sym(vocab_size, seq_len, num_hidden, num_embed):
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=vocab_size, output_dim=num_embed, name="embed")
    cell = mx.rnn.LSTMCell(num_hidden, prefix="lstm_")
    outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size, name="cls")
    label = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label, name="softmax")


def infer_sym(vocab_size, num_hidden, num_embed):
    """One step with explicit state IO: data (1, 1) and init_h / init_c
    in, [prob, next_h, next_c] out."""
    data = mx.sym.Variable("data")
    init_h = mx.sym.Variable("init_h")
    init_c = mx.sym.Variable("init_c")
    embed = mx.sym.Embedding(data, input_dim=vocab_size, output_dim=num_embed, name="embed")
    embed = mx.sym.Reshape(embed, shape=(0, -1))  # (batch, embed)
    cell = mx.rnn.LSTMCell(num_hidden, prefix="lstm_")
    out, states = cell(embed, [init_h, init_c])
    pred = mx.sym.FullyConnected(out, num_hidden=vocab_size, name="cls")
    prob = mx.sym.SoftmaxActivation(pred, name="prob")
    return mx.sym.Group([prob] + list(states))  # states = [h, c]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--num-hidden", type=int, default=128)
    p.add_argument("--num-embed", type=int, default=32)
    p.add_argument("--sample-chars", type=int, default=200)
    p.set_defaults(num_epochs=25, batch_size=16, lr=0.02)
    return p.parse_args(argv)


def run(args):
    """Train, then sample; returns {"sampled": the text}."""
    ctx = get_context(args)
    text, vocab, c2i = corpus()
    ids = np.asarray([c2i[c] for c in text], np.float32)
    seq = args.seq_len
    n = (len(ids) - 1) // seq
    X = ids[:n * seq].reshape(n, seq)
    Y = ids[1:n * seq + 1].reshape(n, seq)
    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True,
                           last_batch_handle="discard", label_name="softmax_label")
    mod = mx.mod.Module(train_sym(len(vocab), seq, args.num_hidden, args.num_embed), context=ctx)
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Xavier(), eval_metric=mx.metric.Perplexity(ignore_label=None),
            num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 10))
    arg_params, _ = mod.get_params()

    # stepwise sampling
    isym = infer_sym(len(vocab), args.num_hidden, args.num_embed)
    exe = isym.simple_bind(ctx=ctx if not isinstance(ctx, list) else ctx[0], data=(1, 1),
                           init_c=(1, args.num_hidden), init_h=(1, args.num_hidden),
                           grad_req="null")
    for name, arr in arg_params.items():
        if name in exe.arg_dict:
            exe.arg_dict[name][:] = arr.asnumpy()
    rng = np.random.RandomState(0)
    c = np.zeros((1, args.num_hidden), np.float32)
    h = np.zeros((1, args.num_hidden), np.float32)
    ch = text[0]
    out_text = [ch]
    for _ in range(args.sample_chars):
        exe.arg_dict["data"][:] = np.asarray([[c2i[ch]]], np.float32)
        exe.arg_dict["init_c"][:] = c
        exe.arg_dict["init_h"][:] = h
        prob, h, c = [o.asnumpy() for o in exe.forward()]  # [prob, h, c]
        # temperature-0.7 sampling: stochastic but legible
        logits = np.log(np.maximum(prob[0], 1e-12)) / 0.7
        pvals = np.exp(logits - logits.max())
        pvals = pvals / pvals.sum()
        ch = vocab[int(rng.choice(len(vocab), p=pvals))]
        out_text.append(ch)
    sampled = "".join(out_text)
    print("---- sampled ----")
    print(sampled)
    return {"sampled": sampled}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
