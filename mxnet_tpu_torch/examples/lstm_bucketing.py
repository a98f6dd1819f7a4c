"""LSTM language model with bucketing on the PyTorch port (counterpart of
``examples/lstm_bucketing.py``, the reference's
example/rnn/lstm_bucketing.py and cudnn_lstm_bucketing.py: the PTB
perplexity workload).

    python -m mxnet_tpu_torch.examples.lstm_bucketing [--stack-rnn] [--ctx cpu]
        [--data-path ptb.train.txt] [--vocab 10000] [--num-epochs 5]

Reads a whitespace-tokenised text file (one sentence per line), or makes a
synthetic cyclic corpus of 400 sentences at ``--vocab`` words, so the
example runs offline. The default route is ``FusedRNNCell``: the fused
``RNN`` operator, cuDNN on the card; ``--stack-rnn`` unrolls an
``LSTMCell`` stack instead. ``BucketingModule`` binds one Module a bucket,
all sharing the default bucket's parameters. ``--num-devices N`` > 1
trains each bucket on the fused data-parallel path (N logical ranks of
the one device, kvstore ``device``).
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

BUCKETS = [10, 20, 30, 40, 50, 60]


def tokenize(path, vocab=None):
    sentences = []
    vocab = vocab if vocab is not None else {"<pad>": 0, "<eos>": 1}
    with open(path) as f:
        for line in f:
            ids = [vocab.setdefault(w, len(vocab)) for w in line.split()]
            if ids:
                sentences.append(ids + [1])
    return sentences, vocab


def synthetic_corpus(vocab_size=40, n=400, seed=0):
    """``n`` cyclic sentences of 5-44 words over ids 2..vocab_size-1 (0 is
    the padding, 1 the end of a sentence), from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    sentences = []
    for _ in range(n):
        start = rng.randint(2, vocab_size)
        length = rng.randint(5, 45)
        sentences.append([2 + (start - 2 + t) % (vocab_size - 2) for t in range(length)])
    return sentences, vocab_size


def make_cell(mx, num_hidden, num_layers, stack_rnn):
    """The LSTMCell stack (``--stack-rnn``) or the FusedRNNCell."""
    if stack_rnn:
        cell = mx.rnn.SequentialRNNCell()
        for i in range(num_layers):
            cell.add(mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i))
        return cell
    return mx.rnn.FusedRNNCell(num_hidden, num_layers=num_layers, mode="lstm", prefix="lstm_")


def make_sym_gen(mx, cell, vocab_size, num_embed, num_hidden):
    """The BucketingModule's sym_gen: embedding, the cell unrolled over the
    bucket's length, the softmax over the vocabulary."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size, output_dim=num_embed, name="embed")
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, lab, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def contexts(mx, ctx, num_devices):
    """The BucketingModule's contexts: ``num_devices`` copies of the one
    device (the fused path's logical ranks when > 1)."""
    dev = mx.cpu() if ctx == "cpu" else mx.gpu(0)
    return [dev] * num_devices if num_devices > 1 else dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-path", type=str, default=None)
    ap.add_argument("--vocab", type=int, default=40,
                    help="words of the synthetic corpus (PTB has 10000)")
    ap.add_argument("--num-hidden", type=int, default=200)
    ap.add_argument("--num-embed", type=int, default=200)
    ap.add_argument("--num-lstm-layers", type=int, default=2)
    ap.add_argument("--stack-rnn", action="store_true",
                    help="unfused LSTMCell stack instead of the fused RNN operator")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", type=str, default="adam")
    ap.add_argument("--disp-batches", type=int, default=50)
    ap.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--num-devices", type=int, default=1)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)-15s %(message)s")
    import mxnet_tpu_torch as mx

    if args.data_path and os.path.exists(args.data_path):
        sentences, vocab = tokenize(args.data_path)
        vocab_size = len(vocab)
    else:
        sentences, vocab_size = synthetic_corpus(args.vocab)
    ctx = contexts(mx, args.ctx, args.num_devices)
    with mx.cpu() if args.ctx == "cpu" else mx.gpu(0):
        train = mx.rnn.BucketSentenceIter(sentences, args.batch_size, buckets=BUCKETS)
        cell = make_cell(mx, args.num_hidden, args.num_lstm_layers, args.stack_rnn)
        model = mx.mod.BucketingModule(
            make_sym_gen(mx, cell, vocab_size, args.num_embed, args.num_hidden),
            default_bucket_key=train.default_bucket_key, context=ctx)
        model.fit(train, eval_metric=mx.metric.Perplexity(ignore_label=0),
                  kvstore="device" if args.num_devices > 1 else "local",
                  optimizer=args.optimizer, optimizer_params={"learning_rate": args.lr},
                  initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
                  num_epoch=args.num_epochs,
                  batch_end_callback=mx.callback.Speedometer(args.batch_size,
                                                             args.disp_batches))
        train.reset()
        ppl = model.score(train, mx.metric.Perplexity(ignore_label=0))
    print("final train perplexity:", ppl)
    return model, ppl


if __name__ == "__main__":
    main()
