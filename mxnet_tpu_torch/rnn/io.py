"""Bucketed sentence iterator of the PyTorch port (counterpart of
``mxnet_tpu/rnn/io.py``): ``encode_sentences`` and ``BucketSentenceIter``.
Each sentence pads into the smallest bucket that covers it (the rule of
``serving/buckets.py``) and batches are served one bucket at a time, in
an order drawn from ``random`` and rows shuffled by ``np.random``, as the
JAX package does: the same sentences, seeds and buckets give the same
batches, bucket keys and order in both packages. Batches land on the
current context.
"""
from __future__ import annotations

import random

import numpy as np

from .. import ndarray as nd
from ..io import DataBatch, DataIter, DataDesc
from ..serving import buckets as _buckets


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Tokenize nested word lists to int ids, growing the vocab only
    when the caller did not supply one."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sentence in sentences:
        ids = []
        for token in sentence:
            if token not in vocab:
                if not grow:
                    raise AssertionError("Unknown token %s" % token)
                if next_id == invalid_label:
                    next_id += 1
                vocab[token] = next_id
                next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Pads each sentence into the smallest bucket that fits and serves
    (data, next-token label) batches of one bucket at a time."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32"):
        super().__init__()
        if not buckets:
            # auto-buckets: every length with at least one full batch
            counts = np.bincount([len(s) for s in sentences])
            buckets = [length for length, n in enumerate(counts)
                       if n >= batch_size]
        self.buckets = sorted(buckets)

        per_bucket = [[] for _ in self.buckets]
        n_discarded = 0
        for sentence in sentences:
            # smallest covering bucket — shared with the serving queue
            # (serving/buckets.py is the one implementation of this rule)
            slot = _buckets.smallest_covering(self.buckets, len(sentence))
            if slot is None:
                n_discarded += 1
                continue
            row = _buckets.pad_to_width(
                np.asarray(sentence, dtype=dtype), self.buckets[slot],
                invalid_label)
            per_bucket[slot].append(row)
        # (0, width) for empty buckets keeps label shifting uniform
        self.data = [np.asarray(rows, dtype=dtype).reshape(-1, width)
                     for rows, width in zip(per_bucket, self.buckets)]
        print("WARNING: discarded %d sentences longer than the largest "
              "bucket." % n_discarded)

        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.major_axis = 0
        self.default_bucket_key = max(self.buckets)
        default = (batch_size, self.default_bucket_key)
        self.provide_data = [DataDesc(data_name, default)]
        self.provide_label = [DataDesc(label_name, default)]
        # schedule: every full batch as a (bucket index, row offset) pair
        self.idx = [
            (b, off)
            for b, rows in enumerate(self.data)
            for off in range(0, len(rows) - batch_size + 1, batch_size)
        ]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for rows in self.data:
            np.random.shuffle(rows)
        # language-model targets: the sequence shifted left by one
        self.nddata, self.ndlabel = [], []
        for rows in self.data:
            target = np.roll(rows, -1, axis=1)
            target[:, -1] = self.invalid_label
            self.nddata.append(nd.array(rows, dtype=self.dtype))
            self.ndlabel.append(nd.array(target, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        bucket, off = self.idx[self.curr_idx]
        self.curr_idx += 1
        sl = slice(off, off + self.batch_size)
        data, label = self.nddata[bucket][sl], self.ndlabel[bucket][sl]
        return DataBatch(
            [data], [label], pad=0,
            bucket_key=self.buckets[bucket],
            provide_data=[DataDesc(self.data_name, data.shape)],
            provide_label=[DataDesc(self.label_name, label.shape)],
        )
