"""Noise-contrastive estimation with the PyTorch port (counterpart of
``examples/nce_loss.py``; reference example/nce-loss): word embeddings
trained against a handful of sampled negatives instead of the whole
vocabulary's softmax, on a synthetic skip-gram corpus whose tokens come in
groups::

    python -m mxnet_tpu_torch.examples.nce_loss [--ctx cpu]

After training a word's nearest embedding neighbours are mostly of its own
group, which random embeddings fail completely.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context

VOCAB = 60
GROUPS = 6
K_NOISE = 8


def make_corpus(n_pairs, seed):
    """(center, target) skip-gram pairs: targets share the center's group
    90% of the time."""
    rng = np.random.RandomState(seed)
    g_of = np.arange(VOCAB) % GROUPS
    centers = rng.randint(0, VOCAB, n_pairs)
    same = rng.rand(n_pairs) < 0.9
    same_group_tok = rng.randint(0, VOCAB // GROUPS, n_pairs) * GROUPS + g_of[centers]
    targets = np.where(same, same_group_tok, rng.randint(0, VOCAB, n_pairs))
    return centers.astype(np.float32), targets.astype(np.float32)


def build_sym(num_embed):
    center = mx.sym.Variable("center")
    cand = mx.sym.Variable("cand")  # (batch, 1 + K): the target and the noise
    label = mx.sym.Variable("nce_label")  # (batch, 1 + K): 1 then zeros
    emb_in = mx.sym.Embedding(center, input_dim=VOCAB, output_dim=num_embed, name="embed_in")
    emb_out = mx.sym.Embedding(cand, input_dim=VOCAB, output_dim=num_embed, name="embed_out")
    scores = mx.sym.sum_axis(
        mx.sym.broadcast_mul(mx.sym.Reshape(emb_in, shape=(-1, 1, num_embed)), emb_out), axis=2)
    return mx.sym.LogisticRegressionOutput(scores, label, name="nce")


def make_data(num_pairs):
    """(data dict, label dict) of the corpus with K_NOISE noise words a pair."""
    rng = np.random.RandomState(3)
    centers, targets = make_corpus(num_pairs, 1)
    noise = rng.randint(0, VOCAB, (num_pairs, K_NOISE)).astype(np.float32)
    cand = np.concatenate([targets[:, None], noise], axis=1)
    label = np.zeros_like(cand)
    label[:, 0] = 1.0
    return {"center": centers, "cand": cand}, {"nce_label": label}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--num-embed", type=int, default=16)
    p.add_argument("--num-pairs", type=int, default=20000)
    p.set_defaults(num_epochs=8, batch_size=500, lr=0.3)
    return p.parse_args(argv)


def run(args):
    """Train; returns {"same_group", "chance"} (asserts a same-group rate
    of the nearest three neighbours of 0.6)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    data, label = make_data(args.num_pairs)
    it = mx.io.NDArrayIter(data, label, batch_size=args.batch_size, shuffle=True)
    mod = mx.mod.Module(build_sym(args.num_embed), context=ctx, data_names=["center", "cand"],
                        label_names=["nce_label"])
    mod.fit(it, optimizer="adam",
            optimizer_params={"learning_rate": args.lr, "rescale_grad": 1.0},
            initializer=mx.init.Normal(0.1), num_epoch=args.num_epochs)
    emb = mod.get_params()[0]["embed_in_weight"].asnumpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sims = emb @ emb.T
    np.fill_diagonal(sims, -np.inf)
    nn3 = np.argsort(-sims, axis=1)[:, :3]
    g_of = np.arange(VOCAB) % GROUPS
    same_group = float((g_of[nn3] == g_of[:, None]).mean())
    # chance of the self-excluded top 3: 9 same-group peers among 59 others
    chance = (VOCAB // GROUPS - 1) / (VOCAB - 1)
    print("nearest-neighbor same-group rate: %.3f (chance %.3f)" % (same_group, chance))
    assert same_group >= 0.6, "NCE embeddings failed to capture co-occurrence: %r" % same_group
    return {"same_group": same_group, "chance": chance}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
