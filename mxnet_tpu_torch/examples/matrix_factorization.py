"""Matrix-factorization recommender with the PyTorch port (counterpart of
``examples/matrix_factorization.py``; reference example/recommenders):
user and item embeddings whose dot product predicts the rating, trained
with a regression head on synthetic low-rank ratings::

    python -m mxnet_tpu_torch.examples.matrix_factorization [--ctx cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context


def build_sym(num_users, num_items, factor):
    user = mx.sym.Variable("user")
    item = mx.sym.Variable("item")
    score = mx.sym.Variable("score_label")
    u = mx.sym.Embedding(user, input_dim=num_users, output_dim=factor, name="user_embed")
    v = mx.sym.Embedding(item, input_dim=num_items, output_dim=factor, name="item_embed")
    pred = mx.sym.sum_axis(u * v, axis=1)
    return mx.sym.LinearRegressionOutput(pred, score, name="pred")


def make_data(args):
    """(data dict, float64 ratings) of ground-truth factors of rank --rank."""
    rng = np.random.RandomState(0)
    U = rng.randn(args.num_users, args.rank) * 0.8
    V = rng.randn(args.num_items, args.rank) * 0.8
    ui = rng.randint(0, args.num_users, args.num_ratings)
    vi = rng.randint(0, args.num_items, args.num_ratings)
    r = (U[ui] * V[vi]).sum(1) + rng.randn(args.num_ratings) * 0.1
    return {"user": ui.astype(np.float32), "item": vi.astype(np.float32)}, r


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--num-users", type=int, default=300)
    p.add_argument("--num-items", type=int, default=200)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--factor", type=int, default=8)
    p.add_argument("--num-ratings", type=int, default=30000)
    p.set_defaults(num_epochs=12, batch_size=500, lr=0.05)
    return p.parse_args(argv)


def run(args):
    """Train and score; returns {"mse", "variance"} (asserts the mse is
    below a fifth of the ratings' variance: the rank is recovered)."""
    ctx = get_context(args)
    np.random.seed(0)
    mx.random.seed(0)
    data, r = make_data(args)
    it = mx.io.NDArrayIter(data, {"score_label": r.astype(np.float32)},
                           batch_size=args.batch_size, shuffle=True)
    mod = mx.mod.Module(build_sym(args.num_users, args.num_items, args.factor), context=ctx,
                        data_names=["user", "item"], label_names=["score_label"])
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Normal(0.1), eval_metric=mx.metric.MSE(),
            num_epoch=args.num_epochs)
    it.reset()
    mse = dict(mod.score(it, mx.metric.MSE()))["mse"]
    var = float(r.var())
    print("rating mse: %.4f (rating variance %.4f)" % (mse, var))
    assert mse < var * 0.2, "factorization failed to recover the low-rank structure"
    return {"mse": mse, "variance": var}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
