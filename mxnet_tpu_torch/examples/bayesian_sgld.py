"""SGLD posterior sampling held to the analytic posterior, with the PyTorch
port (counterpart of ``examples/bayesian_sgld.py``; reference
example/bayesian-methods: stochastic gradient Langevin dynamics as an mx
Optimizer)::

    python -m mxnet_tpu_torch.examples.bayesian_sgld [--ctx cpu]

Bayesian linear regression has a closed form, so the sample mean and the
per-dimension spread of ``optimizer='sgld'`` on the exact log-posterior
gradients are held to the analytic N(mu, Sigma).

Model: y = Xw + eps, eps ~ N(0, s2); prior w ~ N(0, I).
Posterior: Sigma = (X'X / s2 + I)^-1, mu = Sigma X'y / s2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context

DIM = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--n-data", type=int, default=512)
    p.add_argument("--burnin", type=int, default=2000)
    p.add_argument("--samples", type=int, default=6000)
    p.set_defaults(lr=1e-4)
    return p.parse_args(argv)


def run(args):
    """Sample; returns {"mean_err", "std_ratio", "draws"} (asserts the mean
    within 3.5 posterior stds and each std within 35%)."""
    rng = np.random.RandomState(0)
    s2 = 0.25  # noise variance
    w_true = rng.randn(DIM)
    X = rng.randn(args.n_data, DIM)
    y = X @ w_true + rng.randn(args.n_data) * np.sqrt(s2)
    prior_prec = 1.0  # w ~ N(0, I)
    A = X.T @ X / s2 + prior_prec * np.eye(DIM)
    Sigma = np.linalg.inv(A)
    mu = Sigma @ (X.T @ y / s2)

    # SGLD on U(w) = ||y - Xw||^2 / (2 s2) + prior_prec ||w||^2 / 2, the
    # whole data's gradient each step
    opt = mx.optimizer.create("sgld", learning_rate=args.lr, wd=0.0, rescale_grad=1.0)
    updater = mx.optimizer.get_updater(opt)
    mx.random.seed(1)
    w = mx.nd.zeros((DIM,))
    draws = []
    for t in range(args.burnin + args.samples):
        wn = w.asnumpy()
        g = X.T @ (X @ wn - y) / s2 + prior_prec * wn
        updater(0, mx.nd.array(g.astype(np.float32)), w)
        if t >= args.burnin:
            draws.append(w.asnumpy().copy())
    draws = np.asarray(draws)
    mean_err = np.abs(draws.mean(0) - mu).max()
    std_ratio = draws.std(0) / np.sqrt(np.diag(Sigma))
    print("posterior mean |err|_max: %.4f  (posterior std ~ %.4f)"
          % (mean_err, float(np.sqrt(np.diag(Sigma)).mean())))
    print("posterior std ratio (sampled/analytic):", np.round(std_ratio, 2))
    assert mean_err < 3.5 * np.sqrt(np.diag(Sigma)).max(), mean_err
    assert np.all(std_ratio > 0.65) and np.all(std_ratio < 1.35), std_ratio
    print("SGLD matches the analytic posterior")
    return {"mean_err": float(mean_err), "std_ratio": std_ratio.tolist(), "draws": draws}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
