"""Deep Embedded Clustering with the PyTorch port (counterpart of
``examples/dec_clustering.py``; reference example/dec): pretrain an
autoencoder, k-means the embeddings, then refine the encoder and the
cluster centers together by matching the soft assignment Q to the
sharpened target P (minimising KL(P || Q))::

    python -m mxnet_tpu_torch.examples.dec_clustering [--ctx cpu]

The refinement's loss is ``MakeLoss(-sum(P * log Q))`` with the centers a
trainable free Variable, and P recomputed on the host each round. The
clustering accuracy (the best cluster -> label map) must survive the
refinement.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context, load_digits

DIMS = (64, 48, 10)  # input -> hidden -> embedding
K = 10


def encoder(data):
    x = data
    for i, h in enumerate(DIMS[1:], 1):
        x = mx.sym.FullyConnected(x, num_hidden=h, name="enc%d" % i)
        if i < len(DIMS) - 1:
            x = mx.sym.Activation(x, act_type="relu")
    return x


def build_ae():
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("recon_label")
    x = encoder(data)
    for i, h in enumerate(reversed(DIMS[:-1]), 1):
        x = mx.sym.FullyConnected(x, num_hidden=h, name="dec%d" % i)
        if i < len(DIMS) - 1:
            x = mx.sym.Activation(x, act_type="relu")
    return mx.sym.LinearRegressionOutput(x, label, name="recon")


def build_dec():
    """The encoder and the soft assignment Q against trainable centers; the
    target distribution P arrives as the label."""
    data = mx.sym.Variable("data")
    p = mx.sym.Variable("p_label")
    z = encoder(data)  # (B, D)
    mu = mx.sym.Variable("centers", shape=(K, DIMS[-1]), init=mx.init.Normal(0.1))
    zb = mx.sym.expand_dims(z, axis=1)  # (B, 1, D)
    mub = mx.sym.expand_dims(mu, axis=0)  # (1, K, D)
    d2 = mx.sym.sum_axis(mx.sym.square(mx.sym.broadcast_sub(zb, mub)), axis=2)  # (B, K)
    q = 1.0 / (1.0 + d2)
    qn = mx.sym.broadcast_div(q, mx.sym.sum_axis(q, axis=1, keepdims=True))
    loss = mx.sym.sum_axis(-p * mx.sym.log(qn + 1e-10), axis=1)
    return mx.sym.Group([mx.sym.MakeLoss(mx.sym.mean(loss)), mx.sym.BlockGrad(qn, name="q")])


def kmeans(Z, k, rng, iters=50):
    centers = Z[rng.choice(len(Z), k, replace=False)]
    for _ in range(iters):
        assign = ((Z[:, None, :] - centers[None]) ** 2).sum(2).argmin(1)
        for j in range(k):
            pts = Z[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return centers, assign


def cluster_acc(assign, labels):
    """Best cluster -> label mapping accuracy (Hungarian)."""
    from scipy.optimize import linear_sum_assignment

    w = np.zeros((K, K))
    for a, lab in zip(assign, labels.astype(int)):
        w[a, lab] += 1
    r, c = linear_sum_assignment(-w)
    return w[r, c].sum() / len(assign)


def target_p(qn):
    f = qn.sum(0, keepdims=True)
    p = (qn ** 2) / f
    return p / p.sum(1, keepdims=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(ap)
    ap.add_argument("--refine-rounds", type=int, default=6)
    ap.set_defaults(num_epochs=25, batch_size=100, lr=0.01)
    return ap.parse_args(argv)


def run(args):
    """Pretrain, initialise, refine; returns {"init_acc", "refined_acc"}
    (asserts the refined accuracy within 0.02 of the k-means one and at
    least 0.6)."""
    ctx = get_context(args)
    one_ctx = ctx[0] if isinstance(ctx, list) else ctx
    np.random.seed(0)
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    d = load_digits()
    X = (d.images / 16.0).astype(np.float32).reshape(-1, 64)
    y = d.target.astype(np.float32)
    n = (len(X) // args.batch_size) * args.batch_size
    X, y = X[:n], y[:n]

    # stage 1: the autoencoder
    it = mx.io.NDArrayIter(X, X, batch_size=args.batch_size, shuffle=True,
                           label_name="recon_label")
    ae = mx.mod.Module(build_ae(), context=ctx, label_names=["recon_label"])
    ae.fit(it, optimizer="adam", optimizer_params={"learning_rate": 0.02},
           initializer=mx.init.Xavier(), num_epoch=args.num_epochs)
    ae_args, _ = ae.get_params()

    # stage 2: embed and k-means
    dec = mx.mod.Module(build_dec(), context=one_ctx, label_names=["p_label"])
    dec.bind(data_shapes=[("data", (n, 64))], label_shapes=[("p_label", (n, K))])
    dec.init_params(mx.init.Xavier())
    dec.set_params({k: v for k, v in ae_args.items() if k.startswith("enc")}, {},
                   allow_missing=True)
    batch = mx.io.DataBatch([mx.nd.array(X)], [mx.nd.zeros((n, K))])
    enc_exe = encoder(mx.sym.Variable("data")).simple_bind(ctx=one_ctx, data=(n, 64),
                                                           grad_req="null")
    for k_, v in dec.get_params()[0].items():
        if k_ in enc_exe.arg_dict and k_ != "data":
            enc_exe.arg_dict[k_][:] = v.asnumpy()
    enc_exe.arg_dict["data"][:] = X
    Z = enc_exe.forward(is_train=False)[0].asnumpy()
    centers, assign0 = kmeans(Z, K, rng)
    acc0 = cluster_acc(assign0, y)
    dec.set_params({"centers": mx.nd.array(centers)}, {}, allow_missing=True, force_init=True)

    # stage 3: KL(P || Q), P refreshed each round
    dec.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": args.lr, "rescale_grad": 1.0},
                       force_init=True)
    for r in range(args.refine_rounds):
        dec.forward(batch, is_train=False)
        P = target_p(dec.get_outputs()[1].asnumpy()).astype(np.float32)
        b2 = mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(P)])
        for _ in range(12):
            dec.forward(b2, is_train=True)
            dec.backward()
            dec.update()
        dec.forward(batch, is_train=False)
        print("round %d cluster acc %.3f"
              % (r, cluster_acc(dec.get_outputs()[1].asnumpy().argmax(1), y)))
    dec.forward(batch, is_train=False)
    acc1 = cluster_acc(dec.get_outputs()[1].asnumpy().argmax(1), y)
    print("k-means init acc %.3f -> DEC refined acc %.3f" % (acc0, acc1))
    assert acc1 >= acc0 - 0.02, (acc0, acc1)
    assert acc1 >= 0.6, acc1
    return {"init_acc": float(acc0), "refined_acc": float(acc1)}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
