"""Train the transformer LM with the PyTorch port (counterpart of
``examples/train_transformer_lm.py``).

    python -m mxnet_tpu_torch.examples.train_transformer_lm [--cpu] [flags]

Same flags, defaults, synthetic corpus, loss and printed lines as the JAX
example. Each step is one forward through ``transformer_lm``'s
``apply_fn`` (attention through the CUDA flash kernels on the card), the
mean next-token NLL in f32, ``loss.backward()`` (the flash-attention
backward kernels), and plain SGD ``p -= lr * g`` on f32 master
parameters; ``--dtype`` is the compute dtype. It runs on the CUDA card
unless ``--cpu`` is given. The mesh flags (``--dp/--tp/--sp/--ep`` > 1) and
``--moe-experts`` raise NotImplementedError: the modules they need are not
ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..context import resolve_device
from ..models.transformer import _torch_dtype, params_from_jax, transformer_lm

_NOT_PORTED = (
    ("dp", "data parallelism over a device mesh (mxnet_tpu/parallel/mesh.py)"),
    ("tp", "tensor parallelism over a device mesh (mxnet_tpu/parallel/mesh.py)"),
    ("sp", "sequence parallelism, ring attention (mxnet_tpu/parallel/ring_attention.py)"),
    ("ep", "expert parallelism (mxnet_tpu/parallel/moe.py)"),
)


def corpus(vocab, batch_size, seq_len):
    """The JAX example's synthetic corpus, draw for draw: next char =
    (2*c + 1) % vocab with 5% noise. Returns int32 [batch_size, seq_len + 1];
    tokens are ``[:, :-1]`` and targets ``[:, 1:]``."""
    rng = np.random.RandomState(0)
    seq = np.zeros((batch_size, seq_len + 1), np.int32)
    seq[:, 0] = rng.randint(0, vocab, batch_size)
    for t in range(seq_len):
        nxt = (2 * seq[:, t] + 1) % vocab
        noise = rng.rand(batch_size) < 0.05
        seq[:, t + 1] = np.where(noise, rng.randint(0, vocab, batch_size), nxt)
    return seq


def lm_loss(logits, targets):
    """Mean next-token NLL, the log-softmax in f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, targets[..., None]).mean()


def sgd_step(params, lr):
    """``p -= lr * g`` for every parameter, in place; clears the gradients."""
    with torch.no_grad():
        for p in params.parameters():
            p.sub_(lr * p.grad.to(p.dtype))
            p.grad = None


def check_supported(dp=None, tp=1, sp=1, ep=1, moe_experts=0):
    """Raise NotImplementedError for what the port cannot run yet."""
    sizes = {"dp": dp or 1, "tp": tp, "sp": sp, "ep": ep}
    for axis, what in _NOT_PORTED:
        if sizes[axis] > 1:
            raise NotImplementedError(
                "--%s %d needs %s, which is not ported to PyTorch yet"
                % (axis, sizes[axis], what))
    if moe_experts > 0:
        raise NotImplementedError(
            "--moe-experts needs Switch-MoE layers (mxnet_tpu/parallel/moe.py), "
            "which are not ported to PyTorch yet")


def train(vocab=256, d_model=256, n_heads=8, n_layers=4, d_ff=1024, seq_len=256,
          batch_size=8, steps=30, lr=3e-2, dtype="float32", device=None, dp=None,
          tp=1, sp=1, ep=1, moe_experts=0, log=print, on_step=None):
    """Train from ``init_fn(0)`` on the synthetic corpus; returns the
    per-step losses (floats). ``device`` defaults to the CUDA card;
    ``on_step(i, loss, params)``, if given, is called after each step's
    update with the loss tensor (not synchronised) and the parameters."""
    check_supported(dp, tp, sp, ep, moe_experts)
    dev = resolve_device(device)
    init_fn, apply_fn = transformer_lm(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, dtype=_torch_dtype(dtype))
    log("device:", dev)
    seq = torch.from_numpy(corpus(vocab, batch_size, seq_len).astype(np.int64)).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    params = params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    params.requires_grad_()

    losses = []
    t0 = time.time()
    for i in range(steps):
        loss = lm_loss(apply_fn(params, tokens), targets)
        loss.backward()
        sgd_step(params, lr)
        loss = loss.detach()
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss, params)
        if i % 5 == 0 or i == steps - 1:
            log("step %3d  loss %.4f  (%.1fs)" % (i, float(loss), time.time() - t0))
    losses = [float(x) for x in losses]
    if losses:
        log("done: final loss %.4f" % losses[-1])
    return losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--cpu", action="store_true", help="run on the host instead of the CUDA card")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    train(vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
          n_layers=args.n_layers, d_ff=args.d_ff, seq_len=args.seq_len,
          batch_size=args.batch_size, steps=args.steps, lr=args.lr, dtype=args.dtype,
          device="cpu" if args.cpu else None, dp=args.dp, tp=args.tp, sp=args.sp,
          ep=args.ep, moe_experts=args.moe_experts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
