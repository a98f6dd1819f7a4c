"""Train the transformer LM with the PyTorch port (counterpart of
``examples/train_transformer_lm.py``).

    python -m mxnet_tpu_torch.examples.train_transformer_lm [--cpu] [flags]

Same flags, defaults, synthetic corpus, loss and printed lines as the JAX
example. Each step is one forward through ``transformer_lm``'s
``apply_fn`` (attention through the CUDA flash kernels on the card), the
mean next-token NLL in f32 (plus 0.01 times the load-balance loss with
``--moe-experts``), ``loss.backward()`` (the flash-attention backward
kernels), and plain SGD ``p -= lr * g`` on f32 master parameters;
``--dtype`` is the compute dtype. It runs on the CUDA card unless
``--cpu`` is given. ``--moe-experts N`` swaps every second FFN for a
Switch-MoE block; ``--sp`` and ``--ep`` build a mesh of sp x ep logical
ranks on the one device: attention runs as ring attention over sp
sequence blocks, and the experts must divide by ep. ``--dp N`` splits the
batch over N data-parallel ranks, which may span the processes of a
launched job (``python -m mxnet_tpu_torch.tools.launch -n 2 python -m
mxnet_tpu_torch.examples.train_transformer_lm --dp 2``): each process
takes its ranks' rows, and its gradients (of the global batch's mean loss)
are summed across the processes of the gloo group before each step; the
printed loss is the global batch's. ``--tp`` > 1 raises
NotImplementedError (tensor parallelism needs the multi-card half of
ROADMAP Queue 1 step 8), and so do sp or ep > 1 across processes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..context import resolve_device
from ..models.transformer import _torch_dtype, params_from_jax, transformer_lm
from ..parallel import mesh as _mesh
from ..parallel.mesh import make_mesh

_NOT_PORTED = (
    ("tp", "tensor parallelism across cards (the multi-card half of ROADMAP Queue 1 step 8, "
           "param_specs)"),
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


def _allreduce_grads(params):
    """Every parameter's gradient summed across the processes, one
    collective a dtype."""
    grads = [p.grad for p in params.parameters()]
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        summed = _mesh.allreduce_sum(torch.cat([g.reshape(-1) for g in gs]))
        off = 0
        for g in gs:
            g.copy_(summed[off:off + g.numel()].view(g.shape))
            off += g.numel()


def check_supported(dp=None, tp=1, sp=1, ep=1, moe_experts=0, seq_len=None):
    """Raise for what the port cannot run: NotImplementedError for
    ``--tp`` > 1 and for sp or ep > 1 across processes, ValueError for a
    sequence that does not divide by sp or experts that do not divide by
    ep."""
    sizes = {"tp": tp}
    if _mesh.process_count() > 1 and sp * ep > 1:
        raise NotImplementedError(
            "--sp/--ep across %d processes need the multi-card half of ROADMAP Queue 1 "
            "step 8; across processes only --dp is ported" % _mesh.process_count())
    for axis, what in _NOT_PORTED:
        if sizes[axis] > 1:
            raise NotImplementedError(
                "--%s %d needs %s, which is not ported to PyTorch yet"
                % (axis, sizes[axis], what))
    if seq_len is not None and seq_len % sp:
        raise ValueError("--seq-len %d does not divide into --sp %d sequence blocks"
                         % (seq_len, sp))
    if moe_experts > 0 and moe_experts % ep:
        raise ValueError("--moe-experts %d do not shard over --ep %d" % (moe_experts, ep))


def train(vocab=256, d_model=256, n_heads=8, n_layers=4, d_ff=1024, seq_len=256,
          batch_size=8, steps=30, lr=3e-2, dtype="float32", device=None, dp=None,
          tp=1, sp=1, ep=1, moe_experts=0, log=print, on_step=None):
    """Train from ``init_fn(0)`` on the synthetic corpus; returns the
    per-step losses (floats). ``device`` defaults to the CUDA card;
    ``on_step(i, loss, params)``, if given, is called after each step's
    update with the loss tensor (not synchronised) and the parameters."""
    _mesh.init_distributed()  # a launched job's process group (else nothing)
    check_supported(dp, tp, sp, ep, moe_experts, seq_len)
    nproc, prank = _mesh.process_count(), _mesh.process_index()
    dp = dp or nproc
    if dp % nproc or batch_size % dp:
        raise ValueError("--dp %d must divide by the %d processes and divide --batch-size %d"
                         % (dp, nproc, batch_size))
    dev = resolve_device(device)
    init_fn, apply_fn = transformer_lm(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, dtype=_torch_dtype(dtype), moe_experts=moe_experts)
    log("device:", dev)
    mesh = None
    if sp * ep > 1:
        mesh = make_mesh(sp=sp, ep=ep, devices=[dev] * (sp * ep))
        log("mesh:", mesh.shape)
    if dp > 1:
        log("mesh: dp %d over %d process(es), %d rank(s) in this one"
            % (dp, nproc, dp // nproc))
    seq = torch.from_numpy(corpus(vocab, batch_size, seq_len).astype(np.int64)).to(dev)
    rows = batch_size // nproc  # this process's ranks' rows of the global batch
    seq = seq[prank * rows:(prank + 1) * rows]
    tokens, targets = seq[:, :-1], seq[:, 1:]
    params = params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    params.requires_grad_()

    losses = []
    t0 = time.time()
    for i in range(steps):
        out = apply_fn(params, tokens, mesh=mesh if sp > 1 else None)
        logits, aux = out if moe_experts else (out, 0.0)
        loss = lm_loss(logits, targets) + 0.01 * aux
        if nproc > 1:
            # the global batch's mean: this process's share, summed across
            loss = loss / nproc
        loss.backward()
        if nproc > 1:
            _allreduce_grads(params)
            loss = _mesh.allreduce_sum(loss.detach())
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
