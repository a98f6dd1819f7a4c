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
ranks: attention runs as ring attention over sp sequence blocks, and the
experts must divide by ep. ``--tp N`` shards the attention heads and the FFN
columns over N ranks in Megatron's layout (``models/transformer.py``:
``wq wk wv w1`` by columns, ``wo w2`` by rows, the rest replicated).
``--dp N`` splits the batch over N data-parallel ranks. The mesh is
dp x tp x sp x ep (dp defaults to what is left of the processes) and may
span the processes of a launched job (``python -m
mxnet_tpu_torch.tools.launch -n 2 python -m
mxnet_tpu_torch.examples.train_transformer_lm --tp 2``), in JAX's rank
order: each process holds its ranks' shards of the parameters
(``shard_params``), its dp rows of the batch and its sp block of the
sequence, and the batch is replicated over tp and ep. Gradients are summed
over the processes along which the batch is split (dp, and sp along the
sequence; the loss is each process's share of the global batch's mean);
a parameter sharded on an axis is never summed over it, and a replicated
one gets the same gradient on every tp and ep rank. The printed loss is the
global batch's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..context import resolve_device
from ..models.transformer import _torch_dtype, params_from_jax, shard_params, transformer_lm
from ..parallel import mesh as _mesh
from ..parallel.mesh import make_mesh


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


def allreduce_grads(params, axis=None, mesh=None):
    """Every parameter's gradient summed across the processes (of one mesh
    axis with ``axis``), one collective a dtype."""
    grads = [p.grad for p in params.parameters()]
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        summed = _mesh.allreduce_sum(torch.cat([g.reshape(-1) for g in gs]), axis=axis,
                                     mesh=mesh)
        off = 0
        for g in gs:
            g.copy_(summed[off:off + g.numel()].view(g.shape))
            off += g.numel()


def check_supported(dp=None, tp=1, sp=1, ep=1, moe_experts=0, seq_len=None, n_heads=None,
                    d_ff=None):
    """Raise ValueError for what the mesh cannot split: a sequence that does
    not divide by sp, experts that do not divide by ep, heads or FFN columns
    that do not divide by tp."""
    if n_heads is not None and n_heads % tp:
        raise ValueError("--n-heads %d do not shard over --tp %d" % (n_heads, tp))
    if d_ff is not None and d_ff % tp:
        raise ValueError("--d-ff %d does not shard over --tp %d" % (d_ff, tp))
    if seq_len is not None and seq_len % sp:
        raise ValueError("--seq-len %d does not divide into --sp %d sequence blocks"
                         % (seq_len, sp))
    if moe_experts > 0 and moe_experts % ep:
        raise ValueError("--moe-experts %d do not shard over --ep %d" % (moe_experts, ep))


def describe_mesh(mesh):
    """The mesh line: its axes, and which processes and ranks hold them."""
    shape = " x ".join("%s %d" % (ax, n) for ax, n in mesh.shape.items() if n > 1) or "dp 1"
    line = "%s over %d process(es), %d rank(s) in this one" % (shape, mesh.processes,
                                                               mesh.size)
    if mesh.processes > 1:
        held = ["%s %s" % (ax, _mesh.axis_group(mesh, ax).positions)
                for ax, n in mesh.shape.items() if n > 1]
        line += " (process %d holds %s)" % (mesh.process_rank, ", ".join(held))
    return line


def train(vocab=256, d_model=256, n_heads=8, n_layers=4, d_ff=1024, seq_len=256,
          batch_size=8, steps=30, lr=3e-2, dtype="float32", device=None, dp=None,
          tp=1, sp=1, ep=1, moe_experts=0, log=print, on_step=None, on_grads=None,
          on_mesh=None):
    """Train from ``init_fn(0)`` on the synthetic corpus; returns the
    per-step losses (floats). ``device`` defaults to the CUDA card;
    ``on_step(i, loss, params)``, if given, is called after each step's
    update with the loss tensor (not synchronised) and the parameters;
    ``on_grads(i, params)`` before the update, the parameters' ``.grad``
    summed as the update reads them; ``on_mesh(mesh)`` once with the mesh
    (None without one) before the first step."""
    _mesh.init_distributed()  # a launched job's process group (else nothing)
    check_supported(dp, tp, sp, ep, moe_experts, seq_len, n_heads, d_ff)
    nproc = _mesh.process_count()
    model = tp * sp * ep
    dp = dp or max(1, nproc // model)
    if (dp * model) % nproc or batch_size % dp:
        raise ValueError("a mesh of dp %d x tp %d x sp %d x ep %d does not split over %d "
                         "processes, or --dp does not divide --batch-size %d"
                         % (dp, tp, sp, ep, nproc, batch_size))
    dev = resolve_device(device)
    init_fn, apply_fn = transformer_lm(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, dtype=_torch_dtype(dtype), moe_experts=moe_experts)
    log("device:", dev)
    mesh = None
    if dp * model > 1:
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, ep=ep, devices=[dev] * (dp * model // nproc),
                         processes=nproc)
        # one process without dp: the JAX example's line, the axis sizes
        # one string: the launched processes share a stdout, write by write
        log("mesh: %s" % (mesh.shape if mesh.processes == 1 and dp == 1
                          else describe_mesh(mesh),))
    seq = torch.from_numpy(corpus(vocab, batch_size, seq_len).astype(np.int64)).to(dev)
    # this process's dp rows and sp block of the global batch
    dp_grp = sp_grp = None
    if mesh is not None:
        dp_grp, sp_grp = _mesh.axis_group(mesh, "dp"), _mesh.axis_group(mesh, "sp")
        rows, cols = batch_size // dp, seq_len // sp
        seq = seq[rows * dp_grp.positions[0]:rows * (dp_grp.positions[-1] + 1)]
        tokens = seq[:, :-1][:, cols * sp_grp.positions[0]:cols * (sp_grp.positions[-1] + 1)]
        targets = seq[:, 1:][:, cols * sp_grp.positions[0]:cols * (sp_grp.positions[-1] + 1)]
    else:
        tokens, targets = seq[:, :-1], seq[:, 1:]
    # the processes along which the batch is split: the gradients sum over them
    split = 1 if mesh is None else dp_grp.size * sp_grp.size
    params = params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    if mesh is not None:
        params = shard_params(params, mesh)
    params.requires_grad_()
    if on_mesh is not None:
        on_mesh(mesh)

    losses = []
    t0 = time.time()
    for i in range(steps):
        out = apply_fn(params, tokens, mesh=mesh)
        logits, aux = out if moe_experts else (out, 0.0)
        loss = lm_loss(logits, targets) + 0.01 * aux
        if split > 1:
            # the global batch's mean: this process's share, summed across
            loss = loss / split
        loss.backward()
        if split > 1:
            for grp in (dp_grp, sp_grp):
                if grp.size > 1:
                    allreduce_grads(params, axis=grp)
                    loss = _mesh.allreduce_sum(loss.detach(), axis=grp)
        if on_grads is not None:
            on_grads(i, params)
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
