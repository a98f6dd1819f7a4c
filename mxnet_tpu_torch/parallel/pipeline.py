"""GPipe pipeline over the 'pp' axis of a mesh (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

The JAX package runs one stage on each pp device inside ``shard_map`` and
moves activations stage to stage with ``ppermute`` over M + S - 1 ticks.

On logical ranks of one process the ranks take their turns within each
tick: at tick t every stage s runs ``stage_fn`` on what stage s - 1 sent at
tick t - 1 (stage 0 on microbatch min(t, M - 1)), and the last stage's
outputs of ticks t >= S - 1 are microbatch t - (S - 1)'s. The fill and
drain ticks compute what the JAX schedule computes there (on zeros, or on
the clamped last microbatch) and, as there, nothing of it reaches the
outputs. Gradients come through autograd, whose backward runs the ticks in
reverse.

Over a pp axis that spans processes each process runs its own stages (its
pp positions, a contiguous run; one stage a process with ``make_mesh(pp=P,
processes=P)``) on each microbatch in turn: the first stage feeds ``x[m]``,
every other receives microbatch m's activation from the process before it
(:func:`~.mesh.ppermute`, tagged m), and all but the last send their output
on. Backward runs the microbatches in reverse order on every process: the
last stage's gradient comes from the loss, every other receives its
output's gradient from the process after it and sends its input's gradient
back. The bubble ticks are not run: they reach no output, so the values and
gradients are those of the tick schedule. The loss is computed on the last
stage and summed over the pp processes with zeros elsewhere, so every
process returns the same scalar, as the JAX package's ``psum`` of the masked
loss does.

Layout as in the JAX package: ``stage_params`` is a dict (or nested dicts)
of tensors each leading with the S axis, ``x`` [M, mb, ...] microbatches,
and every stage's output has the shape and dtype of a microbatch of ``x``
(a stage's input is the feed or the received activation alike).
"""
from __future__ import annotations

import torch

from .mesh import axis_group, axis_size, ppermute, reduce_from_axis


def _stage_slice(params, s):
    if isinstance(params, dict):
        return {k: _stage_slice(v, s) for k, v in params.items()}
    return params[s]


def pipeline_stages(stage_fn, stage_params, x, n_stages):
    """GPipe forward: ``stage_fn(params_slice, act) -> act`` applied
    ``n_stages`` times in sequence, M microbatches streaming through with a
    bubble of S - 1 ticks. Returns the last stage's outputs [M, mb, ...] in
    microbatch order."""
    n_micro = x.shape[0]
    params = [_stage_slice(stage_params, s) for s in range(n_stages)]
    with torch.no_grad():
        zero_act = torch.zeros_like(stage_fn(params[0], x[0]))
    recv = [zero_act] * n_stages  # what each stage receives this tick
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        sent = []
        for s in range(n_stages):
            act_in = x[min(t, n_micro - 1)] if s == 0 else recv[s]
            sent.append(stage_fn(params[s], act_in))
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:
            outs[out_idx] = sent[-1]
        # ppermute s -> s + 1; stage 0 receives nothing (its feed is x)
        recv = [zero_act] + sent[:-1]
    return torch.stack(outs)


def _spread(act, n):
    """``act`` as one entry for each of a process's ``n`` pp positions."""
    return act.unsqueeze(0).expand((n,) + tuple(act.shape))


class _ProcessStages(torch.autograd.Function):
    """This process's stages over every microbatch, with the sends and
    receives to its neighbours on the pp axis (see the module docstring).
    Returns the last stage's outputs [M, mb, ...] on the last process,
    zeros on the others (as the JAX package's ``pipeline_stages``)."""

    @staticmethod
    def forward(ctx, stage_fn, grp, paths, need, x, *local):
        first, last = grp.index == 0, grp.index == grp.size - 1
        lo, hi, n = grp.positions[0], grp.positions[-1] + 1, grp.local
        ps = [p.detach().requires_grad_(need) for p in local]
        saved, outs = [], []
        for m in range(x.shape[0]):
            if first:
                inp = x[m].detach()
            else:
                inp = ppermute(_spread(x[m], n), [(lo - 1, lo)], grp, tag=m)[0]
            inp.requires_grad_(need and (not first or x.requires_grad))
            with torch.set_grad_enabled(need):
                a = inp
                for j in range(n):
                    a = stage_fn(_unflatten(paths, [p[j] for p in ps]), a)
            if last:
                outs.append(a.detach())
            else:
                ppermute(_spread(a.detach(), n), [(hi - 1, hi)], grp, tag=m)
            if need:
                saved.append((inp, a))
        ctx.stage = (grp, ps, saved, x.requires_grad)
        return torch.stack(outs) if last else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        grp, ps, saved, x_grad = ctx.stage
        first, last = grp.index == 0, grp.index == grp.size - 1
        lo, hi, n = grp.positions[0], grp.positions[-1] + 1, grp.local
        grads = [torch.zeros_like(p) for p in ps]
        gx = torch.zeros_like(g) if first and x_grad else None
        for m in reversed(range(len(saved))):  # one order on every process
            inp, a = saved[m]
            saved[m] = None
            if last:
                gm = g[m]
            else:
                gm = ppermute(_spread(a.detach(), n), [(hi, hi - 1)], grp, tag=m)[n - 1]
            want = ps + ([inp] if inp.requires_grad else [])
            res = torch.autograd.grad(a, want, gm, allow_unused=True)
            for acc, r in zip(grads, res):
                if r is not None:
                    acc += r
            if not first:
                ppermute(_spread(res[-1], n), [(lo, lo - 1)], grp, tag=m)
            elif gx is not None:
                gx[m] = res[-1]
        return (None, None, None, None, gx) + tuple(grads)


def _process_loss(stage_fn, loss_fn, params, x, y, grp):
    """The pipelined loss over a pp axis that spans processes."""
    paths, leaves = _flatten(params)
    lo, hi = grp.positions[0], grp.positions[-1] + 1
    local = [leaf[lo:hi] for leaf in leaves]  # the other stages' rows get zero gradients
    need = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in local))
    outs = _ProcessStages.apply(stage_fn, grp, paths, need, x, *local)
    if grp.index == grp.size - 1:
        part = loss_fn(outs, y).float()
    else:
        part = outs.sum().float() * 0.0  # zero, and backward reaches the stages
    return reduce_from_axis(part, grp)


def pipelined_loss(stage_fn, loss_fn, mesh, axis="pp"):
    """``loss(params, x, y)``: :func:`pipeline_stages` over the mesh's
    ``axis`` ranks (a :class:`~.mesh.Mesh` or a mapping of axis sizes),
    then ``loss_fn(last stage outputs, y) -> scalar``. Stage parameters lead
    with the S axis, whose length must be the axis's size. Over an axis that
    spans processes each process runs its own stages and reads its own rows
    of the stage parameters (see the module docstring), and the loss is a
    float32 scalar, the same on every process of the axis. Gradients of
    what every process holds whole are partial there: ``x``'s is the first
    stage's process's (zeros elsewhere) and those of what ``loss_fn`` reads
    the last stage's; the JAX package's transpose of a replicated input sums
    them over the axis, and a caller that keeps them replicated sums them
    too (``allreduce_sum(..., axis=)``)."""
    n_stages = axis_size(mesh, axis)
    grp = axis_group(mesh, axis) if getattr(mesh, "processes", 1) > 1 else None
    if grp is not None and grp.size <= 1:
        grp = None

    def loss(params, x, y):
        for leaf in _flatten(params)[1]:
            if leaf.shape[0] != n_stages:
                raise ValueError("stage parameters lead with the %s axis of %d stages, got "
                                 "a leaf of shape %s" % (axis, n_stages, tuple(leaf.shape)))
        if grp is not None:
            return _process_loss(stage_fn, loss_fn, params, x, y, grp)
        return loss_fn(pipeline_stages(stage_fn, params, x, n_stages), y)

    return loss


def _flatten(tree, prefix=()):
    """(paths, leaves) of a dict of dicts of tensors, in insertion order."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    paths, leaves = [], []
    for k, v in tree.items():
        p, lv = _flatten(v, prefix + (k,))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(paths, leaves):
    if paths == [()]:
        return leaves[0]
    tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
