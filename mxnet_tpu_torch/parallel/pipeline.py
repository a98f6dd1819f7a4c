"""GPipe pipeline over the 'pp' axis of a mesh (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

The JAX package runs one stage on each pp device inside ``shard_map`` and
moves activations stage to stage with ``ppermute`` over M + S - 1 ticks.
The port's pp ranks are logical ranks of one device, so the ranks take
their turns within each tick: at tick t every stage s runs ``stage_fn`` on
what stage s - 1 sent at tick t - 1 (stage 0 on microbatch min(t, M - 1)),
and the last stage's outputs of ticks t >= S - 1 are microbatch
t - (S - 1)'s. The fill and drain ticks compute what the JAX schedule
computes there (on zeros, or on the clamped last microbatch) and, as
there, nothing of it reaches the outputs. Gradients come through autograd,
whose backward runs the ticks in reverse.

Layout as in the JAX package: ``stage_params`` is a dict (or nested dicts)
of tensors each leading with the S axis, ``x`` [M, mb, ...] microbatches.
"""
from __future__ import annotations

import torch

from .mesh import axis_size


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


def pipelined_loss(stage_fn, loss_fn, mesh, axis="pp"):
    """``loss(params, x, y)``: :func:`pipeline_stages` over the mesh's
    ``axis`` ranks (a :class:`~.mesh.Mesh` or a mapping of axis sizes),
    then ``loss_fn(last stage outputs, y) -> scalar``. Stage parameters lead
    with the S axis, whose length must be the axis's size."""
    n_stages = axis_size(mesh, axis)

    def loss(params, x, y):
        for leaf in _leaves(params):
            if leaf.shape[0] != n_stages:
                raise ValueError("stage parameters lead with the %s axis of %d stages, got "
                                 "a leaf of shape %s" % (axis, n_stages, tuple(leaf.shape)))
        return loss_fn(pipeline_stages(stage_fn, params, x, n_stages), y)

    return loss


def _leaves(tree):
    if not isinstance(tree, dict):
        yield tree
        return
    for v in tree.values():
        yield from _leaves(v)
