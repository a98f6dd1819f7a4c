"""Switch mixture-of-experts FFN (counterpart of
``mxnet_tpu/parallel/moe.py``).

Top-1 routing with a capacity limit, in the JAX package's dense-dispatch
formulation: the router's logits, softmax and one-hot dispatch / combine
tensors [tokens, E, C] in f32, the expert FFN as batched products over
[E, C, d] in the caller's dtype, tokens past an expert's capacity dropped
(they contribute 0), and the Switch Transformer's load-balance loss
``E * sum_e frac_tokens_e * mean_prob_e``. The dispatch, expert and
combine products are einsums, as in the JAX package, where no Pallas
kernel computes them either.

Expert parallelism: in the JAX package the expert-major weights carry
``PartitionSpec("ep", ...)`` and GSPMD inserts the all-to-alls. On logical
ep ranks of one device the experts stay whole on it and the numbers are
those of one device, as the JAX package's sharded run is (the trainer still
refuses experts that do not divide by ep, as JAX's ``device_put`` of that
spec does). Where the ep axis spans processes (``ep=``, the axis's
:class:`~.mesh.AxisGroup`), each process holds the experts of its ep
positions, E / ep whole experts a position (``moe_partition_specs``). The
batch is replicated over ep (the JAX trainer's ``data_spec`` is
``P("dp")``), so every process routes every token alike; each runs its own
experts on their slots of the dispatched ``[E, C, d]`` tokens, and the
combined outputs are summed over the ep processes (Megatron's *g*). No
all-to-all is needed. The tokens and the chosen expert's probability enter
that region through Megatron's *f*, so their gradients, partial in each
process, are summed backward; the load-balance loss comes from the
replicated router and is every process's alike.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import mesh as _mesh


def init_moe_params(seed, d_model, d_hidden, num_experts, dtype=torch.float32, device=None):
    """Router and expert weights, the JAX package's ``RandomState(seed)``
    draws in its order: ``gate_w`` [d_model, E], ``w_up`` [E, d_model,
    d_hidden], ``w_down`` [E, d_hidden, d_model] (expert-major, so the ep
    spec shards whole experts)."""
    from ..context import resolve_device

    r = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(d_model)
    host = {
        "gate_w": r.randn(d_model, num_experts) * scale,
        "w_up": r.randn(num_experts, d_model, d_hidden) * scale,
        "w_down": r.randn(num_experts, d_hidden, d_model) / np.sqrt(d_hidden),
    }
    dev = resolve_device(device)
    # f64 draws rounded to f32 (jnp.asarray's rounding in f32), then to dtype
    return {k: torch.from_numpy(v.astype(np.float32)).to(device=dev, dtype=dtype)
            for k, v in host.items()}


def moe_partition_specs():
    """The spec of each :func:`init_moe_params` tensor on a (dp, ..., ep)
    mesh, as a tuple of axis names (``PartitionSpec``'s entries): the
    router replicated, whole experts over ep."""
    return {"gate_w": (), "w_up": ("ep", None, None), "w_down": ("ep", None, None)}


def switch_moe(params, x, capacity_factor=1.25, ep=None):
    """Top-1 MoE FFN. x: [tokens, d_model] -> ([tokens, d_model] in x's
    dtype, f32 aux loss). ``params`` maps ``gate_w``, ``w_up``, ``w_down``
    to tensors (any dtype: the router reads them in f32, the experts in x's
    dtype); differentiable in x and the weights. ``ep``, the ep axis's
    :class:`~.mesh.AxisGroup` of a mesh that spans processes: ``w_up`` and
    ``w_down`` are then this process's experts (see the module
    docstring)."""
    tokens, _ = x.shape
    num_experts = params["gate_w"].shape[1]
    capacity = int(max(1, tokens * capacity_factor / num_experts))

    logits = x.float() @ params["gate_w"].float()
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    expert_idx = torch.argmax(probs, dim=-1)  # [T], the first maximum as jnp.argmax
    expert_prob = probs.gather(-1, expert_idx[:, None])[:, 0]  # [T]
    assign = F.one_hot(expert_idx, num_experts).float()

    # position of each token within its expert's queue; >= capacity drops
    pos_in_expert = (assign.cumsum(0) - assign) * assign  # [T, E]
    keep = (pos_in_expert < capacity) * assign  # [T, E]
    pos = pos_in_expert.sum(-1).long()  # [T]
    # one_hot of a position past the capacity is a zero row, as jax.nn.one_hot's
    pos_hot = (pos[:, None] == torch.arange(capacity, device=x.device)).float()  # [T, C]

    dispatch = keep[:, :, None] * pos_hot[:, None, :]  # [T, E, C]
    x_in = x
    if ep is not None and ep.size > 1:
        # this process's experts: E / ep of them at each of its positions
        local = params["w_up"].shape[0]
        e0 = ep.positions[0] * local // ep.local
        dispatch = dispatch[:, e0:e0 + local]
        expert_prob = _mesh.copy_to_axis(expert_prob, ep)
        x_in = _mesh.copy_to_axis(x, ep)
    combine = dispatch * expert_prob[:, None, None]  # [T, E, C]

    cdtype = x.dtype
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(cdtype), x_in)
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, params["w_up"].to(cdtype)))
    expert_out = torch.einsum("ech,ehd->ecd", h, params["w_down"].to(cdtype))
    y = torch.einsum("tec,ecd->td", combine.to(cdtype), expert_out)
    if ep is not None:
        y = _mesh.reduce_from_axis(y, ep)

    frac_tokens = assign.mean(0)
    mean_prob = probs.mean(0)
    aux_loss = num_experts * torch.sum(frac_tokens * mean_prob)
    return y.to(x.dtype), aux_loss

