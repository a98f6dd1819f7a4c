"""Helpers every image-classification model of the port shares: the
JAX package's numpy initialisation of a symbol's parameters (the one
``bench.py:797-813`` and ``benchmarks/model_sweep.py:75-90`` both make),
the carriage of name -> numpy dicts to and from torch tensors (what both
packages take, so the JAX package's parameters cross into the port), and
the list of a symbol's convolutions with their shapes."""
from __future__ import annotations

import numpy as np
import torch

from ..context import resolve_device


def init_params(symbol, data_shape, seed=0):
    """Random weights for ``symbol`` at input ``data_shape`` (N, C, H, W), as
    ``bench.py``'s ResNet-50 row and the model sweep make them: gammas 1,
    betas and biases 0, every other argument N(0, 2 / fan_in) (He-normal)
    from ``RandomState(seed)`` in ``list_arguments`` order; moving means 0
    and moving vars 1. Returns
    ``(arg_params, aux_params)``, name -> f32 numpy array."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data=tuple(data_shape), softmax_label=(data_shape[0],))
    rng = np.random.RandomState(seed)
    params = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            params[n] = np.ones(s, np.float32)
        elif n.endswith(("_beta", "_bias")):
            params[n] = np.zeros(s, np.float32)
        else:
            fan_in = int(np.prod(s[1:])) or 1
            params[n] = (rng.randn(*s) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    aux = {n: (np.ones(s, np.float32) if n.endswith("var") else np.zeros(s, np.float32))
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return params, aux


def params_from_numpy(arg_params, aux_params, device=None, dtype=torch.float32):
    """Name -> numpy dicts as torch tensors on ``device`` (default: the
    card): the arguments in ``dtype``, the aux states in f32 (moving stats
    stay f32 in every recipe)."""
    device = resolve_device(device)
    # torch.tensor copies: a step that updates the tensors in place leaves
    # the caller's arrays as they were
    args = {n: torch.tensor(np.asarray(v, np.float32)).to(device, dtype)
            for n, v in arg_params.items()}
    aux = {n: torch.tensor(np.asarray(v, np.float32)).to(device, torch.float32)
           for n, v in aux_params.items()}
    return args, aux


def grads_to_numpy(grads):
    """Name -> tensor dict as name -> f32 numpy array."""
    return {n: g.detach().float().cpu().numpy() for n, g in grads.items()}


def conv_layers(symbol, data_shape):
    """Every Convolution node of ``symbol`` at input ``data_shape``, in
    topological order: dicts of name, data / weight / output shapes,
    stride, pad, dilate and groups, with the forward's multiply-adds
    counted as ``flops`` = 2·N·OH·OW·O·(C/groups)·kh·kw."""
    from ..ops.nn import _conv_dims

    known = symbol._infer_shape_impl(
        False, data=tuple(data_shape), softmax_label=(data_shape[0],))[3]
    out = []
    for node in symbol._nodes():
        if node.is_variable or node.op.name != "Convolution":
            continue
        attrs = node.canon_attrs()
        kernel, stride, dilate, pad = _conv_dims(attrs)
        (dnode, di), (wnode, wi) = node.inputs[0], node.inputs[1]
        dshape, wshape = known[(id(dnode), di)], known[(id(wnode), wi)]
        oshape = known[(id(node), 0)]
        out.append({
            "name": node.name, "data": tuple(dshape), "weight": tuple(wshape),
            "out": tuple(oshape), "stride": stride, "pad": pad, "dilate": dilate,
            "groups": int(attrs.get("num_group", 1)),
            "flops": 2.0 * float(np.prod(oshape)) * float(np.prod(wshape[1:])),
        })
    return out
