"""Fused optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``): sgd_update, sgd_mom_update,
adam_update, rmsprop_update, rmspropalex_update.

The update math and its order are the JAX package's (reference
``optimizer_op-inl.h``):
  rescaled = clip(rescale_grad * grad, clip_gradient) + wd * weight
The updated states come back as trailing outputs under ``mutate_inputs``;
the imperative layer writes them into the state arrays in place.

``lr`` of sgd_update, sgd_mom_update and adam_update is a number or a 0-d
f32 tensor on the weight's device, read where it lies: a grouped step
(``ShardedTrainStep.call_multi``) captured into a CUDA graph takes each
micro-step's lr from memory the host writes before each replay, since a
number would be baked into the capture. ``f32(lr)`` as a tensor gives the
bits of ``lr`` as a number.
"""
from __future__ import annotations

import torch

from .registry import OpDef, register


def _prep_grad(weight, grad, attrs):
    g = grad * float(attrs.get("rescale_grad", 1.0))
    clip = attrs.get("clip_gradient", -1.0)
    if clip is not None and float(clip) > 0:
        g = torch.clamp(g, -float(clip), float(clip))
    return g + float(attrs.get("wd", 0.0)) * weight


def _lr(attrs):
    """The step's lr: a 0-d tensor as it is (no host read), else a number."""
    lr = attrs["lr"]
    return lr if torch.is_tensor(lr) else float(lr)


_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0}


def _sgd_update(attrs, ins, is_train):
    weight, grad = ins
    g = _prep_grad(weight, grad, attrs)
    return [weight - _lr(attrs) * g]


register(
    OpDef(
        "sgd_update",
        _sgd_update,
        arguments=("weight", "grad"),
        defaults=dict(_COMMON),
    )
)


def _sgd_mom_update(attrs, ins, is_train):
    weight, grad, mom = ins
    g = _prep_grad(weight, grad, attrs)
    new_mom = float(attrs.get("momentum", 0.0)) * mom - _lr(attrs) * g
    return [weight + new_mom, new_mom]


register(
    OpDef(
        "sgd_mom_update",
        _sgd_mom_update,
        arguments=("weight", "grad", "mom"),
        defaults=dict(_COMMON, momentum=0.0),
        mutate_inputs=(2,),
    )
)


def _adam_update(attrs, ins, is_train):
    weight, grad, mean, var = ins
    beta1 = float(attrs.get("beta1", 0.9))
    beta2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep_grad(weight, grad, attrs)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    new_w = weight - _lr(attrs) * new_mean / (torch.sqrt(new_var) + eps)
    return [new_w, new_mean, new_var]


register(
    OpDef(
        "adam_update",
        _adam_update,
        arguments=("weight", "grad", "mean", "var"),
        defaults=dict(_COMMON, beta1=0.9, beta2=0.999, epsilon=1e-8),
        mutate_inputs=(2, 3),
    )
)


def _clip_weights(w, attrs):
    cw = attrs.get("clip_weights", -1.0)
    if cw is not None and float(cw) > 0:
        w = torch.clamp(w, -float(cw), float(cw))
    return w


def _rmsprop_update(attrs, ins, is_train):
    weight, grad, n = ins
    gamma1 = float(attrs.get("gamma1", 0.95))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep_grad(weight, grad, attrs)
    new_n = (1.0 - gamma1) * torch.square(g) + gamma1 * n
    delta = -float(attrs["lr"]) * g / torch.sqrt(new_n + eps)
    return [_clip_weights(weight + delta, attrs), new_n]


register(
    OpDef(
        "rmsprop_update",
        _rmsprop_update,
        arguments=("weight", "grad", "n"),
        defaults=dict(_COMMON, gamma1=0.95, epsilon=1e-8, clip_weights=-1.0),
        mutate_inputs=(2,),
    )
)


def _rmspropalex_update(attrs, ins, is_train):
    weight, grad, n, g_avg, delta = ins
    gamma1 = float(attrs.get("gamma1", 0.95))
    gamma2 = float(attrs.get("gamma2", 0.9))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep_grad(weight, grad, attrs)
    new_n = (1.0 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1.0 - gamma1) * g + gamma1 * g_avg
    new_delta = gamma2 * delta - float(attrs["lr"]) * g / torch.sqrt(
        new_n - torch.square(new_g) + eps
    )
    return [_clip_weights(weight + new_delta, attrs), new_n, new_g, new_delta]


register(
    OpDef(
        "rmspropalex_update",
        _rmspropalex_update,
        arguments=("weight", "grad", "n", "g", "delta"),
        defaults=dict(_COMMON, gamma1=0.95, gamma2=0.9, epsilon=1e-8, clip_weights=-1.0),
        mutate_inputs=(2, 3, 4),
    )
)
