"""Random sampling operators (counterpart of ``mxnet_tpu/ops/sample.py``):
uniform, normal, gamma, exponential, poisson, negative_binomial and
generalized_negative_binomial.

Each call draws from the ``torch.Generator`` in ``attrs["__rng__"]`` (one
per device, ``mxnet_tpu_torch.random``), on that generator's device. The
JAX package draws from threefry keys; parity is distributional, not
stream-exact, and the tests hold the samplers to their moments.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import OpDef, register
from .utils import as_tuple


def _sample_infer(attrs, in_shapes):
    return [], [as_tuple(attrs.get("shape", (1,)))], []


def _sample_type(attrs, in_types):
    from ..base import np_dtype

    return [], [np_dtype(attrs.get("dtype", "float32"))], []


def _register_sampler(name, fn, defaults, aliases=()):
    def fcompute(attrs, ins, is_train, _fn=fn):
        gen = attrs["__rng__"]
        shape = as_tuple(attrs.get("shape", (1,)))
        out = _fn(gen, shape, attrs)
        return [out.to(torch_dtype(attrs.get("dtype", "float32")))]

    d = {"shape": (1,), "dtype": "float32"}
    d.update(defaults)
    register(
        OpDef(
            name,
            fcompute,
            arguments=(),
            defaults=d,
            infer_shape=_sample_infer,
            infer_type=_sample_type,
            needs_rng=True,
            aliases=aliases,
        )
    )


def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _gamma(gen, alpha, shape):
    """Gamma(alpha, 1) draws; ``alpha`` a float or a tensor of ``shape``."""
    a = alpha if torch.is_tensor(alpha) else torch.full(shape, float(alpha), device=gen.device)
    return torch._standard_gamma(a, generator=gen)


def _poisson(gen, lam, shape):
    rate = lam if torch.is_tensor(lam) else torch.full(shape, float(lam), device=gen.device)
    return torch.poisson(rate, generator=gen)


_register_sampler(
    "_sample_uniform",
    lambda gen, shape, a: float(a.get("low", 0.0)) + _uniform(gen, shape) * (
        float(a.get("high", 1.0)) - float(a.get("low", 0.0))),
    {"low": 0.0, "high": 1.0},
    aliases=("uniform", "_random_uniform"),
)
_register_sampler(
    "_sample_normal",
    lambda gen, shape, a: torch.randn(shape, generator=gen, device=gen.device)
    * float(a.get("scale", 1.0)) + float(a.get("loc", 0.0)),
    {"loc": 0.0, "scale": 1.0},
    aliases=("normal", "_random_normal"),
)
_register_sampler(
    "_sample_gamma",
    lambda gen, shape, a: _gamma(gen, a.get("alpha", 1.0), shape) * float(a.get("beta", 1.0)),
    {"alpha": 1.0, "beta": 1.0},
    aliases=("_random_gamma",),
)
_register_sampler(
    "_sample_exponential",
    lambda gen, shape, a: torch.empty(shape, device=gen.device).exponential_(
        generator=gen) / float(a.get("lam", 1.0)),
    {"lam": 1.0},
    aliases=("_random_exponential",),
)
_register_sampler(
    "_sample_poisson",
    lambda gen, shape, a: _poisson(gen, a.get("lam", 1.0), shape),
    {"lam": 1.0},
    aliases=("_random_poisson",),
)


def _neg_binomial(gen, shape, a):
    k = float(a.get("k", 1.0))
    p = float(a.get("p", 1.0))
    # NB(k, p) == Poisson(Gamma(k, (1-p)/p))
    return _poisson(gen, _gamma(gen, k, shape) * ((1.0 - p) / p), shape)


_register_sampler(
    "_sample_negbinomial",
    _neg_binomial,
    {"k": 1.0, "p": 1.0},
    aliases=("_random_negative_binomial",),
)


def _gen_neg_binomial(gen, shape, a):
    mu = float(a.get("mu", 1.0))
    alpha = float(a.get("alpha", 1.0))
    return _poisson(gen, _gamma(gen, 1.0 / alpha, shape) * (mu * alpha), shape)


_register_sampler(
    "_sample_gennegbinomial",
    _gen_neg_binomial,
    {"mu": 1.0, "alpha": 1.0},
    aliases=("_random_generalized_negative_binomial",),
)
