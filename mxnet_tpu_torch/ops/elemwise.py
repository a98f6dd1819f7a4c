"""Elementwise unary/binary/scalar/logic operators and their broadcast
variants (counterpart of ``mxnet_tpu/ops/elemwise.py``), under the JAX
package's names, aliases and defaults.

Each is a one-line torch expression. Dtypes follow the JAX package, which
runs with x64 on: a float function of an integer input, and the true
division of two integers, give float32, or float64 for int64
(``utils.as_float``); a scalar
operand takes the array's dtype first (``utils.scalar_like``); logic ops
return the first input's dtype. ``_mod`` is jnp's floored remainder built
from ``fmod``, so the two packages round alike.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, dtype_name, np_dtype, torch_dtype
from .registry import OpDef, register
from .utils import as_float, binary_broadcast_infer, merge_shapes, same_shape_infer, scalar_like


def elemwise_backward_infer(attrs, in_shapes, out_shapes):
    """Reverse inference for same-shape ops: outputs refine inputs."""
    merged = None
    for s in list(out_shapes) + list(in_shapes):
        merged = merge_shapes(merged, s, "elemwise")
    return [merged] * len(in_shapes)


def _unary(name, fn, aliases=()):
    register(
        OpDef(
            name,
            lambda attrs, ins, is_train, _fn=fn: [_fn(ins[0])],
            arguments=("data",),
            infer_shape=same_shape_infer(1),
            backward_infer_shape=elemwise_backward_infer,
            aliases=aliases,
        )
    )


def _float_unary(name, fn, aliases=()):
    _unary(name, lambda x, _fn=fn: _fn(as_float(x)), aliases)


def _logic(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _binary(name, fn, aliases=()):
    register(
        OpDef(
            name,
            lambda attrs, ins, is_train, _fn=fn: [_fn(ins[0], ins[1])],
            arguments=("lhs", "rhs"),
            infer_shape=same_shape_infer(2),
            backward_infer_shape=elemwise_backward_infer,
            aliases=aliases,
        )
    )


def _binary_scalar(name, fn, aliases=()):
    register(
        OpDef(
            name,
            lambda attrs, ins, is_train, _fn=fn: [
                _fn(ins[0], scalar_like(attrs["scalar"], ins[0]))],
            arguments=("data",),
            defaults={"scalar": 0.0},
            infer_shape=same_shape_infer(1),
            aliases=aliases,
        )
    )


def _broadcast(name, fn, aliases=()):
    register(
        OpDef(
            name,
            lambda attrs, ins, is_train, _fn=fn: [_fn(ins[0], ins[1])],
            arguments=("lhs", "rhs"),
            infer_shape=binary_broadcast_infer,
            aliases=aliases,
        )
    )


def _divide(a, b):
    if not (a.is_floating_point() or b.is_floating_point()):
        a, b = as_float(a), as_float(b)
    return torch.true_divide(a, b)


def _mod(a, b):
    """jnp.mod: the truncated remainder, moved to the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _hypot(a, b):
    return torch.hypot(as_float(a), as_float(b))


# --------------------------------------------------------------------------
# unary (reference elemwise_unary_op.cc)
# --------------------------------------------------------------------------
_unary("relu", lambda x: torch.where(x > 0, x, torch.zeros_like(x)))
_float_unary("sigmoid", torch.sigmoid)
_unary("_copy", lambda x: x, aliases=("identity",))
_unary("BlockGrad", lambda x: x.detach(), aliases=("stop_gradient",))
_unary("make_loss", lambda x: x)
_unary("negative", torch.neg)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("rint", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_float_unary("sqrt", torch.sqrt)
_float_unary("rsqrt", torch.rsqrt)
_float_unary("cbrt", lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0))
_float_unary("rcbrt", lambda x: 1.0 / (torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)))
_float_unary("exp", torch.exp)
_float_unary("log", torch.log)
_float_unary("log10", torch.log10)
_float_unary("log2", torch.log2)
_float_unary("log1p", torch.log1p)
_float_unary("expm1", torch.expm1)
_float_unary("reciprocal", torch.reciprocal)
_float_unary("sin", torch.sin)
_float_unary("cos", torch.cos)
_float_unary("tan", torch.tan)
_float_unary("arcsin", torch.asin)
_float_unary("arccos", torch.acos)
_float_unary("arctan", torch.atan)
_float_unary("sinh", torch.sinh)
_float_unary("cosh", torch.cosh)
_float_unary("tanh", torch.tanh)
_float_unary("arcsinh", torch.asinh)
_float_unary("arccosh", torch.acosh)
_float_unary("arctanh", torch.atanh)
_float_unary("degrees", torch.rad2deg)
_float_unary("radians", torch.deg2rad)
_float_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_float_unary("gammaln", torch.lgamma)
_float_unary("erf", torch.erf)
_float_unary("softsign", lambda x: x / (1 + torch.abs(x)))


# Cast — dtype change (reference elemwise_unary_op.cc Cast)
def _cast_infer_type(attrs, in_types):
    try:
        t = np_dtype(attrs["dtype"])
    except MXNetError:  # bfloat16 where numpy has none
        t = dtype_name(attrs["dtype"])
    inferred = [in_types[0] if in_types[0] is not None else np_dtype("float32")]
    return inferred, [t], []


register(
    OpDef(
        "Cast",
        lambda attrs, ins, is_train: [ins[0].to(torch_dtype(attrs["dtype"]))],
        arguments=("data",),
        defaults={"dtype": "float32"},
        infer_shape=same_shape_infer(1),
        infer_type=_cast_infer_type,
        aliases=("cast",),
    )
)


# smooth_l1 (reference smooth_l1_unary-inl.h): scalar sigma; f(x) =
# 0.5 (sigma x)^2 if |x| < 1/sigma^2 else |x| - 0.5/sigma^2
def _smooth_l1(attrs, ins, is_train):
    sigma = float(attrs.get("scalar", 1.0))
    x = ins[0]
    s2 = sigma * sigma
    return [torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                        torch.abs(x) - 0.5 / s2)]


register(
    OpDef(
        "smooth_l1",
        _smooth_l1,
        arguments=("data",),
        defaults={"scalar": 1.0},
        infer_shape=same_shape_infer(1),
    )
)

# --------------------------------------------------------------------------
# binary elemwise (same-shape) — reference elemwise_binary_op.cc
# --------------------------------------------------------------------------
_binary("elemwise_add", torch.add, aliases=("_plus", "_add", "_Plus"))
_binary("elemwise_sub", torch.sub, aliases=("_minus", "_sub", "_Minus"))
_binary("elemwise_mul", torch.mul, aliases=("_mul", "_Mul"))
_binary("elemwise_div", _divide, aliases=("_div", "_Div"))
_binary("_mod", _mod, aliases=("_Mod",))
_binary("_power", torch.pow, aliases=("_Power", "_pow"))
_binary("_maximum", torch.maximum, aliases=("_Maximum",))
_binary("_minimum", torch.minimum, aliases=("_Minimum",))
_binary("_hypot", _hypot)
_binary("_equal", _logic(torch.eq), aliases=("_Equal",))
_binary("_not_equal", _logic(torch.ne), aliases=("_Not_Equal",))
_binary("_greater", _logic(torch.gt), aliases=("_Greater",))
_binary("_greater_equal", _logic(torch.ge), aliases=("_Greater_Equal",))
_binary("_lesser", _logic(torch.lt), aliases=("_Lesser",))
_binary("_lesser_equal", _logic(torch.le), aliases=("_Lesser_Equal",))

# --------------------------------------------------------------------------
# binary scalar — reference elemwise_binary_scalar_op.cc
# --------------------------------------------------------------------------
_binary_scalar("_plus_scalar", torch.add, aliases=("_PlusScalar",))
_binary_scalar("_minus_scalar", torch.sub, aliases=("_MinusScalar",))
_binary_scalar("_rminus_scalar", lambda x, s: s - x, aliases=("_RMinusScalar",))
_binary_scalar("_mul_scalar", torch.mul, aliases=("_MulScalar",))
_binary_scalar("_div_scalar", _divide, aliases=("_DivScalar",))
_binary_scalar("_rdiv_scalar", lambda x, s: _divide(s, x), aliases=("_RDivScalar",))
_binary_scalar("_mod_scalar", _mod, aliases=("_ModScalar",))
_binary_scalar("_rmod_scalar", lambda x, s: _mod(s, x), aliases=("_RModScalar",))
_binary_scalar("_power_scalar", torch.pow, aliases=("_PowerScalar",))
_binary_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x), aliases=("_RPowerScalar",))
_binary_scalar("_maximum_scalar", torch.maximum, aliases=("_MaximumScalar",))
_binary_scalar("_minimum_scalar", torch.minimum, aliases=("_MinimumScalar",))
_binary_scalar("_hypot_scalar", _hypot, aliases=("_HypotScalar",))
_binary_scalar("_equal_scalar", _logic(torch.eq), aliases=("_EqualScalar",))
_binary_scalar("_not_equal_scalar", _logic(torch.ne), aliases=("_NotEqualScalar",))
_binary_scalar("_greater_scalar", _logic(torch.gt), aliases=("_GreaterScalar",))
_binary_scalar("_greater_equal_scalar", _logic(torch.ge), aliases=("_GreaterEqualScalar",))
_binary_scalar("_lesser_scalar", _logic(torch.lt), aliases=("_LesserScalar",))
_binary_scalar("_lesser_equal_scalar", _logic(torch.le), aliases=("_LesserEqualScalar",))

# --------------------------------------------------------------------------
# broadcast binary — reference elemwise_binary_broadcast_op_*.cc
# --------------------------------------------------------------------------
_broadcast("broadcast_add", torch.add, aliases=("broadcast_plus",))
_broadcast("broadcast_sub", torch.sub, aliases=("broadcast_minus",))
_broadcast("broadcast_mul", torch.mul)
_broadcast("broadcast_div", _divide)
_broadcast("broadcast_mod", _mod)
_broadcast("broadcast_power", torch.pow)
_broadcast("broadcast_maximum", torch.maximum)
_broadcast("broadcast_minimum", torch.minimum)
_broadcast("broadcast_hypot", _hypot)
_broadcast("broadcast_equal", _logic(torch.eq))
_broadcast("broadcast_not_equal", _logic(torch.ne))
_broadcast("broadcast_greater", _logic(torch.gt))
_broadcast("broadcast_greater_equal", _logic(torch.ge))
_broadcast("broadcast_lesser", _logic(torch.lt))
_broadcast("broadcast_lesser_equal", _logic(torch.le))


# add_n / ElementwiseSum — variable input count (reference elemwise_sum.cc)
def _add_n(attrs, ins, is_train):
    out = ins[0]
    for x in ins[1:]:
        out = out + x
    return [out]


register(
    OpDef(
        "add_n",
        _add_n,
        arguments=("args",),
        key_var_num_args="num_args",
        infer_shape=lambda attrs, in_shapes: same_shape_infer(len(in_shapes))(
            attrs, in_shapes
        ),
        aliases=("ElementWiseSum", "_sum"),
    )
)
