"""Neural-network layer operators of the PyTorch port (the part of
``mxnet_tpu/ops/nn.py`` ResNet needs): Activation, FullyConnected,
Convolution, Pooling, BatchNorm and SoftmaxOutput, under the JAX
package's names, arguments and defaults.

- Convolution's forward is ``F.conv2d``, as the JAX package leaves its
  forward to XLA. Its gradient, for 2-D shapes inside
  ``kernels.conv_bwd_plan``, runs the hand-written conv-backward kernels
  K2/K3 behind an autograd Function (their plain versions for CPU
  tensors): every such convolution, with no switch, where the JAX package
  takes its Pallas pair only under ``MXTPU_CONV_KERNEL=pallas``. Other
  shapes use autograd's own conv backward. The XLA layout levers
  ``MXNET_CONV_S2D`` / ``MXNET_CONV_BWD_LAYOUT`` / ``MXNET_CONV_WGRAD`` are
  not read: the port takes the default path.
- BatchNorm keeps the JAX semantics, not ``F.batch_norm``'s: one-pass f32
  stats with the biased variance E[x²] − mean² clamped at 0, the closed-form
  backward of ``_bn_train_core``, and moving stats
  new = m·old + (1−m)·batch returned as trailing aux outputs.
- SoftmaxOutput's backward ignores the incoming gradient, as the reference
  contract wants: softmax − onehot(label), scaled and normalized.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import kernels
from .elemwise import elemwise_backward_infer
from .registry import OpDef, register
from .utils import as_tuple, same_shape_infer

_ACT = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}

register(
    OpDef(
        "Activation",
        lambda attrs, ins, is_train: [_ACT[attrs.get("act_type", "relu")](ins[0])],
        arguments=("data",),
        defaults={"act_type": "relu"},
        infer_shape=same_shape_infer(1),
        backward_infer_shape=elemwise_backward_infer,
    )
)


# --------------------------------------------------------------------------
# FullyConnected — f32 accumulation, output in the data's dtype
# --------------------------------------------------------------------------
def _fully_connected(attrs, ins, is_train):
    no_bias = bool(attrs.get("no_bias", False))
    data, weight = ins[0], ins[1]
    x2d = data.reshape(data.shape[0], -1)
    out = torch.matmul(x2d.float(), weight.float().t()).to(data.dtype)
    if not no_bias:
        out = out + ins[2]
    return [out]


def _fc_infer(attrs, in_shapes):
    nh = int(attrs["num_hidden"])
    no_bias = bool(attrs.get("no_bias", False))
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("FullyConnected: data shape required")
    if 0 in tuple(dshape)[1:]:
        return (
            [tuple(dshape)] + [None] * (len(in_shapes) - 1),
            [(dshape[0], nh)],
            [],
        )
    in_dim = int(np.prod(dshape[1:]))
    shapes = [tuple(dshape), (nh, in_dim)]
    if not no_bias:
        shapes.append((nh,))
    return shapes, [(dshape[0], nh)], []


def _fc_backward_infer(attrs, in_shapes, out_shapes):
    """Refine the data's batch dim (and, with a known weight, its feature
    dim) from the output."""
    out = out_shapes[0]
    refined = list(in_shapes)
    dshape = in_shapes[0]
    if out is not None and out[0] > 0:
        wshape = in_shapes[1] if len(in_shapes) > 1 else None
        if dshape is not None:
            d = list(dshape)
            if d[0] == 0:
                d[0] = out[0]
            if len(d) == 2 and d[1] == 0 and wshape is not None and wshape[1] > 0:
                d[1] = wshape[1]
            refined[0] = tuple(d)
        elif wshape is not None and all(x > 0 for x in wshape):
            refined[0] = (out[0], wshape[1])
    return refined


_fc = OpDef(
    "FullyConnected",
    _fully_connected,
    arguments=("data", "weight", "bias"),
    defaults={"num_hidden": 0, "no_bias": False},
    infer_shape=_fc_infer,
    backward_infer_shape=_fc_backward_infer,
)
_fc.list_arguments = lambda attrs=None: (
    ["data", "weight"] if (attrs or {}).get("no_bias") else ["data", "weight", "bias"]
)
register(_fc)


# --------------------------------------------------------------------------
# Convolution
# --------------------------------------------------------------------------
def _conv_dims(attrs):
    kernel = as_tuple(attrs["kernel"])
    nd = len(kernel)
    stride = as_tuple(attrs.get("stride") or (1,) * nd, nd, "stride")
    dilate = as_tuple(attrs.get("dilate") or (1,) * nd, nd, "dilate")
    pad = as_tuple(attrs.get("pad") or (0,) * nd, nd, "pad")
    return kernel, stride, dilate, pad


_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _convolution(attrs, ins, is_train):
    kernel, stride, dilate, pad = _conv_dims(attrs)
    nd = len(kernel)
    groups = int(attrs.get("num_group", 1))
    data, weight = ins[0], ins[1]
    if (nd == 2 and groups == 1
            and kernels.conv_bwd_plan(data.shape, weight.shape, stride, pad, dilate,
                                      data.dtype)):
        out = kernels.conv2d_kernel_bwd(data, weight, pad)
    else:
        out = _CONV_FN[nd](data, weight, None, stride, pad, dilate, groups)
    if not bool(attrs.get("no_bias", False)):
        out = out + ins[2].reshape((1, -1) + (1,) * nd)
    return [out]


def _conv_infer(attrs, in_shapes):
    kernel, stride, dilate, pad = _conv_dims(attrs)
    nd = len(kernel)
    nf = int(attrs["num_filter"])
    groups = int(attrs.get("num_group", 1))
    no_bias = bool(attrs.get("no_bias", False))
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("Convolution: data shape required")
    if len(dshape) != nd + 2:
        raise MXNetError("Convolution: data must be %dD, got %s" % (nd + 2, (dshape,)))
    c = dshape[1]
    wshape = (nf, c // groups) + kernel
    out_sp = tuple(
        (dshape[2 + i] + 2 * pad[i] - (dilate[i] * (kernel[i] - 1) + 1)) // stride[i] + 1
        for i in range(nd)
    )
    oshape = (dshape[0], nf) + out_sp
    shapes = [tuple(dshape), wshape] + ([] if no_bias else [(nf,)])
    return shapes, [oshape], []


_conv = OpDef(
    "Convolution",
    _convolution,
    arguments=("data", "weight", "bias"),
    defaults={
        "kernel": (1, 1),
        "stride": None,
        "dilate": None,
        "pad": None,
        "num_filter": 1,
        "num_group": 1,
        "no_bias": False,
        "workspace": 1024,
        "cudnn_tune": None,
        "cudnn_off": False,
        "layout": None,
    },
    infer_shape=_conv_infer,
    aliases=("Convolution_v1",),  # the reference keeps the pre-NNVM name alive
)
_conv.list_arguments = lambda attrs=None: (
    ["data", "weight"] if (attrs or {}).get("no_bias") else ["data", "weight", "bias"]
)
register(_conv)


# --------------------------------------------------------------------------
# Pooling (2-D)
# --------------------------------------------------------------------------
def _pool_out_dim(x, k, s, p, convention):
    if convention == "full":
        return int(np.ceil(float(x + 2 * p - k) / s)) + 1
    return (x + 2 * p - k) // s + 1


def _pooling(attrs, ins, is_train):
    data = ins[0]
    nd = data.dim() - 2
    if nd != 2:
        raise NotImplementedError(
            "Pooling over %d spatial dims is not ported to PyTorch yet "
            "(mxnet_tpu/ops/nn.py:747 handles any rank)" % nd)
    global_pool = bool(attrs.get("global_pool", False))
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nd
        pad = (0,) * nd
    else:
        kernel = as_tuple(attrs["kernel"])
        stride = as_tuple(attrs.get("stride") or (1,) * nd, nd, "stride")
        pad = as_tuple(attrs.get("pad") or (0,) * nd, nd, "pad")
    ptype = attrs.get("pool_type", "max")
    # "full" convention (ceil output size): extend the high-side pad so the
    # window count is ceil((x+2p-k)/s)+1; the avg divisor below does not
    # count that extension
    hi_extra = (0,) * nd
    if not global_pool and attrs.get("pooling_convention", "valid") == "full":
        hi_extra = tuple(
            max(0, (_pool_out_dim(data.shape[2 + i], kernel[i], stride[i], pad[i], "full") - 1)
                * stride[i] + kernel[i] - (data.shape[2 + i] + 2 * pad[i]))
            for i in range(nd))
    widths = (pad[1], pad[1] + hi_extra[1], pad[0], pad[0] + hi_extra[0])
    if ptype == "max":
        xpad = F.pad(data, widths, value=-float("inf"))
        return [F.max_pool2d(xpad, kernel, stride)]
    if ptype in ("avg", "sum"):
        out = F.avg_pool2d(F.pad(data, widths), kernel, stride, divisor_override=1)
        if ptype == "avg":
            # divisor = window area clipped to the PADDED extent (padding
            # counts toward the average, the "full" extension does not)
            ones = torch.ones((1, 1) + tuple(data.shape[2 + i] + 2 * pad[i] for i in range(nd)),
                              dtype=torch.float32, device=data.device)
            counts = F.avg_pool2d(F.pad(ones, (0, hi_extra[1], 0, hi_extra[0])), kernel, stride,
                                  divisor_override=1)
            out = (out / counts).to(data.dtype)
        return [out]
    raise MXNetError("Pooling: unknown pool_type %s" % ptype)


def _pooling_infer(attrs, in_shapes):
    dshape = in_shapes[0]
    nd = len(dshape) - 2
    if bool(attrs.get("global_pool", False)):
        return [tuple(dshape)], [tuple(dshape[:2]) + (1,) * nd], []
    kernel = as_tuple(attrs["kernel"])
    stride = as_tuple(attrs.get("stride") or (1,) * nd, nd, "stride")
    pad = as_tuple(attrs.get("pad") or (0,) * nd, nd, "pad")
    conv = attrs.get("pooling_convention", "valid")
    out_sp = tuple(
        _pool_out_dim(dshape[2 + i], kernel[i], stride[i], pad[i], conv) for i in range(nd)
    )
    return [tuple(dshape)], [tuple(dshape[:2]) + out_sp], []


register(
    OpDef(
        "Pooling",
        _pooling,
        arguments=("data",),
        defaults={
            "kernel": (1, 1),
            "stride": None,
            "pad": None,
            "pool_type": "max",
            "global_pool": False,
            "pooling_convention": "valid",
            "cudnn_off": False,
        },
        infer_shape=_pooling_infer,
        aliases=("Pooling_v1",),
    )
)


# --------------------------------------------------------------------------
# BatchNorm. aux: moving_mean/moving_var; outputs (output, mean, var) with
# 1 visible, then the two updated aux values.
# --------------------------------------------------------------------------
def _bn_shape(x):
    return (1, -1) + (1,) * (x.dim() - 2)


def _bn_axes(x):
    return tuple(i for i in range(x.dim()) if i != 1)


class _BNTrainCore(torch.autograd.Function):
    """Counterpart of ``_bn_train_core`` (``nn.py:864-939``): one-pass f32
    stats (sum and sum of squares), the biased variance clamped at 0, and
    its closed-form backward. The gradients of the mean and var outputs are
    taken only when they are given (in a training step they feed only the
    undifferentiated moving-stat updates)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ax, bshape = _bn_axes(x), _bn_shape(x)
        n = x.numel() // x.shape[1]
        x32 = x.float()
        s1 = x32.sum(dim=ax)
        s2 = (x32 * x32).sum(dim=ax)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        g32 = gamma.float()
        scale = (g32 * rstd).reshape(bshape)
        shift = (beta.float() - g32 * rstd * mean).reshape(bshape)
        y = (x32 * scale + shift).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, rstd = ctx.saved_tensors
        ax, bshape = _bn_axes(x), _bn_shape(x)
        n = x.numel() // x.shape[1]
        x32 = x.float()
        if dy is None:
            dx32 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            dgamma = torch.zeros(gamma.shape, dtype=torch.float32, device=x.device)
            dbeta = torch.zeros(gamma.shape, dtype=torch.float32, device=x.device)
        else:
            dy32 = dy.float()
            xhat = (x32 - mean.reshape(bshape)) * rstd.reshape(bshape)
            dbeta = dy32.sum(dim=ax)
            dgamma = (dy32 * xhat).sum(dim=ax)
            dx32 = (gamma.float() * rstd).reshape(bshape) * (
                dy32 - (dbeta / n).reshape(bshape) - xhat * (dgamma / n).reshape(bshape))
        if dmean is not None:
            dx32 = dx32 + (dmean / n).reshape(bshape).float()
        if dvar is not None:
            dx32 = dx32 + dvar.reshape(bshape).float() * 2.0 / n * (x32 - mean.reshape(bshape))
        return dx32.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def _batch_norm(attrs, ins, is_train):
    data, gamma, beta, moving_mean, moving_var = ins
    eps = float(attrs.get("eps", 1e-3))
    momentum = float(attrs.get("momentum", 0.9))
    fix_gamma = bool(attrs.get("fix_gamma", True))
    use_global = bool(attrs.get("use_global_stats", False)) or not is_train
    bshape = _bn_shape(data)
    if fix_gamma:
        # ones, and a zero gradient for gamma (JAX: ones + stop_gradient(gamma*0))
        gamma = torch.ones_like(gamma) + (gamma * 0).detach()
    if use_global:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
        out = (data - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape) + eps) \
            * gamma.reshape(bshape) + beta.reshape(bshape)
        out = out.to(data.dtype)
    else:
        out, mean, var = _BNTrainCore.apply(data, gamma, beta, eps)
        new_mean = momentum * moving_mean + (1.0 - momentum) * mean.to(moving_mean.dtype)
        new_var = momentum * moving_var + (1.0 - momentum) * var.to(moving_var.dtype)
    return [out, mean.float(), var.float(), new_mean, new_var]


def _bn_infer(attrs, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("BatchNorm: data shape required")
    c = (dshape[1],)
    return [tuple(dshape), c, c], [tuple(dshape), c, c], [c, c]


_bn = OpDef(
    "BatchNorm",
    _batch_norm,
    arguments=("data", "gamma", "beta"),
    outputs=("output", "mean", "var"),
    aux=("moving_mean", "moving_var"),
    defaults={
        "eps": 1e-3,
        "momentum": 0.9,
        "fix_gamma": True,
        "use_global_stats": False,
        "output_mean_var": False,
    },
    infer_shape=_bn_infer,
    aliases=("CuDNNBatchNorm",),
)
_bn._num_visible_outputs = 1
register(_bn)


# --------------------------------------------------------------------------
# SoftmaxOutput — a loss head whose backward ignores the head gradient
# --------------------------------------------------------------------------
def _normalize_grad(grad, label, attrs, valid_mask=None):
    normalization = attrs.get("normalization", "null")
    if normalization == "batch":
        grad = grad / label.shape[0]
    elif normalization == "valid" and valid_mask is not None:
        grad = grad / torch.clamp_min(valid_mask.sum(), 1.0)
    elif normalization == "valid":
        grad = grad / float(np.prod(label.shape))
    return grad


def _softmax_axis(attrs, x):
    return 1 if attrs.get("multi_output") and x.dim() > 2 else -1


class _SoftmaxOutput(torch.autograd.Function):
    """Counterpart of ``_softmax_output_core`` (``nn.py:1172-1211``): the
    forward is a softmax; the backward ignores the incoming gradient and
    returns (softmax − onehot(int(label))) · grad_scale, masked where the
    label is ignored, normalized, in the output's dtype; the label gets a
    zero gradient."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        out = torch.softmax(data, dim=_softmax_axis(attrs, data))
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        attrs = ctx.attrs
        grad_scale = float(attrs.get("grad_scale", 1.0))
        use_ignore = bool(attrs.get("use_ignore", False))
        ignore_label = float(attrs.get("ignore_label", -1.0))
        axis = _softmax_axis(attrs, out)
        depth = out.shape[axis]
        lbl = label.to(torch.int32).long()
        # one-hot that, like jax.nn.one_hot, is all zeros for an
        # out-of-range label
        onehot = (lbl.unsqueeze(-1) == torch.arange(depth, device=out.device)).to(out.dtype)
        if axis == 1:
            onehot = torch.movedim(onehot, -1, 1)
        grad = out - onehot
        valid = None
        if use_ignore:
            valid = (label != ignore_label).to(out.dtype)
            grad = grad * valid.unsqueeze(axis)
        grad = _normalize_grad(grad * grad_scale, label, attrs, valid)
        return grad.to(out.dtype), torch.zeros_like(label), None


def _softmax_output(attrs, ins, is_train):
    return [_SoftmaxOutput.apply(ins[0], ins[1], attrs)]


def _softmax_output_infer(attrs, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("SoftmaxOutput: data shape required")
    if attrs.get("multi_output") and len(dshape) > 2:
        lshape = (dshape[0],) + tuple(dshape[2:])
    else:
        lshape = tuple(dshape[:-1]) if len(dshape) > 1 else (dshape[0],)
    return [tuple(dshape), lshape], [tuple(dshape)], []


register(
    OpDef(
        "SoftmaxOutput",
        _softmax_output,
        arguments=("data", "label"),
        defaults={
            "grad_scale": 1.0,
            "ignore_label": -1.0,
            "use_ignore": False,
            "multi_output": False,
            "normalization": "null",
            "preserve_shape": False,
            "out_grad": False,
        },
        infer_shape=_softmax_output_infer,
        need_top_grad=False,
        aliases=("Softmax",),
    )
)
