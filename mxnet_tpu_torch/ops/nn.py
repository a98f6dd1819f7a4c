"""Neural-network layer operators of the PyTorch port (counterpart of
``mxnet_tpu/ops/nn.py``): Activation, LeakyReLU, FullyConnected,
Convolution, Deconvolution, Pooling, BatchNorm, InstanceNorm,
L2Normalization, LRN, Dropout, softmax, log_softmax, SoftmaxActivation,
the loss heads (SoftmaxOutput, the regression outputs, SVMOutput,
MakeLoss, softmax_cross_entropy), UpSampling, SequenceLast/Mask/Reverse
and Crop, under the JAX package's names, arguments and defaults.

- Convolution's forward is ``F.conv2d``, as the JAX package leaves its
  forward to XLA. Its gradient, for 2-D shapes inside
  ``kernels.conv_bwd_plan``, runs the hand-written conv-backward kernels
  K2/K3 behind an autograd Function (their plain versions for CPU
  tensors): every such convolution, with no switch, where the JAX package
  takes its Pallas pair only under ``MXTPU_CONV_KERNEL=pallas``. Other
  shapes use autograd's own conv backward. The XLA layout levers
  ``MXNET_CONV_S2D`` / ``MXNET_CONV_BWD_LAYOUT`` / ``MXNET_CONV_WGRAD`` are
  not read: the port takes the default path. Deconvolution is
  ``F.conv_transpose*`` on the reference's (C_in, C_out/g, *K) weight, as
  the JAX package lowers it through XLA.
- BatchNorm keeps the JAX semantics, not ``F.batch_norm``'s: one-pass f32
  stats with the biased variance E[x²] − mean² clamped at 0, the closed-form
  backward of ``_bn_train_core``, and moving stats
  new = m·old + (1−m)·batch returned as trailing aux outputs. Inside
  ``parallel.mesh.spanning_batch_stats`` (the fused step over a mesh that
  spans processes) its per-channel Σx and Σx² and its backward's two
  per-channel sums are summed across the processes, so the statistics are
  the global batch's, as in the JAX package's one GSPMD step; the
  executor path keeps each worker's own statistics.
- The loss heads' backward ignores the incoming gradient, as the reference
  contract wants: SoftmaxOutput's is softmax − onehot(label), scaled and
  normalized; the others' are the reference's closed forms.
- Dropout and rrelu draw from the ``torch.Generator`` the graph program
  hands to ``needs_rng`` nodes, so their masks and slopes cannot match
  JAX's threefry bits (ROADMAP, Queue 3); the keep rate, the 1/keep
  scaling and the slope range are JAX's, and one seed gives one mask.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import kernels
from .elemwise import elemwise_backward_infer
from .registry import OpDef, register
from .utils import as_tuple, same_shape_infer, scalar_like

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


def _leaky_relu(attrs, ins, is_train):
    act = attrs.get("act_type", "leaky")
    slope = float(attrs.get("slope", 0.25))
    x = ins[0]
    if act == "leaky":
        return [torch.where(x > 0, x, slope * x)]
    if act == "elu":
        return [torch.where(x > 0, x, slope * (torch.exp(x) - 1.0))]
    if act == "prelu":
        gamma = ins[1].reshape((1, -1) + (1,) * (x.dim() - 2))
        return [torch.where(x > 0, x, gamma * x)]
    if act == "rrelu":
        lo = float(attrs.get("lower_bound", 0.125))
        up = float(attrs.get("upper_bound", 0.334))
        if is_train:
            # an f32 slope an element in [lo, up), as jax.random.uniform draws it
            gen = attrs["__rng__"]
            slope_r = lo + (up - lo) * torch.rand(x.shape, generator=gen, device=gen.device)
            return [torch.where(x > 0, x, slope_r * x)]
        return [torch.where(x > 0, x, ((lo + up) / 2.0) * x)]
    raise MXNetError("LeakyReLU: unknown act_type %s" % act)


def _leaky_relu_infer(attrs, in_shapes):
    d = tuple(in_shapes[0])
    if attrs.get("act_type", "leaky") == "prelu":
        return [d, (d[1],)], [d], []
    return [d], [d], []


_lrelu = OpDef(
    "LeakyReLU",
    _leaky_relu,
    arguments=("data",),
    defaults={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125, "upper_bound": 0.334},
    infer_shape=_leaky_relu_infer,
    needs_rng=True,
)
_lrelu.list_arguments = lambda attrs=None: (
    ["data", "gamma"] if (attrs or {}).get("act_type") == "prelu" else ["data"]
)
register(_lrelu)


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
# Deconvolution: the transpose of a strided convolution, weight
# (C_in, C_out/g, *K) as in the reference
# --------------------------------------------------------------------------
_CONV_T_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _deconvolution(attrs, ins, is_train):
    kernel, stride, dilate, pad = _conv_dims(attrs)
    nd = len(kernel)
    groups = int(attrs.get("num_group", 1))
    adj = as_tuple(attrs.get("adj") or (0,) * nd, nd, "adj")
    out = _CONV_T_FN[nd](ins[0], ins[1], None, stride, pad, adj, groups, dilate)
    if not bool(attrs.get("no_bias", True)):
        out = out + ins[2].reshape((1, -1) + (1,) * nd)
    return [out]


def _deconv_infer(attrs, in_shapes):
    kernel, stride, dilate, pad = _conv_dims(attrs)
    nd = len(kernel)
    nf = int(attrs["num_filter"])
    groups = int(attrs.get("num_group", 1))
    no_bias = bool(attrs.get("no_bias", True))
    adj = as_tuple(attrs.get("adj") or (0,) * nd, nd, "adj")
    dshape = in_shapes[0]
    wshape = (dshape[1], nf // groups) + kernel
    out_sp = tuple(
        stride[i] * (dshape[2 + i] - 1) + (dilate[i] * (kernel[i] - 1) + 1) - 2 * pad[i] + adj[i]
        for i in range(nd)
    )
    oshape = (dshape[0], nf) + out_sp
    shapes = [tuple(dshape), wshape] + ([] if no_bias else [(nf,)])
    return shapes, [oshape], []


_deconv = OpDef(
    "Deconvolution",
    _deconvolution,
    arguments=("data", "weight", "bias"),
    defaults={
        "kernel": (1, 1),
        "stride": None,
        "dilate": None,
        "pad": None,
        "adj": None,
        "target_shape": None,
        "num_filter": 1,
        "num_group": 1,
        "no_bias": True,
        "workspace": 512,
    },
    infer_shape=_deconv_infer,
)
_deconv.list_arguments = lambda attrs=None: (
    ["data", "weight"] if (attrs or {}).get("no_bias", True) else ["data", "weight", "bias"]
)
register(_deconv)


# --------------------------------------------------------------------------
# Pooling over 1, 2 or 3 spatial dims
# --------------------------------------------------------------------------
def _pool_out_dim(x, k, s, p, convention):
    if convention == "full":
        return int(np.ceil(float(x + 2 * p - k) / s)) + 1
    return (x + 2 * p - k) // s + 1


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _sum_pool(x, kernel, stride):
    """Window sums of ``x`` (N, C, *spatial) with no padding, summed in
    f32 for bf16 (``avg_pool``'s accumulator); 1-D through the 2-D pool."""
    if x.dim() == 3:
        return F.avg_pool2d(x[:, :, None], (1,) + kernel, (1,) + stride,
                            divisor_override=1)[:, :, 0]
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _pooling(attrs, ins, is_train):
    data = ins[0]
    nd = data.dim() - 2
    if nd not in _MAX_POOL:
        raise MXNetError("Pooling: data must be 3-D to 5-D, got %dD" % data.dim())
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
    # F.pad's widths run from the last dim back
    widths = tuple(w for i in reversed(range(nd)) for w in (pad[i], pad[i] + hi_extra[i]))
    if ptype == "max":
        xpad = F.pad(data, widths, value=-float("inf"))
        return [_MAX_POOL[nd](xpad, kernel, stride)]
    if ptype in ("avg", "sum"):
        out = _sum_pool(F.pad(data, widths), kernel, stride)
        if ptype == "avg":
            # divisor = window area clipped to the PADDED extent (padding
            # counts toward the average, the "full" extension does not)
            ones = torch.ones((1, 1) + tuple(data.shape[2 + i] + 2 * pad[i] for i in range(nd)),
                              dtype=torch.float32, device=data.device)
            extra = tuple(w for i in reversed(range(nd)) for w in (0, hi_extra[i]))
            counts = _sum_pool(F.pad(ones, extra), kernel, stride)
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
    undifferentiated moving-stat updates). With ``span`` the forward's two
    per-channel sums, and the backward's, are summed across the processes
    of the group (one all-reduce each way); the parameter gradients it
    returns stay this process's own, which the step's gradient sum adds."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, span=False):
        ax, bshape = _bn_axes(x), _bn_shape(x)
        n = x.numel() // x.shape[1]
        x32 = x.float()
        s1 = x32.sum(dim=ax)
        s2 = (x32 * x32).sum(dim=ax)
        if span:
            from ..parallel import mesh as _mesh

            # over every process, or over the processes of the batch's axis
            grp = span if isinstance(span, _mesh.AxisGroup) else None
            s1, s2 = _mesh.allreduce_sum(torch.stack([s1, s2]), axis=grp).unbind(0)
            n *= _mesh.process_count() if grp is None else grp.size
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        g32 = gamma.float()
        scale = (g32 * rstd).reshape(bshape)
        shift = (beta.float() - g32 * rstd * mean).reshape(bshape)
        y = (x32 * scale + shift).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.set_materialize_grads(False)
        ctx.span, ctx.n = span, n
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, rstd = ctx.saved_tensors
        ax, bshape = _bn_axes(x), _bn_shape(x)
        n = ctx.n
        x32 = x.float()
        zeros = lambda: torch.zeros(gamma.shape, dtype=torch.float32, device=x.device)  # noqa: E731
        if dy is None:
            dbeta, dgamma = zeros(), zeros()
        else:
            dy32 = dy.float()
            xhat = (x32 - mean.reshape(bshape)) * rstd.reshape(bshape)
            dbeta = dy32.sum(dim=ax)
            dgamma = (dy32 * xhat).sum(dim=ax)
        sum_beta, sum_gamma = dbeta, dgamma
        if ctx.span:
            from ..parallel import mesh as _mesh

            # the sums over the global batch; dmean and dvar are the
            # gradients of global statistics, so every process's add up
            parts = [dbeta, dgamma] + [g.float() for g in (dmean, dvar) if g is not None]
            grp = ctx.span if isinstance(ctx.span, _mesh.AxisGroup) else None
            summed = _mesh.allreduce_sum(torch.stack(parts), axis=grp).unbind(0)
            sum_beta, sum_gamma = summed[0], summed[1]
            rest = iter(summed[2:])
            dmean = next(rest) if dmean is not None else None
            dvar = next(rest) if dvar is not None else None
        if dy is None:
            dx32 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        else:
            dx32 = (gamma.float() * rstd).reshape(bshape) * (
                dy32 - (sum_beta / n).reshape(bshape) - xhat * (sum_gamma / n).reshape(bshape))
        if dmean is not None:
            dx32 = dx32 + (dmean / n).reshape(bshape).float()
        if dvar is not None:
            dx32 = dx32 + dvar.reshape(bshape).float() * 2.0 / n * (x32 - mean.reshape(bshape))
        return dx32.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None


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
        from ..parallel.mesh import batch_stats_span

        out, mean, var = _BNTrainCore.apply(data, gamma, beta, eps, batch_stats_span())
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
# InstanceNorm / L2Normalization / LRN
# --------------------------------------------------------------------------
def _instance_norm(attrs, ins, is_train):
    data, gamma, beta = ins
    eps = float(attrs.get("eps", 1e-3))
    ax = tuple(range(2, data.dim()))
    mean = data.mean(dim=ax, keepdim=True)
    var = torch.square(data - mean).mean(dim=ax, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return [(data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
            + beta.reshape(bshape)]


register(
    OpDef(
        "InstanceNorm",
        _instance_norm,
        arguments=("data", "gamma", "beta"),
        defaults={"eps": 1e-3},
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0]), (in_shapes[0][1],), (in_shapes[0][1],)],
            [tuple(in_shapes[0])],
            [],
        ),
    )
)


def _l2_normalization(attrs, ins, is_train):
    data = ins[0]
    eps = float(attrs.get("eps", 1e-10))
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.dim()))
    else:
        raise MXNetError("L2Normalization: unknown mode %s" % mode)
    norm = torch.sqrt(torch.square(data).sum(dim=ax, keepdim=True) + eps)
    return [data / norm]


register(
    OpDef(
        "L2Normalization",
        _l2_normalization,
        arguments=("data",),
        defaults={"eps": 1e-10, "mode": "instance"},
        infer_shape=same_shape_infer(1),
    )
)


def _lrn(attrs, ins, is_train):
    """x·(knorm + alpha/nsize·Σ window x²)^−beta over a zero-padded window
    of nsize channels, in the input's dtype, as the JAX package computes
    it."""
    x = ins[0]
    nsize = int(attrs.get("nsize", 5))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    knorm = float(attrs.get("knorm", 2.0))
    half = nsize // 2
    # F.pad's widths run from the last dim back to the channel dim
    sq_pad = F.pad(torch.square(x), (0, 0) * (x.dim() - 2) + (half, half))
    window = torch.stack([sq_pad[:, i:i + x.shape[1]] for i in range(nsize)]).sum(dim=0)
    # the constants in x's dtype, as JAX's weakly typed scalars are
    base = scalar_like(knorm, x) + scalar_like(alpha / nsize, x) * window
    return [x * torch.pow(base, scalar_like(-beta, x))]


register(
    OpDef(
        "LRN",
        _lrn,
        arguments=("data",),
        defaults={"nsize": 5, "alpha": 1e-4, "beta": 0.75, "knorm": 2.0},
        infer_shape=same_shape_infer(1),
    )
)


# --------------------------------------------------------------------------
# Dropout: scale at train time, identity at inference
# --------------------------------------------------------------------------
def _dropout(attrs, ins, is_train):
    p = float(attrs.get("p", 0.5))
    x = ins[0]
    if not is_train or p <= 0.0:
        return [x]
    gen = attrs["__rng__"]
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=gen.device) < keep
    # JAX divides by keep in x's dtype (bf16: keep rounded to bf16 first)
    return [torch.where(mask, x / scalar_like(keep, x), torch.zeros_like(x))]


register(
    OpDef(
        "Dropout",
        _dropout,
        arguments=("data",),
        defaults={"p": 0.5, "mode": "training"},
        infer_shape=same_shape_infer(1),
        needs_rng=True,
    )
)


# --------------------------------------------------------------------------
# softmax / log_softmax / SoftmaxActivation
# --------------------------------------------------------------------------
register(
    OpDef(
        "softmax",
        lambda attrs, ins, is_train: [torch.softmax(ins[0], dim=int(attrs.get("axis", -1)))],
        arguments=("data",),
        defaults={"axis": -1, "temperature": None},
        infer_shape=same_shape_infer(1),
    )
)
register(
    OpDef(
        "log_softmax",
        lambda attrs, ins, is_train: [
            torch.log_softmax(ins[0], dim=int(attrs.get("axis", -1)))],
        arguments=("data",),
        defaults={"axis": -1, "temperature": None},
        infer_shape=same_shape_infer(1),
    )
)


def _softmax_activation(attrs, ins, is_train):
    x = ins[0]
    if attrs.get("mode", "instance") == "channel":
        return [torch.softmax(x, dim=1)]
    return [torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)]


register(
    OpDef(
        "SoftmaxActivation",
        _softmax_activation,
        arguments=("data",),
        defaults={"mode": "instance"},
        infer_shape=same_shape_infer(1),
    )
)


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


# --------------------------------------------------------------------------
# The other loss heads: forward as given, a backward that ignores the head
# gradient (reference regression_output-inl.h, svm_output-inl.h,
# make_loss-inl.h)
# --------------------------------------------------------------------------
def _onehot(label, depth, like):
    """onehot(int(label)) in ``like``'s dtype, all zeros for an
    out-of-range label, as ``jax.nn.one_hot`` makes it."""
    lbl = label.to(torch.int32).long()
    return (lbl.unsqueeze(-1) == torch.arange(depth, device=like.device)).to(like.dtype)


class _LossHead(torch.autograd.Function):
    """A loss head, as the JAX package's ``custom_vjp`` cores make one: the
    forward is ``act(data)``; the backward ignores the head gradient and
    hands data ``grad_fn(out, label)`` and label (when given) zeros."""

    @staticmethod
    def forward(ctx, data, label, act, grad_fn):
        out = act(data)
        ctx.grad_fn = grad_fn
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return ctx.grad_fn(out, label).to(out.dtype), dlabel, None, None


def _identity(x):
    return x


_REGRESSION = {
    # name: (forward activation, backward from (out, label))
    "LinearRegressionOutput": (_identity, lambda o, l: o - l),
    "LogisticRegressionOutput": (torch.sigmoid, lambda o, l: o - l),
    "MAERegressionOutput": (_identity, lambda o, l: torch.sign(o - l)),
}


def _make_output_op(name):
    act, bwd_fn = _REGRESSION[name]

    def fcompute(attrs, ins, is_train):
        grad_scale = float(attrs.get("grad_scale", 1.0))

        def grad_fn(out, label):
            n = float(np.prod(out.shape[1:])) if out.dim() > 1 else 1.0
            return bwd_fn(out, label.reshape(out.shape)) * (grad_scale / n)

        return [_LossHead.apply(ins[0], ins[1], act, grad_fn)]

    register(
        OpDef(
            name,
            fcompute,
            arguments=("data", "label"),
            defaults={"grad_scale": 1.0},
            infer_shape=lambda attrs, in_shapes: (
                [tuple(in_shapes[0]), tuple(in_shapes[0])],
                [tuple(in_shapes[0])],
                [],
            ),
            need_top_grad=False,
        )
    )


for _name in _REGRESSION:
    _make_output_op(_name)


def _svm_output(attrs, ins, is_train):
    """Identity forward; the hinge loss's gradient: where the margin is
    violated, −sign·reg (L1, ``use_linear``) or −2·(margin − sign·x)·sign·reg
    (L2), with sign +1 at the label's class and −1 elsewhere."""
    margin = float(attrs.get("margin", 1.0))
    reg = float(attrs.get("regularization_coefficient", 1.0))
    use_linear = bool(attrs.get("use_linear", False))

    def grad_fn(data, label):
        sign = 2.0 * _onehot(label, data.shape[-1], data) - 1.0
        viol = (margin - sign * data) > 0
        step = -sign * reg if use_linear else -2.0 * (margin - sign * data) * sign * reg
        return torch.where(viol, step, torch.zeros_like(data))

    return [_LossHead.apply(ins[0], ins[1], _identity, grad_fn)]


register(
    OpDef(
        "SVMOutput",
        _svm_output,
        arguments=("data", "label"),
        defaults={"margin": 1.0, "regularization_coefficient": 1.0, "use_linear": False},
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0]), (in_shapes[0][0],)],
            [tuple(in_shapes[0])],
            [],
        ),
        need_top_grad=False,
    )
)


def _make_loss(attrs, ins, is_train):
    """Identity forward; the gradient grad_scale everywhere, over the batch
    under ``normalization="batch"``."""
    scale = float(attrs.get("grad_scale", 1.0))
    if attrs.get("normalization", "null") == "batch":
        scale = scale / ins[0].shape[0]
    return [_LossHead.apply(ins[0], None, _identity,
                            lambda out, _: torch.full_like(out, scale))]


register(
    OpDef(
        "MakeLoss",
        _make_loss,
        arguments=("data",),
        defaults={"grad_scale": 1.0, "valid_thresh": 0.0, "normalization": "null"},
        infer_shape=same_shape_infer(1),
        need_top_grad=False,
    )
)


def _softmax_cross_entropy(attrs, ins, is_train):
    data, label = ins
    logp = torch.log_softmax(data, dim=-1)
    picked = logp.gather(-1, label.to(torch.int32).long()[:, None])
    return [-picked.sum().reshape(1)]


register(
    OpDef(
        "softmax_cross_entropy",
        _softmax_cross_entropy,
        arguments=("data", "label"),
        infer_shape=lambda attrs, in_shapes: (
            [tuple(in_shapes[0]), (in_shapes[0][0],)],
            [(1,)],
            [],
        ),
    )
)


# --------------------------------------------------------------------------
# UpSampling (reference upsampling-inl.h): nearest; bilinear as a resize
# --------------------------------------------------------------------------
def _upsampling(attrs, ins, is_train):
    scale = int(attrs["scale"])
    if attrs.get("sample_type", "nearest") == "nearest":
        outs = []
        target = None
        for x in ins:
            h, w = x.shape[2], x.shape[3]
            if target is None:
                target = (h * scale, w * scale)
            s = target[0] // h
            outs.append(x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3))
        return [torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]]
    # bilinear: half-pixel centres, edge samples clamped, as
    # jax.image.resize samples an upscale; the weight input is not read
    x = ins[0]
    return [F.interpolate(x, size=(x.shape[2] * scale, x.shape[3] * scale), mode="bilinear",
                          align_corners=False)]


def _upsampling_infer(attrs, in_shapes):
    scale = int(attrs["scale"])
    d0 = in_shapes[0]
    if attrs.get("sample_type", "nearest") == "bilinear":
        kernel = 2 * scale - scale % 2
        wshape = (d0[1], 1, kernel, kernel)
        return [tuple(d0), wshape], [(d0[0], d0[1], d0[2] * scale, d0[3] * scale)], []
    c = sum(s[1] for s in in_shapes)
    return [tuple(s) for s in in_shapes], [(d0[0], c, d0[2] * scale, d0[3] * scale)], []


register(
    OpDef(
        "UpSampling",
        _upsampling,
        arguments=("data",),
        key_var_num_args="num_args",
        defaults={
            "scale": 1,
            "num_filter": 0,
            "sample_type": "nearest",
            "multi_input_mode": "concat",
            "num_args": 1,
            "workspace": 512,
        },
        infer_shape=_upsampling_infer,
    )
)


# --------------------------------------------------------------------------
# Sequence ops (reference sequence_last/mask/reverse-inl.h), TNC layout:
# (seq_len, batch, ...)
# --------------------------------------------------------------------------
def _seq_lengths(attrs, ins, maxlen, batch, device):
    if bool(attrs.get("use_sequence_length", False)) and len(ins) > 1:
        return ins[1].to(torch.int32).long()
    return torch.full((batch,), maxlen, dtype=torch.long, device=device)


def _take_steps(data, idx):
    """data[idx[t, b], b, ...] for an index of shape (T', batch)."""
    idx = idx.reshape(idx.shape + (1,) * (data.dim() - 2))
    return data.gather(0, idx.expand(idx.shape[:2] + data.shape[2:]))


def _sequence_last(attrs, ins, is_train):
    data = ins[0]
    lengths = _seq_lengths(attrs, ins, data.shape[0], data.shape[1], data.device)
    return [_take_steps(data, torch.clamp_min(lengths - 1, 0)[None])[0]]


def _seq_list_arguments(attrs=None):
    return (["data", "sequence_length"] if (attrs or {}).get("use_sequence_length")
            else ["data"])


def _seq_infer(out_shape):
    return lambda attrs, in_shapes: (
        [tuple(s) for s in in_shapes if s is not None], [out_shape(in_shapes[0])], [])


_seq_last = OpDef(
    "SequenceLast",
    _sequence_last,
    arguments=("data", "sequence_length"),
    defaults={"use_sequence_length": False},
    infer_shape=_seq_infer(lambda d: tuple(d[1:])),
)
_seq_last.list_arguments = _seq_list_arguments
register(_seq_last)


def _sequence_mask(attrs, ins, is_train):
    data = ins[0]
    value = float(attrs.get("value", 0.0))
    lengths = _seq_lengths(attrs, ins, data.shape[0], data.shape[1], data.device)
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    mask = (t < lengths[None, :]).reshape((data.shape[0], data.shape[1])
                                          + (1,) * (data.dim() - 2))
    return [torch.where(mask, data, torch.tensor(value, dtype=data.dtype, device=data.device))]


_seq_mask = OpDef(
    "SequenceMask",
    _sequence_mask,
    arguments=("data", "sequence_length"),
    defaults={"use_sequence_length": False, "value": 0.0},
    infer_shape=_seq_infer(tuple),
)
_seq_mask.list_arguments = _seq_list_arguments
register(_seq_mask)


def _sequence_reverse(attrs, ins, is_train):
    data = ins[0]
    lengths = _seq_lengths(attrs, ins, data.shape[0], data.shape[1], data.device)
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    src = torch.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)
    return [_take_steps(data, src)]


_seq_rev = OpDef(
    "SequenceReverse",
    _sequence_reverse,
    arguments=("data", "sequence_length"),
    defaults={"use_sequence_length": False},
    infer_shape=_seq_infer(tuple),
)
_seq_rev.list_arguments = _seq_list_arguments
register(_seq_rev)


# --------------------------------------------------------------------------
# Crop (reference crop-inl.h): the first input cut to the second's (or
# h_w's) spatial size, at an offset or centred
# --------------------------------------------------------------------------
def _crop(attrs, ins, is_train):
    x = ins[0]
    if len(ins) > 1:
        th, tw = ins[1].shape[2], ins[1].shape[3]
    else:
        th, tw = as_tuple(attrs["h_w"], 2, "h_w")
    if bool(attrs.get("center_crop", False)):
        oy = (x.shape[2] - th) // 2
        ox = (x.shape[3] - tw) // 2
    else:
        oy, ox = as_tuple(attrs.get("offset", (0, 0)), 2, "offset")
    return [x[:, :, oy:oy + th, ox:ox + tw]]


def _crop_infer(attrs, in_shapes):
    d0 = in_shapes[0]
    if int(attrs.get("num_args", 1)) > 1 and len(in_shapes) > 1 and in_shapes[1]:
        th, tw = in_shapes[1][2], in_shapes[1][3]
    else:
        th, tw = as_tuple(attrs["h_w"], 2, "h_w")
    return [tuple(s) for s in in_shapes], [(d0[0], d0[1], th, tw)], []


register(
    OpDef(
        "Crop",
        _crop,
        arguments=("data",),
        key_var_num_args="num_args",
        defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0), "center_crop": False},
        infer_shape=_crop_infer,
    )
)
