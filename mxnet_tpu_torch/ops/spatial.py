"""Spatial-transform and matching operators of the port (counterpart of
``mxnet_tpu/ops/spatial.py``): GridGenerator, BilinearSampler,
SpatialTransformer, Correlation and IdentityAttachKLSparseReg, under the JAX
names, defaults and shape inference.

The sampler reads its four corners with gathers and weights them as the
JAX package does, so autograd gives the data and the grid gradients; a
corner outside the map reads 0 (``bilinear_sampler-inl.h``'s zero
padding), corner by corner. Correlation sums each displacement's product
over a k x k window with a sum pool. IdentityAttachKLSparseReg's moving
average is an aux state, written back as BatchNorm's moving statistics
are, and its gradient term reads the updated average.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, register
from .utils import as_tuple


# ---------------------------------------------------------------------------
# bilinear sampling core (shared by BilinearSampler / SpatialTransformer)
# ---------------------------------------------------------------------------
def _bilinear_sample(data, grid):
    """Sample ``data`` [B,C,H,W] at the normalized ``grid`` [B,2,Ho,Wo]:
    channel 0 is x, channel 1 y, both in [-1, 1], mapped as
    x_real = (x + 1)(W - 1)/2; a corner outside the map contributes 0."""
    b_n, c_n, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0  # [B,Ho,Wo]
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = data.reshape(b_n, c_n, h * w)

    def corner(y, x):
        yi = torch.clamp(y, 0, h - 1).to(torch.int64)
        xi = torch.clamp(x, 0, w - 1).to(torch.int64)
        valid = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
        idx = (yi * w + xi).reshape(b_n, 1, -1).expand(b_n, c_n, -1)
        vals = torch.gather(flat, 2, idx).reshape((b_n, c_n) + tuple(y.shape[1:]))
        return vals * valid[:, None].to(data.dtype)

    out = (corner(y0, x0) * (wy0 * wx0)[:, None]
           + corner(y0, x0 + 1) * (wy0 * wx1)[:, None]
           + corner(y0 + 1, x0) * (wy1 * wx0)[:, None]
           + corner(y0 + 1, x0 + 1) * (wy1 * wx1)[:, None])
    return out.to(data.dtype)


def _affine_grid(theta, target_shape):
    """theta [B,6] -> the normalized grid [B,2,H,W]: theta as [B,2,3] times
    the rows (x, y, 1) of the target's grid, x and y spaced evenly over
    [-1, 1] (computed in f64 and rounded to theta's dtype, as the JAX
    package's ``jnp.linspace`` under x64)."""
    h, w = target_shape
    if h <= 0 or w <= 0:
        raise MXNetError("target_shape is required and must be positive, got %s"
                         % (target_shape,))
    b = theta.shape[0]
    f64 = dict(dtype=torch.float64, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, **f64) if w > 1 else torch.zeros(1, **f64)
    ys = torch.linspace(-1.0, 1.0, h, **f64) if h > 1 else torch.zeros(1, **f64)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H,W]
    src = torch.stack([gx, gy, torch.ones_like(gx)], dim=0).reshape(3, h * w)
    mat = theta.reshape(b, 2, 3)
    grid = torch.einsum("bij,jk->bik", mat, src.to(theta.dtype))
    return grid.reshape(b, 2, h, w)


# ---------------------------------------------------------------------------
# GridGenerator
# ---------------------------------------------------------------------------
def _grid_generator(attrs, ins, is_train):
    ttype = attrs.get("transform_type", "affine")
    if ttype == "affine":
        target = as_tuple(attrs["target_shape"], 2, "target_shape")
        return [_affine_grid(ins[0], target).to(ins[0].dtype)]
    if ttype == "warp":
        flow = ins[0]  # [B,2,H,W] pixel offsets
        _, _, h, w = flow.shape
        xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
        ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
        gx = (flow[:, 0] + xs[None, None, :]) * (2.0 / max(w - 1, 1)) - 1.0
        gy = (flow[:, 1] + ys[None, :, None]) * (2.0 / max(h - 1, 1)) - 1.0
        return [torch.stack([gx, gy], dim=1)]
    raise MXNetError("GridGenerator: unknown transform_type %s" % ttype)


def _grid_generator_infer(attrs, in_shapes):
    ttype = attrs.get("transform_type", "affine")
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("GridGenerator: input shape required")
    if ttype == "affine":
        target = as_tuple(attrs["target_shape"], 2, "target_shape")
        if len(dshape) != 2 or (dshape[1] not in (0, 6)):
            raise MXNetError("GridGenerator(affine): data must be [batch, 6], got %s"
                             % (dshape,))
        return [(dshape[0], 6)], [(dshape[0], 2) + target], []
    if len(dshape) != 4 or dshape[1] not in (0, 2):
        raise MXNetError("GridGenerator(warp): data must be [batch,2,H,W], got %s"
                         % (dshape,))
    full = (dshape[0], 2, dshape[2], dshape[3])
    return [full], [full], []


register(
    OpDef(
        "GridGenerator",
        _grid_generator,
        arguments=("data",),
        defaults={"transform_type": "affine", "target_shape": (0, 0)},
        infer_shape=_grid_generator_infer,
    )
)


# ---------------------------------------------------------------------------
# BilinearSampler
# ---------------------------------------------------------------------------
def _bilinear_sampler_infer(attrs, in_shapes):
    dshape, gshape = in_shapes
    if dshape is None or gshape is None:
        raise MXNetError("BilinearSampler: data and grid shapes required")
    if len(dshape) != 4 or len(gshape) != 4:
        raise MXNetError("BilinearSampler: data/grid must be 4D")
    out = (dshape[0], dshape[1], gshape[2], gshape[3])
    return [tuple(dshape), (dshape[0], 2, gshape[2], gshape[3])], [out], []


register(
    OpDef(
        "BilinearSampler",
        lambda attrs, ins, is_train: [_bilinear_sample(ins[0], ins[1])],
        arguments=("data", "grid"),
        infer_shape=_bilinear_sampler_infer,
    )
)


# ---------------------------------------------------------------------------
# SpatialTransformer (the affine GridGenerator and the BilinearSampler)
# ---------------------------------------------------------------------------
def _spatial_transformer(attrs, ins, is_train):
    if attrs.get("transform_type", "affine") != "affine":
        raise MXNetError("SpatialTransformer: only affine supported (as reference)")
    if attrs.get("sampler_type", "bilinear") != "bilinear":
        raise MXNetError("SpatialTransformer: only bilinear supported (as reference)")
    data, loc = ins
    target = as_tuple(attrs["target_shape"], 2, "target_shape")
    grid = _affine_grid(loc, target)
    return [_bilinear_sample(data, grid.to(data.dtype))]


def _spatial_transformer_infer(attrs, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("SpatialTransformer: data shape required")
    target = as_tuple(attrs["target_shape"], 2, "target_shape")
    out = (dshape[0], dshape[1]) + target
    return [tuple(dshape), (dshape[0], 6)], [out], []


register(
    OpDef(
        "SpatialTransformer",
        _spatial_transformer,
        arguments=("data", "loc"),
        defaults={"transform_type": "affine", "sampler_type": "bilinear",
                  "target_shape": (0, 0)},
        infer_shape=_spatial_transformer_infer,
    )
)


# ---------------------------------------------------------------------------
# Correlation (FlowNet cost volume)
# ---------------------------------------------------------------------------
def _corr_dims(attrs, dshape):
    k = int(attrs.get("kernel_size", 1))
    md = int(attrs.get("max_displacement", 1))
    s1 = int(attrs.get("stride1", 1))
    s2 = int(attrs.get("stride2", 1))
    pad = int(attrs.get("pad_size", 0))
    kr = (k - 1) // 2
    border = md + kr
    ph, pw = dshape[2] + 2 * pad, dshape[3] + 2 * pad
    top_h = int(math.ceil((ph - 2 * border) / float(s1)))
    top_w = int(math.ceil((pw - 2 * border) / float(s1)))
    if top_h <= 0 or top_w <= 0:
        raise MXNetError("Correlation: output size would be empty")
    radius = md // s2
    ngrid = 2 * radius + 1
    return k, md, s1, s2, pad, kr, top_h, top_w, radius, ngrid


def _correlation(attrs, ins, is_train):
    d1, d2 = ins
    k, md, s1, s2, pad, _, top_h, top_w, radius, _ = _corr_dims(attrs, d1.shape)
    is_multiply = bool(attrs.get("is_multiply", True))
    c = d1.shape[1]
    # an extra kernel length of padding keeps every displacement's window
    # slice in bounds, whatever k's parity
    extra = k
    acc_t = torch.promote_types(d1.dtype, torch.float32)
    cfg = (pad, pad + extra, pad, pad + extra)
    p1 = F.pad(d1.to(acc_t), cfg)
    p2 = F.pad(d2.to(acc_t), cfg)
    span_h = (top_h - 1) * s1 + k
    span_w = (top_w - 1) * s1 + k
    a = p1[:, :, md:md + span_h, md:md + span_w]
    norm = float(k * k * c)
    maps = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sh, sw = dy * s2, dx * s2
            b = p2[:, :, md + sh:md + sh + span_h, md + sw:md + sw + span_w]
            term = a * b if is_multiply else torch.abs(a - b)
            term = term.sum(dim=1, keepdim=True)  # over channels
            box = F.avg_pool2d(term, k, stride=s1, divisor_override=1)  # window sums
            maps.append(box[:, 0] / norm)
    out = torch.stack(maps, dim=1)  # [B, ngrid^2, top_h, top_w]
    return [out.to(d1.dtype)]


def _correlation_infer(attrs, in_shapes):
    dshape = in_shapes[0] or in_shapes[1]
    if dshape is None:
        raise MXNetError("Correlation: input shape required")
    _, _, _, _, _, _, top_h, top_w, _, ngrid = _corr_dims(attrs, dshape)
    out = (dshape[0], ngrid * ngrid, top_h, top_w)
    return [tuple(dshape), tuple(dshape)], [out], []


register(
    OpDef(
        "Correlation",
        _correlation,
        arguments=("data1", "data2"),
        defaults={"kernel_size": 1, "max_displacement": 1, "stride1": 1, "stride2": 1,
                  "pad_size": 0, "is_multiply": True},
        infer_shape=_correlation_infer,
    )
)


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg
# ---------------------------------------------------------------------------
class _IdentityWithKL(torch.autograd.Function):
    """Identity forward; the backward adds the KL sparseness term
    penalty * (-rho / avg + (1 - rho) / (1 - avg)) per channel, from the
    moving average ``avg`` of this step."""

    @staticmethod
    def forward(ctx, x, avg, penalty, rho):
        ctx.save_for_backward(avg)
        ctx.penalty, ctx.rho = penalty, rho
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (avg,) = ctx.saved_tensors
        eps = 1e-8
        kl_grad = ctx.penalty * (-ctx.rho / (avg + eps) + (1.0 - ctx.rho) / (1.0 - avg + eps))
        if g.dim() > 1:
            bshape = [1] * g.dim()
            bshape[1] = g.shape[1]
            kl_grad = kl_grad.reshape(bshape)
        return g + kl_grad.to(g.dtype), None, None, None


def _kl_sparse_fcompute(attrs, ins, is_train):
    data, moving_avg = ins
    momentum = float(attrs.get("momentum", 0.9))
    penalty = float(attrs.get("penalty", 0.001))
    rho = float(attrs.get("sparseness_target", 0.1))
    if is_train:
        axes = tuple(i for i in range(data.dim()) if i != 1)
        rho_hat = data.detach().mean(dim=axes)
        new_avg = momentum * moving_avg + (1.0 - momentum) * rho_hat
    else:
        new_avg = moving_avg
    return [_IdentityWithKL.apply(data, new_avg.detach(), penalty, rho), new_avg.detach()]


def _kl_sparse_infer(attrs, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("IdentityAttachKLSparseReg: data shape required")
    c = dshape[1] if len(dshape) > 1 else dshape[0]
    return [tuple(dshape)], [tuple(dshape)], [(c,)]


register(
    OpDef(
        "IdentityAttachKLSparseReg",
        _kl_sparse_fcompute,
        arguments=("data",),
        aux=("moving_avg",),
        defaults={"momentum": 0.9, "penalty": 0.001, "sparseness_target": 0.1},
        infer_shape=_kl_sparse_infer,
    )
)
