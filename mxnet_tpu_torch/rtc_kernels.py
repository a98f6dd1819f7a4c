"""Four CUDA C kernel bodies for ``mx.rtc`` (kernel K5), each beside its
plain PyTorch version; ``chip_smoke.py`` and the card-only tests run them.

- ``AXPB`` (a) and ``MADD`` (b): ``tests/test_rtc.py``'s kernels,
  y = 2x + 1 and out = a·b + a, as grid-stride loops over ``<out>_size``.
- ``EXP5`` (c): the reference rtc docstring's example, y = exp(5x) staged
  through ``__shared__`` memory; push it with ``block_dims=(n, 1, 1)``,
  n ≤ 1024, and ``grid_dims`` covering the array in blocks of n.
- :func:`sgd_mom_source` (d): an SGD-momentum step with MXNet's formula
  (``sgd_mom_update``), lr / momentum / wd / rescale_grad baked into the
  text; ``grad`` is the input, ``weight`` and ``mom`` outputs updated in
  place. Its plain version is ``mx.nd.sgd_mom_update``.

Each body computes in f32 and stores in its array's type (``<name>_t``),
so one body serves float32 and bfloat16 arrays. An elementwise pass like
these moves bytes and does few operations: its bound on the card is the
bytes read and written over the HBM bandwidth.
"""
from __future__ import annotations

import torch

AXPB = ("axpb", ("x",), ("y",), """
for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < y_size;
     i += (long long)gridDim.x * blockDim.x)
    y[i] = (y_t)((float)x[i] * 2.0f + 1.0f);
""")

MADD = ("madd", ("a", "b"), ("out",), """
for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < out_size;
     i += (long long)gridDim.x * blockDim.x)
    out[i] = (out_t)((float)a[i] * (float)b[i] + (float)a[i]);
""")

EXP5 = ("exp5", ("x",), ("y",), """
__shared__ float s_rec[x_size < 1024 ? x_size : 1024];
long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
if (i < x_size) s_rec[threadIdx.x] = (float)x[i];
__syncthreads();
if (i < y_size) y[i] = (y_t)expf(s_rec[threadIdx.x] * 5.0f);
""")


def axpb_plain(x):
    return (x.float() * 2.0 + 1.0).to(x.dtype)


def madd_plain(a, b):
    af = a.float()
    return (af * b.float() + af).to(a.dtype)


def exp5_plain(x):
    return torch.exp(x.float() * 5.0).to(x.dtype)


def _f32(v):
    """A float literal that reads back as the f32 nearest to ``v``."""
    return "%.9ef" % float(v)


def sgd_mom_source(lr, momentum, wd=0.0, rescale_grad=1.0):
    """Body of kernel (d): for each element, g = grad·rescale_grad + wd·w,
    mom = momentum·mom − lr·g, w += mom (``optimizer_ops.py:54``'s order),
    in f32. Each product and sum is its own rounded intrinsic
    (``__fmul_rn``, ``__fadd_rn``), which the compiler never contracts into
    an FMA, so the update rounds as ``sgd_mom_update``'s separate torch ops
    do."""
    return ("sgd_mom", ("grad",), ("weight", "mom"), """
for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < weight_size;
     i += (long long)gridDim.x * blockDim.x) {
    float w = (float)weight[i];
    float g = __fadd_rn(__fmul_rn((float)grad[i], %s), __fmul_rn(%s, w));
    float m = __fsub_rn(__fmul_rn(%s, (float)mom[i]), __fmul_rn(%s, g));
    mom[i] = (mom_t)m;
    weight[i] = (weight_t)__fadd_rn(w, m);
}
""" % (_f32(rescale_grad), _f32(wd), _f32(momentum), _f32(lr)))


def grid_stride_dims(size, threads=256, max_blocks=1056):
    """(grid_dims, block_dims) of a grid-stride loop over ``size`` elements:
    ``threads`` a block, at most ``max_blocks`` blocks (8 for each of the
    H100's 132 SMs)."""
    blocks = max(1, min(max_blocks, -(-int(size) // threads)))
    return (blocks, 1, 1), (threads, 1, 1)


def make(spec, inputs, outputs):
    """An ``Rtc`` of ``spec`` (name, input names, output names, body) with
    ``inputs`` / ``outputs`` NDArrays as its templates."""
    from .rtc import Rtc

    name, in_names, out_names, body = spec
    return Rtc(name, list(zip(in_names, inputs)), list(zip(out_names, outputs)), body)
