#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --only f32_lm --package DIR  # phase 19 and 8 on another tree
    python3 chip_smoke.py --only rtc --package DIR     # K5's push path on another tree
    python3 chip_smoke.py --only slab --package DIR    # phases 16-18 and K1's times there
    python3 chip_smoke.py --only zoo                   # K2/K3's build and phase 20


Phases, each fatal on failure:

1. device: the card's name and power limit; build every CUDA kernel from
   the sources in this checkout (nvcc, sm_90a, one process per source, all
   started together) and time the build; ptxas's registers and spills of
   each kernel. Then ``cuobjdump -sass`` (beside nvcc) of the flash and
   conv libraries, read by function: every flash kernel, bf16 and split
   f32, and every bf16 and f32 K2 and K3 kernel (flash_fwd_sm90,
   flash_fwd_split_sm90 at D 16-128, flash_dq_sm90 and flash_dkv_sm90 at
   D 16-128 on one bf16 plane or the hi and lo planes of split f32;
   conv_wgrad_sm90 and conv_dgrad_sm90 at 64
   and 128 channels a tile, on one bf16 plane or the hi and lo planes of
   split f32, K2 in CTAs of one and two warpgroups, reading channels-last
   copies or, bf16 only, NCHW in place) holds HGMMA (wgmma) and UTMALDG
   (TMA load) instructions; no SIMT flash kernel and no SIMT filter- or
   data-gradient kernel of any type is left.
2. forward kernel vs plain: the flash-attention forward kernels against
   their plain PyTorch version on the card, f32 to 1e-4 and bf16 to 2e-2
   (the plain version rounds its scores to bf16; the bf16 kernel keeps them
   in f32 and rounds P to bf16 before P·V), D 16 to 128, T 7 to 2048,
   contiguous operands and transposed views of [B, H, T, D] tensors (which
   TMA reads in place), and in f32 at FLASH_DEEP (T 4096 and 8192, D 64
   and 128, causal and not, n·H 1-2); a second launch gives the same bits.
   The split pass of the f32 kernels (``split_planes``) is bit for bit
   ``split_bf16`` on the training path's four operands and on a
   [B, H, T, D] view, and repeatable.
3. backward kernels vs plain: dq and dk/dv kernels against
   ``reference_attention_bwd`` on the same q, k, v, dO, lse and delta, for
   T in 7..2048, D 16 to 128, causal or not, f32 and bf16, contiguous
   and as [B, H, T, D] views, and in f32 at FLASH_DEEP; error relative
   to max|plain| at most 1e-4 in f32 (the split f32 dq and dk/dv kernels
   take three bf16 products of hi and lo planes for each f32 one, split
   dS, Pᵀ and dSᵀ into hi and lo planes in registers, and add each K/V
   tile's (dq) or q tile's (dk, dv) products into the sum after a zeroed
   partial, so the error does not grow with T) and 2e-2 in
   bf16 (the outputs differ by about one bf16 rounding, 2^-8 relative, and
   the bf16 kernels round dS to bf16 before dS·K, and P^T and dS^T before
   P^T·dO and dS^T·Q); and a second launch on the same inputs gives the
   same bits.
4. serving, f32: the full-width transformer LM at depth 2; prefill
   last-token logits through the kernel agree with the same forward
   through the plain attention at rtol = atol = 1e-3.
5. training, f32: the full-width LM at depth 2, batch 2, T 1000: loss and
   backward through the three kernels against the same with the plain
   attention; every parameter gradient agrees at rtol = atol = 1e-3 of its
   max|.| (the embedding's gradient is accumulated with atomics, so it is
   not bitwise stable); each kernel ran twice.
6. serving, bf16 (main path 1): the full model (vocab 32000, d_model 1024,
   16 heads, 12 layers, d_ff 4096, KV window 2048, 4 slots) behind a
   GenerationEngine on the card; 8 requests of 32 new tokens each. The
   kernel launch counts are zeroed just before and read just after: the
   flash kernel must have run n_layers times per prefill dispatch.
7. training, bf16 (main path 2): 10 SGD steps of the example trainer
   ``train(...)`` on the full model (batch 8, T 2047, f32 masters) on one
   batch of its corpus: every loss finite, the last below the first, and
   the forward, dq and dk/dv kernels each launched exactly n_layers times
   per step (counts zeroed just before); step ms, tokens/s, peak memory.
   Phase 19 (main path 6) is the same in f32, the trainer's default.
8. attention kernel times: per flash kernel its launches on the main
   paths, error against the plain version, time (``ms``: CUDA events
   around one call, median, L2 flushed before each, so the host's enqueue
   of the call shows where the card would wait for it), the plain
   version's time, the least time
   the card could take (bytes at 3.35 TB/s or operations at 989 TFLOP/s,
   H100 SXM data sheet) and one PyTorch call computing the same function
   as a yardstick the port never calls (scaled_dot_product_attention, and
   its backward for dq, dk and dv together). Beside them, for the kernel
   and for that call: ``device_ms``, the same span with a ~0.5 ms sleep
   kernel queued first, so the events time the card alone, and
   ``host_ms``, the host's time to enqueue one call. The same for the f32
   kernels (three bf16 products of split planes, the split pass inside
   each standalone call and its own ``split_device_ms`` beside) at T 2048
   and at the training path's shape, against f32
   scaled_dot_product_attention (TF32 off), under each entry's ``f32``
   (and ``f32_shapes``) key, their bound counted as for f32 K2 and K3
   (phase 12); beside the backward's, ``pair``: dq and dk/dv as the
   autograd backward runs them, on the planes of one split pass, against
   f32 SDPA's backward.
9. conv-backward kernels vs plain: K2 (conv_bwd_filter) and K3
   (conv_bwd_input) against their plain versions on every distinct
   in-envelope convolution shape of ResNet-50 at batch 32 (from
   ``infer_shape``) and on ragged small shapes (N 1 to 3, H x W 7 x 7 to
   17 x 17, k 1/3/5, 1 x 7 and 3 x 1, pad 0-3, C and O 8-512, 24 in and
   out), f32 and bf16, and in f32 on the shapes whose sums are the longest
   (``CONV_DEEP``: ResNet-50's at batch 256, AlexNet's conv2 at 512): the f32
   outputs before any cast within 1e-4 of max|plain| (bf16 products are
   exact in f32 and summed in another order; an f32 product is taken as
   three bf16 products of its hi and lo planes, about 5e-6 of max), and a
   second launch gives the same bits. grad's channels-last copy (f32: its
   two planes) made once and handed to both kernels (``g_cl``), and the
   autograd Function's backward that does so, give the standalone
   wrappers' bits.
10. ResNet-50 gradients, f32: full width and depth, batch 2, 224 x 224,
    weights from ``init_params``: every parameter gradient and new aux
    state through K2/K3 against the same through their plain versions, at
    rtol = atol = 1e-3 of each tensor's max|.|; each kernel ran 46 times.
    A tensor that two runs of the plain path do not reproduce to 1e-3 of
    its max (bn0_gamma: a cancelling sum, moved by ops outside K2/K3 that
    are not bitwise repeatable) is held to three times that spread.
11. ResNet-50 training (main path 3): ``tools/resnet_bench.py``'s step
    (bench.py's SGD-momentum step) at batch 32, one warm-up and 5 steps on
    one fixed random batch, in f32 (TF32 off) and in bf16: every loss
    (the cross-entropy of the softmax output) finite, the last below the
    first, K2 and K3 each launched exactly 46 times a step (counts zeroed
    just before); step ms, img/s, model TFLOP/s, peak memory.
12. conv kernel times: K2, K3, their plain versions and the library calls
    (``torch.nn.grad.conv2d_weight`` / ``conv2d_input``, which the port
    never calls) at every distinct in-envelope ResNet-50 shape at batch
    32, bf16 and f32, each kernel and library call also as ``device_ms``
    (after a sleep kernel: the card alone) and the kernel's ``host_ms``
    (the host's enqueue of one call); the launch-weighted total a step;
    the kernels-line entry at the shape where the kernel spends the most
    of a bf16 step, with bound = max(bytes / 3.35 TB/s, 2·N·OH·OW·O·C·kh·kw
    / 989 TFLOP/s); in f32, the bytes of f32 inputs and three times the
    operations at the bf16 rate (each f32 product is three bf16 ones,
    ``bound_counts``).

13. Rtc (kernel K5, CUDA C through NVRTC): the kernel bodies of
    ``rtc_kernels`` — (a) y = 2x + 1, (b) a·b + a, (c) exp(5x) through
    shared memory with ``block_dims=(n, 1, 1)`` — at tests/test_rtc.py's
    sizes (8 x 128, 4 x 128) and at 32 x 64 x 112 x 112, f32 and bf16,
    against their plain versions: f32 within rtol 1e-6 (FMA contraction),
    bf16 within one bf16 ulp; a second push gives the same bits. The cache
    holds 1, then 1, then 2 entries; a bad source and a wrong array count
    each raise MXNetError.
14. Executor at full width: ResNet-50 (1000 classes) bound with
    ``simple_bind(mx.gpu(0), data=(32, 3, 224, 224))`` in f32, TF32 off,
    with phase 11's weights and batch; ``forward(is_train=True)`` and
    ``backward()`` against ``resnet_bench.make_train_step``'s step on the
    same program: every gradient (as the step's first momentum, −lr·(g/32 +
    wd·p)) and new aux state within 1e-6 of its max; 46 launches of K2 and
    of K3 in the backward. Phases 14 and 15 run cuDNN deterministic: its
    default backward of the 7 strided convolutions sums in a run-dependent
    order, which moves cancelling sums such as bn_data_beta's gradient by
    ~2e-5 of their max between two runs.
15. Training through Executor and Rtc (main path 4): six steps of
    forward / backward, then kernel (d) (``rtc_kernels.sgd_mom_source``,
    bench.py's lr 0.1, momentum 0.9, wd 1e-4, rescale 1/32) pushed on
    every parameter NDArray; the same six steps on a second executor with
    ``mx.nd.sgd_mom_update``. Parameters agree within 1e-5 of each tensor's
    max, the loss falls, K5 ran once per parameter array a step, K2 and K3
    46 times a step (counts zeroed just before), and NVRTC compiled once
    per distinct parameter shape, none after step 1. Then the times of a
    step's kernel (d) launches and of the plain updates (CUDA events, L2
    flushed before each step), the bound (20 bytes an element at 3.35
    TB/s) and NVRTC ms per compile; ``host_ms``, the host's enqueue of one
    push and (``host_ms_step``) of the step's pushes, and ``device_ms``,
    the card's time for the step's launches (a sleep kernel queued first,
    long enough to cover the enqueue); one launch on the largest parameter
    array against its bound; phase 14's forward + backward ms.

16. Optimizer-slab kernel K1 against its plain version: one slab
    (``fused_slab_update``, a table of one) for sgd, sgd_mom and adam, bf16
    and f32 gradients, clipping on and off, a finite and a skipped step, at
    S = 131, 1024, 5000, 2,359,296 and every bucket size of ResNet-50's AMP
    plan at dp 4; then tables in one call (``fused_slab_update_multi``):
    ResNet-50's 16 buckets and seven slabs of 1-7 elements at offsets 1-3
    off the 16-byte boundary, each with its own lr (one a device tensor)
    and wd, for each kind and gradient type, finite and skipped, with and
    without clipping, and replicated mode's 64 dp chunks of the buckets with
    the small slabs (71 slabs, three launches): master, states and the bf16
    copy bit for bit (the kernel rounds each operation once, as each
    PyTorch op of the plain version does), a skipped step returns its
    inputs bit for bit, a repeat gives the same bits, a call takes one
    launch a table of up to 32 slabs; one launch
    of each wrapper under ``torch.cuda.set_sync_debug_mode("error")`` (the
    table's in place, with host lrs, as the trainer makes it) shows neither
    waits for the device. Then K1's kernels-line entry: one step's update
    over ResNet-50's 16 buckets as the trainer hands it over (sgd_mom, bf16
    gradient, in place): ``ms`` (CUDA events, L2 flushed), ``device_ms``
    (after a sleep kernel), ``host_ms`` (the enqueue), the plain version's
    device ms, the bound (20 bytes an element at 3.35 TB/s) in total and a
    bucket beside each bucket's one-slab call, the card time of K1 in phase
    17's profile, and the trainer's whole AMP update
    (``_apply_optimizer_flat_amp`` on phase 17's plan: gradient slabs,
    finite flag, K1, loss scaler) timed the same way. ``--only slab`` runs
    the build of K1, phases 16-18 and this entry on any tree's package
    (``--package``; a tree without the table wrapper takes one call a
    bucket), so that a parent and a change are timed in one call.
17. ResNet-50 through ``Module.fit`` with bf16 AMP (main path 5): the
    imagenet ResNet-50 at batch 32, ``Module(context=mx.gpu(0),
    mesh=make_mesh(dp=4, devices=[mx.gpu(0)] * 4))``, ``kvstore="device"``,
    SGD (lr 0.1, momentum 0.9, wd 1e-4), Xavier, ``MXTPU_AMP=bf16``, over an
    NDArrayIter of 8 seeded batches: AMP on and the flat update in shard
    mode; K1 launched once a step over the 16 buckets, K2 and K3 46 times a
    step (counts zeroed just before ``fit``); every working param bf16 and
    equal to bf16(master), ``get_params`` f32 and equal to the masters;
    every loss finite, the loss scale unchanged and the good count 8. Then a
    batch poisoned with inf (one K1 launch) leaves params, masters and
    states bit for bit, halves the scale and zeroes the count, and a clean
    step after it updates. Step ms (median of steps 3-8), img/s, peak
    memory; then two more steps under torch.profiler: wall and device-busy
    ms a step, the idle share, kernels a step and device ms per kernel
    family.
18. Convergence on the card (the verify skill's drive 1): 10 seeded
    gaussian blobs in 784 dimensions, ``models/mlp.py``, 3 epochs; (a) on
    ``gpu(0)`` with ``kvstore="local"`` (the executor-group path), (b) on
    the dp 4 mesh with AMP and Adam (K1's adam variant, one launch a step):
    validation accuracy at least 0.97 in both.

19. training, f32 (main path 6; run after phase 7): phase 7 with the
    trainer's default dtype, f32 (the same full model, batch 8, T 2047,
    10 SGD steps on one batch): every loss finite, the last below the
    first, the forward, dq and dk/dv kernels each launched exactly
    n_layers times a step and the split pass twice as often (one for each
    forward and one for each backward, whose dq and dk/dv kernels share
    it); step ms (median of the steps before the last two), tokens/s, peak
    memory; the last two steps run under torch.profiler: wall and
    device-busy ms a step, the idle share, and device ms a step per kernel
    family (the split pass, the three flash kernels, f32 GEMMs, reductions,
    elementwise).

20. the image-classification zoo (main path 7): (a) K2 and K3 against their
    plain versions, as in phase 9, on every distinct in-envelope convolution
    shape of alexnet (batch 512), vgg-16, googlenet, inception-bn,
    inception-v3, inception-resnet-v2 and resnext-50 (batch 32) at their
    published image sides, f32 and bf16 (non-square 1 x 7 / 7 x 1 / 1 x 3 /
    3 x 1 kernels, sides 147 to 8 that are not multiples of K2/K3's 8 x 8
    patch, 1 x 1 convolutions whose OH·OW is not a multiple of 8, 24
    channels); (b) f32 gradients of inception-v3 and alexnet at full width,
    batch 8, through K2/K3 against their plain versions, as phase 10 holds
    ResNet-50's; (c) the model sweep's step (``tools/model_sweep.py``, one
    warm-up and 3 timed steps) on inception-bn, inception-v3 and alexnet in
    f32 and bf16, and on vgg-16, googlenet, resnext-50 and
    inception-resnet-v2 in f32, each at its published batch and side
    (vgg-16 and googlenet, which have no BatchNorm, at lr 0.001: at the
    sweep's 0.1 their losses reach NaN within four steps from the sweep's
    init, in the JAX package as in the port): the
    losses finite and K2 and K3 each launched once a step for each of the
    model's in-envelope convolutions (counts zeroed before each row); img/s,
    step ms, model TFLOP/s, peak memory; (d) K2 and K3 at every distinct f32
    shape of an inception-v3 step at batch 32 against the library calls, as
    phase 12 times them, summed over the step's 89 launches.

Then the kernels line: the seven kernels, K4f, K4dq, K4dkv, K2, K3, K5 and
K1; K2's and K3's launches count phase 20's training rows, and their
entries carry phase 20's launches and inception-v3 step under ``zoo``.

The last line of output is {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
FULL = dict(vocab=32000, d_model=1024, n_heads=16, n_layers=12, d_ff=4096)
MAX_LEN = 2048
SLOTS = 4
PROMPT_LENGTHS = (5, 60, 128, 300, 700, 1000, 1500, 2000)
MAX_NEW = 32
TRAIN = dict(batch_size=8, seq_len=2047, steps=10, lr=3e-2)  # T = 2047
BWD_CHECK_T = (7, 100, 128, 512, 1000, 2048)
BWD_CHECK_EXTRA = [(2047, 64), (2047, 128), (7, 16), (100, 16), (2047, 16), (7, 32), (100, 32),
                   (2047, 32), (300, 64, "bhtd"), (2047, 128, "bhtd")]
# (T, D[, "bhtd": transposed [B, H, T, D] views]) beside BWD_CHECK_T x (64, 128)
BWD_TIME_SHAPE = (8, 2047, 16, 64)  # n, T, H, D of the training path's attention
# f32 (n, T, H, D) where the sums of the split f32 kernels are longest, small
# n·H so the plain version's [T, T] scores fit; causal and not
FLASH_DEEP = [(1, 4096, 2, 64), (1, 4096, 2, 128), (1, 8192, 2, 64), (1, 8192, 1, 128)]
RESNET_BATCH = 32
RESNET_STEPS = 5
RESNET_CONVS = 46  # in-envelope convolutions of ResNet-50: K2 and K3 launches a step
RTC_STEPS = 6
RTC_BIG = (32, 64, 112, 112)
SGD = dict(lr=0.1, momentum=0.9, wd=1e-4)  # bench.py's step; rescale_grad = 1 / batch
# ragged (data, weight, pad) shapes: N 1 and 3, H x W 7 x 7 and 9 x 11, k 1/3/5, pad 0-2;
# non-square kernels (1 x 7 pad (0, 3) on 17 x 17, 3 x 1 pad (1, 0) on 8 x 8) and 24
# channels in and out (googlenet's 5 x 5 and its 512 -> 24 reduce)
CONV_RAGGED = [
    ((1, 8, 7, 7), (16, 8, 3, 3), (1, 1)),
    ((3, 16, 9, 11), (8, 16, 1, 1), (0, 0)),
    ((3, 24, 9, 11), (40, 24, 5, 5), (2, 2)),
    ((1, 64, 7, 7), (72, 64, 3, 3), (0, 0)),
    ((3, 8, 9, 11), (8, 8, 5, 5), (1, 1)),
    ((1, 72, 9, 11), (64, 72, 1, 1), (0, 0)),
    ((3, 16, 17, 17), (24, 16, 1, 7), (0, 3)),
    ((2, 24, 8, 8), (16, 24, 3, 1), (1, 0)),
    ((2, 24, 14, 14), (64, 24, 5, 5), (2, 2)),
    ((2, 512, 14, 14), (24, 512, 1, 1), (0, 0)),
]
# f32 shapes of ResNet-50 at batch 256 whose sums are the longest: K2's
# 56 x 56 ones (the most k steps a split) and K3's 512-channel 3 x 3
CONV_DEEP = [
    ((256, 64, 56, 56), (64, 64, 3, 3), (1, 1)),
    ((256, 64, 56, 56), (64, 64, 1, 1), (0, 0)),
    ((256, 64, 56, 56), (256, 64, 1, 1), (0, 0)),
    ((256, 256, 56, 56), (64, 256, 1, 1), (0, 0)),
    ((256, 512, 7, 7), (512, 512, 3, 3), (1, 1)),
    # AlexNet's conv2 at batch 512 and 224 x 224 images (26 x 26, 5 x 5 pad 2):
    # the longest K2 sum of any path
    ((512, 96, 26, 26), (256, 96, 5, 5), (2, 2)),
]
# phase 20: the image-classification zoo at its published batch and image
# side. The model sweep's rows other than ResNet, trained in f32 and bf16,
# and the rest of the zoo, trained in f32 at batch 32: name -> ((model
# module, get_symbol kwargs), side, batch, K80 img/s or None)
ZOO_SWEEP = ("inception-bn", "inception-v3", "alexnet")
ZOO_EXTRA = {
    "vgg-16": (("vgg", {"num_layers": 16}), 224, 32, None),
    "googlenet": (("googlenet", {}), 224, 32, None),
    "resnext-50": (("resnext", {"num_layers": 50}), 224, 32, None),
    "inception-resnet-v2": (("inception_resnet_v2", {}), 299, 32, None),
}
# the sweep's step at lr 0.1 takes the two models without BatchNorm to NaN
# losses within four steps from the sweep's init, in the JAX package as in
# the port: they train at this lr
ZOO_LR = {"vgg-16": 1e-3, "googlenet": 1e-3}
ZOO_STEPS = 3  # timed steps of a phase 20 training row, after one warm-up
ZOO_GRAD_BATCH = 8  # phase 20 (b): the plain path's runs fit beside the kernel's
ZOO_GRAD_MODELS = ("inception-v3", "alexnet")


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled):
    """``flash_fwd_sm90<64>`` from a mangled kernel name."""
    m = re.search(r"\d+((?:flash|conv|slab)_[a-z0-9_]+?)I", mangled)
    if not m:
        return mangled[:80]
    args = re.findall(r"13__nv_bfloat16|L[a-z]\d+E|f",
                      mangled[m.end():mangled.find("EEv", m.end()) + 1])
    names = ["bf16" if a[0] == "1" else "float" if a == "f" else a[2:-1] for a in args]
    return "%s<%s>" % (m.group(1), ",".join(names))


def ptxas_lines(log_text):
    """{kernel label: "Used N registers, ...; N bytes stack frame, ..."} from
    nvcc's -Xptxas -v output."""
    out, func = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)'?", line)
        if m:
            func = kernel_label(m.group(1))
        elif func and ("registers" in line or "spill" in line):
            out.setdefault(func, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass_counts(_build, name):
    """{kernel label: {"HGMMA": n, "UTMALDG": n}} over the SASS of kernel
    ``name``'s library, from cuobjdump beside nvcc."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = kernel_label(m.group(1))
            counts[func] = {"HGMMA": 0, "UTMALDG": 0}
        elif func:
            for op in counts[func]:
                counts[func][op] += op in line
    return counts


# (kernel whose library to read, Hopper kernel prefix, its instantiations,
# the SIMT kernels that must be gone)
SASS_CHECKS = (
    ("flash_attn_fwd", "flash_fwd_sm90", 4, ("flash_fwd_kernel<",)),  # bf16, D 16-128
    ("flash_attn_fwd", "flash_fwd_split_sm90", 4, ("flash_fwd_kernel<",)),  # split f32
    # <D, planes>: bf16 and split f32
    ("flash_attn_bwd_dq", "flash_dq_sm90", 8, ("flash_dq_kernel<",)),
    ("flash_attn_bwd_dkv", "flash_dkv_sm90", 8, ("flash_dkv_kernel<",)),
    # <c tile, warpgroups, NCHW in place, planes>: 8 bf16, 4 f32
    ("conv_bwd_filter", "conv_wgrad_sm90", 12, ("conv_wgrad_kernel<",)),
    # <c tile, planes>
    ("conv_bwd_input", "conv_dgrad_sm90", 4, ("conv_dgrad_kernel<",)),
)


def phase_build(_build):
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, text in sorted(logs.items()):
        for func, line in sorted(ptxas_lines(text).items()):
            log("  %s %s: %s" % (name, func, line))
    log("phase 1: built %s in %.2f s" % (sorted(logs) or "nothing new", secs))
    sass, by_lib = {}, {}
    for name, prefix, count, simt in SASS_CHECKS:
        lib = _build.library_path(name)
        if lib not in by_lib:  # dq and dk/dv share one library, K2 and K3 another
            by_lib[lib] = sass_counts(_build, name)
        counts = by_lib[lib]
        tma = {f: c for f, c in counts.items() if f.startswith(prefix + "<")}
        left = [f for f in counts if f.startswith(simt)]
        log("  sass %s: %s" % (name, json.dumps(tma)))
        if len(tma) != count or not all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                        for c in tma.values()):
            raise AssertionError("%s: the Hopper kernels want wgmma and TMA in their SASS, got %s"
                                 % (name, tma))
        if left:
            raise AssertionError("%s: SIMT kernels left: %s" % (name, left))
        sass.update(tma)
    flash = [f for lib, counts in by_lib.items() for f in counts if f.startswith("flash_")]
    simt = [f for f in flash if "_sm90" not in f and not f.startswith("flash_split_kernel")]
    if simt:
        raise AssertionError("the flash libraries want no SIMT kernel, got %s" % simt)
    log("phase 1: HGMMA and UTMALDG in every flash kernel (bf16 and split f32) and every bf16 "
        "and f32 K2 and K3 kernel; no SIMT flash, K2 or K3 kernel")
    return secs, sass


def _randn(shape, dtype, device, rng):
    import torch

    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _operand(kernels, n, t, h, d, dtype, dev, rng, layout=()):
    """A [B, T, H, D] operand: contiguous, or with ``layout`` == ["bhtd"]
    the transposed view of a contiguous [B, H, T, D] tensor, which
    ``tma_compatible`` accepts, so the bf16 kernels read it in place."""
    if not layout:
        return _randn((n, t, h, d), dtype, dev, rng)
    x = _randn((n, h, t, d), dtype, dev, rng).transpose(1, 2)
    assert x.stride(1) < x.stride(2) and kernels.tma_compatible(x), x.stride()
    return x


def max_err(kernels, q, k, v, causal, repeat=False):
    """max |kernel - plain| of the forward; with ``repeat``, also whether a
    second launch gave the same bits (output and lse)."""
    import torch

    out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ref = kernels.reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == q.dtype
    err = (out.float() - ref.float()).abs().max().item()
    if not repeat:
        return err
    out2, lse2 = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    return err, torch.equal(out, out2) and torch.equal(lse, lse2)


def phase_kernel_checks(kernels, dev):
    import torch

    rng = np.random.default_rng(0)
    cases = [(n, t, 16, 64, True) for n in (1, 4) for t in (7, 100, 128, 512, 1000, 2048)]
    cases += [(2, 300, 16, 64, False), (2, 500, 8, 128, True), (1, 2047, 16, 64, True),
              (1, 2047, 8, 128, False)]
    cases += [(2, t, 8, d, causal) for d in (16, 32) for t, causal in
              ((7, True), (100, False), (300, True), (2047, True), (2047, False))]
    # [B, H, T, D] tensors read as [B, T, H, D] views: TMA-aligned strides in another order
    cases += [(2, 300, 8, 64, True, "bhtd"), (1, 2047, 16, 64, False, "bhtd"),
              (2, 100, 8, 128, True, "bhtd")]
    split = split_checks(kernels, dev, rng)
    worst = {}
    f32_only = ((torch.float32, 1e-4),)
    cases = [c + (None,) for c in cases] + [(n, t, h, d, causal, f32_only)
                                            for n, t, h, d in FLASH_DEEP for causal in (True, False)]
    for (n, t, h, d, causal, *layout, dtypes) in cases:
        for dtype, tol in dtypes or ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (_operand(kernels, n, t, h, d, dtype, dev, rng, layout) for _ in range(3))
            err, same = max_err(kernels, q, k, v, causal, repeat=True)
            log("  flash_attn_fwd n=%d T=%d H=%d D=%d causal=%s %s%s: max_abs_err %.3g (tol %g), "
                "bitwise repeat %s" % (n, t, h, d, causal, str(dtype).split(".")[-1],
                                       " bhtd view" if layout else "", err, tol, same))
            if not err <= tol:
                raise AssertionError("flash_attn_fwd disagrees with the plain version")
            if not same:
                raise AssertionError("flash_attn_fwd is not bitwise repeatable")
            key = str(dtype).split(".")[-1]
            worst[key] = max(worst.get(key, 0.0), err)
    log("phase 2: forward kernels vs plain ok over %d cases (%d FLASH_DEEP, f32), worst %s; "
        "split pass bitwise equal to split_bf16: %s"
        % (len(cases), 2 * len(FLASH_DEEP), json.dumps(worst), json.dumps(split)))
    worst["split"] = split
    return worst


def split_checks(kernels, dev, rng):
    """The split pass (``split_planes``) bit for bit against its plain
    version ``split_bf16``: the four operands of the training path's dk/dv
    (n=8, T=2047, H=16, D=64) contiguous, and a [B, H, T, D] view next to a
    contiguous tensor; a second launch gives the same bits."""
    import torch

    n, t, h, d = BWD_TIME_SHAPE
    out = {}
    for name, xs in (
            ("contiguous x4", [_randn((n, t, h, d), torch.float32, dev, rng) for _ in range(4)]),
            ("bhtd view + contiguous", [_operand(kernels, 2, 300, 8, 64, torch.float32, dev, rng,
                                                 ["bhtd"]),
                                        _randn((2, 300, 8, 64), torch.float32, dev, rng)])):
        got = kernels.split_planes(*xs)
        again = kernels.split_planes(*xs)
        want = torch.stack([kernels.split_bf16(x) for x in xs])
        bits = lambda a: a.view(torch.int16)  # noqa: E731
        same = torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
        log("  split_planes %s %s: bitwise equal to split_bf16 and repeatable %s"
            % (name, tuple(xs[0].shape), same))
        if not same:
            raise AssertionError("split_planes differs from split_bf16 (%s)" % name)
        out[name] = same
    return out


def bwd_inputs(kernels, n, t, h, d, dtype, causal, dev, rng, layout=()):
    """q, k, v, dO (laid out as :func:`_operand`), and the lse and delta a
    training backward would hand the kernels: lse from the forward kernel,
    delta = sum_D dO * O in f32."""
    import torch

    q, k, v, do = (_operand(kernels, n, t, h, d, dtype, dev, rng, layout) for _ in range(4))
    with torch.no_grad():
        out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def bwd_errors(kernels, args, causal):
    """Per backward kernel: max |kernel - plain| / max |plain| over its
    outputs, the max abs error, and whether a second launch gave the same
    bits."""
    import torch

    dq = kernels.flash_attention_dq(*args, causal=causal)
    dk, dv = kernels.flash_attention_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    dq2 = kernels.flash_attention_dq(*args, causal=causal)
    dk2, dv2 = kernels.flash_attention_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    ref = kernels.reference_attention_bwd(*args, causal=causal)
    out = {}
    for name, got, again, want in (("flash_attn_bwd_dq", (dq,), (dq2,), ref[:1]),
                                   ("flash_attn_bwd_dkv", (dk, dv), (dk2, dv2), ref[1:])):
        rel, err = 0.0, 0.0
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype)
            # max() below would drop a NaN, so non-finite values fail here
            if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
                raise AssertionError("%s or its plain version is not finite" % name)
            diff = (g.float() - w.float()).abs().max().item()
            rel = max(rel, diff / max(w.float().abs().max().item(), 1e-30))
            err = max(err, diff)
        out[name] = {"rel_err": rel, "max_abs_err": err,
                     "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again))}
    return out


def phase_bwd_checks(kernels, dev):
    import torch

    rng = np.random.default_rng(4)
    worst = {}
    n, h = 2, 8
    both = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    shapes = [(n, h, t, d, both) for t in BWD_CHECK_T for d in (64, 128)]
    shapes += [(n, h, *extra, both) for extra in BWD_CHECK_EXTRA]
    shapes += [(dn, dh, t, d, ((torch.float32, 1e-4),)) for dn, t, dh, d in FLASH_DEEP]
    for n, h, t, d, *layout, dtypes in shapes:
        for causal in (True, False):
            for dtype, tol in dtypes:
                args = bwd_inputs(kernels, n, t, h, d, dtype, causal, dev, rng, layout)
                key = str(dtype).split(".")[-1]
                for name, e in bwd_errors(kernels, args, causal).items():
                    log("  %s n=%d T=%d H=%d D=%d causal=%s %s%s: rel_err %.3g (tol %g) "
                        "max_abs_err %.3g, bitwise repeat %s"
                        % (name, n, t, h, d, causal, key, " bhtd view" if layout else "",
                           e["rel_err"], tol, e["max_abs_err"], e["bitwise_repeat"]))
                    if not e["rel_err"] <= tol:
                        raise AssertionError("%s disagrees with the plain version" % name)
                    if not e["bitwise_repeat"]:
                        raise AssertionError("%s is not bitwise repeatable" % name)
                    worst[name + " " + key] = max(worst.get(name + " " + key, 0.0),
                                                  e["rel_err"])
    log("phase 3: backward kernels vs plain ok, worst rel_err %s" % json.dumps(worst))
    return worst


def phase_serving_f32(tfm, kernels, dev):
    import torch

    dims = dict(FULL, n_layers=2)
    init_fn, _ = tfm.transformer_lm(dtype=torch.float32, **dims)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    init_cache, prefill, _ = tfm.transformer_lm_serving(
        max_len=MAX_LEN, dtype=torch.float32, **dims)
    rng = np.random.default_rng(1)
    lengths = np.array([5, 300, 1000], np.int64)
    toks = np.zeros((3, 1024), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, dims["vocab"], n)
    slots = np.arange(3)

    def run():
        cache = init_cache(4, device=dev)
        _, last = prefill(params, cache, torch.from_numpy(toks), torch.from_numpy(slots),
                          torch.from_numpy(lengths))
        torch.cuda.synchronize()
        return last

    zero_counts(kernels)
    got = run()
    launched = kernels.flash_attention.launches
    # the same forward with the plain attention in the kernel's place
    dispatch = kernels.attention
    kernels.attention = lambda q, k, v, causal=False, scale=None, mesh=None: (
        kernels.reference_attention(q, k, v, causal=causal, scale=scale))
    try:
        ref = run()
    finally:
        kernels.attention = dispatch
    assert launched == dims["n_layers"], launched
    assert got.shape == (3, dims["vocab"]) and bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    log("phase 4: f32 depth-2 prefill logits, kernel vs plain attention: "
        "max_abs_err %.3g (rtol = atol = 1e-3)" % err)
    return {"err": err, "launches": launched}


def zero_counts(kernels):
    for fn in (kernels.flash_attention, kernels.flash_attention_dq, kernels.flash_attention_dkv,
               kernels.conv_bwd_filter, kernels.conv_bwd_input, kernels.fused_slab_update,
               getattr(kernels, "split_planes", None)):  # absent from older trees
        if fn is not None:
            fn.launches = 0


def conv_counts(kernels):
    return {"conv_bwd_filter": kernels.conv_bwd_filter.launches,
            "conv_bwd_input": kernels.conv_bwd_input.launches}


def read_counts(kernels):
    return {"flash_attn_fwd": kernels.flash_attention.launches,
            "flash_attn_bwd_dq": kernels.flash_attention_dq.launches,
            "flash_attn_bwd_dkv": kernels.flash_attention_dkv.launches}


def phase_train_f32(tfm, trainer, kernels, dev):
    import torch

    dims = dict(FULL, n_layers=2)
    init_fn, apply_fn = tfm.transformer_lm(dtype=torch.float32, **dims)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    params.requires_grad_()
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, dims["vocab"], (2, 1001))).to(dev)

    def grads():
        loss = trainer.lm_loss(apply_fn(params, toks[:, :-1]), toks[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        out = [p.grad for p in params.parameters()]
        for p in params.parameters():
            p.grad = None
        return loss.detach(), out

    zero_counts(kernels)
    loss, got = grads()
    counts = read_counts(kernels)
    dispatch = kernels.attention
    kernels.attention = lambda q, k, v, causal=False, scale=None, mesh=None: (
        kernels.reference_attention(q, k, v, causal=causal, scale=scale))
    try:
        ref_loss, want = grads()
    finally:
        kernels.attention = dispatch
    assert counts == dict.fromkeys(counts, dims["n_layers"]), counts
    assert bool(torch.isfinite(loss)) and abs(loss.item() - ref_loss.item()) <= 1e-3, (
        loss.item(), ref_loss.item())
    worst = 0.0
    for (name, _), g, w in zip(params.named_parameters(), got, want):
        m = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / m, w / m, rtol=1e-3, atol=1e-3, msg=name)
        worst = max(worst, ((g - w).abs().max() / m).item())
    log("phase 5: f32 depth-2 training grads, kernels vs plain attention: loss %.6f vs %.6f, "
        "worst grad err %.3g of max (rtol = atol = 1e-3), launches %s"
        % (loss.item(), ref_loss.item(), worst, json.dumps(counts)))
    return {"loss": loss.item(), "ref_loss": ref_loss.item(), "worst_rel_err": worst,
            "launches": counts}


# kernel families of the LM step's profile (phase 19), first match wins:
# the f32 split pass, the flash kernels (bf16 and split f32), cuBLAS's f32
# GEMMs (TF32 off) and other GEMMs, reductions and softmax, elementwise
LM_FAMILIES = (
    ("flash_split", ("flash_split",)),
    ("flash_attn_fwd", ("flash_fwd_",)),
    ("flash_attn_bwd_dq", ("flash_dq_",)),
    ("flash_attn_bwd_dkv", ("flash_dkv_",)),
    ("gemm_f32", ("sgemm", "f32f32")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reduce", ("reduce", "SoftMax", "softmax")),
    ("elementwise", ("elementwise",)),
)


def lm_family(name):
    return next((fam for fam, keys in LM_FAMILIES if any(k in name for k in keys)), "other")


def phase_train_lm(trainer, kernels, dev, dtype, family=None):
    """Phase 7 (bf16) or 19 (f32): TRAIN's SGD steps of the example
    trainer on the full model; see the module docstring. With ``family``
    (a kernel name's family), the last two steps run under torch.profiler
    and the step time is the median of the steps before them."""
    import torch

    steps, layers = TRAIN["steps"], FULL["n_layers"]
    profiled = 2 if family is not None else 0
    per_step, stamps, prof = [], [], {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def on_step(i, loss, params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(read_counts(kernels))
        if profiled and i == steps - 1 - profiled:
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif profiled and i == steps - 1:
            prof["wall"] = time.perf_counter() - prof["t0"]
            prof["p"].__exit__(None, None, None)

    f32 = dtype == "float32"
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)  # counts from here are the training path's
    t0 = time.perf_counter()
    losses = trainer.train(dtype=dtype, device=dev, on_step=on_step,
                           log=lambda *a: log("  train:", *a), **FULL, **TRAIN)
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    split = getattr(kernels, "split_planes", None)
    split_launches = split.launches if split is not None else None
    prev = dict.fromkeys(counts, 0)
    for i, c in enumerate(per_step):
        for name, n in c.items():
            assert n - prev[name] == layers, (i, name, n - prev[name])
        prev = c
    assert counts == dict.fromkeys(counts, steps * layers), counts
    # f32: one split pass a forward and one a backward (dq and dk/dv share
    # it); bf16: none
    if split_launches is not None:
        assert split_launches == (2 * steps * layers if f32 else 0), split_launches
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    step_s = [b - a for a, b in zip(stamps, stamps[1:])][:len(stamps) - 1 - profiled]
    t = TRAIN["seq_len"]
    res = {
        "dtype": dtype, "losses": losses, "wall_s": wall,
        "step_ms_median": 1e3 * statistics.median(step_s), "steps_in_median": len(step_s),
        "first_step_ms_with_setup": 1e3 * (stamps[0] - t0),
        "tokens_per_s": TRAIN["batch_size"] * t / statistics.median(step_s),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": counts, "split_launches": split_launches, "batch": TRAIN["batch_size"],
        "T": t,
    }
    if profiled:
        res["profile"] = profile_summary(prof["p"], profiled, prof["wall"], family)
    log("phase %d: %s full model, %d SGD steps of train(): %s"
        % (19 if f32 else 7, "f32" if f32 else "bf16", steps, json.dumps(res)))
    return res


def phase_serving_bf16(tfm, kernels, telemetry, GenerationEngine, dev):
    import torch

    t0 = time.perf_counter()
    init_fn, _ = tfm.transformer_lm(dtype=torch.bfloat16, **FULL)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.bfloat16)
    init_cache, prefill, decode_step = tfm.transformer_lm_serving(
        max_len=MAX_LEN, dtype=torch.bfloat16, **FULL)
    nonfinite = []

    def checked(fn):
        def call(*args, **kwargs):
            cache, logits = fn(*args, **kwargs)
            nonfinite.append(~torch.isfinite(logits).all())
            return cache, logits
        return call

    gen = GenerationEngine(params, (init_cache, checked(prefill), checked(decode_step)),
                           slots=SLOTS, max_len=MAX_LEN, device=dev)
    gen.compile()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FULL["vocab"], n) for n in PROMPT_LENGTHS]

    telemetry.enable()
    telemetry.reset()
    nonfinite.clear()
    kernels.flash_attention.launches = 0  # counts from here are the main path's
    t0 = time.perf_counter()
    gen.start(precompile=False)
    try:
        reqs = [gen.submit(p, max_new=MAX_NEW) for p in prompts]
        outs = [r.result(timeout=300) for r in reqs]
    finally:
        gen.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.flash_attention.launches

    h_prefill = telemetry.REGISTRY.get("serve.prefill_seconds")
    h_decode = telemetry.REGISTRY.get("serve.decode_step_seconds")
    dispatches = h_prefill.count()
    for out in outs:
        assert len(out) == MAX_NEW and all(0 <= t < FULL["vocab"] for t in out), out
    assert not bool(torch.stack(nonfinite).any()), "non-finite logits"
    assert launches == dispatches * FULL["n_layers"], (launches, dispatches)
    res = {
        "setup_s": setup_s, "wall_s": wall, "requests": len(outs),
        "new_tokens": sum(len(o) for o in outs),
        "tokens_per_s": sum(len(o) for o in outs) / wall,
        "prefill_dispatches": dispatches, "decode_steps": h_decode.count(),
        "flash_launches": launches,
        "prefill_p50_s": h_prefill.percentile(50), "prefill_p99_s": h_prefill.percentile(99),
        "decode_step_p50_s": h_decode.percentile(50), "decode_step_p99_s": h_decode.percentile(99),
        "prefill_mean_s": h_prefill.sum() / dispatches,
        "decode_step_mean_s": h_decode.sum() / h_decode.count(),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }
    log("phase 6: bf16 full model, %d requests x %d tokens via GenerationEngine: %s"
        % (len(outs), MAX_NEW, json.dumps(res)))
    return res


def time_ms(fn, reps, warmup, flush):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()  # evict the 50 MB L2 so each launch starts cold
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_fwd_row(kernels, n, t, h, d, dtype, dev, rng, flush, reps):
    """Phase 8's numbers of the forward kernel at one causal shape."""
    import torch
    import torch.nn.functional as F

    q, k, v = (_randn((n, t, h, d), dtype, dev, rng) for _ in range(3))
    err = max_err(kernels, q, k, v, True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kern():
        return kernels.flash_attention(q, k, v, causal=True)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    kernel_ms = time_ms(kern, reps, 5, flush)
    # causal: t(t+1)/2 live (q, k) pairs, 2*d flops each for q.k and for p.v
    flops = 2.0 * n * h * d * t * (t + 1)
    nbytes = 4 * n * t * h * d * q.element_size() + 4 * n * h * t  # q k v o + f32 lse
    t_ops = split_products(dtype) * flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    key = str(dtype).split(".")[-1]
    return {
        "n": n, "T": t, "H": h, "D": d, "dtype": key, "causal": True,
        "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: kernels.reference_attention(q, k, v, causal=True), 10, 2,
                            flush),
        "library_ms": time_ms(lib, reps, 5, flush),
        "device_ms": device_ms(kern, reps, 5, flush), "host_ms": host_ms(kern, reps, 5),
        "library_device_ms": device_ms(lib, reps, 5, flush),
        "library_host_ms": host_ms(lib, reps, 5),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_counts": BOUND_COUNTS[key], "flops": flops, "bytes": nbytes,
        **split_row(kernels, (q, k, v), flush, reps),
    }


def split_row(kernels, xs, flush, reps):
    """For f32 operands: the device ms of the split pass the wrapper runs
    first (``split_planes`` of ``xs``; inside the kernel's ``ms``), and its
    bound, 4 bytes read and 4 written a value."""
    import torch

    if xs[0].dtype != torch.float32 or not hasattr(kernels, "split_planes"):
        return {}
    nbytes = 8 * len(xs) * xs[0].numel()
    return {"split_device_ms": device_ms(lambda: kernels.split_planes(*xs), reps, 3, flush),
            "split_bound_ms": nbytes / PEAK_BYTES * 1e3, "split_bytes": nbytes}


F32_DESIGN = "tma+wgmma, 3 bf16 products of split hi/lo planes (f32)"


def phase_kernel_times(kernels, dev, launches, f32_launches):
    import torch

    rng = np.random.default_rng(3)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n, h, d = 4, 16, 64
    shapes = []
    for t in (1024, 2048):
        shapes.append(flash_fwd_row(kernels, n, t, h, d, torch.bfloat16, dev, rng, flush, 30))
        log("  flash_attn_fwd %s" % json.dumps(shapes[-1]))
    f32_rows = [flash_fwd_row(kernels, fn, ft, h, d, torch.float32, dev, rng, flush, 10)
                for fn, ft in ((n, 2048), BWD_TIME_SHAPE[:2])]
    for row in f32_rows:
        row["launches"] = f32_launches
        log("  flash_attn_fwd %s" % json.dumps(row))
    f32 = f32_rows[0]
    head = shapes[-1]
    entry = {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "design": "tma+wgmma (bf16); " + F32_DESIGN,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:263",
        "launches": launches,
        **{key: head[key] for key in ("max_abs_err", "ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms", "device_ms",
                                      "host_ms", "library_device_ms", "library_host_ms")},
        "shapes": shapes, "f32": f32, "f32_shapes": f32_rows,
    }
    return [entry]


def flash_bwd_rows(kernels, dtype, dev, rng, flush, reps, shape=BWD_TIME_SHAPE):
    """Phase 8's numbers of the two backward kernels at ``shape`` (n, T, H,
    D; by default the training path's attention shape), causal: {name:
    row}."""
    import torch
    import torch.nn.functional as F

    n, t, h, d = shape
    args = bwd_inputs(kernels, n, t, h, d, dtype, True, dev, rng)
    errs = bwd_errors(kernels, args, True)
    kern = {"flash_attn_bwd_dq": lambda: kernels.flash_attention_dq(*args, causal=True),
            "flash_attn_bwd_dkv": lambda: kernels.flash_attention_dkv(*args, causal=True)}
    # the plain version computes dq, dk and dv together
    plain_ms = time_ms(lambda: kernels.reference_attention_bwd(*args, causal=True), 5, 1, flush)
    q, k, v, do = args[:4]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    library = {"library_ms": time_ms(lib, reps, 3, flush),
               "library_device_ms": device_ms(lib, reps, 3, flush),
               "library_host_ms": host_ms(lib, reps, 3)}
    pairs = t * (t + 1)  # twice the live (q, k) pairs under the causal mask
    esize = q.element_size()
    work = {  # flops, bytes: each input read once, each output written once
        "flash_attn_bwd_dq": (3.0 * n * h * d * pairs, 5 * n * t * h * d * esize + 8 * n * h * t),
        "flash_attn_bwd_dkv": (4.0 * n * h * d * pairs, 6 * n * t * h * d * esize + 8 * n * h * t),
    }
    key = str(dtype).split(".")[-1]
    rows = {}
    for name, (flops, nbytes) in work.items():
        t_ops = split_products(dtype) * flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        ms = time_ms(kern[name], reps, 3, flush)
        rows[name] = {
            "max_abs_err": errs[name]["max_abs_err"], "rel_err": errs[name]["rel_err"],
            "ms": ms, "kernel_ms": ms, "device_ms": device_ms(kern[name], reps, 3, flush),
            "host_ms": host_ms(kern[name], reps, 3),
            "plain_ms": plain_ms, "plain_computes": "dq, dk, dv",
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_counts": BOUND_COUNTS[key], **library,
            "library_computes": "scaled_dot_product_attention backward: dq, dk, dv",
            "n": n, "T": t, "H": h, "D": d, "dtype": key, "causal": True,
            "flops": flops, "bytes": nbytes,
        }
    split = split_row(kernels, args[:4], flush, reps)
    rows["flash_attn_bwd_dkv"].update(split)
    if takes_planes(kernels):  # f32 dq splits its operands too (older trees: not)
        rows["flash_attn_bwd_dq"].update(split)
    if dtype == torch.float32:
        pair = backward_pair(kernels, args)
        summary = {"ms": time_ms(pair, reps, 3, flush),
                   "device_ms": device_ms(pair, reps, 3, flush),
                   "host_ms": host_ms(pair, reps, 3), "computes": "dq, dk, dv",
                   "shared_split": pair.shared}
        for row in rows.values():
            row["pair"] = summary
    return rows


def takes_planes(kernels):
    """Whether the backward wrappers take a split made once for both."""
    return "planes" in inspect.signature(kernels.flash_attention_dq).parameters


def backward_pair(kernels, args):
    """dq and dk/dv of ``args`` (q, k, v, dO, lse, delta; causal) as the
    autograd backward runs them: on the planes of one split pass where the
    wrappers take ``planes`` (``pair.shared``), else each wrapper with its
    own split (older trees)."""
    shared = takes_planes(kernels)

    def pair():
        kw = {"planes": kernels.split_planes(*args[:4])} if shared else {}
        kernels.flash_attention_dq(*args, causal=True, **kw)
        kernels.flash_attention_dkv(*args, causal=True, **kw)

    pair.shared = shared
    return pair


def phase_bwd_times(kernels, dev, launches, f32_launches):
    """Kernels-line entries of the two backward kernels at the training
    path's attention shape: n=8, T=2047, H=16, D=64, causal; bf16, and
    f32 under ``f32``."""
    import torch

    rng = np.random.default_rng(6)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = flash_bwd_rows(kernels, torch.bfloat16, dev, rng, flush, 20)
    f32 = flash_bwd_rows(kernels, torch.float32, dev, rng, flush, 5)
    f32_t2048 = flash_bwd_rows(kernels, torch.float32, dev, rng, flush, 5, (4, 2048, 16, 64))
    entries = []
    for name, row in rows.items():
        for r in (f32, f32_t2048):
            r[name]["launches"] = f32_launches[name]
        entries.append({
            "name": name, "route": "cuda", "source": "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
            "design": "tma+wgmma (bf16); " + F32_DESIGN,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % (
                295 if name.endswith("dq") else 316),
            "launches": launches[name], **row, "f32": f32[name],
            "f32_shapes": [f32[name], f32_t2048[name]],
        })
        log("  %s %s" % (name, json.dumps(entries[-1])))
    return entries


def resnet_conv_shapes(resnet, kernels, batch):
    """{(data, weight, pad): convolutions of that shape} over ResNet-50's
    in-envelope convolutions at ``batch``, 3 x 224 x 224, from infer_shape."""
    shapes = {}
    for layer in resnet.conv_layers(resnet.get_symbol(), (batch, 3, 224, 224)):
        if kernels.conv_bwd_plan(layer["data"], layer["weight"], layer["stride"], layer["pad"],
                                 layer["dilate"], "float32"):
            key = (layer["data"], layer["weight"], layer["pad"])
            shapes[key] = shapes.get(key, 0) + 1
    assert sum(shapes.values()) == RESNET_CONVS, shapes
    return shapes


def conv_inputs(dshape, wshape, pad, dtype, dev, rng):
    """x, w and an output gradient g of one convolution shape."""
    import torch

    n, _, h, w = dshape
    o, _, kh, kw = wshape
    oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
    x = _randn(dshape, dtype, dev, rng)
    wt = (0.1 * _randn(wshape, torch.float32, dev, rng)).to(dtype)
    g = _randn(oshape, dtype, dev, rng)
    return x, wt, g


def conv_errors(kernels, x, w, g, dshape, wshape, pad):
    """Per conv kernel: max |kernel - plain| / max |plain| of the f32
    output, the max abs error, and whether a second launch gave the same
    bits."""
    import torch

    got = {"conv_bwd_filter": kernels.conv_bwd_filter(x, g, wshape, pad),
           "conv_bwd_input": kernels.conv_bwd_input(g, w, dshape, pad)}
    torch.cuda.synchronize()
    again = {"conv_bwd_filter": kernels.conv_bwd_filter(x, g, wshape, pad),
             "conv_bwd_input": kernels.conv_bwd_input(g, w, dshape, pad)}
    torch.cuda.synchronize()
    want = {"conv_bwd_filter": kernels.conv_bwd_filter_reference(x, g, wshape, pad),
            "conv_bwd_input": kernels.conv_bwd_input_reference(g, w, dshape, pad)}
    out = {}
    for name in got:
        a, b = got[name], want[name]
        assert a.dtype == torch.float32 and a.shape == b.shape, (name, a.dtype, a.shape)
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError("%s or its plain version is not finite" % name)
        diff = (a - b).abs().max().item()
        out[name] = {"rel_err": diff / max(b.abs().max().item(), 1e-30), "max_abs_err": diff,
                     "bitwise_repeat": torch.equal(a, again[name])}
    for name, same in shared_grad_bits(kernels, x, w, g, dshape, wshape, pad, got).items():
        out[name]["shared_g_cl_bitwise"] = same
    return out


def shared_grad_bits(kernels, x, w, g, dshape, wshape, pad, got):
    """Per conv kernel: whether grad's channels-last copy (f32: its hi and
    lo planes) made once and handed to it (``g_cl``), and the autograd
    Function's backward that does so for both, give the bits of its
    standalone call ``got``."""
    import torch

    g_cl = kernels.conv_grad_channels_last(g)
    shared = {"conv_bwd_filter": kernels.conv_bwd_filter(x, g, wshape, pad, g_cl=g_cl),
              "conv_bwd_input": kernels.conv_bwd_input(g, w, dshape, pad, g_cl=g_cl)}
    leaves = [x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()]
    kernels.conv2d_kernel_bwd(*leaves, pad).backward(g)
    torch.cuda.synchronize()
    autograd = {"conv_bwd_filter": (leaves[1].grad, w.dtype),
                "conv_bwd_input": (leaves[0].grad, x.dtype)}
    return {name: torch.equal(shared[name], got[name])
            and torch.equal(autograd[name][0], got[name].to(autograd[name][1]))
            for name in got}


def conv_checks(kernels, cases, dev, rng):
    """K2 and K3 against their plain versions on ``cases`` [((data, weight,
    pad), dtypes)]: each within 1e-4 of max|plain|, a repeat bitwise, the
    shared channels-last grad bitwise. Returns (worst error by kernel and
    dtype, every case's errors)."""
    worst, errs = {}, {}
    for (dshape, wshape, pad), dtypes in cases:
        for dtype in dtypes:
            key = str(dtype).split(".")[-1]
            args = conv_inputs(dshape, wshape, pad, dtype, dev, rng)
            for name, e in conv_errors(kernels, *args, dshape, wshape, pad).items():
                log("  %s data=%s weight=%s pad=%s %s: rel_err %.3g (tol 1e-4) max_abs_err "
                    "%.3g, bitwise repeat %s, shared g_cl bitwise %s"
                    % (name, dshape, wshape, pad, key, e["rel_err"], e["max_abs_err"],
                       e["bitwise_repeat"], e["shared_g_cl_bitwise"]))
                if not e["rel_err"] <= 1e-4:
                    raise AssertionError("%s disagrees with the plain version" % name)
                if not e["bitwise_repeat"]:
                    raise AssertionError("%s is not bitwise repeatable" % name)
                if not e["shared_g_cl_bitwise"]:
                    raise AssertionError("%s with the shared channels-last grad differs from "
                                         "its standalone call" % name)
                worst[name + " " + key] = max(worst.get(name + " " + key, 0.0), e["rel_err"])
                errs[(name, dshape, wshape, pad, key)] = e
    return worst, errs


def phase_conv_checks(kernels, resnet, dev):
    import torch

    cases = [(key, (torch.float32, torch.bfloat16)) for key in
             list(resnet_conv_shapes(resnet, kernels, RESNET_BATCH)) + CONV_RAGGED]
    cases += [(key, (torch.float32,)) for key in CONV_DEEP]
    worst, errs = conv_checks(kernels, cases, dev, np.random.default_rng(7))
    log("phase 9: conv-backward kernels vs plain ok over %d shapes, worst rel_err %s"
        % (len(cases), json.dumps(worst)))
    return worst, errs


def grads_kernel_vs_plain(kernels, symbol, params, aux, data, label, seed=0):
    """Every parameter gradient and new aux state of ``symbol`` in training
    mode through K2/K3 against the same through their plain versions, at
    rtol = atol = 1e-3 of each tensor's max|.|. Dropout draws the same
    masks in each run (a generator seeded with ``seed``). A tensor that two
    runs of the plain path do not reproduce to 1e-3 of its max (a
    cancelling sum, moved by ops outside K2/K3 that are not bitwise
    repeatable) is held to three times that spread. Returns (worst error,
    tensors held to 1e-3, the noisy ones, K2/K3 launches of the kernel
    run)."""
    import torch

    from mxnet_tpu_torch.executor import _GraphProgram

    program = _GraphProgram(symbol)

    def grads():
        gen = torch.Generator(device=data.device).manual_seed(seed)
        outs, new_aux = program({**params, "data": data, "softmax_label": label}, aux, gen, True)
        got = torch.autograd.grad(outs[0].sum(), list(params.values()), allow_unused=True)
        torch.cuda.synchronize()
        out = {n: torch.zeros_like(p) if g is None else g
               for (n, p), g in zip(params.items(), got)}
        out.update({"aux " + n: v.detach() for n, v in new_aux.items()})
        return out

    zero_counts(kernels)
    got = grads()
    counts = conv_counts(kernels)
    swapped = (kernels.conv_bwd_filter, kernels.conv_bwd_input)
    # the plain versions in the wrappers' place; they need no g_cl
    kernels.conv_bwd_filter = lambda *args, g_cl=None: kernels.conv_bwd_filter_reference(*args)
    kernels.conv_bwd_input = lambda *args, g_cl=None: kernels.conv_bwd_input_reference(*args)
    try:
        want, again = grads(), grads()
    finally:
        kernels.conv_bwd_filter, kernels.conv_bwd_input = swapped
    worst, noisy = 0.0, {}
    for name, w in want.items():
        g = got[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("%s is not finite" % name)
        m = w.abs().max().clamp_min(1e-30)
        err = ((g - w).abs().max() / m).item()
        # the plain path run twice: ops outside K2/K3 are not bitwise
        # repeatable, which shows in gradients that are tiny cancelling
        # sums (bn0_gamma); there the bound is that spread
        spread = ((again[name] - w).abs().max() / m).item()
        if spread > 1e-3:
            noisy[name] = {"err": err, "plain_run_to_run": spread}
            if not err <= 3 * spread:
                raise AssertionError("%s: kernel vs plain %.3g of max, plain vs plain %.3g"
                                     % (name, err, spread))
            continue
        torch.testing.assert_close(g / m, w / m, rtol=1e-3, atol=1e-3, msg=name)
        worst = max(worst, err)
    return worst, len(want) - len(noisy), noisy, counts


def phase_resnet_grads_f32(resnet_bench, kernels, dev):
    _, (params, _, aux), data, label, symbol = resnet_bench.build_step(2, False, dev)
    worst, held, noisy, counts = grads_kernel_vs_plain(kernels, symbol, params, aux, data, label)
    assert counts == dict.fromkeys(counts, RESNET_CONVS), counts
    log("phase 10: f32 ResNet-50 (batch 2, 224x224) gradients and aux, K2/K3 vs plain: worst "
        "err %.3g of max (rtol = atol = 1e-3) over %d tensors; not repeatable between two plain "
        "runs (held to 3x that spread): %s; launches %s"
        % (worst, held, json.dumps(noisy), json.dumps(counts)))
    return {"worst_rel_err": worst, "tensors": held + len(noisy), "noisy": noisy,
            "launches": counts}


def phase_resnet_train(resnet_bench, kernels, dev, dtype):
    import torch

    bf16 = dtype == "bfloat16"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step, (params, moms, aux), data, label, symbol = resnet_bench.build_step(
        RESNET_BATCH, bf16, dev)
    flops = 3.0 * resnet_bench.model_flops(symbol, tuple(data.shape))
    setup_s = time.perf_counter() - t0
    zero_counts(kernels)  # counts from here are this path's
    losses, stamps, per_step = [], [time.perf_counter()], []
    for _ in range(1 + RESNET_STEPS):
        aux, prob = step(params, moms, aux, data, label)
        losses.append(float(resnet_bench.cross_entropy(prob, label)))  # synchronises
        stamps.append(time.perf_counter())
        per_step.append(conv_counts(kernels))
    flash = read_counts(kernels)
    prev = dict.fromkeys(per_step[0], 0)
    for i, c in enumerate(per_step):
        for name, n in c.items():
            assert n - prev[name] == RESNET_CONVS, (dtype, i, name, n - prev[name])
        prev = c
    assert flash == dict.fromkeys(flash, 0), flash
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    step_s = [b - a for a, b in zip(stamps[1:], stamps[2:])]  # after the warm-up step
    med = statistics.median(step_s)
    res = {
        "dtype": dtype, "batch": RESNET_BATCH, "steps": RESNET_STEPS, "warmup": 1,
        "losses": losses, "setup_s": setup_s,
        "first_step_ms_with_build": 1e3 * (stamps[1] - stamps[0]),
        "step_ms_median": 1e3 * med, "step_ms_mean": 1e3 * statistics.mean(step_s),
        "img_per_s": RESNET_BATCH / med, "tflops_per_step": flops / 1e12,
        "tflops_per_s": flops / med / 1e12,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": per_step[-1], "tf32": False,
    }
    log("phase 11: ResNet-50 %s batch %d, 1 + %d steps of resnet_bench's step: %s"
        % (dtype, RESNET_BATCH, RESNET_STEPS, json.dumps(res)))
    return res


# how a bound counts operations: an f32 product keeps the f32 limit as three
# bf16 products of its hi and lo planes (the f32 conv kernels' design)
BOUND_COUNTS = {
    "bfloat16": "operations at 989 TFLOP/s (bf16 tensor cores), f32 output bytes",
    "float32": "3 bf16 products per f32 product at 989 TFLOP/s, f32 input and output bytes",
}


def split_products(dtype):
    import torch

    return 3 if dtype == torch.float32 else 1


def conv_work(name, dshape, wshape, pad, esize):
    """(flops, bytes) of one kernel call: 2·N·OH·OW·O·C·kh·kw; each input
    read once, the f32 output written once."""
    n, c, h, w = dshape
    o, _, kh, kw = wshape
    oh, ow = h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1
    flops = 2.0 * n * oh * ow * o * c * kh * kw
    x, g, wt = n * c * h * w, n * o * oh * ow, o * c * kh * kw
    if name == "conv_bwd_filter":
        return flops, (x + g) * esize + 4 * wt
    return flops, (g + wt) * esize + 4 * x


def conv_time_rows(kernels, shapes, dtypes, dev, errs, rng):
    """Phase 12's numbers of K2 and K3 at each of ``shapes`` ({(data, weight,
    pad): convolutions of that shape a step}) in each of ``dtypes``: the
    kernel's ``ms``, ``device_ms`` and ``host_ms``, the plain version's ms,
    the library call's ms and device ms, the bound and ``errs``' error.
    Returns {kernel name: [row, ...]}."""
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = {"conv_bwd_filter": [], "conv_bwd_input": []}
    for dtype in dtypes:
        key = str(dtype).split(".")[-1]
        for (dshape, wshape, pad), count in shapes.items():
            x, w, g = conv_inputs(dshape, wshape, pad, dtype, dev, rng)
            calls = {
                "conv_bwd_filter": (
                    lambda: kernels.conv_bwd_filter(x, g, wshape, pad),
                    lambda: kernels.conv_bwd_filter_reference(x, g, wshape, pad),
                    lambda: conv2d_weight(x, wshape, g, padding=pad)),
                "conv_bwd_input": (
                    lambda: kernels.conv_bwd_input(g, w, dshape, pad),
                    lambda: kernels.conv_bwd_input_reference(g, w, dshape, pad),
                    lambda: conv2d_input(dshape, w, g, padding=pad)),
            }
            for name, (kern, plain, lib) in calls.items():
                flops, nbytes = conv_work(name, dshape, wshape, pad, x.element_size())
                t_ops, t_bytes = split_products(dtype) * flops / PEAK_BF16_FLOPS * 1e3, \
                    nbytes / PEAK_BYTES * 1e3
                row = {
                    "dtype": key, "data": dshape, "weight": wshape, "pad": pad,
                    "convs_per_step": count, "ms": time_ms(kern, 10, 2, flush),
                    "device_ms": device_ms(kern, 10, 2, flush), "host_ms": host_ms(kern, 10, 2),
                    "plain_ms": time_ms(plain, 3, 1, flush), "library_ms": time_ms(lib, 10, 2, flush),
                    "library_device_ms": device_ms(lib, 10, 2, flush),
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "bound_counts": BOUND_COUNTS[key],
                    "flops": flops, "bytes": nbytes,
                    "max_abs_err": errs[(name, dshape, wshape, pad, key)]["max_abs_err"],
                    "rel_err": errs[(name, dshape, wshape, pad, key)]["rel_err"],
                }
                rows[name].append(row)
                log("  %s %s" % (name, json.dumps(row)))
    return rows


STEP_FIELDS = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")


def per_step(rows, key):
    """The launch-weighted sums of a step over ``rows`` of dtype ``key``."""
    mine = [r for r in rows if r["dtype"] == key]
    return {f: sum(r[f] * r["convs_per_step"] for r in mine) for f in STEP_FIELDS}


def phase_conv_times(kernels, resnet, dev, launches, errs):
    """Kernels-line entries of K2 and K3; see the module docstring."""
    import torch

    rows = conv_time_rows(kernels, resnet_conv_shapes(resnet, kernels, RESNET_BATCH),
                          (torch.bfloat16, torch.float32), dev, errs, np.random.default_rng(8))
    entries = []
    for name, shape_rows in rows.items():
        step = {key: per_step(shape_rows, key) for key in ("bfloat16", "float32")}
        head, f32_head = (max((r for r in shape_rows if r["dtype"] == key),
                              key=lambda r: r["ms"] * r["convs_per_step"])
                          for key in ("bfloat16", "float32"))
        f32_design = ("f32: the same kernel on the split-bf16 hi and lo planes of channels-last "
                      "copies, three wgmma products (hi·lo, lo·hi, hi·hi) a k16 step into an f32 "
                      "accumulator added into a second on the CUDA cores every 8 k steps")
        entries.append({
            "name": name, "route": "cuda", "source": "mxnet_tpu_torch/csrc/conv_bwd.cu",
            "design": ("tma+wgmma implicit GEMM on channels-last copies (both operands "
                       "MN-major) or on NCHW in place (1x1), CTAs of two warpgroups (128 o) "
                       "where O > 64, one-wave split of M + ordered reduce (bf16); " + f32_design
                       if name == "conv_bwd_filter" else
                       "tma+wgmma implicit GEMM on channels-last copies (bf16); " + f32_design),
            "timed_with": "the wrapper's own layout transposes inside each timed call",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % (
                745 if name == "conv_bwd_filter" else 804),
            "launches": launches[name],
            **{f: head[f] for f in ("max_abs_err", "rel_err", "ms", "device_ms", "host_ms",
                                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library_device_ms", "dtype", "data", "weight", "pad",
                                    "convs_per_step", "flops", "bytes")},
            "kernel_ms": head["ms"],
            "library_computes": "torch.nn.grad.%s" % (
                "conv2d_weight" if name == "conv_bwd_filter" else "conv2d_input"),
            "launch_weighted_ms_per_step": step,
            "f32": {f: f32_head[f] for f in ("data", "weight", "pad", "convs_per_step", "ms",
                                               "device_ms", "host_ms", "plain_ms", "library_ms",
                                               "library_device_ms", "bound_ms", "bound_by",
                                               "bound_counts", "max_abs_err", "rel_err")},
            "shapes": shape_rows,
        })
        log("  %s per step %s, headline shape %s %s" % (
            name, json.dumps(step), head["data"], head["weight"]))
    return entries


def zoo_models(model_sweep):
    """Phase 20's models: {name: (((module, kwargs), side, batch, k80), dtypes
    trained)}."""
    zoo = {name: (model_sweep.MODELS[name], ("float32", "bfloat16")) for name in ZOO_SWEEP}
    zoo.update({name: (spec, ("float32",)) for name, spec in ZOO_EXTRA.items()})
    return zoo


def zoo_conv_shapes(model_sweep, kernels, spec, dtype):
    """{(data, weight, pad): convolutions of that shape} over the in-envelope
    convolutions of one zoo model (``spec`` as in ``zoo_models``) in
    ``dtype``, at its published batch and side."""
    (module, kwargs), side, batch, _ = spec
    shape = (batch, 3, side, side)
    symbol = model_sweep.build_symbol(module, kwargs, side)
    shapes = {}
    for layer in model_sweep.conv_layers(symbol, shape):
        if kernels.conv_bwd_plan(layer["data"], layer["weight"], layer["stride"], layer["pad"],
                                 layer["dilate"], dtype):
            key = (layer["data"], layer["weight"], layer["pad"])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_zoo(model_sweep, kernels, dev):
    """Phase 20 (see the module docstring). Returns (results, K2/K3
    launches of its training rows)."""
    import torch

    zoo = zoo_models(model_sweep)
    res = {"counts": {}}
    # (a) every distinct in-envelope convolution shape, f32 and bf16
    dtypes_of = {}
    for name, (spec, _) in zoo.items():
        res["counts"][name] = {}
        for dtype in ("float32", "bfloat16"):
            shapes = zoo_conv_shapes(model_sweep, kernels, spec, dtype)
            res["counts"][name][dtype] = {"convs": sum(shapes.values()),
                                          "distinct": len(shapes)}
            for key in shapes:
                dtypes_of.setdefault(key, []).append(getattr(torch, dtype))
    cases = [(key, tuple(dict.fromkeys(dts))) for key, dts in dtypes_of.items()]
    t0 = time.perf_counter()
    worst, errs = conv_checks(kernels, cases, dev, np.random.default_rng(20))
    res["conv_checks"] = {"shapes": len(cases), "cases": sum(len(d) for _, d in cases),
                          "worst_rel_err": worst, "s": time.perf_counter() - t0}
    log("phase 20 (a): K2/K3 vs plain ok over the zoo's %d distinct in-envelope shapes (%d "
        "shape-dtype cases; in-envelope convolutions by model and dtype %s), worst rel_err %s"
        % (len(cases), res["conv_checks"]["cases"], json.dumps(res["counts"]),
           json.dumps(worst)))
    # (b) full-width f32 gradients, kernel against plain
    res["grads_f32"] = {}
    for name in ZOO_GRAD_MODELS:
        (module, kwargs), side, _, _ = zoo[name][0]
        _, (params, _, aux), data, label, symbol = model_sweep.build_step(
            module, kwargs, side, ZOO_GRAD_BATCH, False, dev)
        convs = model_sweep.in_envelope_convs(symbol, tuple(data.shape), "float32")
        worst_g, held, noisy, counts = grads_kernel_vs_plain(kernels, symbol, params, aux,
                                                             data, label)
        assert counts == dict.fromkeys(counts, convs), (name, counts, convs)
        res["grads_f32"][name] = {"batch": ZOO_GRAD_BATCH, "side": side,
                                  "worst_rel_err": worst_g, "tensors": held + len(noisy),
                                  "noisy": noisy, "launches": counts}
        log("phase 20 (b): f32 %s (batch %d, %dx%d) gradients and aux, K2/K3 vs plain: worst "
            "err %.3g of max (rtol = atol = 1e-3) over %d tensors; held to 3x the plain "
            "run-to-run spread: %s; launches %s" % (name, ZOO_GRAD_BATCH, side, side, worst_g,
                                                   held, json.dumps(noisy), json.dumps(counts)))
        del params, aux, data, label
        torch.cuda.empty_cache()
    # (c) training at the published batch and side (main path 7)
    res["train"], launches = [], dict.fromkeys(("conv_bwd_filter", "conv_bwd_input"), 0)
    for name, (spec, dtypes) in zoo.items():
        for dtype in dtypes:
            zero_counts(kernels)  # counts from here are this row's
            row = model_sweep.run_row(name, dtype, ZOO_STEPS, dev, model=spec,
                                      lr=ZOO_LR.get(name, model_sweep.resnet_bench.LR))
            counts = conv_counts(kernels)
            want = (1 + ZOO_STEPS) * row["in_envelope_convs"]
            assert counts == dict.fromkeys(counts, want), (name, dtype, counts, want)
            row["launches"] = counts
            for k in launches:
                launches[k] += counts[k]
            res["train"].append(row)
            log("phase 20 (c): %s %s batch %d: %s" % (name, dtype, row["batch"],
                                                      json.dumps(row)))
    # (d) inception-v3's conv gradients in one f32 step against cuDNN
    shapes = zoo_conv_shapes(model_sweep, kernels, zoo["inception-v3"][0], "float32")
    rows = conv_time_rows(kernels, shapes, (torch.float32,), dev, errs,
                          np.random.default_rng(21))
    res["inception_v3_f32_step"] = {
        name: {"launches_per_step": sum(shapes.values()), "distinct_shapes": len(shapes),
               "launch_weighted_ms_per_step": per_step(shape_rows, "float32"),
               "library_computes": "torch.nn.grad.%s" % (
                   "conv2d_weight" if name == "conv_bwd_filter" else "conv2d_input"),
               "shapes": shape_rows}
        for name, shape_rows in rows.items()}
    log("phase 20 (d): inception-v3 f32 batch 32, K2/K3 against cuDNN (TF32 off), a step: %s"
        % json.dumps({n: {k: v for k, v in r.items() if k != "shapes"}
                      for n, r in res["inception_v3_f32_step"].items()}))
    return res, launches


def _rtc_errors(out, want, dtype):
    """Worst error of an Rtc kernel against its plain version, and whether
    it is inside the tolerance: rtol 1e-6 in f32, one bf16 ulp of the
    larger magnitude in bf16."""
    import torch

    got, want = out.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-6 * want.abs()).all())
    else:
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        ok = bool((err <= 2.0 ** (torch.floor(torch.log2(mag)) - 7)).all())
    return err.max().item(), ok


def phase_rtc(mx, rk, dev):
    import torch

    rng = np.random.default_rng(9)
    worst, cases = {}, 0
    small = {"axpb": (8, 128), "madd": (4, 128), "exp5": (8, 128)}
    for spec, plain in ((rk.AXPB, rk.axpb_plain), (rk.MADD, rk.madd_plain),
                        (rk.EXP5, rk.exp5_plain)):
        for shape in (small[spec[0]], RTC_BIG):
            for dtype in (torch.float32, torch.bfloat16):
                # madd on [0, 1) as test_rtc.py draws it: a·b + a then has no
                # cancellation, so a relative tolerance applies
                ins = [mx.nd.NDArray((torch.from_numpy(rng.random(shape, np.float32)).to(dev)
                                      if spec[0] == "madd" else
                                      0.5 * _randn(shape, torch.float32, dev, rng)).to(dtype))
                       for _ in spec[1]]
                out = mx.nd.zeros(shape, ctx=mx.gpu(0), dtype=dtype)
                size = int(np.prod(shape))
                if spec[0] == "exp5":
                    n = min(size, 1024)
                    dims = ((size // n, 1, 1), (n, 1, 1))
                elif shape == RTC_BIG:
                    dims = rk.grid_stride_dims(size)
                else:  # test_rtc.py's launches: one block of one thread
                    dims = ((1, 1, 1), (1, 1, 1))
                k = rk.make(spec, ins, [out])
                k.push(ins, [out], *dims)
                torch.cuda.synchronize()
                first = out._data.clone()
                k.push(ins, [out], *dims)
                torch.cuda.synchronize()
                err, ok = _rtc_errors(out._data, plain(*[a._data for a in ins]), dtype)
                key = "%s %s" % (spec[0], str(dtype).split(".")[-1])
                log("  rtc %s %s grid %s block %s: max_abs_err %.3g, within tolerance %s, "
                    "bitwise repeat %s" % (key, shape, dims[0], dims[1], err, ok,
                                           torch.equal(first, out._data)))
                if not ok:
                    raise AssertionError("rtc %s disagrees with its plain version" % key)
                if not torch.equal(first, out._data):
                    raise AssertionError("rtc %s is not bitwise repeatable" % key)
                worst[key] = max(worst.get(key, 0.0), err)
                cases += 1
    a, b = (mx.nd.NDArray(torch.rand(4, 128, device=dev)) for _ in range(2))
    out = mx.nd.zeros((4, 128), ctx=mx.gpu(0))
    k = rk.make(rk.MADD, [a, b], [out])
    counts = [len(k._cache)]
    k.push([a, b], [out])
    counts.append(len(k._cache))
    a2, o2 = mx.nd.ones((2, 128), ctx=mx.gpu(0)), mx.nd.zeros((2, 128), ctx=mx.gpu(0))
    k.push([a2, a2], [o2])
    counts.append(len(k._cache))
    torch.cuda.synchronize()
    assert counts == [1, 1, 2] and bool((o2._data == 2.0).all()), counts
    raised = {}
    for what, call in (
            ("bad source", lambda: mx.rtc.Rtc("bad", [("x", a)], [("y", out)], "y[0] = = x[0];")),
            ("wrong array count", lambda: k.push([a], [out]))):
        try:
            call()
        except mx.MXNetError as e:
            raised[what] = str(e).splitlines()[0][:120]
        else:
            raise AssertionError("rtc: %s did not raise" % what)
    log("phase 13: Rtc kernels (a)-(c) vs plain ok over %d cases, worst %s; cache counts %s; "
        "raised %s" % (cases, json.dumps(worst), counts, json.dumps(raised)))
    return {"worst": worst, "cache_counts": counts, "raised": raised}


def _resnet_executor(mx, resnet, symbol, state, data, label):
    """ResNet-50 bound by simple_bind on gpu(0) at ``data``'s shape, grad_req
    null for data and label, arrays holding ``state``'s params and aux."""
    params, aux = state
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in symbol.list_arguments()}
    exe = symbol.simple_bind(mx.gpu(0), grad_req=req, data=tuple(data.shape),
                             softmax_label=tuple(label.shape))
    with_data = dict(params, data=data, softmax_label=label)
    for n, arr in exe.arg_dict.items():
        arr._data.copy_(with_data[n].detach())
    for n, arr in exe.aux_dict.items():
        arr._data.copy_(aux[n])
    return exe


def phase_executor(mx, resnet, resnet_bench, kernels, dev):
    import torch

    step, (params, moms, aux), data, label, symbol = resnet_bench.build_step(
        RESNET_BATCH, False, dev)
    exe = _resnet_executor(mx, resnet, symbol, (params, aux), data, label)
    zero_counts(kernels)
    exe.forward(is_train=True)
    exe.backward()
    torch.cuda.synchronize()
    counts = conv_counts(kernels)
    new_aux, prob = step(params, moms, aux, data, label)
    torch.cuda.synchronize()
    assert counts == dict.fromkeys(counts, RESNET_CONVS), counts
    lr, wd, rescale = SGD["lr"], SGD["wd"], 1.0 / RESNET_BATCH
    worst, bitwise = 0.0, 0
    with torch.no_grad():
        pairs = [("output", exe.outputs[0]._data, prob)]
        for n, g in exe.grad_dict.items():
            if g is not None:
                p0 = exe.arg_dict[n]._data
                mom = torch.zeros_like(p0).mul_(SGD["momentum"]).sub_(lr * (g._data * rescale
                                                                            + wd * p0))
                pairs.append(("grad " + n, mom, moms[n]))
        pairs += [("aux " + n, a._data, new_aux[n]) for n, a in exe.aux_dict.items()]
        for name, got, want in pairs:
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("executor %s is not finite" % name)
            err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
            if not err <= 1e-6:
                raise AssertionError("executor %s: %.3g of max from make_train_step" % (name, err))
            worst = max(worst, err)
            bitwise += bool(torch.equal(got, want))
    stamps = []
    for _ in range(1 + 5):  # one warm-up, then five timed forward + backward
        exe.forward(is_train=True)
        exe.backward()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    res = {"tensors": len(pairs), "bitwise_equal": bitwise, "worst_rel_err": worst,
           "launches": counts,
           "fwd_bwd_ms_median": 1e3 * statistics.median(
               b - a for a, b in zip(stamps, stamps[1:]))}
    log("phase 14: ResNet-50 Executor (simple_bind, batch 32, f32) vs make_train_step: %s"
        % json.dumps(res))
    return res


def _update_all(exe, update):
    args = exe.arg_dict  # a property that builds its dict: once a step
    for n, g in exe.grad_dict.items():
        if g is not None:
            update(n, args[n], g)


def phase_rtc_training(mx, rk, resnet, resnet_bench, kernels, dev):
    import torch

    _, (params, _, aux), data, label, symbol = resnet_bench.build_step(RESNET_BATCH, False, dev)
    rescale = 1.0 / RESNET_BATCH
    runs = {}
    for how in ("rtc", "nd"):
        exe = _resnet_executor(mx, resnet, symbol, (params, aux), data, label)
        moms = {n: mx.nd.zeros(g.shape, ctx=mx.gpu(0)) for n, g in exe.grad_dict.items()
                if g is not None}
        compiles0 = mx.rtc.Rtc.compiles
        if how == "rtc":
            spec = rk.sgd_mom_source(rescale_grad=rescale, **SGD)
            first = next(iter(moms))
            kernel = rk.make(spec, [exe.grad_dict[first]], [exe.arg_dict[first], moms[first]])

            def update(n, w, g):
                kernel.push([g], [w, moms[n]], *rk.grid_stride_dims(w.size))
        else:
            def update(n, w, g):
                mx.nd.sgd_mom_update(w, g, moms[n], out=w, rescale_grad=rescale, **SGD)
        zero_counts(kernels)
        mx.rtc.Rtc.launches = 0  # counts from here are this path's
        losses, per_step, compiles = [], [], []
        t0 = time.perf_counter()
        for _ in range(RTC_STEPS):
            exe.forward(is_train=True)
            exe.backward()
            _update_all(exe, update)
            losses.append(float(resnet_bench.cross_entropy(exe.outputs[0]._data, label)))
            per_step.append(dict(conv_counts(kernels), rtc=mx.rtc.Rtc.launches))
            compiles.append(mx.rtc.Rtc.compiles - compiles0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[how] = {"exe": exe, "moms": moms, "losses": losses, "per_step": per_step,
                     "compiles": compiles, "wall_s": wall}
        if how == "rtc":
            runs[how]["kernel"] = kernel
    n_params = len(runs["rtc"]["moms"])
    shapes = {tuple(m.shape) for m in runs["rtc"]["moms"].values()}
    for how, r in runs.items():
        prev = {"conv_bwd_filter": 0, "conv_bwd_input": 0, "rtc": 0}
        for i, c in enumerate(r["per_step"]):
            want = {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS,
                    "rtc": n_params if how == "rtc" else 0}
            assert {k: c[k] - prev[k] for k in c} == want, (how, i, c, prev)
            prev = c
        assert all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0], r["losses"]
    compiles = runs["rtc"]["compiles"]
    assert compiles == [len(shapes)] * RTC_STEPS, (compiles, len(shapes))
    worst, err = 0.0, 0.0
    with torch.no_grad():
        a, b = runs["rtc"]["exe"], runs["nd"]["exe"]
        for n in runs["rtc"]["moms"]:
            for got, want in ((a.arg_dict[n]._data, b.arg_dict[n]._data),
                              (runs["rtc"]["moms"][n]._data, runs["nd"]["moms"][n]._data)):
                diff = (got - want).abs().max().item()
                rel = diff / max(want.abs().max().item(), 1e-30)
                if not rel <= 1e-5:
                    raise AssertionError("%s: Rtc vs sgd_mom_update %.3g of max" % (n, rel))
                worst, err = max(worst, rel), max(err, diff)
    res = {"steps": RTC_STEPS, "params": n_params, "distinct_shapes": len(shapes),
           "losses_rtc": runs["rtc"]["losses"], "losses_nd": runs["nd"]["losses"],
           "worst_rel_err": worst, "max_abs_err": err,
           "launches": runs["rtc"]["per_step"][-1], "nvrtc_compiles_by_step": compiles,
           "wall_s": {h: r["wall_s"] for h, r in runs.items()}}
    log("phase 15: ResNet-50 training through Executor + Rtc sgd_mom (kernel d) vs "
        "nd.sgd_mom_update, %d steps: %s" % (RTC_STEPS, json.dumps(res)))
    return res, runs


def phase_rtc_times(mx, rk, runs, res, dev):
    """Kernels-line entry of K5: kernel (d)'s launches of one step against
    the plain updates of one step."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    r, p = runs["rtc"], runs["nd"]
    kernel, rescale = r["kernel"], 1.0 / RESNET_BATCH
    steps = {
        "rtc": lambda: _update_all(r["exe"], lambda n, w, g: kernel.push(
            [g], [w, r["moms"][n]], *rk.grid_stride_dims(w.size))),
        "nd": lambda: _update_all(p["exe"], lambda n, w, g: mx.nd.sgd_mom_update(
            w, g, p["moms"][n], out=w, rescale_grad=rescale, **SGD)),
    }
    ms = {how: time_ms(fn, 10, 2, flush) for how, fn in steps.items()}
    # the card alone: a sleep of ~50 ms (100 M clocks) covers the host's
    # enqueue of a step
    dev_ms = {how: device_ms(fn, 10, 2, flush, sleep_cycles=100_000_000)
              for how, fn in steps.items()}
    step_host_ms = {how: host_ms(fn, 10, 2) for how, fn in steps.items()}
    # one launch on the largest parameter array: the kernel's own device time
    big = max(r["moms"], key=lambda n: r["moms"][n].size)
    w, g, m = r["exe"].arg_dict[big], r["exe"].grad_dict[big], r["moms"][big]

    def push_big():
        kernel.push([g], [w, m], *rk.grid_stride_dims(w.size))

    one_ms = time_ms(push_big, 20, 3, flush)
    elems = sum(m.size for m in r["moms"].values())
    nbytes = 20.0 * elems  # w, g, mom read; w, mom written; f32
    entry = {
        "name": "rtc_sgd_mom", "route": "cuda", "source": "mxnet_tpu_torch/rtc_kernels.py",
        "replaces": "mxnet_tpu/rtc.py:71", "launches": res["launches"]["rtc"],
        "max_abs_err": res["max_abs_err"], "rel_err": res["worst_rel_err"],
        "ms": ms["rtc"], "kernel_ms": ms["rtc"], "plain_ms": ms["nd"],
        "host_ms": host_ms(push_big, 50, 5), "host_ms_step": step_host_ms["rtc"],
        "device_ms": dev_ms["rtc"], "plain_host_ms_step": step_host_ms["nd"],
        "plain_device_ms": dev_ms["nd"],
        "host_note": "host_ms: one push (the largest array); host_ms_step: the step's pushes",
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes", "library_ms": None,
        "library_note": "none: no single PyTorch call computes MXNet's sgd_mom_update",
        "per": "one step: %d launches over %d parameter arrays, %d elements, f32"
               % (res["params"], res["params"], elems),
        "bytes": nbytes, "largest_array": {
            "name": big, "elements": w.size, "ms": one_ms,
            "bound_ms": 20.0 * w.size / PEAK_BYTES * 1e3},
        "nvrtc_compiles": mx.rtc.Rtc.compiles,
        "nvrtc_ms_per_compile": 1e3 * mx.rtc.Rtc.compile_seconds / mx.rtc.Rtc.compiles,
    }
    log("  rtc_sgd_mom %s" % json.dumps(entry))
    return [entry]


def phase_rtc_push(mx, rk, resnet, dev):
    """K5's push path alone (``--only rtc``, on any tree's package): kernel
    (d) pushed once on each of ResNet-50's 157 f32 parameter arrays (random
    values, no executor), as one step: ``ms`` (events around the step),
    ``host_ms_step`` and ``host_ms`` (the host's enqueue of the step and of
    one push on the largest array), ``device_ms`` (the card alone, after a
    ~50 ms sleep kernel) and, where the package keeps launch records, the
    host µs a call of the push's parts: the launch (``_nvrtc.launch``), the
    CUDA driver call alone (``cuLaunchKernel``) and the stream lookup."""
    import ctypes

    import torch

    symbol = resnet.get_symbol()
    shapes = dict(zip(symbol.list_arguments(), symbol.infer_shape(
        data=(RESNET_BATCH, 3, 224, 224), softmax_label=(RESNET_BATCH,))[0]))
    names = [n for n in symbol.list_arguments() if n not in ("data", "softmax_label")]
    rng = np.random.default_rng(14)
    arrays = {n: [mx.nd.array(rng.standard_normal(shapes[n]).astype(np.float32), ctx=mx.gpu(0))
                  for _ in range(3)] for n in names}
    kernel = rk.make(rk.sgd_mom_source(rescale_grad=1.0 / RESNET_BATCH, **SGD),
                     [arrays[names[0]][1]], [arrays[names[0]][0], arrays[names[0]][2]])

    def step():
        for n in names:
            w, g, m = arrays[n]
            kernel.push([g], [w, m], *rk.grid_stride_dims(w.size))

    big = max(names, key=lambda n: arrays[n][0].size)
    w, g, m = arrays[big]
    dims = rk.grid_stride_dims(w.size)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    res = {"params": len(names), "ms": time_ms(step, 10, 2, flush),
           "host_ms_step": host_ms(step, 10, 2),
           "device_ms": device_ms(step, 10, 2, flush, sleep_cycles=100_000_000),
           "host_ms": host_ms(lambda: kernel.push([g], [w, m], *dims), 200, 10)}
    records = getattr(kernel, "_records", None)
    if records:
        from mxnet_tpu_torch import _nvrtc

        record = next(r for key, r in records.items()
                      if key[0][0] == g._data.shape and r.grid == dims[0])
        ptrs = [x._data.data_ptr() for x in (g, w, m)]
        lib = _nvrtc._lib("cuda")
        stream = torch.cuda.current_stream(dev).cuda_stream
        parts = {"launch": lambda: _nvrtc.launch(record, ptrs),
                 "cuLaunchKernel": lambda: lib.cuLaunchKernel(
                     *record.head, ctypes.c_void_p(stream), record.params, None),
                 "stream": lambda: _nvrtc._raw_stream(dev.index)}
        res["host_us_a_call"] = {k: 1e3 * host_ms(lambda: [fn() for _ in range(200)], 10, 1)
                                 / 200 for k, fn in parts.items()}
    log("rtc push: %s" % json.dumps(res))
    return res


SLAB_SIZES = (131, 1024, 5000, 2359296)
SLAB_KW = dict(wd=1e-4, rescale_grad=1.0 / RESNET_BATCH, momentum=0.9, beta1=0.9,
               beta2=0.999, epsilon=1e-8)
SLAB_STATICS = {k: v for k, v in SLAB_KW.items() if k != "wd"}  # a table's wd is per slab
FIT_BATCHES = 8
BLOBS = dict(classes=10, dim=784, train=2000, val=500, batch=100, epochs=3)


def resnet50_amp_plan(mx, resnet):
    """The flat plan the AMP fused path builds for ResNet-50 at dp 4 (SGD,
    the Module's optimizer and multipliers): ``_FlatUpdatePlan`` itself."""
    from mxnet_tpu_torch.parallel.train_step import _FlatUpdatePlan

    symbol = resnet.get_symbol()
    shapes = dict(zip(symbol.list_arguments(), symbol.infer_shape(
        data=(RESNET_BATCH, 3, 224, 224), softmax_label=(RESNET_BATCH,))[0]))
    names = [n for n in symbol.list_arguments() if n not in ("data", "softmax_label")]
    opt = mx.optimizer.create("sgd", momentum=SGD["momentum"], sym=symbol,
                              param_idx2name=dict(enumerate(names)))
    return _FlatUpdatePlan(names, {n: tuple(shapes[n]) for n in names},
                           dict.fromkeys(names, "float32"), opt, 4, 4 * 1024 * 1024,
                           comm_itemsize=2)


def slab_case(kernels, kind, size, g_dtype, dev, rng):
    """Master, gradient and states of one K1 case (Adam's second moment,
    the last state, non-negative as it always is)."""
    import torch

    w = _randn((size,), torch.float32, dev, rng)
    g = (4.0 * _randn((size,), torch.float32, dev, rng)).to(g_dtype)
    states = [0.1 * _randn((size,), torch.float32, dev, rng)
              for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
    if kind == "adam":
        states[1] = states[1].abs()
    return w, g, tuple(states)


def host_ms(fn, reps, warmup):
    """Median host ms to enqueue one call of ``fn`` (checks, allocations,
    the launch itself): a ~0.5 ms sleep kernel is queued first, so the call
    never waits for the card."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps, warmup, flush, sleep_cycles=1_000_000):
    """Median device ms of ``fn``'s launches, L2 flushed before each rep:
    a sleep kernel (``sleep_cycles`` clocks, ~0.5 ms by default) is queued
    before the start event, so the host enqueues the launches while the
    card sleeps and the events time the launches back to back, not the
    host's enqueue gaps, as long as the enqueue is shorter than the
    sleep."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slab_launches_a_step(kernels, slabs):
    """K1's launches for one update over ``slabs`` slabs: one for every
    table of ``SLAB_TABLE_CAP`` where the package has the table wrapper,
    else one a slab (older trees, run through ``--package``)."""
    cap = getattr(kernels, "SLAB_TABLE_CAP", None)
    return -(-slabs // cap) if cap else slabs


def slab_table(kernels, kind, g_dtype, plan, dev, gen, chunks=1):
    """One step's table for phase 16: ResNet-50's AMP buckets (each whole,
    or as its ``chunks`` dp chunks, which begin at multiples of padded /
    chunks: replicated mode's entries) and seven entries of 1-7 elements
    at offsets 1-3 off the 16-byte boundary, each with its own lr (one a
    device tensor) and wd; random masters, states and gradients from the
    device generator ``gen`` (Adam's second moment non-negative)."""
    import torch

    def rand(n, scale=1.0, dtype=torch.float32, offset=0):
        buf = torch.randn(n + offset, generator=gen, device=dev) * scale
        return buf.to(dtype)[offset:]

    slots = kernels.SLAB_STATE_SLOTS[kind]
    slabs = []
    for b in plan.buckets:
        w, g = rand(b.padded), rand(b.padded, 4.0, g_dtype)
        states = [rand(b.padded, 0.1) for _ in range(slots)]
        s = b.padded // chunks
        slabs += [(w[c * s:(c + 1) * s], g[c * s:(c + 1) * s],
                   [x[c * s:(c + 1) * s] for x in states]) for c in range(chunks)]
    for n in range(1, 8):
        off = 1 + n % 3
        slabs.append((rand(n, offset=off), rand(n, 4.0, g_dtype, off),
                      [rand(n, 0.1, offset=off) for _ in range(slots)]))
    entries = []
    for i, (w, g, states) in enumerate(slabs):
        if kind == "adam":
            states[1] = states[1].abs()
        lr = torch.full((), 0.07, device=dev) if i == 1 else 0.1 * (1 + i % 3) / 2
        entries.append(kernels.SlabEntry(w, g, tuple(states), lr, (0.0, 1e-4, 5e-4)[i % 3]))
    return entries


def slab_outputs(result):
    new_w, new_states, w16 = result
    return (new_w, *new_states, w16)


def phase_slab_table_checks(kernels, dev, plan):
    """Phase 16's table cases: K1 over ``slab_table`` in one call, against
    the plain version of the table, bit for bit; a repeat; a skipped step;
    the launches a call; replicated mode's 64 chunks with the small slabs
    (71 slabs, three launches); one call in place under sync debug mode
    'error'."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(16)
    cases, worst, shapes = 0, 0.0, {}
    tables = [(kind, g_dtype, 1) for kind in ("sgd", "sgd_mom", "adam")
              for g_dtype in (torch.bfloat16, torch.float32)] + [("sgd_mom", torch.bfloat16, 4)]
    for kind, g_dtype, chunks in tables:
        entries = slab_table(kernels, kind, g_dtype, plan, dev, gen, chunks)
        shapes[len(entries)] = slab_launches_a_step(kernels, len(entries))
        for finite in (1.0, 0.0):
            for clip in (None, 0.05):
                args = (kind, entries, torch.full((), 1.0 / 128, device=dev),
                        torch.full((), finite, device=dev))
                before = kernels.fused_slab_update.launches
                got = kernels.fused_slab_update_multi(*args, clip_gradient=clip, **SLAB_STATICS)
                again = kernels.fused_slab_update_multi(*args, clip_gradient=clip,
                                                        **SLAB_STATICS)
                launched = kernels.fused_slab_update.launches - before
                want = kernels.slab_update_multi_reference(*args, clip_gradient=clip,
                                                           **SLAB_STATICS)
                torch.cuda.synchronize()
                if launched != 2 * slab_launches_a_step(kernels, len(entries)):
                    raise AssertionError("slab_update_multi: %d launches for two calls over %d "
                                         "slabs" % (launched, len(entries)))
                for e, r, w_, a in zip(entries, got, want, again):
                    for x, y, z in zip(slab_outputs(r), slab_outputs(w_), slab_outputs(a)):
                        err = (x.float() - y.float()).abs().max().item()
                        worst = max(worst, err)
                        if not torch.equal(x, y):
                            raise AssertionError(
                                "slab_update_multi %s g %s S=%d finite %s clip %s: %.3g from "
                                "the plain version" % (kind, g_dtype, e.w.shape[0], finite, clip,
                                                       err))
                        if not torch.equal(x, z):
                            raise AssertionError("slab_update_multi is not bitwise repeatable")
                    if finite == 0.0 and not (
                            torch.equal(r[0], e.w)
                            and all(torch.equal(x, y) for x, y in zip(r[1], e.states))
                            and torch.equal(r[2], e.w.to(torch.bfloat16))):
                        raise AssertionError("slab_update_multi changed a skipped step's bits")
                cases += 1
        del entries, got, again, want
    # one step's call as the trainer makes it (in place, host lrs, device
    # inv_scale and finite), which must never wait for the device
    entries = [kernels.SlabEntry(e.w, e.g, e.states, float(0.05 * (1 + i % 2)), e.wd,
                                 (e.w, e.states, torch.empty_like(e.w, dtype=torch.bfloat16)))
               for i, e in enumerate(slab_table(kernels, "sgd_mom", torch.bfloat16, plan, dev,
                                                gen))]
    copy = [kernels.SlabEntry(e.w.clone(), e.g, tuple(x.clone() for x in e.states), e.lr, e.wd)
            for e in entries]
    inv, fin = torch.full((), 1.0 / 128, device=dev), torch.ones((), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.fused_slab_update_multi("sgd_mom", entries, inv, fin, clip_gradient=None,
                                        **SLAB_STATICS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kernels.slab_update_multi_reference("sgd_mom", copy, inv, fin, clip_gradient=None,
                                               **SLAB_STATICS)
    torch.cuda.synchronize()
    for e, w_ in zip(entries, want):
        if not all(torch.equal(x, y) for x, y in zip((e.w, *e.states, e.out[2]),
                                                      slab_outputs(w_))):
            raise AssertionError("slab_update_multi in place differs from the plain version")
    log("phase 16: slab_update_multi (K1 over a table) vs plain bit for bit over %d cases "
        "(slabs: launches a call %s), max_abs_err %.3g; a call in place under sync debug mode "
        "'error' ran" % (cases, json.dumps(shapes), worst))
    return {"table_cases": cases, "launches_a_call": shapes, "table_max_abs_err": worst}


def phase_slab_checks(kernels, dev, plan):
    import torch

    rng = np.random.default_rng(10)
    sizes = sorted(set(SLAB_SIZES) | {b.padded for b in plan.buckets})
    cases, worst = 0, 0.0
    for size in sizes:
        for kind in ("sgd", "sgd_mom", "adam"):
            for g_dtype in (torch.bfloat16, torch.float32):
                w, g, states = slab_case(kernels, kind, size, g_dtype, dev, rng)
                for finite in (1.0, 0.0):
                    for clip in (None, 0.05):
                        args = (kind, w, g, states, 0.05, 1.0 / 128, finite)
                        got = kernels.fused_slab_update(*args, clip_gradient=clip, **SLAB_KW)
                        again = kernels.fused_slab_update(*args, clip_gradient=clip, **SLAB_KW)
                        want = kernels.slab_update_reference(*args, clip_gradient=clip,
                                                             **SLAB_KW)
                        torch.cuda.synchronize()
                        outs = list(zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2]),
                                        (again[0], *again[1], again[2])))
                        for a, b, c in outs:
                            err = (a.float() - b.float()).abs().max().item()
                            worst = max(worst, err)
                            if not torch.equal(a, b):
                                raise AssertionError(
                                    "slab_update %s S=%d g %s finite %s clip %s: %.3g from the "
                                    "plain version" % (kind, size, g_dtype, finite, clip, err))
                            if not torch.equal(a, c):
                                raise AssertionError("slab_update is not bitwise repeatable")
                        if finite == 0.0 and not (
                                torch.equal(got[0], w)
                                and all(torch.equal(a, s) for a, s in zip(got[1], states))
                                and torch.equal(got[2], w.to(torch.bfloat16))):
                            raise AssertionError("slab_update changed a skipped step's bits")
                        cases += 1
    # one launch that must never wait for the device
    w, g, states = slab_case(kernels, "sgd_mom", 5000, torch.bfloat16, dev, rng)
    inv, fin = torch.full((), 1.0 / 128, device=dev), torch.ones((), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.fused_slab_update("sgd_mom", w, g, states, 0.05, inv, fin, clip_gradient=None,
                                  out=(w, states, torch.empty(5000, dtype=torch.bfloat16,
                                                              device=dev)), **SLAB_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("phase 16: slab_update (K1) vs plain bit for bit over %d cases, %d sizes (%d buckets of "
        "ResNet-50's AMP plan), max_abs_err %.3g; a launch under sync debug mode 'error' ran"
        % (cases, len(sizes), len(plan.buckets), worst))
    res = {"cases": cases, "sizes": sizes, "max_abs_err": worst}
    if hasattr(kernels, "fused_slab_update_multi"):
        res.update(phase_slab_table_checks(kernels, dev, plan))
        res["max_abs_err"] = max(worst, res["table_max_abs_err"])
    return res


def k1_step(kernels, plan, dev, rng):
    """One step's K1 work on ResNet-50's AMP plan as the trainer hands it
    over (sgd_mom, bf16 gradient, in place, each bucket's lr and wd host
    numbers, inv_scale and finite device scalars): one table call where the
    package has the table wrapper, else one call a bucket. Returns the
    callable, its plain version (one ``slab_update_reference`` a bucket)
    and each bucket's one-slab call."""
    import torch

    inv, fin = torch.full((), 1.0 / 32768, device=dev), torch.ones((), device=dev)
    slabs = []
    for b in plan.buckets:
        w, g, states = slab_case(kernels, "sgd_mom", b.padded, torch.bfloat16, dev, rng)
        slabs.append((w, g, states, torch.empty(b.padded, dtype=torch.bfloat16, device=dev)))
    singles = [lambda s=s: kernels.fused_slab_update(
        "sgd_mom", s[0], s[1], s[2], 0.1, inv, fin, clip_gradient=None, out=(s[0], s[2], s[3]),
        **SLAB_KW) for s in slabs]
    plain = [lambda s=s: kernels.slab_update_reference(
        "sgd_mom", s[0], s[1], s[2], 0.1, inv, fin, clip_gradient=None, **SLAB_KW)
        for s in slabs]
    if hasattr(kernels, "fused_slab_update_multi"):
        entries = [kernels.SlabEntry(w, g, states, 0.1, SLAB_KW["wd"], (w, states, w16))
                   for w, g, states, w16 in slabs]

        def step():
            kernels.fused_slab_update_multi("sgd_mom", entries, inv, fin, clip_gradient=None,
                                            **SLAB_STATICS)
    else:
        def step():
            for fn in singles:
                fn()
    return step, (lambda: [fn() for fn in plain]), singles


def phase_slab_times(kernels, dev, plan, launches, checks, fit):
    """Kernels-line entry of K1: one step's update over ResNet-50's 16 AMP
    buckets (``k1_step``): ``ms`` (events around the call, L2 flushed),
    ``device_ms`` (after a ~5 ms sleep kernel: the card alone),
    ``host_ms`` (the enqueue), the plain version's device ms, the bound in
    total and a bucket (with each bucket's one-slab call), the in-step card
    time from phase 17's profile and the trainer's whole update beside it."""
    import torch

    rng = np.random.default_rng(11)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    step, plain, singles = k1_step(kernels, plan, dev, rng)
    before = kernels.fused_slab_update.launches
    step()
    step_launches = kernels.fused_slab_update.launches - before
    ms = time_ms(step, 20, 3, flush)
    dev_ms = device_ms(step, 20, 3, flush, sleep_cycles=10_000_000)
    host = host_ms(step, 20, 3)
    plain_ms = device_ms(plain, 10, 2, flush, sleep_cycles=10_000_000)
    rows = [{"padded": b.padded, "one_slab_device_ms": device_ms(fn, 10, 2, flush),
             "bound_ms": 20.0 * b.padded / PEAK_BYTES * 1e3}
            for b, fn in zip(plan.buckets, singles)]
    elems = sum(b.padded for b in plan.buckets)
    nbytes = 20.0 * elems  # read w 4, g 2, mom 4; write w 4, mom 4, w16 2
    bound = nbytes / PEAK_BYTES * 1e3
    in_step = fit["profile"]["families_per_step"].get("slab_update", {})
    entry = {
        "name": "slab_update", "route": "cuda", "source": "mxnet_tpu_torch/csrc/slab_update.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:582", "launches": launches,
        "max_abs_err": checks["max_abs_err"], "ms": ms, "device_ms": dev_ms, "host_ms": host,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "library_note": "none: no single PyTorch call computes this update (torch's fused "
                        "optimizers use other formulas and write no bf16 copy)",
        "per": "one step: %d launch(es) (sgd_mom, bf16 gradient, in place) over ResNet-50's %d "
               "AMP buckets at dp 4, %d elements" % (step_launches, len(plan.buckets), elems),
        "launches_a_step": step_launches, "bytes": nbytes,
        "share_of_bound": bound / dev_ms, "in_step_device_ms": in_step.get("device_ms"),
        "in_step_launches": in_step.get("count"), "trainer_update": fit["update_times"],
        "buckets": rows,
    }
    log("  slab_update %s" % json.dumps(entry))
    return [entry]


def phase_trainer_update_times(mod, kernels, dev):
    """The trainer's whole AMP update (``_apply_optimizer_flat_amp``: the
    gradient slabs, the finite flag, K1, the loss scaler) on phase 17's
    plan, on copies of its state, with random bf16 gradients (finite at its
    loss scale): ``ms`` (events, L2 flushed), ``device_ms`` (after a ~10 ms
    sleep kernel), ``host_ms`` (the enqueue) and K1's launches a call."""
    import torch

    tr, owner = mod._fused_trainer, mod._fused_owner
    params = dict(owner._fused_params)
    opt = {k: (tuple(x.clone() for x in v) if isinstance(v, tuple) else
               v.clone() if torch.is_tensor(v) else v) for k, v in owner._fused_opt.items()}
    gen = torch.Generator(device=dev).manual_seed(17)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev).to(torch.bfloat16)
             for n, p in params.items()}
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def update():
        with torch.no_grad():
            tr._apply_optimizer_flat_amp(params, grads, opt, SGD["lr"], 10)

    before = kernels.fused_slab_update.launches
    update()
    launched = kernels.fused_slab_update.launches - before
    return {"ms": time_ms(update, 10, 2, flush),
            "device_ms": device_ms(update, 10, 2, flush, sleep_cycles=20_000_000),
            "host_ms": host_ms(update, 10, 2), "k1_launches_a_call": launched}


def phase_slab_path(mx, resnet, kernels, dev, results):
    """Phases 16-18 and K1's kernels-line entry (``results["k1_entry"]``),
    as the full run and ``--only slab`` run them."""
    plan = resnet50_amp_plan(mx, resnet)
    results["slab_checks"] = phase_slab_checks(kernels, dev, plan)
    results["fit_resnet_amp"] = fit = phase_fit_resnet_amp(mx, kernels, dev, plan)
    results["convergence"] = conv = phase_convergence(mx, kernels, dev)
    by_path = {"fit_resnet_amp": fit["launches"]["slab_update"],
               "convergence_adam": conv["b"]["slab_update_launches"]}
    k1 = phase_slab_times(kernels, dev, plan, sum(by_path.values()), results["slab_checks"], fit)[0]
    k1["launches_by_path"] = by_path
    k1["share_of_phase17_step"] = k1["ms"] / fit["step_ms_median_steps_3_8"]
    results["k1_entry"] = k1


def _amp_env(on):
    if on:
        os.environ["MXTPU_AMP"] = "bf16"
    else:
        os.environ.pop("MXTPU_AMP", None)


def phase_fit_resnet_amp(mx, kernels, dev, plan):
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rng = np.random.RandomState(12)
    n = FIT_BATCHES * RESNET_BATCH
    X = rng.rand(n, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    from mxnet_tpu_torch.models import resnet

    np.random.seed(0)
    mod = mx.mod.Module(resnet.get_symbol(), context=mx.gpu(0),
                        mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
    losses, stamps = [], []
    from mxnet_tpu_torch.tools import model_sweep, resnet_bench

    def on_batch(param):
        prob = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data
        losses.append(float(resnet_bench.cross_entropy(prob, label)))  # synchronises
        stamps.append(time.perf_counter())

    _amp_env(True)
    try:
        zero_counts(kernels)
        kernels.fused_slab_update.launches = 0  # counts from here are this path's
        t_fit = time.perf_counter()
        mod.fit(it, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": SGD["lr"], "momentum": SGD["momentum"],
                                  "wd": SGD["wd"]},
                initializer=mx.init.Xavier(), num_epoch=1, batch_end_callback=on_batch)
        counts = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
    finally:
        _amp_env(False)
    tr = mod._fused_trainer
    owner = mod._fused_owner
    buckets = len(tr._flat_plan.buckets)
    assert tr.amp and tr.flat_mode == "shard", (tr.amp, tr.flat_mode)
    assert [b.padded for b in tr._flat_plan.buckets] == [b.padded for b in plan.buckets]
    # K1: one launch a step over every bucket (older trees: one a bucket)
    want = {"conv_bwd_filter": RESNET_CONVS * FIT_BATCHES,
            "conv_bwd_input": RESNET_CONVS * FIT_BATCHES,
            "slab_update": slab_launches_a_step(kernels, buckets) * FIT_BATCHES}
    assert counts == want, (counts, want)
    assert len(losses) == FIT_BATCHES and all(np.isfinite(losses)), losses
    masters = tr.master_params_named(owner._fused_opt)
    for name, p in owner._fused_params.items():
        assert p.dtype == torch.bfloat16, name
        assert torch.equal(p, masters[name].to(torch.bfloat16)), "%s != bf16(master)" % name
    arg, _ = mod.get_params()
    for name, v in arg.items():
        assert v._data.dtype == torch.float32 and torch.equal(v._data, masters[name].cpu()), name
    scale, good = (float(owner._fused_opt[k]) for k in (tr.AMP_SCALE_KEY, tr.AMP_GOOD_KEY))
    assert scale == tr.amp_scale_init and good == FIT_BATCHES, (scale, good)
    step_s = [b - a for a, b in zip(stamps[1:], stamps[2:])]  # steps 3-8
    med = statistics.median(step_s)
    res = {"batch": RESNET_BATCH, "steps": FIT_BATCHES, "dp": 4, "buckets": buckets,
           "padded": [b.padded for b in tr._flat_plan.buckets], "losses": losses,
           "launches": counts, "loss_scale": scale, "good_steps": good,
           "setup_and_fit_s": time.perf_counter() - t0, "fit_s": time.perf_counter() - t_fit,
           "step_ms_median_steps_3_8": 1e3 * med, "img_per_s": RESNET_BATCH / med,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}

    # a poisoned batch: skipped bit for bit, scale halved; then a clean step
    snap = {"params": {k: v.clone() for k, v in owner._fused_params.items()},
            "opt": {k: v.clone() for k, v in owner._fused_opt.items() if torch.is_tensor(v)}}
    it.reset()
    batch = next(iter(it))
    bad = mx.io.DataBatch([batch.data[0].copy()], batch.label)
    bad.data[0]._data[0, 0, 0, 0] = float("inf")
    before = kernels.fused_slab_update.launches
    mod.forward_backward(bad)
    mod.update()
    torch.cuda.synchronize()
    assert kernels.fused_slab_update.launches - before == slab_launches_a_step(kernels, buckets)
    for k, v in owner._fused_params.items():
        assert torch.equal(v, snap["params"][k]), "param %s changed on a skipped step" % k
    for k, v in owner._fused_opt.items():
        if k not in (tr.AMP_SCALE_KEY, tr.AMP_GOOD_KEY):
            assert torch.equal(v, snap["opt"][k]), "state %s changed on a skipped step" % k
    assert float(owner._fused_opt[tr.AMP_SCALE_KEY]) == scale / 2
    assert float(owner._fused_opt[tr.AMP_GOOD_KEY]) == 0.0
    mod.forward_backward(batch)
    mod.update()
    changed = sum(not torch.equal(v, snap["params"][k]) for k, v in owner._fused_params.items())
    assert changed > 0, "the clean step after the skipped one did not update"
    assert float(owner._fused_opt[tr.AMP_GOOD_KEY]) == 1.0
    res["poisoned_step"] = {"skipped_bitwise": True, "scale_after": scale / 2,
                            "params_changed_by_next_clean_step": changed}
    res["profile"] = profile_fit_steps(mod, batch)
    res["update_times"] = phase_trainer_update_times(mod, kernels, dev)
    log("phase 17: ResNet-50 Module.fit, bf16 AMP, dp 4 mesh on gpu(0): %s" % json.dumps(res))
    return res


def profile_fit_steps(mod, batch, steps=2):
    """Where a fused step's time goes: ``steps`` more steps under
    torch.profiler (each ending in a synchronise); see
    :func:`profile_summary` (resnet_bench's families, K1 apart)."""
    import torch

    from mxnet_tpu_torch.tools import model_sweep, resnet_bench

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return profile_summary(prof, steps, wall, lambda name: (
        "slab_update" if "slab_update" in name else resnet_bench.family(name)))


def profile_summary(prof, steps, wall_s, family):
    """Of ``steps`` steps profiled in ``wall_s`` seconds: wall ms and
    device-busy ms a step, the idle share, kernels a step, and device ms a
    step per kernel family (``family(name)``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    fams = {}
    for e in events:
        f = fams.setdefault(family(e.name), {"device_ms": 0.0, "count": 0})
        f["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3 / steps
        f["count"] += 1 / steps
    busy = sum(f["device_ms"] for f in fams.values())
    wall = 1e3 * wall_s / steps
    return {"steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "kernels_per_step": len(events) / steps, "families_per_step": fams}


def phase_convergence(mx, kernels, dev):
    from mxnet_tpu_torch.models import mlp

    rng = np.random.RandomState(13)
    c, d = BLOBS["classes"], BLOBS["dim"]
    centers = rng.randn(c, d).astype(np.float32)
    n = BLOBS["train"] + BLOBS["val"]
    labels = rng.randint(0, c, n)
    X = (centers[labels] + rng.randn(n, d).astype(np.float32)).astype(np.float32)
    y = labels.astype(np.float32)
    tr_, va = slice(0, BLOBS["train"]), slice(BLOBS["train"], n)
    res = {}
    for leg in ("a", "b"):
        np.random.seed(0)
        train = mx.io.NDArrayIter(X[tr_], y[tr_], batch_size=BLOBS["batch"], shuffle=True)
        val = mx.io.NDArrayIter(X[va], y[va], batch_size=BLOBS["batch"])
        if leg == "a":
            mod = mx.mod.Module(mlp.get_symbol(), context=mx.gpu(0))
            kw = dict(kvstore="local", optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        else:
            mod = mx.mod.Module(mlp.get_symbol(), context=mx.gpu(0),
                                mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
            kw = dict(kvstore="device", optimizer="adam",
                      optimizer_params={"learning_rate": 0.001})
        _amp_env(leg == "b")
        try:
            kernels.fused_slab_update.launches = 0  # counts from here are this leg's
            t0 = time.perf_counter()
            mod.fit(train, eval_data=val, initializer=mx.init.Xavier(),
                    num_epoch=BLOBS["epochs"], **kw)
            wall = time.perf_counter() - t0
        finally:
            _amp_env(False)
        acc = dict(mod.score(val, "acc"))["accuracy"]
        tr = mod._fused_trainer
        res[leg] = {"val_acc": acc, "fit_s": wall, "fused": tr is not None,
                    "amp": bool(tr is not None and tr.amp),
                    "slab_update_launches": kernels.fused_slab_update.launches}
        if leg == "b":
            steps = BLOBS["epochs"] * BLOBS["train"] // BLOBS["batch"]
            assert tr.amp and tr.flat_mode == "shard" and tr._slab_kind() == "adam"
            assert res[leg]["slab_update_launches"] == steps * slab_launches_a_step(
                kernels, len(tr._flat_plan.buckets)), res
        else:
            assert tr is None
        assert acc >= 0.97, (leg, acc)
    log("phase 18: 10-blob MLP convergence on the card: %s" % json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's numbers to this JSON file")
    ap.add_argument("--package", help="import mxnet_tpu_torch from this checkout instead of the "
                    "one beside this script (to run this script's phases on another tree)")
    ap.add_argument("--only", choices=("f32_lm", "rtc", "slab", "zoo"),
                    help="f32_lm: build, phase 19 and phase 8's attention kernel times only; "
                    "rtc: K5's push path on ResNet-50's parameter arrays only; slab: K1's "
                    "build, phases 16-18 and K1's times only; zoo: K2/K3's build and "
                    "phase 20 only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.package or os.path.dirname(os.path.abspath(__file__))))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_kernels as rk
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.examples import train_transformer_lm as trainer
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.serving import GenerationEngine
    from mxnet_tpu_torch.tools import model_sweep, resnet_bench

    # f32 products stay f32 (no TF32) in the plain versions and the f32 model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))

    results = {"card": card, "package": os.path.dirname(os.path.abspath(mx.__file__))}
    if args.only == "rtc":
        results["rtc_push"] = phase_rtc_push(mx, rk, resnet, dev)
    if args.only == "f32_lm":
        t0 = time.perf_counter()
        _build.build()
        results["build_s"] = time.perf_counter() - t0
        results["training_f32_full"] = phase_train_lm(trainer, kernels, dev, "float32",
                                                      lm_family)
        f32_launches = dict(results["training_f32_full"]["launches"])
        bf16_launches = dict.fromkeys(f32_launches, 0)
        results["kernels"] = (
            phase_kernel_times(kernels, dev, 0, f32_launches["flash_attn_fwd"])
            + phase_bwd_times(kernels, dev, bf16_launches, f32_launches))
    if args.only == "slab":
        t0 = time.perf_counter()
        _build.build(["slab_update"])
        results["build_s"] = time.perf_counter() - t0
        phase_slab_path(mx, resnet, kernels, dev, results)
        results["kernels"] = [results.pop("k1_entry")]
    if args.only == "zoo":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter"])
        results["build_s"] = time.perf_counter() - t0
        results["zoo"], results["zoo_launches"] = phase_zoo(model_sweep, kernels, dev)
    if args.only:
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        print(card)
        return 0
    results["build_s"], results["sass"] = phase_build(_build)
    results["kernel_checks"] = phase_kernel_checks(kernels, dev)
    results["bwd_kernel_checks"] = phase_bwd_checks(kernels, dev)
    results["serving_f32"] = phase_serving_f32(tfm, kernels, dev)
    results["training_f32"] = phase_train_f32(tfm, trainer, kernels, dev)
    results["serving_bf16"] = phase_serving_bf16(tfm, kernels, telemetry, GenerationEngine, dev)
    results["training_bf16"] = phase_train_lm(trainer, kernels, dev, "bfloat16")
    train_launches = results["training_bf16"]["launches"]
    results["training_f32_full"] = phase_train_lm(trainer, kernels, dev, "float32",
                                                  lm_family)
    results["conv_checks"], conv_errs = phase_conv_checks(kernels, resnet, dev)
    results["resnet_grads_f32"] = phase_resnet_grads_f32(resnet_bench, kernels, dev)
    results["resnet_train"] = [phase_resnet_train(resnet_bench, kernels, dev, dtype)
                               for dtype in ("float32", "bfloat16")]
    conv_launches = {name: sum(r["launches"][name] for r in results["resnet_train"])
                     for name in ("conv_bwd_filter", "conv_bwd_input")}
    results["rtc"] = phase_rtc(mx, rk, dev)
    # cuDNN's default backward algorithms for the strided convolutions sum
    # in an order that changes from run to run; phases 14 and 15 compare two
    # runs of one computation, so they take its deterministic algorithms
    torch.backends.cudnn.deterministic = True
    results["executor"] = phase_executor(mx, resnet, resnet_bench, kernels, dev)
    results["rtc_training"], rtc_runs = phase_rtc_training(mx, rk, resnet, resnet_bench, kernels,
                                                          dev)
    torch.backends.cudnn.deterministic = False
    conv_launches = {name: conv_launches[name] + results["rtc_training"]["launches"][name]
                     for name in conv_launches}
    phase_slab_path(mx, resnet, kernels, dev, results)
    conv_launches = {name: conv_launches[name] + results["fit_resnet_amp"]["launches"][name]
                     for name in conv_launches}
    results["zoo"], zoo_launches = phase_zoo(model_sweep, kernels, dev)
    conv_launches = {name: conv_launches[name] + zoo_launches[name] for name in conv_launches}
    # the f32 kernels' launches in phases 4, 5 and 19
    f32_launches = {name: n + results["training_f32_full"]["launches"][name]
                    for name, n in results["training_f32"]["launches"].items()}
    f32_launches["flash_attn_fwd"] += results["serving_f32"]["launches"]
    fwd = phase_kernel_times(kernels, dev, results["serving_bf16"]["flash_launches"],
                             f32_launches["flash_attn_fwd"])
    # the forward kernel runs on both main paths
    fwd[0]["launches_by_path"] = {"serving": fwd[0]["launches"],
                                  "training": train_launches["flash_attn_fwd"]}
    fwd[0]["launches"] += train_launches["flash_attn_fwd"]
    conv_entries = phase_conv_times(kernels, resnet, dev, conv_launches, conv_errs)
    for entry in conv_entries:
        # phase 20: the zoo's training launches and inception-v3's f32 step
        step = results["zoo"]["inception_v3_f32_step"][entry["name"]]
        entry["zoo"] = {"launches": zoo_launches[entry["name"]],
                        "inception_v3_f32_step": {k: v for k, v in step.items()
                                                  if k != "shapes"}}
    kernel_line = {"kernels": fwd + phase_bwd_times(kernels, dev, train_launches, f32_launches)
                   + conv_entries
                   + phase_rtc_times(mx, rk, rtc_runs, results["rtc_training"], dev)
                   + [results.pop("k1_entry")],
                   "card": card}
    results.update(kernel_line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
