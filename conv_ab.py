"""A/B of the bf16 conv filter-gradient kernel (K2, ``conv_wgrad_sm90``)
against variants of its own source, in one process on one CUDA card.

    python3 conv_ab.py [--out r.json] [--rounds 2] [--profile]

A variant is a copy of ``mxnet_tpu_torch/csrc/conv_bwd.cu`` and
``flash_sm90.cuh`` with some text of the kernels' code replaced
(``VARIANTS``), written to ``build/conv_ab/<name>/`` and built from there
by ``mxnet_tpu_torch.tools.source_ab`` (the package's own ``_build``, one
``nvcc`` per distinct library, all started together), and split by
``kernels.wgrad_splits_sm90`` told the variant's CTA (``RULES``):

- ``as_built``: the sources as they are (CTAs of two warpgroups, 128 o,
  where O > 64);
- ``one_warpgroup``: CTAs of one warpgroup, 64 o, at every O;
- ``three_stages``: a ring of 3 stages, not 4, so more CTAs fit an SM;
- ``scalar_transpose``: every layout transpose through the 32 x 32 tile
  of 2-byte loads and stores, not the 64 x 64 one of 4-byte pairs.

The entry point ``mxtt_conv_bwd_filter`` is called directly with the
wrapper's allocations (where g and x are not read in place, the layout
transposes of both inside every call, as a standalone ``conv_bwd_filter``
makes them). Every variant is first held to ``conv_bwd_filter_reference``
at every in-envelope ResNet-50 shape at batch 32 and at
``chip_smoke.CONV_RAGGED`` (1e-4 of max|plain|, a repeat bitwise); a
variant that fails stops the run. Then each is timed in turns, the order
forward and back, ``--rounds`` times, at every ResNet-50 shape with
``chip_smoke.device_ms`` (L2 flushed and a sleep kernel queued before
each launch: the card's time alone); ``torch.nn.grad.conv2d_weight``
(cuDNN) once a shape as a yardstick. Prints the card's name and power
limit, the ptxas registers, every timing's median per shape and the
launch-weighted ms of a batch-32 step. ``--profile`` then traces five
calls a shape of ``as_built`` and of cuDNN with ``torch.profiler`` (L2
flushed before each) and prints the device ms of one call per kernel: the
layout transposes, the first pass and the reduce apart.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

SOURCES = ("flash_sm90.cuh", "conv_bwd.cu")
KERNELS = ("conv_bwd_filter",)
# name: [(source file, old text, new text)]; every replacement must apply
VARIANTS = {
    "as_built": [],
    "one_warpgroup": [("conv_bwd.cu", "return q.o > kRows ? launch_wgrad_tiles",
                       "return false ? launch_wgrad_tiles")],
    "three_stages": [("conv_bwd.cu", "constexpr int kConvStages = 4;",
                      "constexpr int kConvStages = 3;")],
    "scalar_transpose": [("conv_bwd.cu", "if (words && rows % 2 == 0 && cols % 2 == 0) {",
                          "if (false) {")],
}
# name: the arguments of kernels.wgrad_splits_sm90 that describe its CTA
RULES = {"one_warpgroup": {"o_tile": 64}, "three_stages": {"stages": 3}}


def launch(fn, kernels, x, g, wshape, pad, rule, sm_count):
    """One call of a variant's K2 entry point on bf16 NCHW x and g, with
    the wrapper's allocations and mode and the variant's split; returns
    gw."""
    import torch

    geo = kernels._conv_geometry(x.shape, wshape, pad)
    n, c, h, w, o, kh, kw, _, _, oh, ow = geo
    mode = kernels.wgrad_plan_sm90(x, g, wshape, pad, sm_count)[0]
    splits, per = kernels.wgrad_splits_sm90(
        o, c, kh * kw, kernels.wgrad_steps_sm90(mode, n, oh, ow), sm_count, **rule)
    x_cl = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    g_cl = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, kh * kw, o, c), dtype=torch.float32, device=x.device)
    gw = torch.empty(tuple(wshape), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), g.data_ptr(), x_cl.data_ptr(), g_cl.data_ptr(), ws.data_ptr(),
            gw.data_ptr(), *geo, splits, per, 1, 0, int(mode == "nchw"),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit("launch failed: CUDA error %d" % rc)
    return gw


def kernel_ms(fn, flush, calls=5):
    """{kernel name: device ms of one call} of ``fn`` over ``calls`` traced
    calls, each after an L2 flush (whose fill kernel is left out)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or "elementwise" in e.key:
            continue
        names = re.findall(r"([A-Za-z_]\w*)\s*[<(]", e.key)
        name = names[0] if names else e.key[:60]
        out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / calls
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--rounds", type=int, default=2,
                    help="times each variant is timed, in turns forward and back")
    ap.add_argument("--profile", action="store_true",
                    help="also trace as_built and cuDNN: device ms per kernel of one call")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("conv_ab: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.tools import source_ab

    card = chip_smoke.card_line()
    print("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))
    dirs = source_ab.write_variants(_build.BUILD_DIR.parent / "conv_ab", SOURCES, VARIANTS)
    fns = {name: fn for name, (fn,) in source_ab.build_variants(dirs, KERNELS).items()}
    regs = source_ab.registers(dirs, KERNELS, chip_smoke.ptxas_lines)
    for name, lines in regs.items():
        for label, line in sorted(lines.items()):
            print("  %s %s: %s" % (name, label, line))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def call(name, x, g, wshape, pad):
        return launch(fns[name], kernels, x, g, wshape, pad, RULES.get(name, {}), sms)

    rng = np.random.default_rng(9)
    shapes = chip_smoke.resnet_conv_shapes(resnet, kernels, chip_smoke.RESNET_BATCH)
    inputs = {key: chip_smoke.conv_inputs(*key, torch.bfloat16, dev, rng)
              for key in list(shapes) + chip_smoke.CONV_RAGGED}
    for name in fns:
        worst = 0.0
        for (dshape, wshape, pad), (x, _, g) in inputs.items():
            got = call(name, x, g, wshape, pad)
            want = kernels.conv_bwd_filter_reference(x, g, wshape, pad)
            err = (got - want).abs().max().item() / want.abs().max().item()
            same = torch.equal(got, call(name, x, g, wshape, pad))
            if not (err <= 1e-4 and same):
                raise SystemExit("variant %s fails at %s %s pad %s: rel_err %.3g, repeat bitwise %s"
                                 % (name, dshape, wshape, pad, err, same))
            worst = max(worst, err)
        print("check %s: ok over %d shapes, worst rel_err %.3g" % (name, len(inputs), worst),
              flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def time_variant(name):
        out = {}
        for key in shapes:
            x, _, g = inputs[key]
            out[str(key)] = chip_smoke.device_ms(lambda: call(name, x, g, key[1], key[2]),
                                                 10, 2, flush)
        return out

    ms, median = source_ab.in_turns(list(fns), args.rounds, time_variant)
    cudnn = {}
    for key in shapes:
        x, _, g = inputs[key]
        cudnn[str(key)] = chip_smoke.device_ms(
            lambda: conv2d_weight(x, key[1], g, padding=key[2]), 10, 2, flush)
    per_step = {name: sum(median[name][str(key)] * count for key, count in shapes.items())
                for name in fns}
    per_step["cudnn_conv2d_weight"] = sum(cudnn[str(key)] * count
                                          for key, count in shapes.items())
    for key, count in shapes.items():
        print("time %s x%d: %s cudnn %.5f" % (key, count, json.dumps(
            {name: round(median[name][str(key)], 5) for name in fns}), cudnn[str(key)]))
    print("per batch-32 step (launch-weighted device ms): %s" % json.dumps(per_step))
    profile, profile_step = {}, {}
    if args.profile:
        for key, count in shapes.items():
            x, _, g = inputs[key]
            profile[str(key)] = {
                "as_built": kernel_ms(lambda: call("as_built", x, g, key[1], key[2]), flush),
                "cudnn": kernel_ms(lambda: conv2d_weight(x, key[1], g, padding=key[2]), flush)}
            print("profile %s x%d: %s" % (key, count, json.dumps(
                {side: {k: round(v, 5) for k, v in r.items()}
                 for side, r in profile[str(key)].items()})))
            for side, r in profile[str(key)].items():
                for k, v in r.items():
                    profile_step.setdefault(side, {}).setdefault(k, 0.0)
                    profile_step[side][k] += v * count
        print("profile per batch-32 step: %s" % json.dumps(
            {side: {k: round(v, 4) for k, v in r.items()} for side, r in profile_step.items()}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "registers": regs, "ms": ms, "median_ms": median,
                       "cudnn_ms": cudnn, "per_step_ms": per_step, "profile": profile,
                       "profile_per_step": profile_step}, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
