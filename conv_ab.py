"""A/B of the conv-gradient kernels (K2 ``conv_wgrad_sm90`` and K3
``conv_dgrad_sm90``) against variants of their own source, in one process
on one CUDA card.

    python3 conv_ab.py [--out r.json] [--rounds 2] [--profile] [--deep]
                       [--dtypes bfloat16,float32]

A variant is a copy of ``mxnet_tpu_torch/csrc/conv_bwd.cu`` and
``flash_sm90.cuh`` with some text of the kernels' code replaced
(``VARIANTS``), written to ``build/conv_ab/<name>/`` and built from there
by ``mxnet_tpu_torch.tools.source_ab`` (the package's own ``_build``, one
``nvcc`` per distinct library, all started together), and split by
``kernels.wgrad_splits_sm90`` told the variant's CTA (``RULES``):

- ``as_built``: the sources as they are (CTAs of two warpgroups, 128 o,
  where O > 64; the products of 8 k steps summed in a second accumulator
  and then added into the first on the CUDA cores; f32: a ring of 4
  stages where they fit, 3 at 128 o x 128 c);
- ``one_warpgroup``: CTAs of one warpgroup, 64 o, at every O (bf16);
- ``three_stages``: a ring of 3 stages, not 4, so more CTAs fit an SM
  (bf16; f32, where two f32 CTAs of 64 o x 64 c then fit an SM);
- ``scalar_transpose``: every layout transpose through the 32 x 32 tile
  of 2-byte loads and stores, not the 64 x 64 one of 4-byte pairs (bf16);
- ``promote_4``, ``promote_16``: the products of 4 (16) k steps, not 8,
  summed in the second accumulator before it is added into the first;
- ``no_promotion``: every k step of a CTA in the second accumulator,
  added into the first once, after the last (the tensor cores' sum alone,
  the way the kernels summed before they promoted).

The entry points ``mxtt_conv_bwd_filter`` (and ``mxtt_conv_bwd_input``)
are called directly with the wrappers' allocations (where g and x are not
read in place, the layout passes inside every call, as a standalone
``conv_bwd_filter`` and ``conv_bwd_input`` make them). Every variant is
first held to ``conv_bwd_filter_reference`` (and
``conv_bwd_input_reference``) at every in-envelope ResNet-50 shape at
batch 32 and at ``chip_smoke.CONV_RAGGED`` (1e-4 of max|plain|, a repeat
bitwise), in each dtype it is timed in (``DTYPES``); a variant that fails
stops the run. Then each is timed in turns, the order forward and back,
``--rounds`` times, at every ResNet-50 shape with ``chip_smoke.device_ms``
(L2 flushed and a sleep kernel queued before each launch: the card's time
alone); ``torch.nn.grad.conv2d_weight`` and ``conv2d_input`` (cuDNN, TF32
off) once a shape as a yardstick. Prints the card's name and power limit,
the ptxas registers, every timing's median per shape and the
launch-weighted ms of a batch-32 step. ``--profile`` then traces five
calls a shape of ``as_built`` and of cuDNN with ``torch.profiler`` (L2
flushed before each) and prints the device ms of one call per kernel: the
layout passes, the first pass and the reduce apart. ``--deep`` then runs
every f32 variant at ``chip_smoke.CONV_DEEP`` (the longest sums:
ResNet-50's at batch 256, AlexNet's conv2 at 512) and prints each
kernel's error against the plain version and its
device ms, K2 also at fewer k steps a split (``DEEP_PER``), the bf16
kernels' error there, and the plain version's own error against f64.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

SOURCES = ("flash_sm90.cuh", "conv_bwd.cu")
KERNELS = ("conv_bwd_filter", "conv_bwd_input")

_PROMOTE = "constexpr int kPromoteSteps = 8;"
# name: [(source file, old text, new text)]; every replacement must apply
VARIANTS = {
    "as_built": [],
    "one_warpgroup": [("conv_bwd.cu", "return q.o > kRows ? launch_wgrad_tiles",
                       "return false ? launch_wgrad_tiles")],
    "three_stages": [("conv_bwd.cu", "constexpr int kConvStages = 4;",
                      "constexpr int kConvStages = 3;")],
    "scalar_transpose": [("conv_bwd.cu", "if (words && rows % 2 == 0 && cols % 2 == 0) {",
                          "if (false) {")],
    "promote_4": [("conv_bwd.cu", _PROMOTE, _PROMOTE.replace("8", "4"))],
    "promote_16": [("conv_bwd.cu", _PROMOTE, _PROMOTE.replace("8", "16"))],
    # every k step of a CTA into part, added into acc once, after the last
    "no_promotion": [("conv_bwd.cu", _PROMOTE, _PROMOTE.replace("8", "1 << 30"))],
}
# name: the dtypes its kernels (K2 and K3) are checked and timed in
DTYPES = {"as_built": ("bfloat16", "float32"), "one_warpgroup": ("bfloat16",),
          "three_stages": ("bfloat16", "float32"), "scalar_transpose": ("bfloat16",),
          "promote_4": ("float32",), "promote_16": ("float32",),
          "no_promotion": ("bfloat16", "float32")}
# --deep: the k steps a split K2 is also run at (those below its plan)
DEEP_PER = (448, 224, 112, 56)
# name: the arguments of kernels.wgrad_splits_sm90 that describe its CTA
RULES = {"one_warpgroup": {"o_tile": 64}, "three_stages": {"stages": 3}}


def launch(fn, kernels, x, g, wshape, pad, rule, sm_count, per=None):
    """One call of a variant's K2 entry point on NCHW x and g (bf16 or
    f32), with the wrapper's allocations and mode and the variant's split
    (or ``per`` k steps a split); returns gw."""
    import torch

    geo = kernels._conv_geometry(x.shape, wshape, pad)
    n, c, h, w, o, kh, kw, _, _, oh, ow = geo
    mode = kernels.wgrad_plan_sm90(x, g, wshape, pad, sm_count)[0]
    steps = kernels.wgrad_steps_sm90(mode, n, oh, ow)
    splits, per = kernels.wgrad_splits_sm90(
        o, c, kh * kw, steps, sm_count, planes=1 if x.dtype == torch.bfloat16 else 2,
        **rule) if per is None else (-(-steps // per), per)
    x_cl = kernels._workspace((n, h, w, c), x.dtype, x.device)
    g_cl, _ = kernels._grad_cl("conv_ab", g, None)
    ws = torch.empty((splits, kh * kw, o, c), dtype=torch.float32, device=x.device)
    gw = torch.empty(tuple(wshape), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), g.data_ptr(), x_cl.data_ptr(), g_cl.data_ptr(), ws.data_ptr(),
            gw.data_ptr(), *geo, splits, per, int(x.dtype == torch.bfloat16), 0,
            int(mode == "nchw"), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit("K2 launch failed: CUDA error %d" % rc)
    return gw


def launch_input(fn, kernels, g, w, dshape, pad):
    """One call of a variant's K3 entry point, with the wrapper's
    allocations; returns dx."""
    import torch

    geo = kernels._conv_geometry(dshape, w.shape, pad)
    n, c, h, wd, o, kh, kw, _, _, _, _ = geo
    g_cl, _ = kernels._grad_cl("conv_ab", g, None)
    w_t = kernels._workspace((c, kh, kw, o), g.dtype, g.device)
    dx = torch.empty((n, c, h, wd), dtype=torch.float32, device=g.device)
    rc = fn(g.data_ptr(), w.data_ptr(), g_cl.data_ptr(), w_t.data_ptr(), dx.data_ptr(), *geo,
            int(g.dtype == torch.bfloat16), 0, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit("K3 launch failed: CUDA error %d" % rc)
    return dx


def deep_sweep(fns, names, kernels, dev, sms, flush):
    """f32 K2 and K3 of every variant in ``names`` at ``chip_smoke.CONV_DEEP``
    (batch 256): max |kernel - plain| / max |plain| (plain: the reference
    in f32, TF32 off) and the device ms, K2 at its planned split and at
    each of ``DEEP_PER`` k steps a split below it; as_built's bf16 error
    there; the plain version's own error against the same in f64. Returns
    {shape: {...}}."""
    import numpy as np
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    import chip_smoke

    rng = np.random.default_rng(11)
    out = {}
    for key in chip_smoke.CONV_DEEP:
        dshape, wshape, pad = key
        x, w, g = chip_smoke.conv_inputs(dshape, wshape, pad, torch.float32, dev, rng)
        plain = {"K2": kernels.conv_bwd_filter_reference(x, g, wshape, pad),
                 "K3": kernels.conv_bwd_input_reference(g, w, dshape, pad)}
        exact = {"K2": conv2d_weight(x.double(), wshape, g.double(), padding=pad),
                 "K3": conv2d_input(dshape, w.double(), g.double(), padding=pad)}
        row = {"plain_vs_f64": {k: ((plain[k].double() - exact[k]).abs().max()
                                    / exact[k].abs().max()).item() for k in plain}}
        del exact
        mode = kernels.wgrad_plan_sm90(x, g, wshape, pad, sms)[0]
        steps = row["steps"] = kernels.wgrad_steps_sm90(mode, dshape[0], *g.shape[2:])
        for name in names:
            filt, inp = fns[name]
            planned = kernels.wgrad_splits_sm90(wshape[0], wshape[1], wshape[2] * wshape[3],
                                                steps, sms, planes=2, **RULES.get(name, {}))[1]
            calls = {"K3": lambda: launch_input(inp, kernels, g, w, dshape, pad)}
            for per in (None,) + tuple(p for p in DEEP_PER if p < planned):
                calls["K2 per %s" % (per or planned)] = (
                    lambda per=per: launch(filt, kernels, x, g, wshape, pad, RULES.get(name, {}),
                                           sms, per))
            for tag, call in calls.items():
                want = plain[tag.split(" ")[0]]
                err = ((call() - want).abs().max() / want.abs().max()).item()
                ms = chip_smoke.device_ms(call, 5, 1, flush)
                row.setdefault(name, {})[tag] = {"rel_err": err, "ms": ms}
                print("deep %s %s %s: rel_err %.3g, %.4f ms" % (name, key, tag, err, ms),
                      flush=True)
        # bf16 as built (promoted every kPromoteSteps k steps, as f32 is)
        xb, wb, gb = (t.bfloat16() for t in (x, w, g))
        filt, inp = fns["as_built"]
        for tag, got, want in (
                ("K2", launch(filt, kernels, xb, gb, wshape, pad, {}, sms),
                 kernels.conv_bwd_filter_reference(xb, gb, wshape, pad)),
                ("K3", launch_input(inp, kernels, gb, wb, dshape, pad),
                 kernels.conv_bwd_input_reference(gb, wb, dshape, pad))):
            err = ((got - want).abs().max() / want.abs().max()).item()
            row.setdefault("bf16", {})[tag] = err
            print("deep bf16 as_built %s %s: rel_err %.3g" % (key, tag, err), flush=True)
        del xb, wb, gb
        print("deep %s plain vs f64: %s" % (key, json.dumps(row["plain_vs_f64"])), flush=True)
        out[str(key)] = row
    return out


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
    ap.add_argument("--dtypes", default="bfloat16,float32",
                    help="comma-separated dtypes to check and time the variants in")
    ap.add_argument("--deep", action="store_true",
                    help="also the f32 variants' error and ms at the batch-256 shapes whose "
                         "sums are the longest, K2 at shorter splits too")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    if not torch.cuda.is_available():
        print("conv_ab: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.tools import source_ab

    torch.backends.cudnn.allow_tf32 = False  # the f32 yardstick keeps f32 products
    card = chip_smoke.card_line()
    print("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))
    dtypes = args.dtypes.split(",")
    variants = {name: edits for name, edits in VARIANTS.items()
                if set(DTYPES[name]) & set(dtypes)}
    dirs = source_ab.write_variants(_build.BUILD_DIR.parent / "conv_ab", SOURCES, variants)
    fns = source_ab.build_variants(dirs, KERNELS)
    regs = source_ab.registers(dirs, KERNELS, chip_smoke.ptxas_lines)
    for name, lines in regs.items():
        for label, line in sorted(lines.items()):
            print("  %s %s: %s" % (name, label, line))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def calls(name, dtype, x, w, g, dshape, wshape, pad):
        """{kernel: a call of the variant's kernel} timed in dtype."""
        filt, inp = fns[name]
        return {"K2": lambda: launch(filt, kernels, x, g, wshape, pad, RULES.get(name, {}), sms),
                "K3": lambda: launch_input(inp, kernels, g, w, dshape, pad)}

    def plain(kernel, x, w, g, dshape, wshape, pad):
        if kernel == "K2":
            return kernels.conv_bwd_filter_reference(x, g, wshape, pad)
        return kernels.conv_bwd_input_reference(g, w, dshape, pad)

    rng = np.random.default_rng(9)
    shapes = chip_smoke.resnet_conv_shapes(resnet, kernels, chip_smoke.RESNET_BATCH)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    results = {}
    for dtype in dtypes:
        names = [name for name in variants if dtype in DTYPES[name]]
        inputs = {key: chip_smoke.conv_inputs(*key, getattr(torch, dtype), dev, rng)
                  for key in list(shapes) + chip_smoke.CONV_RAGGED}
        for name in names:
            worst = 0.0
            for (dshape, wshape, pad), (x, w, g) in inputs.items():
                for kernel, call in calls(name, dtype, x, w, g, dshape, wshape, pad).items():
                    got = call()
                    want = plain(kernel, x, w, g, dshape, wshape, pad)
                    err = (got - want).abs().max().item() / want.abs().max().item()
                    same = torch.equal(got, call())
                    if not (err <= 1e-4 and same):
                        raise SystemExit("variant %s %s %s fails at %s %s pad %s: rel_err %.3g, "
                                         "repeat bitwise %s" % (name, dtype, kernel, dshape,
                                                                 wshape, pad, err, same))
                    worst = max(worst, err)
            print("check %s %s: ok over %d shapes, worst rel_err %.3g"
                  % (name, dtype, len(inputs), worst), flush=True)

        def time_variant(name):
            out = {}
            for key in shapes:
                x, w, g = inputs[key]
                for kernel, call in calls(name, dtype, x, w, g, *key).items():
                    out["%s %s" % (kernel, key)] = chip_smoke.device_ms(call, 10, 2, flush)
            return out

        ms, median = source_ab.in_turns(names, args.rounds, time_variant)
        cudnn = {}
        for key in shapes:
            x, w, g = inputs[key]
            dshape, wshape, pad = key
            cudnn["K2 %s" % (key,)] = chip_smoke.device_ms(
                lambda: conv2d_weight(x, wshape, g, padding=pad), 10, 2, flush)
            cudnn["K3 %s" % (key,)] = chip_smoke.device_ms(
                lambda: conv2d_input(dshape, w, g, padding=pad), 10, 2, flush)
        kinds = sorted({k.split(" ")[0] for k in cudnn})
        per_step = {"%s %s" % (kernel, name): sum(median[name]["%s %s" % (kernel, key)] * count
                                                  for key, count in shapes.items())
                    for kernel in kinds for name in names}
        per_step.update({"%s cudnn" % kernel: sum(cudnn["%s %s" % (kernel, key)] * count
                                                  for key, count in shapes.items())
                         for kernel in kinds})
        for key, count in shapes.items():
            for kernel in kinds:
                tag = "%s %s" % (kernel, key)
                print("time %s %s x%d: %s cudnn %.5f" % (dtype, tag, count, json.dumps(
                    {name: round(median[name][tag], 5) for name in names}), cudnn[tag]))
        print("per batch-32 step, %s (launch-weighted device ms): %s"
              % (dtype, json.dumps(per_step)), flush=True)
        profile, profile_step = {}, {}
        if args.profile:
            for key, count in shapes.items():
                x, w, g = inputs[key]
                dshape, wshape, pad = key
                sides = {"as_built %s" % k: c for k, c in
                         calls("as_built", dtype, x, w, g, *key).items()}
                sides["cudnn K2"] = lambda: conv2d_weight(x, wshape, g, padding=pad)
                sides["cudnn K3"] = lambda: conv2d_input(dshape, w, g, padding=pad)
                profile[str(key)] = {side: kernel_ms(fn, flush) for side, fn in sides.items()}
                print("profile %s %s x%d: %s" % (dtype, key, count, json.dumps(
                    {side: {k: round(v, 5) for k, v in r.items()}
                     for side, r in profile[str(key)].items()})))
                for side, r in profile[str(key)].items():
                    for k, v in r.items():
                        profile_step.setdefault(side, {}).setdefault(k, 0.0)
                        profile_step[side][k] += v * count
            print("profile per batch-32 step, %s: %s" % (dtype, json.dumps(
                {side: {k: round(v, 4) for k, v in r.items()}
                 for side, r in profile_step.items()})))
        results[dtype] = {"ms": ms, "median_ms": median, "cudnn_ms": cudnn,
                          "per_step_ms": per_step, "profile": profile,
                          "profile_per_step": profile_step}
    if args.deep and "float32" in dtypes:
        results["deep"] = deep_sweep(fns, [name for name in variants
                                           if "float32" in DTYPES[name]], kernels, dev, sms,
                                     flush)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "registers": regs, **results}, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
