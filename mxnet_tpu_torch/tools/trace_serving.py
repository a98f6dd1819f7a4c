"""Trace one serving run of the port on the card with torch.profiler.

    python -m mxnet_tpu_torch.tools.trace_serving [--out trace.json] [--chrome t.json]

Serves the mix of ``chip_smoke.py``'s phase 4 — the full bf16 transformer
LM (vocab 32000, d_model 1024, 16 heads, 12 layers, d_ff 4096), KV window
2048, 4 slots, 8 prompts of 5 to 2000 tokens with 32 new tokens each —
through ``GenerationEngine``, driven by ``step()`` on the calling thread
after a warm-up, under ``torch.profiler`` (CPU and CUDA activities).

It reports where the device time goes: the window from the first model
call to the last kernel's end, the device busy time in it (kernels and
copies, one stream, so their sum) and the idle share, and for prefill and
decode calls separately their count, device time and kernels launched.
Each kernel is charged to the model call that started last before it; the
engine synchronises after every call, so calls do not overlap on the
device. Host time inside the window includes the profiler's own overhead.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

FULL = dict(vocab=32000, d_model=1024, n_heads=16, n_layers=12, d_ff=4096)
MAX_LEN = 2048
SLOTS = 4
PROMPT_LENGTHS = (5, 60, 128, 300, 700, 1000, 1500, 2000)
MAX_NEW = 32
_RANGES = ("mxtt.prefill", "mxtt.decode_step")


def _labelled(name, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def summarize(events, ranges=_RANGES):
    """Charge every device event to the labelled host range (one of
    ``ranges``) that started last before it; see the module docstring.
    The caller makes sure the ranges' device work does not overlap."""
    cuda = torch.autograd.DeviceType.CUDA
    calls = sorted((e.time_range.start, e.name) for e in events
                   if e.name in ranges and e.device_type != cuda)
    if not calls:
        raise RuntimeError("the trace holds none of the ranges %s" % (ranges,))
    starts = [c[0] for c in calls]
    # the profiler mirrors each labelled range onto the device timeline;
    # those copies are not device work
    device = [e for e in events if e.device_type == cuda and e.name not in ranges]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    per = {name: {"calls": 0, "device_us": 0.0, "kernels": 0} for name in ranges}
    for _, name in calls:
        per[name]["calls"] += 1
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    busy = 0.0
    end = starts[0]
    for e in device:
        if e.time_range.start < starts[0]:
            continue
        dur = e.time_range.end - e.time_range.start
        busy += dur
        end = max(end, e.time_range.end)
        owner = calls[bisect.bisect_right(starts, e.time_range.start) - 1][1]
        per[owner]["device_us"] += dur
        per[owner]["kernels"] += 1
        by_kernel[e.name][0] += dur
        by_kernel[e.name][1] += 1
    window = end - starts[0]
    for v in per.values():
        v["kernels_per_call"] = v["kernels"] / max(v["calls"], 1)
        v["device_ms_per_call"] = v["device_us"] / 1e3 / max(v["calls"], 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / window if window > 0 else None,
        "calls": per,
        "top_kernels": [{"name": k[:120], "device_ms": v[0] / 1e3, "count": v[1]}
                        for k, v in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the summary JSON here")
    ap.add_argument("--chrome", help="also export the chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_serving: no CUDA device visible", file=sys.stderr)
        return 1
    from ..models import transformer as tfm
    from ..serving import GenerationEngine

    dev = torch.device("cuda", 0)
    card = card_line()
    init_fn, _ = tfm.transformer_lm(dtype=torch.bfloat16, **FULL)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.bfloat16)
    init_cache, prefill, decode_step = tfm.transformer_lm_serving(
        max_len=MAX_LEN, dtype=torch.bfloat16, **FULL)
    gen = GenerationEngine(
        params, (init_cache, _labelled(_RANGES[0], prefill),
                 _labelled(_RANGES[1], decode_step)),
        slots=SLOTS, max_len=MAX_LEN, device=dev).compile()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FULL["vocab"], n) for n in PROMPT_LENGTHS]

    def serve():
        t0 = time.perf_counter()
        reqs = [gen.submit(p, max_new=MAX_NEW) for p in prompts]
        while not all(r.done.is_set() for r in reqs):
            gen.step()
        torch.cuda.synchronize(dev)
        assert all(len(r.result(0)) == MAX_NEW for r in reqs)
        return time.perf_counter() - t0

    plain_wall = serve()  # the same run without the profiler, for its overhead
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = serve()
    summary = {"card": card, "host_wall_ms": wall * 1e3,
               "host_wall_unprofiled_ms": plain_wall * 1e3,
               "new_tokens": MAX_NEW * len(prompts), **summarize(prof.events())}
    if args.chrome:
        prof.export_chrome_trace(args.chrome)
    text = json.dumps(summary, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
