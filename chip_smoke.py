#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure:

1. device: the card's name and power limit; build every CUDA kernel from
   the sources in this checkout (nvcc, sm_90a, one process per source, all
   started together) and time the build.
2. forward kernel vs plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, f32 to 1e-4 and bf16 to 2e-2 (the
   plain version rounds its scores to bf16, the kernel keeps them in f32).
3. backward kernels vs plain: dq and dk/dv kernels against
   ``reference_attention_bwd`` on the same q, k, v, dO, lse and delta, for
   T in 7..2048, D 64 and 128, causal or not, f32 and bf16; error relative
   to max|plain| at most 1e-4 in f32 (summation order only) and 2e-2 in
   bf16 (both sides compute in f32 from the same bf16 loads, so the
   outputs differ by about one bf16 rounding, 2^-8 relative); and a second
   launch on the same inputs gives the same bits.
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
8. the kernels line: per kernel its launches on the main paths, error
   against the plain version, time (CUDA events, median, L2 flushed
   before each launch), the plain version's time, the least time the
   card could take (bytes at 3.35 TB/s or operations at 989 TFLOP/s,
   H100 SXM data sheet) and one PyTorch call computing the same function
   as a yardstick the port never calls (scaled_dot_product_attention, and
   its backward for dq, dk and dv together).

The last line of output is {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

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
BWD_TIME_SHAPE = (8, 2047, 16, 64)  # n, T, H, D of the training path's attention


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build(_build):
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  %s: %s" % (name, line.strip()))
    log("phase 1: built %s in %.2f s" % (sorted(logs) or "nothing new", secs))
    return secs


def _randn(shape, dtype, device, rng):
    import torch

    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def max_err(kernels, q, k, v, causal):
    import torch

    out = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = kernels.reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == q.dtype
    return (out.float() - ref.float()).abs().max().item()


def phase_kernel_checks(kernels, dev):
    import torch

    rng = np.random.default_rng(0)
    cases = [(n, t, 16, 64, True) for n in (1, 4) for t in (7, 100, 128, 512, 1000, 2048)]
    cases += [(2, 300, 16, 64, False), (2, 500, 8, 128, True)]
    worst = {}
    for (n, t, h, d, causal) in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (_randn((n, t, h, d), dtype, dev, rng) for _ in range(3))
            err = max_err(kernels, q, k, v, causal)
            log("  flash_attn_fwd n=%d T=%d H=%d D=%d causal=%s %s: max_abs_err %.3g (tol %g)"
                % (n, t, h, d, causal, str(dtype).split(".")[-1], err, tol))
            if not err <= tol:
                raise AssertionError("flash_attn_fwd disagrees with the plain version")
            key = str(dtype).split(".")[-1]
            worst[key] = max(worst.get(key, 0.0), err)
    log("phase 2: forward kernel vs plain ok, worst %s" % json.dumps(worst))
    return worst


def bwd_inputs(kernels, n, t, h, d, dtype, causal, dev, rng):
    """q, k, v, dO, and the lse and delta a training backward would hand the
    kernels: lse from the forward kernel, delta = sum_D dO * O in f32."""
    import torch

    q, k, v, do = (_randn((n, t, h, d), dtype, dev, rng) for _ in range(4))
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
    for t in BWD_CHECK_T:
        for d in (64, 128):
            for causal in (True, False):
                for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                    args = bwd_inputs(kernels, n, t, h, d, dtype, causal, dev, rng)
                    key = str(dtype).split(".")[-1]
                    for name, e in bwd_errors(kernels, args, causal).items():
                        log("  %s n=%d T=%d H=%d D=%d causal=%s %s: rel_err %.3g (tol %g) "
                            "max_abs_err %.3g, bitwise repeat %s"
                            % (name, n, t, h, d, causal, key, e["rel_err"], tol,
                               e["max_abs_err"], e["bitwise_repeat"]))
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

    before = kernels.flash_attention.launches
    got = run()
    launched = kernels.flash_attention.launches - before
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
    return err


def zero_counts(kernels):
    for fn in (kernels.flash_attention, kernels.flash_attention_dq, kernels.flash_attention_dkv):
        fn.launches = 0


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


def phase_train_bf16(trainer, kernels, dev):
    import torch

    per_step, stamps = [], []

    def on_step(i, loss, params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(read_counts(kernels))

    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)  # counts from here are the training path's
    t0 = time.perf_counter()
    losses = trainer.train(dtype="bfloat16", device=dev, on_step=on_step,
                           log=lambda *a: log("  train:", *a), **FULL, **TRAIN)
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    steps, layers = TRAIN["steps"], FULL["n_layers"]
    prev = dict.fromkeys(counts, 0)
    for i, c in enumerate(per_step):
        for name, n in c.items():
            assert n - prev[name] == layers, (i, name, n - prev[name])
        prev = c
    assert counts == dict.fromkeys(counts, steps * layers), counts
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    t = TRAIN["seq_len"]
    res = {
        "losses": losses, "wall_s": wall, "step_ms_median": 1e3 * statistics.median(step_s),
        "first_step_ms_with_setup": 1e3 * (stamps[0] - t0),
        "tokens_per_s": TRAIN["batch_size"] * t / statistics.median(step_s),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": counts, "batch": TRAIN["batch_size"], "T": t,
    }
    log("phase 7: bf16 full model, %d SGD steps of train(): %s" % (steps, json.dumps(res)))
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


def phase_kernel_times(kernels, dev, launches):
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n, h, d = 4, 16, 64
    shapes = []
    for t in (1024, 2048):
        q, k, v = (_randn((n, t, h, d), torch.bfloat16, dev, rng) for _ in range(3))
        err = max_err(kernels, q, k, v, True)
        kernel_ms = time_ms(lambda: kernels.flash_attention(q, k, v, causal=True), 30, 5, flush)
        plain_ms = time_ms(lambda: kernels.reference_attention(q, k, v, causal=True), 10, 2, flush)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 30, 5, flush)
        # causal: t(t+1)/2 live (q, k) pairs, 2*d flops each for q.k and for p.v
        flops = 2.0 * n * h * d * t * (t + 1)
        nbytes = 4 * n * t * h * d * q.element_size() + 4 * n * h * t  # q k v o + f32 lse
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        shapes.append({
            "n": n, "T": t, "H": h, "D": d, "dtype": "bfloat16", "causal": True,
            "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
        })
        log("  flash_attn_fwd %s" % json.dumps(shapes[-1]))
    head = shapes[-1]
    entry = {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:263",
        "launches": launches,
        **{key: head[key] for key in ("max_abs_err", "ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
        "shapes": shapes,
    }
    return [entry]


def phase_bwd_times(kernels, dev, launches):
    """Kernels-line entries of the two backward kernels at the training
    path's attention shape: n=8, T=2047, H=16, D=64, bf16, causal."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(6)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n, t, h, d = BWD_TIME_SHAPE
    args = bwd_inputs(kernels, n, t, h, d, torch.bfloat16, True, dev, rng)
    errs = bwd_errors(kernels, args, True)
    ms = {"flash_attn_bwd_dq": time_ms(
              lambda: kernels.flash_attention_dq(*args, causal=True), 20, 3, flush),
          "flash_attn_bwd_dkv": time_ms(
              lambda: kernels.flash_attention_dkv(*args, causal=True), 20, 3, flush)}
    # the plain version computes dq, dk and dv together
    plain_ms = time_ms(lambda: kernels.reference_attention_bwd(*args, causal=True), 5, 1, flush)
    q, k, v, do = args[:4]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                         20, 3, flush)
    pairs = t * (t + 1)  # twice the live (q, k) pairs under the causal mask
    esize = q.element_size()
    work = {  # flops, bytes: each input read once, each output written once
        "flash_attn_bwd_dq": (3.0 * n * h * d * pairs, 5 * n * t * h * d * esize + 8 * n * h * t),
        "flash_attn_bwd_dkv": (4.0 * n * h * d * pairs, 6 * n * t * h * d * esize + 8 * n * h * t),
    }
    entries = []
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        entries.append({
            "name": name, "route": "cuda", "source": "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % (
                295 if name.endswith("dq") else 316),
            "launches": launches[name], "max_abs_err": errs[name]["max_abs_err"],
            "rel_err": errs[name]["rel_err"], "ms": ms[name], "kernel_ms": ms[name],
            "plain_ms": plain_ms, "plain_computes": "dq, dk, dv",
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "library_computes": "scaled_dot_product_attention backward: dq, dk, dv",
            "n": n, "T": t, "H": h, "D": d, "dtype": "bfloat16", "causal": True,
            "flops": flops, "bytes": nbytes,
        })
        log("  %s %s" % (name, json.dumps(entries[-1])))
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.examples import train_transformer_lm as trainer
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.serving import GenerationEngine

    # f32 products stay f32 (no TF32) in the plain versions and the f32 model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))

    results = {"card": card, "build_s": phase_build(_build)}
    results["kernel_checks"] = phase_kernel_checks(kernels, dev)
    results["bwd_kernel_checks"] = phase_bwd_checks(kernels, dev)
    results["serving_f32_err"] = phase_serving_f32(tfm, kernels, dev)
    results["training_f32"] = phase_train_f32(tfm, trainer, kernels, dev)
    results["serving_bf16"] = phase_serving_bf16(tfm, kernels, telemetry, GenerationEngine, dev)
    results["training_bf16"] = phase_train_bf16(trainer, kernels, dev)
    train_launches = results["training_bf16"]["launches"]
    fwd = phase_kernel_times(kernels, dev, results["serving_bf16"]["flash_launches"])
    # the forward kernel runs on both main paths
    fwd[0]["launches_by_path"] = {"serving": fwd[0]["launches"],
                                  "training": train_launches["flash_attn_fwd"]}
    fwd[0]["launches"] += train_launches["flash_attn_fwd"]
    kernel_line = {"kernels": fwd + phase_bwd_times(kernels, dev, train_launches),
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
