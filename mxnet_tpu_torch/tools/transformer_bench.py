"""Transformer-LM training rate of the PyTorch port on one CUDA card
(counterpart of ``benchmarks/transformer_bench.py``).

    python -m mxnet_tpu_torch.tools.transformer_bench [--out r.json] [--trace t.json]
    TLM_SMOKE=1 python -m mxnet_tpu_torch.tools.transformer_bench --cpu

The JAX bench's workload and knobs: ``TLM_BATCH`` (8), ``TLM_SEQ`` (2048
tokens, so T = 2047 after the shift), ``TLM_LAYERS`` (12), ``TLM_DMODEL``
(1024), ``TLM_SCAN_K`` (8), ``TLM_REPS`` (3); heads = d_model // 64,
d_ff = 4 * d_model, vocab 32000; ``TLM_SMOKE=1`` shrinks all of them.
Random tokens from ``RandomState(0)``; one step is the forward in bf16
compute over f32 master parameters, the mean NLL of an f32 log-softmax,
``loss.backward()`` and SGD at lr 1e-4. One difference: the JAX bench
casts every parameter to bf16 for the step, the LM head's table included;
here the head multiplies against the f32 table, as ``apply_fn`` does
with f32 masters (the same f32 matmul, the table unrounded).

In place of the JAX bench's K-step ``lax.scan``, each rep runs K eager
steps and synchronises; ``step_ms`` is the host clock over REPS x K steps
after one warm-up step. There is no compiled graph to ask for a cost, so
the step's FLOPs are counted from the shapes (:func:`step_flops`): model
FLOPs, forward times three, causal attention counted over its live
(q, k) pairs. ``peak_share`` is that rate over the H100 SXM's dense bf16
rate, 989 TFLOP/s, printed beside the card's name and power limit.

``--trace`` also profiles two more steps with ``torch.profiler``, each
phase (``tlm.forward``, ``tlm.loss``, ``tlm.backward``, ``tlm.sgd``) in a
``record_function`` range and followed by a synchronise so phases do not
overlap on the device, and writes where the device time goes: per phase,
per kernel family (the f32 split pass, the three flash kernels, f32
GEMMs, other GEMMs, the rest) and the idle share. The synchronises add idle time that the
unprofiled steps do not have.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..examples.train_transformer_lm import lm_loss, sgd_step
from ..models.transformer import params_from_jax, transformer_lm
from . import trace_serving

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
LR = 1e-4
PHASES = ("tlm.forward", "tlm.loss", "tlm.backward", "tlm.sgd")
KERNEL_FAMILIES = (
    # the Hopper kernels (flash_*_sm90, bf16 and split f32) and the f32 split pass
    ("flash_split", ("flash_split",)),
    ("flash_attn_fwd", ("flash_fwd_",)),
    ("flash_attn_bwd_dq", ("flash_dq_",)),
    ("flash_attn_bwd_dkv", ("flash_dkv_",)),
    # the LM head's f32 GEMMs (TF32 off) run on cuBLAS's SIMT/FFMA kernels
    ("gemm_f32", ("sgemm", "f32f32")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
)


def config():
    smoke = os.environ.get("TLM_SMOKE") == "1"
    d_model = int(os.environ.get("TLM_DMODEL", "128" if smoke else "1024"))
    return {
        "batch": int(os.environ.get("TLM_BATCH", "2" if smoke else "8")),
        "seq": int(os.environ.get("TLM_SEQ", "128" if smoke else "2048")),
        "n_layers": int(os.environ.get("TLM_LAYERS", "2" if smoke else "12")),
        "d_model": d_model, "n_heads": max(d_model // 64, 1), "d_ff": 4 * d_model,
        "vocab": 1000 if smoke else 32000,
        "scan_k": int(os.environ.get("TLM_SCAN_K", "2" if smoke else "8")),
        "reps": int(os.environ.get("TLM_REPS", "1" if smoke else "3")),
    }


def step_flops(batch, t, d_model, n_layers, d_ff, vocab):
    """Model FLOPs of one training step over ``batch`` sequences of ``t``
    tokens: 3 x forward (the backward's two matmuls per forward matmul),
    where the forward is, per layer, 2·N·(4·d² + 2·d·d_ff) for the
    projections and 2·batch·d·t(t+1) for causal attention (4·d_head flops
    for each of the t(t+1)/2 live pairs of each head), plus 2·N·d·vocab for
    the LM head, N = batch·t. The flash backward's recomputation of the
    scores is not counted."""
    n = batch * t
    proj = 2 * n * (4 * d_model ** 2 + 2 * d_model * d_ff)
    attn = 2 * batch * d_model * t * (t + 1)
    return 3.0 * (n_layers * (proj + attn) + 2 * n * d_model * vocab)


def family(name):
    for fam, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def setup(cfg, dev):
    init_fn, apply_fn = transformer_lm(
        vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], dtype=torch.bfloat16)
    params = params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    params.requires_grad_()
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))).to(dev)
    return apply_fn, params, toks[:, :-1], toks[:, 1:]


def trace_steps(apply_fn, params, tokens, targets, dev, steps=2):
    """Profile ``steps`` steps phase by phase on the card; see the module
    docstring."""
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            with torch.profiler.record_function(PHASES[0]):
                logits = apply_fn(params, tokens)
                sync()
            with torch.profiler.record_function(PHASES[1]):
                loss = lm_loss(logits, targets)
                sync()
            with torch.profiler.record_function(PHASES[2]):
                loss.backward()
                sync()
            with torch.profiler.record_function(PHASES[3]):
                sgd_step(params, LR)
                sync()
            del logits, loss
    events = prof.events()
    summary = trace_serving.summarize(events, ranges=PHASES)
    cuda = torch.autograd.DeviceType.CUDA
    fams = {}
    for e in events:
        if e.device_type == cuda and e.name not in PHASES:
            f = fams.setdefault(family(e.name), {"device_ms": 0.0, "count": 0})
            f["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3 / steps
            f["count"] += 1 / steps
    summary["families_per_step"] = fams
    summary["steps"] = steps
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host (smoke only)")
    ap.add_argument("--out", help="write the result JSON here")
    ap.add_argument("--trace", help="also profile two steps; write the breakdown here")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("transformer_bench: no CUDA device visible (--cpu runs on the host)",
              file=sys.stderr)
        return 1
    if args.cpu and args.trace:
        ap.error("--trace reads device time; it needs the card")
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg = config()
    t = cfg["seq"] - 1
    apply_fn, params, tokens, targets = setup(cfg, dev)

    def step():
        loss = lm_loss(apply_fn(params, tokens), targets)
        loss.backward()
        sgd_step(params, LR)
        return loss.detach()

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    first = float(step())  # builds the kernels, warms the allocator
    k, reps = cfg["scan_k"], cfg["reps"]
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(k):
            loss = step()
        sync()
    dt = time.perf_counter() - t0
    step_ms = 1e3 * dt / (reps * k)
    flops = step_flops(cfg["batch"], t, cfg["d_model"], cfg["n_layers"], cfg["d_ff"],
                       cfg["vocab"])
    out = {
        "model": "transformer_lm d%d L%d heads%d d_ff%d vocab%d" % (
            cfg["d_model"], cfg["n_layers"], cfg["n_heads"], cfg["d_ff"], cfg["vocab"]),
        "batch": cfg["batch"], "seq": cfg["seq"], "T": t, "steps_per_rep": k, "reps": reps,
        "compute_dtype": "bfloat16", "param_dtype": "float32",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": trace_serving.card_line() if cuda else None,
        "first_loss": first, "last_loss": float(loss),
        "step_ms": step_ms,
        "tokens_per_sec": cfg["batch"] * t * reps * k / dt,
        "tflops_per_step": flops / 1e12,
        "tflops_per_sec": flops / (step_ms / 1e3) / 1e12,
        # a share of the card's peak only for a card run
        "peak_share": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS if cuda else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
    }
    if not all(np.isfinite([out["first_loss"], out["last_loss"]])):
        raise RuntimeError("non-finite loss: %r" % out)
    if args.trace:
        summary = trace_steps(apply_fn, params, tokens, targets, dev)
        summary.update(card=out["card"], device=out["device"], model=out["model"])
        with open(args.trace, "w") as fh:
            json.dump(summary, fh, indent=1)
        out["trace"] = {key: summary[key] for key in
                        ("window_ms", "device_busy_ms", "device_idle_share", "calls",
                         "families_per_step")}
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
