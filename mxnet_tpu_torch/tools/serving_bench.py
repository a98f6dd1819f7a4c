"""Serving-path benchmark of the PyTorch port: continuous batching vs
sequential dispatch (counterpart of ``benchmarks/serving_bench.py``).

Four legs, one JSON artifact:

- closed loop — saturation throughput: the request queue is pre-filled
  and the dispatcher drains it, batching OFF (max_batch=1: every request
  pays its own dispatch — sequential serving) vs batching ON (max_batch=8:
  coalesced into covering buckets). ``speedup`` is the best of 3 trials.
- open loop — Poisson arrivals at 0.4x the measured batched capacity
  (capped at 400 rps); achieved requests/s and client-observed p50/p99
  latency (queue wait included).
- decode — GenerationEngine tokens/s on a toy KV-cached transformer
  (slot-based continuous batching, greedy; on the card its decode step is
  one captured CUDA graph).
- quant — int8 weight-quantized predictor vs f32: top-1 agreement
  (parity gate >= 0.99) and the throughput ratio.

``steady_state_recompiles`` is the anatomy counter delta across every
serving leg after warm-up (on the card a recompile is a CUDA-graph
capture outside ``compile()``); ``steady_state_plan_misses`` counts every
dispatch signature first seen after warm-up. Both must be zero.

Run on the card:  python -m mxnet_tpu_torch.tools.serving_bench --out serve.json
On the host:      SERVE_SMOKE=1 python -m mxnet_tpu_torch.tools.serving_bench --cpu

The gates: zero steady-state recompiles and top-1 agreement >= 0.99, and
on the card a closed-loop speedup >= 3. On the host (``--cpu``) the
speedup is reported and not gated: the host is shared and its numbers say
nothing of the card.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np

from .. import telemetry as _tm
from ..serving.buckets import bucket_ladder as _ladder
from ..telemetry import anatomy as _anatomy


def _toy_predictor(ctx, in_dim=128, n_classes=10, quant=""):
    """The JAX bench's small MLP with the same deterministic weights."""
    import mxnet_tpu_torch.ndarray as nd
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.models import mlp

    sym = mlp.get_symbol(num_classes=n_classes, hidden=(32,))
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(1, in_dim))
    with cpu():
        params = {
            ("arg:%s" % n): nd.array((rng.randn(*s) * 0.1).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")
        }
    return predict.Predictor(sym.tojson(), params, {"data": (1, in_dim)},
                             ctx=ctx, quant=quant)


def _saturate(engine, xs, n_requests):
    """Saturation throughput: pre-fill the queue, drain, wait for all."""
    t0 = time.perf_counter()
    futs = [engine.submit(data=xs[i % len(xs)]) for i in range(n_requests)]
    for f in futs:
        f.result(120.0)
    return n_requests / (time.perf_counter() - t0)


def _closed_loop(predictor, n_requests, max_batch, in_dim, trials=3):
    """Batching OFF (max_batch=1) vs ON (coalesced to covering buckets),
    same saturated queue. Per-trial speedups; the headline is the best
    trial."""
    from ..serving import engine as _se
    from ..serving.engine import ServingEngine

    rng = np.random.RandomState(1)
    xs = rng.randn(max(64, n_requests // 4), in_dim).astype(np.float32)

    # reference: raw batch-1 dispatch loop, no engine in the way
    predictor.predict_batch(data=xs[:1])
    t0 = time.perf_counter()
    for i in range(n_requests):
        predictor.predict_batch(data=xs[i % len(xs):i % len(xs) + 1])
    raw_rps = n_requests / (time.perf_counter() - t0)

    rows = []
    occ_reqs = occ_pads = batches = 0
    for trial in range(trials):
        seq = ServingEngine(predictor, max_batch=1, batch_timeout_ms=2.0)
        seq.start()
        _saturate(seq, xs, 32)  # warm the dispatch loop
        r1 = _saturate(seq, xs, n_requests)
        seq.drain()
        bat = ServingEngine(predictor, max_batch=max_batch,
                            batch_timeout_ms=2.0)
        bat.start()
        _saturate(bat, xs, 32)
        reqs0 = _se._C_REQUESTS.value()
        pads0 = _se._C_PAD_ROWS.value()
        batches0 = _se._C_BATCHES.value()
        r8 = _saturate(bat, xs, n_requests)
        bat.drain()
        occ_reqs += _se._C_REQUESTS.value() - reqs0
        occ_pads += _se._C_PAD_ROWS.value() - pads0
        batches += _se._C_BATCHES.value() - batches0
        rows.append({"trial": trial, "sequential_rps": r1,
                     "batched_rps": r8, "speedup": r8 / r1})
    best = max(rows, key=lambda r: r["speedup"])
    occupancy = (occ_reqs / float(occ_reqs + occ_pads)
                 if (occ_reqs + occ_pads) else 0.0)
    return {
        "n_requests": n_requests,
        "raw_dispatch_rps": raw_rps,
        "sequential_rps": best["sequential_rps"],
        "batched_rps": best["batched_rps"],
        "speedup": best["speedup"],
        "trials": rows,
        "mean_batch_occupancy": occupancy,
        "batches": batches,
    }


def _open_loop(engine, xs, n_requests, rate_rps, rng):
    """Poisson arrivals at ``rate_rps`` of ``n_requests`` requests (the rows
    of ``xs`` in turn); client-observed latency. A collector thread waits on
    futures in submission order while the submitter paces arrivals."""
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    inflight = queue.Queue()
    lats = []

    def collector():
        while True:
            item = inflight.get()
            if item is None:
                return
            t0, req = item
            req.result(30.0)
            lats.append(time.perf_counter() - t0)

    coll = threading.Thread(target=collector)
    coll.start()
    t_start = time.perf_counter()
    for i in range(n_requests):
        time.sleep(gaps[i])
        inflight.put((time.perf_counter(), engine.submit(data=xs[i % len(xs)])))
    inflight.put(None)
    coll.join(120)
    wall = time.perf_counter() - t_start
    lats_ms = 1000.0 * np.asarray(lats)
    return {
        "n_requests": n_requests,
        "offered_rps": rate_rps,
        "achieved_rps": n_requests / wall,
        "latency_p50_ms": float(np.percentile(lats_ms, 50)),
        "latency_p99_ms": float(np.percentile(lats_ms, 99)),
    }


def _decode_leg(device, n_prompts, max_new):
    """GenerationEngine tokens/s on the JAX bench's toy KV-cached
    transformer."""
    from ..models import transformer as tfm
    from ..serving import decode as _sd
    from ..serving.decode import GenerationEngine

    dims = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    init_fn, _ = tfm.transformer_lm(**dims)
    params = tfm.params_from_jax(init_fn(0), device=device)
    model = tfm.transformer_lm_serving(max_len=32, **dims)
    gen = GenerationEngine(params, model, slots=4, max_len=32, device=device)
    gen.start()  # warms every (count x length) bucket, captures the step
    rng = np.random.RandomState(3)
    toks0 = _sd._C_TOKENS.value()
    t0 = time.perf_counter()
    futs = [gen.submit(rng.randint(1, 64, size=rng.randint(3, 12)),
                       max_new=max_new)
            for _ in range(n_prompts)]
    outs = [f.result(60.0) for f in futs]
    wall = time.perf_counter() - t0
    gen.drain()
    n_tokens = _sd._C_TOKENS.value() - toks0
    assert all(len(o) == max_new for o in outs)
    return {
        "n_prompts": n_prompts,
        "max_new": max_new,
        "tokens": n_tokens,
        "tokens_per_sec": n_tokens / wall,
        "slots": gen.slots,
        "decode_captures": gen.decode_stats["captures"],
    }


def _quant_leg(predictor, ctx, n_samples, in_dim):
    """int8 weight quantization: top-1 parity + throughput ratio."""
    from ..serving import quant as _q

    q_pred = _toy_predictor(ctx, in_dim=in_dim, quant="int8")
    rng = np.random.RandomState(4)
    xs = rng.randn(n_samples, in_dim).astype(np.float32)
    predictor.compile([{"data": (n_samples, in_dim)}])
    f32 = predictor.predict_batch(data=xs)[0]
    q_pred.compile([{"data": (n_samples, in_dim)}])
    i8 = q_pred.predict_batch(data=xs)[0]

    def rate(p):
        t0 = time.perf_counter()
        for i in range(n_samples):
            p.predict_batch(data=xs[i:i + 1])
        return n_samples / (time.perf_counter() - t0)

    q_pred.compile([{"data": (1, in_dim)}])
    q_pred.predict_batch(data=xs[:1])
    r_f32, r_i8 = rate(predictor), rate(q_pred)
    return {
        "n_samples": n_samples,
        "top1_agreement": float(_q.top1_agreement(f32, i8)),
        "int8_vs_f32_rps": r_i8 / r_f32,
    }


def _plan_misses():
    return _tm.REGISTRY.get("executor.dispatch_plan_misses").value()


def run_serving_bench(smoke=False, max_batch=8, in_dim=128, use_cpu=False):
    """All four legs. Telemetry is force-enabled: occupancy comes from the
    serve.* counters and the recompile gate from the anatomy one."""
    from ..context import cpu, gpu
    from ..serving.engine import ServingEngine

    _tm.enable()
    ctx = cpu() if use_cpu else gpu(0)
    device = ctx.torch_device
    n_closed = 128 if smoke else 384
    n_open = 64 if smoke else 240
    n_quant = 32 if smoke else 128
    predictor = _toy_predictor(ctx, in_dim=in_dim)
    # warm-up: every batch bucket and the quant leg's batch, exempt
    predictor.compile([{"data": (b, in_dim)} for b in _ladder(max_batch)]
                      + [{"data": (n_quant, in_dim)}])
    recompiles0 = _anatomy._C_RECOMPILES.value()
    misses0 = _plan_misses()

    closed = _closed_loop(predictor, n_closed, max_batch, in_dim,
                          trials=2 if smoke else 3)
    # open loop: a fresh engine, Poisson arrivals well under capacity so
    # p99 reflects batching delay, not unbounded backlog; the rate cap
    # keeps inter-arrival sleeps above time.sleep() resolution
    rate = min(400.0, max(20.0, 0.4 * closed["batched_rps"]))
    engine = ServingEngine(predictor, max_batch=max_batch,
                           batch_timeout_ms=2.0)
    engine.start()
    rng = np.random.RandomState(2)
    xs = rng.randn(n_open, in_dim).astype(np.float32)
    open_ = _open_loop(engine, xs, n_open, rate, rng)
    engine.drain()
    misses = _plan_misses() - misses0
    decode = _decode_leg(device, n_prompts=4 if smoke else 8,
                         max_new=4 if smoke else 8)
    quant = _quant_leg(predictor, ctx, n_quant, in_dim)

    return {
        "device": str(device),
        "max_batch": max_batch,
        "batch_timeout_ms": 2.0,
        "closed_loop": closed,
        "open_loop": open_,
        "decode": decode,
        "quant": quant,
        # zero post-warm-up recompiles across every leg above (mixed batch
        # buckets, prefill buckets, decode steps)
        "steady_state_recompiles":
            _anatomy._C_RECOMPILES.value() - recompiles0,
        # signatures first seen in the closed and open loops
        "steady_state_plan_misses": misses,
    }


def gates(out, on_card):
    """The bench's gates; the speedup only on the card."""
    g = {"steady_state_recompiles": out["steady_state_recompiles"] == 0,
         "steady_state_plan_misses": out["steady_state_plan_misses"] == 0,
         "top1_agreement": out["quant"]["top1_agreement"] >= 0.99}
    if on_card:
        g["speedup"] = out["closed_loop"]["speedup"] >= 3.0
    return g


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the JSON here")
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    args = ap.parse_args(argv)
    smoke = os.environ.get("SERVE_SMOKE") == "1"
    out = run_serving_bench(smoke=smoke, use_cpu=args.cpu)
    out["gates"] = gates(out, not args.cpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    ok = all(out["gates"].values())
    print(json.dumps({"gates_pass": ok}), file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
