"""Memory mirroring on inception-v3 (counterpart of
``benchmarks/mirror_inception.py``): the reference fits inception-v3 at
batch 128 on a 12 GB card only with ``MXNET_BACKWARD_DO_MIRROR=1``
(example/image-classification/README.md), paying some img/s for it.

    python -m mxnet_tpu_torch.tools.mirror_inception [--batch 128] [--batches 32,64,128]
        [--variants plain,mirror,mirror_pool,mirror_pool_concat] [--steps 3] [--out f.json]
    python -m mxnet_tpu_torch.tools.mirror_inception --cpu --batch 2 --side 75 --steps 1

One training step is the Executor's: ``models/inception_v3`` (1000
classes, f32, 3×299×299) bound by ``simple_bind``, ``forward(is_train=
True)``, ``backward()`` and an SGD step (lr 0.01) in place. Each variant
binds anew, since the flag is read at bind:

- ``plain``: no mirror;
- ``mirror``: the flag, the default saved set (convolutions and products);
- ``mirror_pool``: also the pooling outputs (``reduce_window_max`` and
  ``reduce_window_sum`` in ``MXNET_MIRROR_SAVE``);
- ``mirror_pool_concat``: also the Concat outputs (``concatenate``).

Each prints one JSON line: the peak device memory of a step
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``)
and what the step added to the memory held before it (the activations and
recompute buffers), step ms (median of ``--steps`` steps after one
warm-up, host clock, each ending in a synchronise), img/s, and the card's
name and power limit. f32 convolutions and products run without TF32.
Parameters are He-normal from a seeded generator on the device, the
gammas one, the betas zero. ``--cpu`` runs on the host to check the
control flow; its numbers are no card's.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import time

import torch

from .trace_serving import card_line

_BASE_SAVE = "dot_general,conv_general_dilated"
VARIANTS = {
    "plain": (False, None),
    "mirror": (True, None),
    "mirror_pool": (True, _BASE_SAVE + ",reduce_window_max,reduce_window_sum"),
    "mirror_pool_concat": (True, _BASE_SAVE + ",reduce_window_max,reduce_window_sum,"
                           "concatenate"),
}
LR = 0.01


def set_variant(variant):
    """The env of one variant: ``MXNET_BACKWARD_DO_MIRROR`` and
    ``MXNET_MIRROR_SAVE``."""
    mirror, save = VARIANTS[variant]
    for key, value in (("MXNET_BACKWARD_DO_MIRROR", "1" if mirror else None),
                       ("MXNET_MIRROR_SAVE", save)):
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def fill(exe, seed=0):
    """He-normal weights, gammas one, betas and biases zero, moving
    variances one, from a seeded generator on the arrays' device; a random
    batch of images in [0, 1) and labels."""
    dev = exe.arg_arrays[0]._data.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, arr in exe.arg_dict.items():
            t = arr._data
            if name == "softmax_label":
                t.copy_(torch.randint(0, 1000, t.shape, generator=gen, device=dev))
            elif name == "data":
                t.copy_(torch.rand(t.shape, generator=gen, device=dev))
            elif name.endswith("_gamma"):
                t.fill_(1.0)
            elif name.endswith(("_beta", "_bias")):
                t.zero_()
            else:
                fan_in = max(1, math.prod(t.shape[1:]))
                t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                        * math.sqrt(2.0 / fan_in))
        for name, arr in exe.aux_dict.items():
            arr._data.fill_(1.0 if name.endswith("var") else 0.0)


def bind(mx, batch, side=299, ctx=None, symbol=None):
    """inception-v3 (or ``symbol``) bound for training at ``batch`` ×
    3×side×side under the current env, filled by :func:`fill`."""
    from ..models import inception_v3

    sym = symbol if symbol is not None else inception_v3.get_symbol(num_classes=1000)
    exe = sym.simple_bind(ctx or mx.gpu(0), data=(batch, 3, side, side),
                          softmax_label=(batch,))
    fill(exe)
    return exe


def params_and_grads(exe):
    names = [n for n, g in zip(exe._arg_names, exe.grad_arrays)
             if g is not None and n not in ("data", "softmax_label")]
    return ([exe.arg_dict[n]._data for n in names], [exe.grad_dict[n]._data for n in names])


def train_step(exe, update=True):
    """forward, backward and (with ``update``) the SGD step in place."""
    exe.forward(is_train=True)
    exe.backward()
    if update:
        params, grads = params_and_grads(exe)
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-LR)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(mx, batch, variant, steps=3, side=299, ctx=None):
    """One variant at ``batch``: see the module docstring. A variant that
    runs out of device memory is reported as such."""
    set_variant(variant)
    exe = None
    try:
        exe = bind(mx, batch, side, ctx)
        dev = exe.arg_arrays[0]._data.device
        train_step(exe)  # warm-up
        _sync(dev)
        cuda = dev.type == "cuda"
        held = torch.cuda.memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            train_step(exe)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(times)
        row = {"variant": variant, "batch": batch, "side": side,
               "mirror": exe._mirror, "save": os.environ.get("MXNET_MIRROR_SAVE"),
               "step_ms": ms, "step_ms_all": [1e3 * t for t in times], "img_per_s": batch / ms * 1e3,
               "device": str(dev)}
        if cuda:
            peak = torch.cuda.max_memory_allocated(dev)
            row.update(peak_bytes=peak, step_added_bytes=peak - held, held_bytes=held)
        return row
    except torch.cuda.OutOfMemoryError as exc:
        return {"variant": variant, "batch": batch, "side": side, "oom": str(exc)[:200]}
    finally:
        set_variant("plain")
        del exe
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=str, default=None,
                    help="comma-separated batches, each with every variant")
    ap.add_argument("--variants", type=str, default="plain,mirror")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--side", type=int, default=299)
    ap.add_argument("--cpu", action="store_true", help="run on the host (control flow only)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    import mxnet_tpu_torch as mx

    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        raise SystemExit("unknown variants: %s (known: %s)" % (unknown, sorted(VARIANTS)))
    batches = [int(b) for b in args.batches.split(",")] if args.batches else [args.batch]
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = None if args.cpu else card_line()
    rows = []
    with ctx:
        for batch in batches:
            for variant in variants:
                row = measure(mx, batch, variant, args.steps, args.side, ctx)
                row["card"] = card
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return rows


if __name__ == "__main__":
    main()
