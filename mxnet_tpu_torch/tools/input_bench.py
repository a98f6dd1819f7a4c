"""Input-pipeline throughput of the PyTorch port (counterpart of
``benchmarks/input_pipeline.py``): can the host decode path feed the card?

    python -m mxnet_tpu_torch.tools.input_bench [--images 512] [--cpu] [--out f.json]

Packs a synthetic .rec of ``--images`` smooth PNG images (``--side`` px,
from ``--seed``; written with the standard library's zlib, so no PIL is
needed), then measures ``ImageRecordIter``'s img/s on the host (batches
under ``cpu()``) for each ``--threads`` (the thread pool,
``preprocess_threads``) and each ``--workers`` (the streaming pipeline's
decode processes, ``input_workers``), and once more through
``DeviceFeedIter`` onto ``gpu(0)`` (the host with ``--cpu``) with the most
workers. Prints one JSON line; each rate is the best epoch after a warm
one.
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from .. import io, recordio
from .. import telemetry as _tm
from ..context import cpu, gpu


def png_bytes(img, filters=(1,), level=1):
    """An 8-bit PNG of ``img`` (HxW gray, HxWx3 RGB or HxWx4 RGBA uint8)
    whose row y uses filter type ``filters[y % len(filters)]`` (0 none,
    1 Sub, 2 Up, 3 Average, 4 Paeth), written with the standard library's
    zlib."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    preds = (np.zeros_like(x), a, b, (a + b) // 2, paeth)
    filt = np.asarray(filters)[np.arange(h) % len(filters)]
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = filt
    for k, pred in enumerate(preds):
        sel = filt == k
        rows[sel, 1:] = ((x[sel] - pred[sel]) % 256).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def pack_rec(root, n, side, seed=0):
    """A .rec / .idx pair of ``n`` smooth side x side images, labels 0-999."""
    rng = np.random.RandomState(seed)
    rec, idx = os.path.join(root, "bench.rec"), os.path.join(root, "bench.idx")
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        f = rng.uniform(0.5, 3.0, (3, 2))
        img = np.stack([127.5 + 100 * np.sin(2 * np.pi * (a * xx + b * yy)) for a, b in f], -1)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(rng.randint(1000)), i, 0),
                                     png_bytes(img.astype(np.uint8))))
    w.close()
    return rec, idx


def measure(make_iter, feed_device=None, epochs=2):
    """img/s of the best of ``epochs`` timed epochs after a warm one (file
    opens, worker spawn, first decode); batches on the host, or staged on
    ``feed_device`` through DeviceFeedIter."""
    with cpu():
        it = make_iter()
        src = io.DeviceFeedIter(it, feed_device) if feed_device is not None else it
        best = 0.0
        for epoch in range(epochs + 1):
            t0 = time.perf_counter()  # a reset stages the first batches: it counts
            if epoch:
                src.reset()
            n = 0
            for batch in src:
                n += batch.data[0].shape[0] - (batch.pad or 0)
            if feed_device is not None and feed_device.device_type == "gpu":
                import torch

                torch.cuda.synchronize()
            if epoch:
                best = max(best, n / (time.perf_counter() - t0))
        if hasattr(it, "close"):
            it.close()
    return best


def run(images=512, side=320, crop=224, batch_size=32, threads=(1, 4, 8), workers=(2, 4),
        device=None, seed=0):
    out = {"images": images, "side": side, "crop": crop, "batch_size": batch_size,
           "host_cores": os.cpu_count(), "rows": []}
    was = _tm.enabled()
    _tm.enable()
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            rec, idx = pack_rec(root, images, side, seed)
            out["pack_s"] = time.perf_counter() - t0
            kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=batch_size,
                      data_shape=(3, crop, crop), rand_crop=True, rand_mirror=True,
                      mean_r=123.68, mean_g=116.779, mean_b=103.939)
            for t in threads:
                out["rows"].append({"mode": "threads", "threads": t, "img_per_s": measure(
                    lambda: io.ImageRecordIter(preprocess_threads=t, input_workers=0, **kw))})
            for w in workers:
                out["rows"].append({"mode": "process", "workers": w, "img_per_s": measure(
                    lambda: io.ImageRecordIter(input_workers=w, **kw))})
            if device is not None and workers:
                w = max(workers)
                out["rows"].append({"mode": "process+feed", "workers": w, "device": str(device),
                                    "img_per_s": measure(
                                        lambda: io.ImageRecordIter(input_workers=w, **kw),
                                        feed_device=device)})
        snap = _tm.snapshot()
        out["decode_seconds"] = snap.get("io.decode_seconds")
    finally:
        if not was:
            _tm.disable()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--side", type=int, default=320)
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--threads", default="1,4,8")
    p.add_argument("--workers", default="2,4")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="feed the host instead of gpu(0)")
    p.add_argument("--out", help="also write the result to this JSON file")
    args = p.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(",") if x)  # noqa: E731
    device = cpu() if args.cpu else gpu(0)
    device.torch_device  # noqa: B018  (raises without a card)
    out = run(args.images, args.side, args.crop, args.batch_size, ints(args.threads),
              ints(args.workers), device, args.seed)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
