"""A/B of the optimizer-slab kernel (K1) against variants of its own
source, in one process on one CUDA card.

    python3 slab_ab.py [--out r.json] [--rounds 3]

Each variant is a copy of ``mxnet_tpu_torch/csrc/slab_update.cu`` with some
text replaced (``VARIANTS``, below ``namespace {``), written to
``build/slab_ab/<name>/`` and built from there by
``mxnet_tpu_torch.tools.source_ab`` (one ``nvcc`` per variant, all started
together):

- ``as_built``: the source as it is (a thread takes two 4-element vectors of
  a 2048-element tile, 1024 elements apart; plain loads and stores);
- ``streaming``: the streaming hints ``__ldcs`` / ``__stcs`` on every load
  and store;
- ``one_vector``, ``four_vectors``: one or four vectors a thread (tiles of
  1024 or 4096 elements);
- ``adjacent_vectors``: a thread's two vectors side by side (elements 8t to
  8t+7 of the tile), so a warp's f32 accesses stride 32 bytes.

Each variant runs through the package's own wrapper
(``kernels.fused_slab_update_multi``, its library and tile size swapped
in). It is first held bit for bit to the plain version on a table of
ResNet-50's 16 AMP buckets and slabs of 1-7 elements at odd offsets; a
variant that fails stops the run. Then one step's update over the 16
buckets is timed in turns, the order forward and back, ``--rounds``
times, with ``chip_smoke.device_ms`` (L2 flushed, a sleep kernel queued
first): sgd_mom with a bf16 gradient (20 bytes an element) and adam (28),
in place. Prints the card's name and power limit, each variant's ptxas
registers, and the median ms and share of the bound of every timing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ANCHOR = "namespace {"
SOURCES = ("slab_update.cu",)
KERNELS = ("slab_update",)
VARIANTS = {
    "as_built": [],
    "streaming": [
        ("slab_update.cu", "return *reinterpret_cast<const float4*>(p);",
         "return __ldcs(reinterpret_cast<const float4*>(p));"),
        ("slab_update.cu", "*reinterpret_cast<float4*>(p) = v;",
         "__stcs(reinterpret_cast<float4*>(p), v);"),
        ("slab_update.cu", "const uint2 raw = *reinterpret_cast<const uint2*>(p);",
         "const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));"),
        ("slab_update.cu", "*reinterpret_cast<uint2*>(p) = raw;",
         "__stcs(reinterpret_cast<uint2*>(p), raw);")],
    "one_vector": [("slab_update.cu", "constexpr int kVecs = 2;", "constexpr int kVecs = 1;")],
    "four_vectors": [("slab_update.cu", "constexpr int kVecs = 2;", "constexpr int kVecs = 4;")],
    "adjacent_vectors": [("slab_update.cu", "tid * kVec;", "tid * kVecs * kVec;"),
                         ("slab_update.cu", "v * kStride", "v * kVec")],
}
TILE = {"one_vector": 1024, "four_vectors": 4096}  # elements a tile, where not 2048


class _Library:
    """Stands in for ``kernels._build``: hands the wrapper one variant's
    entry point."""

    def __init__(self, fn):
        self.fn = fn

    def load(self, name):
        return self.fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("slab_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.tools import source_ab

    card = chip_smoke.card_line()
    print("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))
    dirs = source_ab.write_variants(_build.BUILD_DIR.parent / "slab_ab", SOURCES, VARIANTS,
                                    ANCHOR)
    fns = source_ab.build_variants(dirs, KERNELS)
    regs = {name: chip_smoke.ptxas_lines(_build.library_path("slab_update", d).with_suffix(
        ".log").read_text()) for name, d in dirs.items()}
    for name, lines in regs.items():
        for label, line in sorted(lines.items()):
            print("  %s %s: %s" % (name, label, line))

    dev = torch.device("cuda", 0)
    plan = chip_smoke.resnet50_amp_plan(mx, resnet)
    gen = torch.Generator(device=dev).manual_seed(0)
    inv, fin = torch.full((), 1.0 / 128, device=dev), torch.ones((), device=dev)
    statics = chip_smoke.SLAB_STATICS

    def use(name):
        kernels._build = _Library(fns[name][0])
        kernels._SLAB_TILE = TILE.get(name, 2048)

    try:
        check = {kind: chip_smoke.slab_table(kernels, kind, torch.bfloat16, plan, dev, gen)
                 for kind in ("sgd_mom", "adam")}
        for name in VARIANTS:
            use(name)
            for kind, entries in check.items():
                got = kernels.fused_slab_update_multi(kind, entries, inv, fin, clip_gradient=0.05,
                                                      **statics)
                want = kernels.slab_update_multi_reference(kind, entries, inv, fin,
                                                           clip_gradient=0.05, **statics)
                for r, w in zip(got, want):
                    if not all(torch.equal(a, b) for a, b in zip(chip_smoke.slab_outputs(r),
                                                                  chip_smoke.slab_outputs(w))):
                        raise SystemExit("variant %s differs from the plain version (%s)"
                                         % (name, kind))
        del check
        steps, nbytes = {}, {"sgd_mom": 20, "adam": 28}
        elems = sum(b.padded for b in plan.buckets)
        for kind in nbytes:
            entries = [kernels.SlabEntry(e.w, e.g, e.states, e.lr, e.wd, (
                e.w, e.states, torch.empty_like(e.w, dtype=torch.bfloat16)))
                for e in chip_smoke.slab_table(kernels, kind, torch.bfloat16, plan, dev, gen)
                [:len(plan.buckets)]]
            steps[kind] = (lambda kind=kind, entries=entries: kernels.fused_slab_update_multi(
                kind, entries, inv, fin, clip_gradient=None, **statics))
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

        def time_variant(name):
            use(name)
            return {kind: chip_smoke.device_ms(fn, 10, 2, flush, sleep_cycles=10_000_000)
                    for kind, fn in steps.items()}

        ms, median = source_ab.in_turns(list(VARIANTS), args.rounds, time_variant)
    finally:
        kernels._build = _build
        kernels._SLAB_TILE = 2048
    bound = {kind: n * elems / chip_smoke.PEAK_BYTES * 1e3 for kind, n in nbytes.items()}
    for name, r in median.items():
        print("%-17s " % name + "  ".join(
            "%s %.4f ms (%.1f%% of bound %.4f)" % (k, t, 100 * bound[k] / t, bound[k])
            for k, t in r.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "elements": elems, "bound_ms": bound, "median_ms": median,
                       "ms": ms, "registers": regs}, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
