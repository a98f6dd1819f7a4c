"""A/B of the bf16 flash-attention kernels (K4f, K4dq, K4dkv) against
variants of their own sources, in one process on one CUDA card.

    python3 flash_ab.py [--out r.json] [--rounds 2]

Each variant is a copy of ``mxnet_tpu_torch/csrc/flash_sm90.cuh``,
``flash_attn_fwd.cu`` and ``flash_attn_bwd.cu`` with some text replaced
(``VARIANTS``), written to ``build/flash_ab/<name>/`` and built by the
package's own ``_build`` from there (``csrc=``: same flags, one ``nvcc``
per distinct library, all started together):

- ``as_built``: the sources as they are;
- ``mask_every_tile``: the keep-mask evaluated on every tile, not only on
  the tiles that straddle the causal diagonal or T (all three kernels);
- ``exp2f``: ``exp2f`` in place of the one-instruction ``ex2``;
- ``mask_every_tile_exp2f``: both of the above;
- ``no_cta_minimum``: the forward's registers left to the compiler, not
  capped so that five CTAs fit an SM at D <= 64;
- ``dkv_cta_minimum``: the dk/dv kernel's registers capped so that three
  CTAs fit an SM at D <= 64 (two at D = 128); as built it has no cap.

A replacement whose text is no longer in the sources stops the run before
anything is built. The variants' entry points are called directly on
contiguous operands; the package's wrappers are not touched.

Every variant is first held to the plain versions at D 16 to 128, T 5 to
2047, causal and not (forward 2e-2 absolute, dq, dk and dv 2e-2 of
max|plain|, a repeat bitwise); a variant that fails stops the run. Then
each is timed in turns, the order forward and back, ``--rounds`` times:
K4f at n=4 T=2048 and n=8 T=2047, K4dq and K4dkv at n=8 T=2047 (H 16,
D 64, bf16, causal), with
``chip_smoke.device_ms`` (L2 flushed and a ~0.5 ms sleep kernel queued
before each launch, so the CUDA events time the card, not the host's
enqueue); ``scaled_dot_product_attention`` at n=4 once as a yardstick.
Prints the card's name and power limit, each variant's ptxas registers,
and the median ms of every timing.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SOURCES = ("flash_sm90.cuh", "flash_attn_fwd.cu", "flash_attn_bwd.cu")
KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
# name: [(source file, old text, new text)]; every replacement must apply
_NO_VERSIONING = [("flash_attn_fwd.cu", "softmax_tile<false, D>", "softmax_tile<true, D>"),
                  ("flash_attn_bwd.cu", "ds_tile<false>", "ds_tile<true>"),
                  ("flash_attn_bwd.cu", "pt_tile<false>", "pt_tile<true>")]
_EXP2F = [("flash_attn_fwd.cu", "ex2(", "exp2f("), ("flash_attn_bwd.cu", "ex2(", "exp2f(")]
VARIANTS = {
    "as_built": [],
    "mask_every_tile": _NO_VERSIONING,
    "exp2f": _EXP2F,
    "mask_every_tile_exp2f": _NO_VERSIONING + _EXP2F,
    "no_cta_minimum": [("flash_attn_fwd.cu",
                        "__launch_bounds__(kThreads, D == 128 ? 3 : 5)\n    flash_fwd_sm90(",
                        "__launch_bounds__(kThreads)\n    flash_fwd_sm90(")],
    "dkv_cta_minimum": [("flash_attn_bwd.cu",
                         "__launch_bounds__(kThreads)\n    flash_dkv_sm90(",
                         "__launch_bounds__(kThreads, D == 128 ? 2 : 3)\n    flash_dkv_sm90(")],
}
CHECK_D = (16, 32, 64, 128)
CHECK_T = (5, 100, 2047)


def write_variants(csrc, root):
    """Write every variant's sources under ``root``; {name: directory}.
    Replacements apply to the kernels' code, below the first
    ``namespace sm90 {`` of each file."""
    shutil.rmtree(root, ignore_errors=True)
    dirs = {}
    for name, edits in VARIANTS.items():
        texts = {f: (csrc / f).read_text() for f in SOURCES}
        for f, old, new in edits:
            head, sep, body = texts[f].partition("namespace sm90 {")
            if old not in body:
                raise SystemExit("variant %s: %r not found in %s" % (name, old, f))
            texts[f] = head + sep + body.replace(old, new)
        dirs[name] = root / name
        dirs[name].mkdir(parents=True)
        for f, text in texts.items():
            (dirs[name] / f).write_text(text)
    return dirs


def launch(fn, q, k, v, *rest, causal, grads=1):
    """One launch of a variant's forward (``rest`` empty), dq (``rest`` =
    dO, lse, delta) or dk/dv entry point (the same, ``grads=2``) on
    contiguous [B, T, H, D] bf16 operands, with the wrappers' argument
    order; returns (o, lse), dq or (dk, dv)."""
    import torch

    b, t, h, d = q.shape
    outs = ((torch.empty_like(q), q.new_empty((b, h, t), dtype=torch.float32)) if not rest
            else tuple(torch.empty_like(q) for _ in range(grads)))
    n_ops = 3 if not rest else 4
    rc = fn(*(x.data_ptr() for x in (q, k, v, *rest, *outs)), b, t, h, d,
            *([t * h * d, h * d, d] * n_ops), d ** -0.5, int(causal), 1,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit("launch failed: CUDA error %d" % rc)
    return outs if not rest or grads == 2 else outs[0]


def rel_err(got, want):
    """max |got - want| / max |want| over the pairs."""
    return max((g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
               for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--rounds", type=int, default=2,
                    help="times each variant is timed, in turns forward and back")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke
    from mxnet_tpu_torch.ops import _build, kernels

    card = chip_smoke.card_line()
    print("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))
    dirs = write_variants(_build.CSRC, _build.BUILD_DIR.parent / "flash_ab")
    # one build per distinct library: variants that leave a source as it is share its library
    jobs = {}
    for d in dirs.values():
        for k in KERNELS:
            jobs.setdefault(_build.library_path(k, d), (k, d))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build([job[0]], job[1]), jobs.values()))
    regs = {name: {label: line for k in KERNELS for label, line in chip_smoke.ptxas_lines(
                       _build.library_path(k, d).with_suffix(".log").read_text()).items()
                   if "_sm90<" in label}
            for name, d in dirs.items()}
    for name, lines in regs.items():
        for label, line in sorted(lines.items()):
            print("  %s %s: %s" % (name, label, line))
    fns = {name: [_build.load(k, d) for k in KERNELS] for name, d in dirs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    cases = [(d, t, causal, [rnd(2, t, 3, d) for _ in range(4)])
             for d in CHECK_D for t in CHECK_T for causal in (True, False)]
    for name, (fwd, dq_fn, dkv_fn) in fns.items():
        worst = {"fwd_abs": 0.0, "dq_rel": 0.0, "dkv_rel": 0.0}
        for d, t, causal, (q, k, v, do) in cases:
            out, lse = launch(fwd, q, k, v, causal=causal)
            ref = kernels.reference_attention(q, k, v, causal=causal)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            bwd = (q, k, v, do, lse, delta)
            dq = launch(dq_fn, *bwd, causal=causal)
            dkv = launch(dkv_fn, *bwd, causal=causal, grads=2)
            want = kernels.reference_attention_bwd(*bwd, causal=causal)
            errs = {"fwd_abs": (out.float() - ref.float()).abs().max().item(),
                    "dq_rel": rel_err((dq,), want[:1]), "dkv_rel": rel_err(dkv, want[1:])}
            same = (torch.equal(out, launch(fwd, q, k, v, causal=causal)[0])
                    and torch.equal(dq, launch(dq_fn, *bwd, causal=causal))
                    and all(torch.equal(a, b) for a, b in zip(
                        dkv, launch(dkv_fn, *bwd, causal=causal, grads=2))))
            if not (max(errs.values()) <= 2e-2 and same):
                raise SystemExit("variant %s fails at D=%d T=%d causal=%s: %s, repeat bitwise %s"
                                 % (name, d, t, causal, json.dumps(errs), same))
            worst = {key: max(worst[key], errs[key]) for key in worst}
        print("check %s: ok over %d cases, worst %s" % (name, len(cases), json.dumps(worst)),
              flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    f4 = [rnd(4, 2048, 16, 64) for _ in range(3)]
    f8 = [rnd(8, 2047, 16, 64) for _ in range(4)]
    out8, lse8 = launch(fns["as_built"][0], *f8[:3], causal=True)
    delta8 = (f8[3].float() * out8.float()).sum(-1).transpose(1, 2).contiguous()
    bwd8 = (*f8, lse8, delta8)
    ms = {name: {"fwd_n4_T2048": [], "fwd_n8_T2047": [], "dq_n8_T2047": [], "dkv_n8_T2047": []}
          for name in fns}
    order = list(fns)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            fwd, dq_fn, dkv_fn = fns[name]
            for key, fn in (("fwd_n4_T2048", lambda: launch(fwd, *f4, causal=True)),
                            ("fwd_n8_T2047", lambda: launch(fwd, *f8[:3], causal=True)),
                            ("dq_n8_T2047", lambda: launch(dq_fn, *bwd8, causal=True)),
                            ("dkv_n8_T2047",
                             lambda: launch(dkv_fn, *bwd8, causal=True, grads=2))):
                ms[name][key].append(chip_smoke.device_ms(fn, 20, 3, flush))
    qt = [x.transpose(1, 2) for x in f4]
    sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(*qt, is_causal=True),
                                20, 3, flush)
    result = {"card": card, "sdpa_fwd_n4_T2048_ms": sdpa, "registers": regs,
              "ms": ms, "median_ms": {name: {key: statistics.median(v) for key, v in r.items()}
                                      for name, r in ms.items()}}
    for name, r in result["median_ms"].items():
        print("time %s: %s" % (name, json.dumps({k: round(v, 5) for k, v in r.items()})))
    print("time scaled_dot_product_attention fwd_n4_T2048: %.5f" % sdpa)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
