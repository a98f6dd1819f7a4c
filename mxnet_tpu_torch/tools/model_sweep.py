"""Per-model training rate of the PyTorch port on one CUDA card (counterpart
of ``benchmarks/model_sweep.py``): the reference's per-model table.

    python -m mxnet_tpu_torch.tools.model_sweep [--models inception-v3,alexnet]
        [--steps 10] [--out rows.json] [--trace t.json]
    python -m mxnet_tpu_torch.tools.model_sweep --cpu --smoke

``MODELS`` is the JAX sweep's table: inception-bn, resnet-18/34/101/152 and
inception-v3 at batch 32, alexnet at batch 512 (its per-GPU batch in the
reference's scaling table), each at its image size, with the K80 img/s the
reference's README publishes for it. Every model runs two rows, f32 and
bf16. The step is the sweep's, which is ``bench.py``'s: the sum of the
SoftmaxOutput outputs as the loss, g = grad/batch + wd·p, m = 0.9·m − lr·g,
p += m with lr 0.1 and wd 1e-4, over f32 parameters; the bf16 row casts the
parameters and the data to bf16 inside the step. The weights are the
sweep's numpy init (``models/common.init_params``: gammas 1, betas and
biases 0, He-normal from ``RandomState(0)``), the data one random batch.
Models with Dropout (alexnet) draw its masks from one seeded generator on
the card. The step, its timing, FLOP count and ``--trace`` profile are
``tools/resnet_bench.py``'s, run eagerly; the JAX sweep's ``lax.scan`` of K
steps a dispatch has no counterpart here.

On the card every in-envelope convolution's gradient runs K2/K3: a row
checks that each launched once a step per such convolution (the port's
``conv_bwd_plan`` over ``conv_layers``) and reports img/s, step ms, model
TFLOP/s, peak memory and the launches; the f32 row's ``vs_k80`` divides
its img/s by the K80 figure (``k80_img_s``), which is the reference's
number on its own card, not this one's. f32 runs without TF32. A row that
runs out of device memory is reported as such. It writes only to
``--out`` and ``--trace``. ``--cpu --smoke`` runs the first model (or
``--models``) at the JAX sweep's smoke size (batch 2; 64 x 64, inception-v3
128, alexnet 224) on the host; it measures nothing of the card. Without
``--cpu`` and without a card it raises.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np
import torch

from ..executor import _GraphProgram
from ..models.common import conv_layers, init_params, params_from_numpy
from ..ops import kernels
from . import resnet_bench, trace_serving

# name -> ((model module, get_symbol kwargs), image side, batch, the reference's
# K80 img/s: its README's batch-32 rows and alexnet's 1-GPU row at batch 512)
MODELS = {
    "inception-bn": (("inception_bn", {}), 224, 32, 152.0),
    "resnet-18": (("resnet", {"num_layers": 18}), 224, 32, 185.0),
    "resnet-34": (("resnet", {"num_layers": 34}), 224, 32, 172.0),
    "resnet-101": (("resnet", {"num_layers": 101}), 224, 32, 78.0),
    "resnet-152": (("resnet", {"num_layers": 152}), 224, 32, 57.0),
    "inception-v3": (("inception_v3", {}), 299, 32, 30.4),
    "alexnet": (("alexnet", {}), 224, 512, 457.07),
}
DTYPES = ("float32", "bfloat16")
SMOKE_BATCH = 2
# the smallest side each stem takes in the JAX sweep's smoke run
SMOKE_SIDE = {"inception_v3": 128, "alexnet": 224}


def build_symbol(module, kwargs, side, num_classes=1000):
    """``models.<module>.get_symbol`` at ``side`` x ``side`` images."""
    mod = importlib.import_module("mxnet_tpu_torch.models." + module)
    if "image_shape" in mod.get_symbol.__code__.co_varnames:
        kwargs = dict(kwargs, image_shape="3,%d,%d" % (side, side))
    return mod.get_symbol(num_classes=num_classes, **kwargs)


def in_envelope_convs(symbol, data_shape, dtype):
    """The convolutions of ``symbol`` whose gradients K2/K3 take."""
    return sum(bool(kernels.conv_bwd_plan(c["data"], c["weight"], c["stride"], c["pad"],
                                          c["dilate"], dtype))
               for c in conv_layers(symbol, data_shape))


def build_step(module, kwargs, side, batch, bf16, dev, seed=0, lr=resnet_bench.LR):
    """The sweep's step over ``models.<module>`` at ``batch`` x 3 x ``side``
    x ``side`` and learning rate ``lr``: ``(step, (params, moms, aux),
    data, label, symbol)`` as ``resnet_bench.build_step`` returns them."""
    symbol = build_symbol(module, kwargs, side)
    data_shape = (batch, 3, side, side)
    arg_np, aux_np = init_params(symbol, data_shape, seed)
    params, aux = params_from_numpy(arg_np, aux_np, dev, torch.float32)
    for p in params.values():
        p.requires_grad_()
    moms = {n: torch.zeros_like(p, requires_grad=False) for n, p in params.items()}
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.rand(*data_shape).astype(np.float32)).to(dev)
    label = torch.from_numpy(rng.randint(0, 1000, batch).astype(np.float32)).to(dev)
    program = _GraphProgram(symbol)
    gen = torch.Generator(device=dev).manual_seed(seed) if program.needs_rng else None
    step = resnet_bench.make_train_step(program, batch, bf16, gen, lr)
    return step, (params, moms, aux), data, label, symbol


def run_row(name, dtype, steps, dev, model=None, trace=False, smoke=False,
            lr=resnet_bench.LR):
    """One row of model ``name`` (``MODELS``, or ``model`` = ((module,
    kwargs), side, batch, k80 img/s or None)) in ``dtype``: the sweep's
    step (at learning rate ``lr``) measured by ``resnet_bench.measure``,
    K2/K3 launches checked on the card."""
    (module, kwargs), side, batch, k80 = model or MODELS[name]
    if smoke:
        batch, side = SMOKE_BATCH, SMOKE_SIDE.get(module, 64)
    resnet_bench.reset_peak_memory(dev)
    step, state, data, label, symbol = build_step(module, kwargs, side, batch,
                                                  dtype == "bfloat16", dev, lr=lr)
    convs = in_envelope_convs(symbol, tuple(data.shape), dtype)
    row = {"model": name, "dtype": dtype, "batch": batch, "image_side": side, "lr": lr,
           "in_envelope_convs": convs}
    row.update(resnet_bench.measure(step, state, data, label, symbol, steps, dev, trace))
    if dev.type == "cuda":
        launched = (row["conv_bwd_filter_per_step"], row["conv_bwd_input_per_step"])
        if launched != (convs, convs):
            raise RuntimeError("%s %s: K2/K3 launched %s times a step, not once for each of "
                               "its %d in-envelope convolutions" % (name, dtype, launched, convs))
    if k80 and dtype == "float32" and not smoke:
        row["k80_img_s"] = k80
        row["vs_k80"] = row["img_per_sec"] / k80
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", help="comma-separated names of MODELS (default: all)")
    ap.add_argument("--steps", type=int, default=10, help="timed steps a row")
    ap.add_argument("--cpu", action="store_true", help="run on the host (with --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="batch 2 at the JAX sweep's smoke sizes, the first model only")
    ap.add_argument("--out", help="write the result JSON here")
    ap.add_argument("--trace", help="also profile two steps a row; write the breakdown here")
    args = ap.parse_args(argv)
    if args.cpu and args.trace:
        ap.error("--trace reads device time; it needs the card")
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("model_sweep: no CUDA device visible (--cpu --smoke runs on the host)")
    names = [n.strip() for n in args.models.split(",")] if args.models else list(MODELS)
    unknown = sorted(set(names) - set(MODELS))
    if unknown:
        ap.error("unknown models %s (known: %s)" % (unknown, ", ".join(MODELS)))
    if args.smoke and not args.models:
        names = names[:1]
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    # f32 computes in full f32, as the JAX package does
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": trace_serving.card_line() if cuda else None,
        "tf32": False, "torch": torch.__version__, "smoke": args.smoke, "rows": [],
    }
    for name in names:
        for dtype in DTYPES:
            try:
                row = run_row(name, dtype, args.steps, dev, trace=bool(args.trace),
                              smoke=args.smoke)
            except torch.cuda.OutOfMemoryError as e:
                row = {"model": name, "dtype": dtype, "out_of_memory": str(e).splitlines()[0]}
            res["rows"].append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "trace"}), flush=True)
    if args.trace:
        with open(args.trace, "w") as fh:
            json.dump(res, fh, indent=1)
    text = json.dumps({**res, "rows": [{k: v for k, v in r.items() if k != "trace"}
                                       for r in res["rows"]]})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
