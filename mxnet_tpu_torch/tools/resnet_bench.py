"""ResNet-50 training rate of the PyTorch port on one CUDA card (counterpart
of ``bench.py``'s ``_build_resnet50_step`` and ``run_resnet50``).

    python -m mxnet_tpu_torch.tools.resnet_bench [--rows float32-32,bfloat16-32,bfloat16-256]
        [--steps 10] [--out r.json] [--trace t.json]
    python -m mxnet_tpu_torch.tools.resnet_bench --cpu --smoke

The step is the JAX bench's: ``models/resnet.get_symbol`` (ResNet-50,
1000 classes, 3x224x224) run by ``executor._GraphProgram`` in training
mode; the loss is the sum of the SoftmaxOutput outputs (whose backward
ignores the head gradient, so the gradient is softmax − onehot); the
gradients of every argument come from ``torch.autograd.grad``; then the
inline SGD-momentum update g = grad/batch + wd·p, m = 0.9·m − lr·g,
p += m with lr 0.1 and wd 1e-4, applied in place to the f32 parameters
and momenta. The bf16 recipe casts the parameters and the data to bf16
inside the step; the aux states and the masters stay f32. The weights are
``init_params``'s (the JAX bench's numpy init from ``RandomState(0)``),
and the data one fixed random batch from ``RandomState(1)``, as
``run_resnet50`` makes it.

On CUDA every in-envelope convolution's gradient runs the conv-backward
kernels K2/K3 (46 of ResNet-50's 53 convolutions); the launches per step
are reported. f32 convolutions run without TF32
(``torch.backends.cudnn.allow_tf32 = False``) and f32 matmuls in full
f32, so the f32 row computes what the JAX package computes.

A row is ``<dtype>-<batch>``. Each runs one warm-up step, then ``--steps``
steps timed on the host clock and ending in a synchronise: img/s, step ms,
model TFLOP/s (3 × the forward's convolution and FullyConnected FLOPs,
counted from the shapes) and peak memory. A row that runs out of device
memory is reported as such. The bench's tunnel, memo, ``lax.scan`` and
compile-cache machinery has no counterpart here.

``--trace`` profiles two more steps of each row with ``torch.profiler``,
the phases (``rn.forward``, ``rn.backward``, ``rn.update``) each followed
by a synchronise, and writes the device time per phase and per kernel
family (K2, K3, their bf16 layout transposes, cuDNN convolutions, GEMMs,
reductions, elementwise, the rest) and the idle share. ``--cpu --smoke``
runs a cifar ResNet-8 on the host to check the control flow; it measures
nothing of the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from ..executor import _GraphProgram
from ..models.resnet import conv_layers, get_symbol, init_params, params_from_numpy
from ..ops import kernels
from . import trace_serving

LR, MOMENTUM, WD = 0.1, 0.9, 1e-4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PHASES = ("rn.forward", "rn.backward", "rn.update")
KERNEL_FAMILIES = (
    # conv_wgrad_kernel (f32), conv_wgrad_sm90 (bf16), conv_wgrad_reduce_kernel
    ("conv_bwd_filter", ("conv_wgrad_",)),
    # conv_dgrad_kernel (f32), conv_dgrad_sm90 (bf16)
    ("conv_bwd_input", ("conv_dgrad_",)),
    # the bf16 kernels' channels-last copies of x (K2), w (K3) and the
    # gradient both read
    ("conv_layout", ("transpose_bf16",)),
    ("cudnn_conv_bwd", ("dgrad", "wgrad")),
    ("cudnn_conv_fwd", ("fprop", "conv", "implicit", "cudnn")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)
FULL = dict(num_layers=50, num_classes=1000, image_shape=(3, 224, 224))
SMOKE = dict(num_layers=8, num_classes=10, image_shape=(3, 28, 28))


def model_flops(symbol, data_shape):
    """Forward FLOPs of the convolutions and FullyConnected layers of
    ``symbol`` at ``data_shape``."""
    flops = sum(layer["flops"] for layer in conv_layers(symbol, data_shape))
    arg_shapes = dict(zip(symbol.list_arguments(), symbol.infer_shape(
        data=tuple(data_shape), softmax_label=(data_shape[0],))[0]))
    for name, shape in arg_shapes.items():
        if name.endswith("_weight") and len(shape) == 2:  # FullyConnected
            flops += 2.0 * data_shape[0] * shape[0] * shape[1]
    return flops


def cross_entropy(prob, label):
    """Mean −log of the probability of each row's label, in f32."""
    picked = prob.float().gather(1, label.long().unsqueeze(1)).squeeze(1)
    return -torch.log(picked.clamp_min(1e-30)).mean()


def build_step(batch, bf16, device, num_layers=50, num_classes=1000,
               image_shape=(3, 224, 224), seed=0):
    """Step, state and batch of one row. Returns ``(step, state, data,
    label, symbol)``: ``state`` is ``(params, moms, aux)``, name -> tensor
    on ``device`` (params f32 leaves that require grad); ``step(params,
    moms, aux, data, label, span=None)`` updates params and moms in place
    and returns ``(new_aux, prob)``. ``span(name)`` may wrap each phase."""
    symbol = get_symbol(num_classes=num_classes, num_layers=num_layers,
                        image_shape=",".join(str(d) for d in image_shape))
    data_shape = (batch,) + tuple(image_shape)
    arg_np, aux_np = init_params(symbol, data_shape, seed)
    params, aux = params_from_numpy(arg_np, aux_np, device, torch.float32)
    for p in params.values():
        p.requires_grad_()
    moms = {n: torch.zeros_like(p, requires_grad=False) for n, p in params.items()}
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.rand(*data_shape).astype(np.float32)).to(device)
    label = torch.from_numpy(rng.randint(0, num_classes, batch).astype(np.float32)).to(device)
    step = make_train_step(_GraphProgram(symbol), batch, bf16)
    return step, (params, moms, aux), data, label, symbol


def make_train_step(program, batch, bf16):
    """The training step of ``bench.py:836-857`` over ``program``; see the
    module docstring."""
    rescale = 1.0 / batch

    def step(params, moms, aux, data, label, span=None):
        span = span or (lambda name: contextlib.nullcontext())
        names = list(params)
        with span(PHASES[0]):
            args = {n: (p.to(torch.bfloat16) if bf16 else p) for n, p in params.items()}
            args["data"] = data.to(torch.bfloat16) if bf16 else data
            args["softmax_label"] = label
            outs, new_aux = program(args, aux, None, True)
            loss = outs[0].float().sum()
        with span(PHASES[1]):
            grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        with span(PHASES[2]), torch.no_grad():
            for n, g in zip(names, grads):
                p = params[n]
                if g is None:  # a fix_gamma gamma: its gradient is zero
                    g = torch.zeros_like(p)
                g = g * rescale + WD * p
                moms[n].mul_(MOMENTUM).sub_(LR * g)
                p.add_(moms[n])
        return {n: v.detach() for n, v in new_aux.items()}, outs[0].detach()

    return step


def family(name):
    for fam, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def trace_steps(step, state, data, label, dev, steps=2):
    """Profile ``steps`` steps phase by phase on the card; see the module
    docstring. Returns the breakdown and the state after the steps."""
    params, moms, aux = state
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731

    @contextlib.contextmanager
    def span(name):
        with torch.profiler.record_function(name):
            yield
            sync()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            aux, _ = step(params, moms, aux, data, label, span=span)
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
    return summary, (params, moms, aux)


def run_row(dtype, batch, steps, dev, model, trace=False):
    """One row: warm-up, ``steps`` timed steps, optionally a trace."""
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    bf16 = dtype == "bfloat16"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step, (params, moms, aux), data, label, symbol = build_step(batch, bf16, dev, **model)
    flops = 3.0 * model_flops(symbol, data.shape)
    aux, prob = step(params, moms, aux, data, label)  # builds the kernels
    first = float(cross_entropy(prob, label))
    counts = (kernels.conv_bwd_filter.launches, kernels.conv_bwd_input.launches)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        aux, prob = step(params, moms, aux, data, label)
    sync()
    dt = time.perf_counter() - t0
    launched = (kernels.conv_bwd_filter.launches - counts[0],
                kernels.conv_bwd_input.launches - counts[1])
    step_ms = 1e3 * dt / steps
    out = {
        "row": "%s-%d" % (dtype, batch), "dtype": dtype, "batch": batch,
        "image_shape": list(data.shape[1:]), "num_layers": model["num_layers"],
        "steps": steps, "warmup": 1,
        "step_ms": step_ms, "img_per_sec": batch / (step_ms / 1e3),
        "tflops_per_step": flops / 1e12,
        "tflops_per_sec": flops / (step_ms / 1e3) / 1e12,
        "peak_share": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS if cuda else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        "first_loss": first, "last_loss": float(cross_entropy(prob, label)),
        "conv_bwd_filter_per_step": launched[0] / steps,
        "conv_bwd_input_per_step": launched[1] / steps,
    }
    if not all(np.isfinite([out["first_loss"], out["last_loss"]])):
        raise RuntimeError("non-finite loss: %r" % out)
    if trace:
        summary, _ = trace_steps(step, (params, moms, aux), data, label, dev)
        out["trace"] = summary
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="float32-32,bfloat16-32,bfloat16-256",
                    help="comma-separated <dtype>-<batch> rows")
    ap.add_argument("--steps", type=int, default=10, help="timed steps a row")
    ap.add_argument("--cpu", action="store_true", help="run on the host (with --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="cifar ResNet-8 at batch 4, 28x28, f32 and bf16 (ignores --rows)")
    ap.add_argument("--out", help="write the result JSON here")
    ap.add_argument("--trace", help="also profile two steps a row; write the breakdown here")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("resnet_bench: no CUDA device visible (--cpu runs on the host)", file=sys.stderr)
        return 1
    if args.cpu and args.trace:
        ap.error("--trace reads device time; it needs the card")
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    # the f32 rows compute in full f32, as the JAX package does
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = SMOKE if args.smoke else FULL
    rows = [r.rsplit("-", 1) for r in args.rows.split(",")]
    if args.smoke:
        rows = [("float32", "4"), ("bfloat16", "4")]
    res = {
        "model": "resnet-%d %s classes %d" % (model["num_layers"], model["image_shape"],
                                              model["num_classes"]),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": trace_serving.card_line() if cuda else None,
        "tf32": False, "torch": torch.__version__, "rows": [],
    }
    for dtype, batch in rows:
        try:
            row = run_row(dtype, int(batch), args.steps, dev, model, trace=bool(args.trace))
        except torch.cuda.OutOfMemoryError as e:
            row = {"row": "%s-%s" % (dtype, batch), "out_of_memory": str(e).splitlines()[0]}
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
