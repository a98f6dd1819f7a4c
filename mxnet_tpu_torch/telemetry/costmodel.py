"""Device cost model of the port: FLOPs and bytes of a training step,
and roofline math against the card's peak rates (counterpart of
``mxnet_tpu/telemetry/costmodel.py``).

- :func:`analytic_forward_flops` walks the symbol graph and counts
  conv / FC MACs by hand — the classical "2*N*K*OH*OW*C/g*kh*kw" number
  papers quote MFU against, independent of what kernels run.
- :func:`analytic_op_costs` gives each node's forward FLOPs and unfused
  bytes; :func:`rank_kernel_candidates` ranks the memory-bound ones.
- :func:`analytic_step_cost` is one fused training step's cost: the
  forward's FLOPs three times over (forward + the two backward products)
  and its bytes three times over, plus the optimizer's traffic over the
  parameters. It takes the place of the JAX package's ``extract_cost``
  (XLA's ``cost_analysis()`` of the compiled program), which PyTorch has
  no counterpart of: the anatomy's cost capture counts with it, so
  measuring a step never runs one.

Peak rates are keyed by substrings of ``torch.cuda.get_device_name()``
and taken from NVIDIA's H100 data sheet (dense rates, i.e. the sparse
figures halved). The f32 entry is the card's FP32 rate outside the
tensor cores, because the port runs with TF32 off; bf16 is the dense
tensor-core rate. ``MXTPU_ANATOMY_PEAK_TFLOPS`` / ``MXTPU_ANATOMY_PEAK_GBPS``
override both for unlisted hardware and for deterministic CPU tests.
Stdlib-only at import.
"""
from __future__ import annotations

import os

# substring of torch.cuda.get_device_name() (lower case; first hit wins,
# so the NVL and PCIe parts come before the SXM part's plain "h100"):
# (dense bf16 TFLOP/s, FP32 TFLOP/s, HBM GB/s), per card
_KIND_PEAKS = (
    # NVIDIA H100 Tensor Core GPU data sheet, H100 NVL column (per card:
    # bf16 1,671 TFLOP/s with sparsity, FP32 60 TFLOP/s, HBM3 3.9 TB/s)
    ("h100 nvl", 835.5, 60.0, 3900.0),
    # same data sheet, H100 PCIe column (bf16 1,513 with sparsity, FP32 51,
    # HBM2e 2 TB/s)
    ("h100 pcie", 756.5, 51.0, 2000.0),
    # same data sheet, H100 SXM column ("NVIDIA H100 80GB HBM3": bf16 1,979
    # with sparsity, FP32 67, HBM3 3.35 TB/s)
    ("h100", 989.5, 67.0, 3350.0),
)


def _lookup(kind):
    k = (kind or "").lower()
    for sub, bf16, f32, gbps in _KIND_PEAKS:
        if sub in k:
            return bf16, f32, gbps
    return None


def _is_f32(dtype):
    return bool(dtype) and str(dtype).lower() in ("f32", "fp32", "float32")


def peak_flops_for_kind(kind, dtype=None):
    """Peak FLOP/s for a device name, or None if unknown: the dense bf16
    tensor-core rate, or for dtype "f32"/"float32" the FP32 rate (the port
    runs f32 with TF32 off, so f32 products never reach the tensor
    cores). ``MXTPU_ANATOMY_PEAK_TFLOPS`` (TFLOP/s) overrides the table
    for every dtype — deterministic tests pin exact peaks through it."""
    env = os.environ.get("MXTPU_ANATOMY_PEAK_TFLOPS")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            pass
    row = _lookup(kind)
    if row is None:
        return None
    return (row[1] if _is_f32(dtype) else row[0]) * 1e12


def peak_bytes_for_kind(kind):
    """Peak HBM bytes/s for a device name, or None if unknown.
    ``MXTPU_ANATOMY_PEAK_GBPS`` (in GB/s) overrides the table."""
    env = os.environ.get("MXTPU_ANATOMY_PEAK_GBPS")
    if env:
        try:
            return float(env) * 1e9
        except ValueError:
            pass
    row = _lookup(kind)
    return row[2] * 1e9 if row is not None else None


def classify(flops, bytes_accessed, wall_seconds, comm_seconds,
             peak_flops, peak_bytes):
    """Roofline classification of one interval.

    Returns {"bound", "t_compute", "t_memory", "t_comm"} where the t_*
    legs are the minimum times the interval's work would take at peak
    compute rate, peak HBM rate, and the measured collective time. The
    binding resource is the largest leg; "host" when even that leg
    explains under ~30% of the wall (the step is dominated by time the
    device model cannot see); "unknown" without peak rates.
    """
    legs = {}
    if flops and peak_flops:
        legs["t_compute"] = flops / peak_flops
    if bytes_accessed and peak_bytes:
        legs["t_memory"] = bytes_accessed / peak_bytes
    if comm_seconds:
        legs["t_comm"] = comm_seconds
    out = {"t_compute": legs.get("t_compute"),
           "t_memory": legs.get("t_memory"),
           "t_comm": legs.get("t_comm")}
    if not legs:
        out["bound"] = "unknown"
        return out
    name, t = max(legs.items(), key=lambda kv: kv[1])
    if wall_seconds and t < 0.3 * wall_seconds:
        out["bound"] = "host"
    else:
        out["bound"] = {"t_compute": "compute", "t_memory": "memory",
                        "t_comm": "comm"}[name]
    return out


def analytic_forward_flops(symbol, **input_shapes):
    """Hand-counted forward FLOPs for one batch through ``symbol``.

    Counts the dense-algebra ops (Convolution, Deconvolution,
    FullyConnected) that dominate model FLOPs — the convention MFU
    numbers are quoted in (2 MACs per multiply-add, bias adds included).
    A training step is ~3x this (forward + 2x backward).
    """
    internals = symbol.get_internals()
    names = internals.list_outputs()
    _, oshapes, _ = internals.infer_shape(**input_shapes)
    shape_of = dict(zip(names, oshapes))

    def _in_shape(node, i):
        inode, iidx = node.inputs[i]
        return shape_of.get(inode.output_names()[iidx])

    total = 0.0
    for node in symbol._nodes():
        if node.is_variable:
            continue
        op = node.op.name
        if op not in ("Convolution", "Deconvolution", "FullyConnected"):
            continue
        out = shape_of.get(node.output_names()[0])
        dat = _in_shape(node, 0)
        if out is None or dat is None:
            continue
        attrs = node.canon_attrs()
        n_out = 1
        for d in out:
            n_out *= int(d)
        if op == "FullyConnected":
            # data flattens to (N, prod(rest)); weight is (out, in)
            in_feat = 1
            for d in dat[1:]:
                in_feat *= int(d)
            total += 2.0 * n_out * in_feat
        else:
            from ..ops.utils import as_tuple

            kernel = as_tuple(attrs.get("kernel"), name="kernel") or (1,)
            groups = max(int(attrs.get("num_group", 1)), 1)
            k_elems = 1
            for d in kernel:
                k_elems *= int(d)
            if op == "Convolution":
                # each output element reduces over C_in/g * prod(kernel)
                total += 2.0 * n_out * (int(dat[1]) // groups) * k_elems
            else:
                # Deconvolution scatters each INPUT element into
                # num_filter/g * prod(kernel) outputs
                n_in = 1
                for d in dat:
                    n_in *= int(d)
                nf = int(attrs.get("num_filter", 1))
                total += 2.0 * n_in * (nf // groups) * k_elems
        if not attrs.get("no_bias", False):
            total += float(n_out)
    return total


# Per-op rough cost constants for analytic_op_costs. FLOPs are forward-
# pass, per output element, for the NON-dense ops (dense ops get the
# exact MAC count above); bytes are traffic multipliers on the element
# count (reads + writes at dtype width), assuming no fusion — i.e. the
# worst case a hand-written kernel would attack. Deliberately coarse:
# the table exists to RANK kernel candidates, not to predict absolute
# runtimes.
_ELTWISE_OPS = ("Activation", "LeakyReLU", "relu", "sigmoid", "tanh",
                "elemwise_add", "_Plus", "_plus", "broadcast_add",
                "broadcast_plus", "_add", "add_n", "Dropout", "clip")
_DENSE_OPS = ("Convolution", "Deconvolution", "FullyConnected")


def analytic_op_costs(symbol, dtype_bytes=2, **input_shapes):
    """Per-op forward {flops, bytes} table for ``symbol`` at the given
    input shapes — the roofline's view of each node, before fusion.

    Dense ops (conv/FC/deconv) get the exact 2-MAC count that
    :func:`analytic_forward_flops` totals, plus in+weight+out traffic.
    Memory-shaped ops (BatchNorm, activations, pooling, eltwise,
    softmax) get coarse per-element flop counts and unfused read/write
    traffic at ``dtype_bytes`` per element. Returns a list of
    ``{"name", "op", "flops", "bytes", "numel_out"}`` dicts in graph
    order; ops the table does not model are skipped. Feed the result to
    :func:`rank_kernel_candidates`."""
    internals = symbol.get_internals()
    names = internals.list_outputs()
    _, oshapes, _ = internals.infer_shape(**input_shapes)
    shape_of = dict(zip(names, oshapes))

    def _in_shape(node, i):
        inode, iidx = node.inputs[i]
        return shape_of.get(inode.output_names()[iidx])

    def _numel(shape):
        n = 1
        for d in shape:
            n *= int(d)
        return n

    rows = []
    for node in symbol._nodes():
        if node.is_variable:
            continue
        op = node.op.name
        out = shape_of.get(node.output_names()[0])
        dat = _in_shape(node, 0)
        if out is None or dat is None:
            continue
        attrs = node.canon_attrs()
        n_out = _numel(out)
        n_in = _numel(dat)
        flops = bytes_ = None
        if op in _DENSE_OPS:
            from ..ops.utils import as_tuple

            groups = max(int(attrs.get("num_group", 1)), 1)
            if op == "FullyConnected":
                in_feat = n_in // max(int(dat[0]), 1)
                flops = 2.0 * n_out * in_feat
                w_elems = (n_out // max(int(out[0]), 1)) * in_feat
            else:
                kernel = as_tuple(attrs.get("kernel"),
                                  name="kernel") or (1,)
                k_elems = 1
                for d in kernel:
                    k_elems *= int(d)
                if op == "Convolution":
                    flops = 2.0 * n_out * (int(dat[1]) // groups) * k_elems
                else:
                    nf = int(attrs.get("num_filter", 1))
                    flops = 2.0 * n_in * (nf // groups) * k_elems
                nf = int(attrs.get("num_filter", int(out[1])))
                w_elems = nf * (int(dat[1]) // groups) * k_elems
            bytes_ = (n_in + w_elems + n_out) * dtype_bytes
        elif op == "BatchNorm":
            # mean/var reduce + normalize + scale/shift ≈ 8 flops/elem;
            # unfused: read x twice (stats + normalize), write y, plus
            # f32 stats traffic (folded into the constant)
            flops = 8.0 * n_out
            bytes_ = 3.0 * n_out * dtype_bytes
        elif op == "Pooling":
            from ..ops.utils import as_tuple

            kernel = as_tuple(attrs.get("kernel"), name="kernel") or (1,)
            k_elems = 1
            for d in kernel:
                k_elems *= int(d)
            if attrs.get("global_pool", False):
                k_elems = max(n_in // max(n_out, 1), 1)
            flops = float(k_elems) * n_out
            bytes_ = (n_in + n_out) * dtype_bytes
        elif op in ("SoftmaxOutput", "softmax", "Softmax",
                    "SoftmaxActivation", "log_softmax"):
            # max + sub + exp + sum + div ≈ 6 flops/elem
            flops = 6.0 * n_out
            bytes_ = 2.0 * n_out * dtype_bytes
        elif op == "Flatten" or op == "Reshape":
            continue  # layout-only: a view, no traffic
        elif op in _ELTWISE_OPS or op.startswith(("elemwise_",
                                                  "broadcast_")):
            flops = 1.0 * n_out
            # binary eltwise reads two operands; unary reads one — use
            # the input count actually wired into the node
            n_args = max(len(node.inputs), 1)
            bytes_ = (n_args * n_out + n_out) * dtype_bytes
        else:
            continue
        rows.append({"name": node.name, "op": op,
                     "flops": float(flops), "bytes": float(bytes_),
                     "numel_out": int(n_out)})
    return rows


def rank_kernel_candidates(ops, kind=None, dtype=None, peak_flops=None,
                           peak_bytes=None, top=None):
    """Rank memory-bound ops as hand-written CUDA (fusion) candidates.

    For each op row from :func:`analytic_op_costs`, run the same
    dtype-aware roofline :func:`classify` the anatomy record uses
    (no wall/comm legs): ops whose memory leg exceeds their compute leg
    are memory-bound, and ``recoverable_ms = t_memory - t_compute`` is
    the per-forward-pass time above the compute floor that a fused
    kernel could reclaim by amortizing the op's traffic into a
    neighbor — an upper bound, used for ORDERING not prediction.
    Returns rows sorted by recoverable_ms descending, each extended
    with ``{"bound", "t_compute_ms", "t_memory_ms", "recoverable_ms",
    "intensity"}``. Empty when peak rates are unknown."""
    pf = peak_flops if peak_flops is not None \
        else peak_flops_for_kind(kind, dtype)
    pb = peak_bytes if peak_bytes is not None \
        else peak_bytes_for_kind(kind)
    if not pf or not pb:
        return []
    out = []
    for op in ops:
        f = op.get("flops") or 0.0
        b = op.get("bytes") or 0.0
        if not b:
            continue
        leg = classify(f or None, b, None, None, pf, pb)
        if leg["bound"] != "memory":
            continue
        t_c = leg["t_compute"] or 0.0
        t_m = leg["t_memory"] or 0.0
        row = dict(op)
        row.update({
            "bound": leg["bound"],
            "t_compute_ms": t_c * 1e3,
            "t_memory_ms": t_m * 1e3,
            "recoverable_ms": (t_m - t_c) * 1e3,
            "intensity": (f / b) if b else None,
        })
        out.append(row)
    out.sort(key=lambda r: -r["recoverable_ms"])
    return out[:top] if top else out


def analytic_step_cost(symbol, dtype_bytes=4, state_slots=0, amp=False, **input_shapes):
    """One training step's ``{"flops", "bytes_accessed"}`` at the given
    input shapes: 3x the forward's FLOPs (forward, then the data and weight
    gradients of every dense op: the MFU convention) and 3x its unfused
    bytes (:func:`analytic_op_costs` at ``dtype_bytes``), plus the update:
    each parameter's f32 value and ``state_slots`` f32 state slots read and
    written, its gradient read at ``dtype_bytes`` and, under ``amp``, its
    bf16 working copy written."""
    fwd = analytic_forward_flops(symbol, **input_shapes)
    op_bytes = sum(r["bytes"] for r in analytic_op_costs(
        symbol, dtype_bytes=dtype_bytes, **input_shapes))
    arg_shapes, _, _ = symbol.infer_shape(**input_shapes)
    n_params = 0
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in input_shapes or shape is None:
            continue
        n = 1
        for d in shape:
            n *= int(d)
        n_params += n
    update = n_params * (8 * (1 + state_slots) + dtype_bytes + (2 if amp else 0))
    return {"flops": 3.0 * fwd, "bytes_accessed": 3.0 * op_bytes + float(update)}
