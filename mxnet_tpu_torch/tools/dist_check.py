"""The port's checks across the processes of a launched job (counterpart of
the repo's ``tests/dist_worker.py``), and the fits and steps that the tests
and ``chip_smoke.py`` hold against one process::

    python -m mxnet_tpu_torch.tools.launch -n 2 \\
        python -m mxnet_tpu_torch.tools.dist_check --out DIR --device cpu

Each worker joins the job's gloo group (``parallel.init_distributed``) and
writes ``rank<r>.json`` into ``--out``; a failed assertion exits the worker
with a code other than 0, which the launcher returns.

``--checks`` (default ``kvstore,barrier,fused``):

- ``kvstore``: a ``dist_sync`` store's closed-form cross-worker sum after
  an ``init`` that broadcasts rank 0's value;
- ``barrier``: a barrier that waits: rank 0 waits at least 1 s on a peer
  that sleeps 2 s before it;
- ``fused``: a ``ShardedTrainStep`` over a mesh that spans the processes
  (2 logical ranks in each), whose loss halves in 12 steps and whose ranks
  end bit for bit equal.

``--fit KV[+amp],...`` runs ``Module.fit`` of ``--model`` (``resnet50`` at
3x224x224, ``resnet8`` at 3x16x16, ``mlp-bn``) over ``--steps`` batches of
``--batch`` rows of the job (each process feeds its own rows; the data is
:func:`fit_data`'s, the same in every process) with each kvstore type
(``dist_device_sync``: the fused path over a mesh that spans the
processes; ``dist_sync``: the executor path and the store's GradBucketer),
``+amp`` under ``MXTPU_AMP=bf16``, ``+rep`` with the fused update in
"replicated" mode (``MXTPU_SHARD_UPDATE=0``), ``+localrescale`` with the
gradient rescaled by the process's own rows instead of the job's batch
(the optimizer's ``rescale_grad`` given as one over the local batch: a
wrong fit that a check against one process must catch), ``:N`` for N
steps instead of ``--steps``. Each writes its state
(``fit_<KV[+amp]>_rank<r>.npz``) and, into the JSON, the losses of the
global batch, each tensor's sha256, the kernel launches, ms a step, the
collectives' ms and bytes a step, the buckets, the peak memory and, with
``--profile-steps``, the idle share of that many more profiled steps.
``--snap-step N`` saves the weights and aux states after step N too
(``snap:*``, ``snapaux:*``).
``--ckpt DIR`` fits with ``checkpoint_dir=DIR, resume="auto"`` (the
elastic shrink under ``tools/watchdog.py --elastic``; the global batch stays
``--batch`` at every world size).

``--step-test MODE=FILE.npz,...`` runs a ``ShardedTrainStep`` in each mode
(:data:`STEP_MODES`: f32 or AMP, "shard" or "replicated", or ``zero1``) from
the symbol, parameters, aux states and global batches in the file, and
writes the state after the last step (``step_<MODE>_rank<r>.npz``). Mode
``tp-step`` takes the file's ``specs`` (JSON, name -> spec) as
``param_specs`` over a dp 1 x tp P mesh that spans the P processes (each
feeds the whole batch), its guard armed (the (loss, grad-norm², ok) of each
step into the JSON), writes the gathered weights and momentum, and then
fits ``Module(mesh=, param_specs=)`` on the same batches with
``checkpoint_dir`` (rank 0 writes; ``save_checkpoint`` on rank 0 too,
``tp_module-0001.params`` in ``--out``).

``--checks axes`` holds the mesh's rank order and axis groups to JAX's
layout (dp 1 x tp P and dp 2 x tp 2 meshes over the P processes) and runs
each collective over one axis.

``--checks pp`` holds the pp axis of a dp 1 x pp P mesh over the P processes
to JAX's layout (process r holds stage r; its neighbours r - 1 and r + 1)
and runs ``ppermute`` over it: a shift and a ring, f32 and bf16, and the
gradient of the ring through its autograd pair (the reverse permute).

``--pp-problem FILE.npz[,FILE.npz...]`` runs ``pipelined_loss`` on each
file's problem (``w`` [S, d, d], ``b`` [S, d], ``x`` [M, mb, d], ``y``;
stage ``relu(a @ w + b)``, loss the mean squared error) over a dp 1 x pp S
mesh whose S stages are spread over the P processes, S / P a process, and
writes the loss and the gradients of ``w`` and ``b``
(``pp_problem<S>_rank<r>.npz``).

``--pp-test`` trains the transformer LM of ``--lm-dims`` for ``--lm-steps``
SGD steps as a pipeline over that mesh (:func:`pp_lm`): its blocks in P
stages of n_layers / P, the embedding before the pipeline, the final norm
and the tied head inside the loss, :data:`PP_MICRO` microbatches. Each rank
writes its losses, the K4 launches a step, the step ms, the permutes' and
the replicated leaves' all-reduce ms and bytes a step (after step 1), the
peak memory and, with ``--lm-profile``, the idle share; and the first
step's gradients of its own stage rows (rank 0 also the embedding's and the
final norm's) into ``pp_lm_rank<r>.npz``.

``--lm tp,sp,ep`` trains the transformer LM
(``examples/train_transformer_lm.train``) of ``--lm-dims``
(vocab,d_model,n_heads,n_layers,d_ff,seq_len,batch) for ``--lm-steps``
steps with tp, sp or ep = P across the processes (ep with
``--lm-experts`` experts), and writes each rank's losses, every gathered
leaf's sha256, the replicated leaves' sha256 on this rank, the collectives'
ms and bytes a step (after step 1), the K4 launches, the step ms and the
peak memory; rank 0 also writes the first step's gathered gradients and
the last step's gathered weights (``lm_<leg>.npz``, the JAX tree's
layout).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import sys
import time

import numpy as np

SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
T_IMPORT = time.perf_counter()


def fit_data(model, steps, batch):
    """(X, y) of ``steps`` global batches of ``batch`` rows for ``model``
    (float32 images or features, integer labels as float32); each from a
    generator of its own, so the first N batches are the same whatever
    ``steps`` is."""
    shape, classes = {"resnet50": ((3, 224, 224), 1000), "resnet8": ((3, 16, 16), 10),
                      "mlp-bn": ((16,), 4)}[model]
    X = np.random.default_rng(0).standard_normal((steps * batch,) + shape, dtype=np.float32)
    y = np.random.default_rng(1).integers(0, classes, steps * batch).astype(np.float32)
    return X, y


def fit_symbol(mx, model):
    """The symbol of ``model`` in package ``mx`` (either package)."""
    if model == "resnet50":
        from importlib import import_module

        return import_module(mx.__name__ + ".models.resnet").get_symbol()
    if model == "resnet8":
        from importlib import import_module

        return import_module(mx.__name__ + ".models.resnet").get_symbol(
            num_classes=10, num_layers=8, image_shape="3,16,16")
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def local_rows(X, steps, rank, size):
    """This process's rows of each of ``steps`` global batches of ``X``."""
    per = X.shape[0] // steps
    b = per // size
    return X.reshape((steps, per) + X.shape[1:])[:, rank * b:(rank + 1) * b].reshape(
        (steps * b,) + X.shape[1:])


def digest(t):
    """sha256 of a tensor's bytes (bf16 through its int16 view)."""
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def check_kvstore(mx, rank, size, res):
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (rank, size), (kv.rank, kv.num_workers)
    shape = (5, 7)
    # init broadcasts rank 0's value: the ranks give different ones
    kv.init(3, mx.nd.ones(shape) * (42 if rank == 0 else -1))
    pulled = mx.nd.zeros(shape)
    kv.pull(3, out=pulled)
    np.testing.assert_allclose(pulled.asnumpy(), 42.0)
    rate, repeat = 2.0, 3
    kv.set_updater(lambda key, recv, stored: stored.__iadd__(recv * rate))
    for _ in range(repeat):
        # two values a worker: the local reduce, then the sum across workers
        kv.push(3, [mx.nd.ones(shape) * (rank + 1) * 0.5, mx.nd.ones(shape) * (rank + 1) * 0.5])
    kv.pull(3, out=pulled)
    want = 42.0 + rate * repeat * sum(r + 1 for r in range(size))
    np.testing.assert_allclose(pulled.asnumpy(), want, rtol=1e-6)
    res["kvstore_value"] = float(pulled.asnumpy()[0, 0])
    res["kvstore_expected"] = want


def check_barrier(rank, res):
    from mxnet_tpu_torch.parallel import mesh

    sleep_s = 2.0
    t0 = time.perf_counter()
    if rank != 0:
        time.sleep(sleep_s)
    mesh.barrier("skew-test")
    waited = time.perf_counter() - t0
    if rank == 0:
        assert waited >= 0.5 * sleep_s, "barrier returned in %.2f s: it did not wait" % waited
    res["barrier_wait_s"] = waited


def check_fused(mx, dev, rank, size, res):
    import torch

    from mxnet_tpu_torch.parallel import ShardedTrainStep, make_mesh, mesh

    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    m = make_mesh(dp=2 * size, devices=[dev] * 2, processes=size)
    opt = mx.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0 / 16)
    step = ShardedTrainStep(net, m, optimizer=opt).compile()
    arg_shapes, _, _ = net.infer_shape(data=(16, 8), softmax_label=(16,))
    np.random.seed(7)
    params, aux, state = step.init(dict(zip(net.list_arguments(), arg_shapes)),
                                   mx.initializer.Xavier())
    rng = np.random.RandomState(0)
    X = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 4).astype(np.float32)
    per = 16 // size
    lo = rank * per
    batch = {"data": torch.from_numpy(X[lo:lo + per]).to(step.device),
             "softmax_label": torch.from_numpy(y[lo:lo + per]).to(step.device)}
    losses = []
    for t in range(12):
        params, aux, state, outs = step(params, aux, state, batch, t=t + 1)
        prob = outs[0].float().cpu().numpy()
        losses.append(float(-np.mean(np.log(prob[np.arange(per), y[lo:lo + per].astype(int)]
                                            + 1e-8))))
    assert losses[-1] < 0.5 * losses[0], losses
    w = params["fc1_weight"]
    assert torch.equal(mesh.allreduce_sum(w), w * size), "ranks' weights differ"
    res["fused_losses"] = [losses[0], losses[-1]]
    res["params_identical"] = True


def _launch_counts():
    from mxnet_tpu_torch.ops import kernels

    return {"conv_bwd_filter": kernels.conv_bwd_filter.launches,
            "conv_bwd_input": kernels.conv_bwd_input.launches,
            "slab_update": kernels.fused_slab_update.launches}


def _zero_launches():
    from mxnet_tpu_torch.ops import kernels

    for fn in (kernels.conv_bwd_filter, kernels.conv_bwd_input, kernels.fused_slab_update):
        fn.launches = 0


def _busy_ms(prof):
    """ms of the union of the card's kernels in a profile (copies and
    memsets left out)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda and "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower())
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _idle_share(mod, batch, steps):
    """Wall ms a step, busy ms of the card's kernels (their union) and the
    idle share over ``steps`` more steps under torch.profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms = _busy_ms(prof) / steps
    wall_ms = 1e3 * wall / steps
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms)}


def run_fit(mx, dev, ctx, args, name, rank, size, res):
    import torch

    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch.parallel import mesh

    t_setup = time.perf_counter()
    name, _, steps = name.partition(":")
    steps = int(steps or args.steps)
    X, y = fit_data(args.model, steps, args.batch)
    Xl, yl = local_rows(X, steps, rank, size), local_rows(y, steps, rank, size)
    b = args.batch // size
    it = mx.io.NDArrayIter(Xl, yl, batch_size=b)
    kv_type, *flags = name.split("+")
    amp = "amp" in flags
    if amp:
        os.environ["MXTPU_AMP"] = "bf16"
    else:
        os.environ.pop("MXTPU_AMP", None)
    os.environ["MXTPU_SHARD_UPDATE"] = "0" if "rep" in flags else "1"
    np.random.seed(0)
    mod = mx.mod.Module(fit_symbol(mx, args.model), context=ctx)
    nlls, stamps, first, snap = [], [], {}, {}

    def on_batch(param):
        if param.nbatch + 1 == args.snap_step:
            # the weights after this step (across processes a collective,
            # which every rank reaches here)
            mod._sync_params_from_devices()
            snap.update({"snap:" + k: v.asnumpy().copy() for k, v in mod._arg_params.items()})
            snap.update({"snapaux:" + k: v.asnumpy().copy()
                         for k, v in mod._aux_params.items()})
        prob = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data.long()
        picked = prob.float().gather(1, label.unsqueeze(1)).squeeze(1)
        nlls.append(-torch.log(picked.clamp_min(1e-30)).sum())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())
        if not first:  # the steps after the first: no init broadcasts, no warm-up
            first.update({op: dict(v) for op, v in mesh.collective_stats.items()},
                         buckets=dict(kvs.bucket_stats))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_collective_stats()
    kvs.bucket_stats.update(flushes=0, bytes=0)
    _zero_launches()
    fit_kw = {}
    if args.ckpt:
        fit_kw = dict(checkpoint_dir=args.ckpt, resume="auto")
    t0 = time.perf_counter()
    setup_s = t0 - t_setup
    opt_params = dict(SGD)
    if "localrescale" in flags:
        opt_params["rescale_grad"] = 1.0 / b
    mod.fit(it, kvstore=kv_type, optimizer="sgd",
            optimizer_params=opt_params,
            initializer=mx.init.Xavier(), num_epoch=1, batch_end_callback=on_batch, **fit_kw)
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    n = len(nlls)
    base = {"calls": 0, "seconds": 0.0, "bytes": 0}
    stats = {op: {k: v[k] - first.get(op, base)[k] for k in base}
             for op, v in mesh.collective_stats.items()}
    flushes = kvs.bucket_stats["flushes"] - first["buckets"]["flushes"]
    bucket_bytes = kvs.bucket_stats["bytes"] - first["buckets"]["bytes"]
    # the global batch's mean loss of each step
    losses = (mesh.allreduce_sum(torch.stack(nlls)).double() / args.batch).tolist()
    arg, aux = mod.get_params()  # across processes in "shard" mode: a collective
    state = {"arg:" + k: v.asnumpy() for k, v in arg.items()}
    state.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    state.update(snap)
    digests = {k: digest(v._data) for k, v in arg.items()}
    digests.update({"aux:" + k: digest(v._data) for k, v in aux.items()})
    tr = mod._fused_trainer
    if tr is not None and tr.amp:
        digests.update({"bf16:" + k: digest(v) for k, v in mod._fused_params.items()})
        masters = tr.master_params_named(tr.gather_state(mod._fused_opt, mod._fused_params))
        for k, v in mod._fused_params.items():
            assert torch.equal(v, masters[k].to(torch.bfloat16)), "%s != bf16(master)" % k
    np.savez(os.path.join(args.out, "fit_%s_rank%d.npz" % (name, rank)), **state)
    step_s = [b2 - b1 for b1, b2 in zip(stamps[1:], stamps[2:])]
    fit = {"model": args.model, "kv": kv_type, "amp": bool(amp), "steps": n,
           "batch": args.batch, "rows": b, "losses": losses, "digests": digests,
           "launches": launches, "setup_s": setup_s, "fit_s": fit_s,
           "step_ms_median": 1e3 * float(np.median(step_s)) if step_s else None,
           "collectives_after_step_1": stats,
           "collective_ms_per_step": (1e3 * sum(v["seconds"] for v in stats.values())
                                      / max(1, n - 1)),
           "collective_bytes_per_step": sum(v["bytes"] for v in stats.values()) / max(1, n - 1),
           "bucket_flushes_per_step": flushes / max(1, n - 1),
           "bucket_bytes_per_step": bucket_bytes / max(1, n - 1),
           "fused": tr is not None,
           "flat_mode": None if tr is None else tr.flat_mode,
           "buckets": (len(tr._flat_plan.buckets) if tr is not None and tr._flat_plan
                       else None),
           "backend": mesh.backend()}
    if dev.type == "cuda":
        fit["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if args.profile_steps:
            it.reset()
            fit["profile"] = _idle_share(mod, next(iter(it)), args.profile_steps)
    fit["wall_s"] = time.perf_counter() - t_setup
    res.setdefault("fits", {})[name] = fit


def _leaves(state):
    """The tensors of an optimizer-state dict (its scalars too)."""
    out = []
    for v in state.values():
        out.extend(v if isinstance(v, tuple) else [] if v is None else [v])
    return out


#: --step-test modes: (MXTPU_AMP, MXTPU_SHARD_UPDATE, zero1)
STEP_MODES = {"f32-shard": ("", "1", False), "f32-replicated": ("", "0", False),
              "amp-shard": ("bf16", "1", False), "amp-replicated": ("bf16", "0", False),
              "zero1": ("", "1", True), "tp-step": ("", "1", False)}


def run_step_test(mx, dev, mode, path, out_dir, rank, size, res):
    """One ``ShardedTrainStep`` run of ``mode`` from the blob at ``path``:
    ``symbol`` (JSON), ``arg:*`` / ``aux:*`` arrays, ``data`` / ``label``
    (steps, global batch, ...), ``steps``, ``local_ranks``, ``lr``,
    ``momentum``. Writes ``step_<mode>_rank<r>.npz``: the weights (the
    masters under AMP), aux states, working params and (zero1) the
    momentum after the last step."""
    import torch

    from mxnet_tpu_torch.parallel import ShardedTrainStep, make_mesh

    blob = dict(np.load(path))
    sym = mx.sym.load_json(str(blob["symbol"]))
    steps, local = int(blob["steps"]), int(blob["local_ranks"])
    X, y = blob["data"], blob["label"]
    amp, shard, zero1 = STEP_MODES[mode]
    saved = {k: os.environ.get(k) for k in ("MXTPU_AMP", "MXTPU_SHARD_UPDATE")}
    os.environ.update(MXTPU_AMP=amp, MXTPU_SHARD_UPDATE=shard)
    specs = json.loads(str(blob["specs"])) if mode == "tp-step" else None
    try:
        if specs is None:
            m = make_mesh(dp=local * size, devices=[dev] * local, processes=size)
        else:
            m = make_mesh(dp=1, tp=local * size, devices=[dev] * local, processes=size)
        opt = mx.optimizer.create("sgd", learning_rate=float(blob["lr"]),
                                  momentum=float(blob["momentum"]),
                                  rescale_grad=1.0 / X.shape[1])
        step = ShardedTrainStep(sym, m, optimizer=opt, zero1=zero1, param_specs=specs)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    params, aux = step.place_params(
        {k[4:]: v for k, v in blob.items() if k.startswith("arg:")},
        {k[4:]: v for k, v in blob.items() if k.startswith("aux:")})
    state = step.make_state(params)
    params = step.amp_cast_params(params)
    from mxnet_tpu_torch.parallel.mesh import dp_rows

    rows = dp_rows(m, X.shape[1])  # this process's dp rows: its tp peers' too
    shapes_held = {k: list(v.shape) for k, v in params.items()}
    if specs is not None:
        step.arm_guard()  # its grad-norm² sums each axis's slices over the axis
    diag = []
    for t in range(steps):
        batch = {"data": torch.from_numpy(X[t, rows]).to(dev),
                 "softmax_label": torch.from_numpy(y[t, rows]).to(dev)}
        params, aux, state, outs = step(params, aux, state, batch, t=t + 1)
        if step.guard:
            diag.append(outs[-1].tolist())
    held = sum(t.numel() for t in _leaves(state))
    state = step.gather_state(state, params)
    params = step.gather_params(params)
    weights = step.master_params_named(state) if step.amp else params
    out = {"arg:" + k: v.float().cpu().numpy() for k, v in weights.items()}
    out.update({"aux:" + k: v.cpu().numpy() for k, v in aux.items()})
    out.update({"w:" + k: v.float().cpu().numpy() for k, v in params.items()})
    if zero1 or specs is not None:
        out.update({"mom:" + k: v.cpu().numpy() for k, v in state.items() if torch.is_tensor(v)})
    np.savez(os.path.join(out_dir, "step_%s_rank%d.npz" % (mode, rank)), **out)
    res.setdefault("steps", {})[mode] = {
        "shapes_held": shapes_held, "param_specs": specs, "guard_diag": diag,
        "flat_mode": step.flat_mode, "amp": step.amp, "zero1": step.zero1,
        "state_sharded": step.state_sharded, "state_elems_held": held,
        "state_elems_whole": sum(t.numel() for t in _leaves(state)),
        "digests": {k: digest(torch.from_numpy(v)) for k, v in out.items()}}
    if specs is not None:
        run_tp_module(mx, dev, blob, specs, out_dir, rank, size, res)


def run_tp_module(mx, dev, blob, specs, out_dir, rank, size, res):
    """``Module(mesh=, param_specs=).fit`` over a dp 1 x tp P mesh across the
    processes on the blob's batches (every process feeds them whole), with
    ``checkpoint_dir``; rank 0 also writes ``save_checkpoint``."""
    from mxnet_tpu_torch.parallel import make_mesh

    sym = mx.sym.load_json(str(blob["symbol"]))
    X, y = blob["data"], blob["label"]
    steps, b = X.shape[0], X.shape[1]
    m = make_mesh(dp=1, tp=size, devices=[dev], processes=size)
    it = mx.io.NDArrayIter(X.reshape((steps * b,) + X.shape[2:]), y.reshape(-1),
                           batch_size=b)
    mod = mx.mod.Module(sym, context=mx.cpu() if dev.type == "cpu" else mx.gpu(0), mesh=m,
                        param_specs=specs)
    ckpt = os.path.join(out_dir, "tp_module_ckpt")
    mod.fit(it, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": float(blob["lr"]),
                              "momentum": float(blob["momentum"])},
            arg_params={k[4:]: mx.nd.array(v) for k, v in blob.items() if k.startswith("arg:")},
            aux_params={k[4:]: mx.nd.array(v) for k, v in blob.items() if k.startswith("aux:")},
            num_epoch=1, checkpoint_dir=ckpt)
    arg, aux = mod.get_params()  # the tp shards gathered (a collective)
    tr = mod._fused_trainer
    if rank == 0:
        mod.save_checkpoint(os.path.join(out_dir, "tp_module"), 1)
    res["tp_module"] = {
        "fused": tr is not None, "flat_mode": tr.flat_mode, "state_sharded": tr.state_sharded,
        "shapes_held": {k: list(v.shape) for k, v in mod._fused_params.items()},
        "digests": {k: digest(v._data) for k, v in arg.items()},
        "ckpt_files": sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []}


def _k4_launches():
    from mxnet_tpu_torch.ops import kernels

    return {"flash_attn_fwd": kernels.flash_attention.launches,
            "flash_attn_bwd_dq": kernels.flash_attention_dq.launches,
            "flash_attn_bwd_dkv": kernels.flash_attention_dkv.launches}


def _tree_npz(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_npz(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


#: --lm legs: the trainer's axis flags, with P the job's process count
LM_LEGS = {"tp": lambda p, e: dict(tp=p), "sp": lambda p, e: dict(sp=p),
           "ep": lambda p, e: dict(ep=p, moe_experts=e)}


def run_lm_leg(dev, leg, args, rank, size, res):
    """One ``--lm`` leg (see the module docstring)."""
    import copy

    import torch

    from mxnet_tpu_torch.examples import train_transformer_lm as trainer
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import mesh

    vocab, d_model, n_heads, n_layers, d_ff, seq_len, batch = (
        int(x) for x in args.lm_dims.split(","))
    flags = LM_LEGS[leg](size, args.lm_experts)
    saved, stamps, stats0, meshes = {}, [], {}, []
    save = set(args.lm_save.split(",")) - {"none", ""}
    prof = None
    if args.lm_profile and dev.type == "cuda":
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def on_mesh(m):
        meshes.append(m)

    def whole(params):
        return tfm.params_to_jax(tfm.gather_params(params, meshes[0]))

    def on_grads(i, params):
        if i == 0 and "grads" in save:
            g = copy.deepcopy(params)
            for p, src in zip(g.parameters(), params.parameters()):
                p.data = src.grad.detach().clone()
            saved["grads"] = whole(g)

    def on_step(i, loss, params):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i == 0:
            stats0.update({op: dict(v) for op, v in mesh.collective_stats.items()})
            saved["launches_step0"] = _k4_launches()
            if prof is not None:
                prof.start()  # before the stamp: its start-up is no step's
        stamps.append(time.perf_counter())
        if i == args.lm_steps - 1:
            if prof is not None:
                prof.stop()
            # the steps' collectives, before the gathers that follow them
            saved["stats"] = {op: dict(v) for op, v in mesh.collective_stats.items()}
        saved["params"] = params

    for fn in (kernels.flash_attention, kernels.flash_attention_dq, kernels.flash_attention_dkv):
        fn.launches = 0
    mesh.reset_collective_stats()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the fits' cached blocks before it
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = trainer.train(vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                           d_ff=d_ff, seq_len=seq_len, batch_size=batch, steps=args.lm_steps,
                           lr=3e-2, dtype=args.lm_dtype, device=dev, log=lambda *a: None,
                           on_step=on_step, on_grads=on_grads, on_mesh=on_mesh, **flags)
    wall = time.perf_counter() - t0
    params = saved["params"]
    shapes_held = {n: list(p.shape) for n, p in params.named_parameters()}
    rep = tfm.replicated_names(params)
    final = whole(params)  # a collective
    n = len(losses)
    base = {"calls": 0, "seconds": 0.0, "bytes": 0}
    after = {op: {k: v[k] - stats0.get(op, base)[k] for k in base}
             for op, v in saved["stats"].items()}
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    flat = _tree_npz(final, "")
    out = {"flags": flags, "dims": args.lm_dims, "dtype": args.lm_dtype, "losses": losses,
           "wall_s": wall, "mesh": str(meshes[0]),
           "digests": {k: digest(torch.from_numpy(np.ascontiguousarray(v)))
                       for k, v in flat.items()},
           "replicated_digests": {k: digest(p) for k, p in params.named_parameters()
                                  if k in rep},
           "shapes_held": shapes_held,
           "launches": _k4_launches(), "launches_step0": saved["launches_step0"],
           "collectives_after_step_1": after,
           "collective_ms_per_step": 1e3 * sum(v["seconds"] for v in after.values())
           / max(1, n - 1),
           "collective_bytes_per_step": sum(v["bytes"] for v in after.values()) / max(1, n - 1),
           "step_ms_median": 1e3 * float(np.median(step_s)) if step_s else None}
    if dev.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if prof is not None and step_s:
        busy = _busy_ms(prof) / len(step_s)
        wall_ms = 1e3 * sum(step_s) / len(step_s)
        out["profile"] = {"steps": len(step_s), "wall_ms": wall_ms, "device_busy_ms": busy,
                          "idle_share": max(0.0, 1.0 - busy / wall_ms)}
    if rank == 0 and save:
        blob = {}
        if "grads" in save:
            blob.update({"grad:" + k: v for k, v in _tree_npz(saved["grads"], "").items()})
        if "params" in save:
            blob.update({"param:" + k: v for k, v in flat.items()})
        np.savez(os.path.join(args.out, "lm_%s.npz" % leg), **blob)
    res.setdefault("lm", {})[leg] = out


def check_axes(mx, dev, rank, size, res):
    """The mesh's rank order and axis groups against JAX's layout, and each
    collective over one axis (see the module docstring)."""
    import torch

    from mxnet_tpu_torch.parallel import mesh

    out = {}
    m = mesh.make_mesh(dp=1, tp=size, devices=[dev], processes=size)
    tp = mesh.axis_group(m, "tp")
    assert m.coords(0)["tp"] == rank and tp.ranks == list(range(size)) and tp.index == rank
    assert mesh.axis_group(m, "dp").size == 1
    x = torch.full((2, 3), float(rank + 1), device=dev)
    got = {"allreduce": mesh.allreduce_sum(x, axis=tp)[0, 0].item(),
           "all_gather": mesh.all_gather(x, axis="tp", mesh=m)[:, 0].tolist(),
           "reduce_scatter": mesh.reduce_scatter_sum(
               torch.arange(2 * size, dtype=torch.float32, device=dev) * (rank + 1),
               axis=tp).tolist(),
           "broadcast": mesh.broadcast_from_root(x, axis=tp)[0, 0].item()}
    assert got["allreduce"] == size * (size + 1) / 2
    assert got["all_gather"] == [float(r + 1) for r in range(size) for _ in range(2)]
    tri = size * (size + 1) / 2
    assert got["reduce_scatter"] == [tri * i for i in range(2 * rank, 2 * rank + 2)]
    assert got["broadcast"] == 1.0
    out["dp1_tp"] = {"coords": m.coords(0), "tp_ranks": tp.ranks, "got": got}
    if size == 2:
        m2 = mesh.make_mesh(dp=2, tp=2, devices=[dev] * 2, processes=2)
        # JAX's reshape of the process-major list: tp inside a process, dp across
        assert [m2.coords(i) for i in range(2)] == [
            dict(dp=rank, tp=t, pp=0, sp=0, ep=0) for t in range(2)]
        dp, tp2 = mesh.axis_group(m2, "dp"), mesh.axis_group(m2, "tp")
        assert dp.ranks == [0, 1] and dp.positions == [rank]
        assert tp2.ranks == [rank] and tp2.positions == [0, 1]
        assert mesh.allreduce_sum(x, axis=tp2) is x  # logical: nothing crosses
        s = mesh.allreduce_sum(x, axis=dp)[0, 0].item()
        assert s == 3.0, s
        out["dp2_tp2"] = {"coords": [m2.coords(i) for i in range(2)], "dp_ranks": dp.ranks,
                          "tp_positions": tp2.positions}
    out["stats"] = {k: dict(v) for k, v in mesh.collective_stats.items() if "@" in k}
    res["axes"] = out


def check_pp(dev, rank, size, res):
    """The pp axis across the processes and ``ppermute`` over it (see the
    module docstring)."""
    import torch

    from mxnet_tpu_torch.parallel import mesh

    m = mesh.make_mesh(dp=1, pp=size, devices=[dev], processes=size)
    pp = mesh.axis_group(m, "pp")
    assert m.coords(0)["pp"] == rank and pp.ranks == list(range(size)), (m.coords(0), pp)
    assert pp.positions == [rank] and pp.index == rank
    shift = [(i, i + 1) for i in range(size - 1)]
    ring = [(i, (i + 1) % size) for i in range(size)]
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((1, 3, 5), float(rank + 1), device=dev, dtype=dtype)
        y = mesh.ppermute(x, shift, axis=pp)
        assert y.dtype == dtype and torch.all(y == float(rank)), (dtype, y)  # rank 0: zeros
        z = mesh.ppermute(x, ring, axis=pp, tag=1)
        assert torch.all(z == float((rank - 1) % size + 1)), (dtype, z)
        got[str(dtype)] = [y.flatten()[0].item(), z.flatten()[0].item()]
    x = torch.full((1, 4), float(rank + 1), device=dev, requires_grad=True)
    w = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    (mesh.ppermute(x, ring, axis=pp, tag=2) * w).sum().backward()
    nxt = (rank + 1) % size  # x went to the next stage, whose w is its gradient
    want = torch.arange(4, dtype=torch.float32) + 10 * nxt
    assert torch.equal(x.grad[0].cpu(), want), (x.grad, want)
    res["pp"] = {"coords": m.coords(0), "pp_ranks": pp.ranks, "got": got,
                 "neighbours": {"prev": rank - 1 if rank else None,
                                "next": rank + 1 if rank + 1 < size else None},
                 "grad": x.grad[0].tolist(),
                 "stats": {k: dict(v) for k, v in mesh.collective_stats.items()
                           if k.startswith("ppermute")}}


def relu_stage(p, act):
    """The stage of ``tests/test_moe_pipeline.py``'s pipeline problem."""
    import torch

    return torch.relu(act @ p["w"] + p["b"])


def mse_loss(outs, y):
    import torch

    return torch.mean((outs - y) ** 2)


def run_pp_problem(dev, path, out_dir, rank, size, res):
    """``--pp-problem``: the pipelined loss and its gradients across the
    processes (see the module docstring)."""
    import torch

    from mxnet_tpu_torch.parallel import make_mesh, pipelined_loss

    blob = dict(np.load(path))
    stages = int(blob["w"].shape[0])
    if stages % size:
        raise ValueError("%d stages do not spread over %d processes" % (stages, size))
    m = make_mesh(dp=1, pp=stages, devices=[dev] * (stages // size), processes=size)
    params = {k: torch.from_numpy(blob[k]).to(dev).requires_grad_() for k in ("w", "b")}
    loss = pipelined_loss(relu_stage, mse_loss, m)(params, torch.from_numpy(blob["x"]).to(dev),
                                                   torch.from_numpy(blob["y"]).to(dev))
    loss.backward()
    np.savez(os.path.join(out_dir, "pp_problem%d_rank%d.npz" % (stages, rank)),
             loss=loss.item(), **{k: v.grad.cpu().numpy() for k, v in params.items()})
    res.setdefault("pp_problem", {})[str(stages)] = {"loss": loss.item(),
                                                     "stages_held": m.positions("pp")}


#: the transformer block's weights, stacked for the pipeline's stages
PP_NAMES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w2")
#: ``--pp-test``'s microbatches a step
PP_MICRO = 4


def pp_lm(dims, dtype, dev, n_stages):
    """The transformer LM of ``dims`` (vocab, d_model, n_heads, n_layers,
    d_ff, seq_len, batch) as a pipeline of ``n_stages``, from ``init_fn(0)``
    on the trainer's corpus. Returns a namespace: ``stages`` (each block
    weight stacked [S, n_layers / S, ...], f32 masters), ``embed`` and
    ``ln_f`` (f32, every process holds them whole), ``leaves`` (all of
    them) and ``loss_for(mesh)`` -> ``loss()``: the embedding of the
    tokens in :data:`PP_MICRO` microbatches through ``pipelined_loss`` (each stage
    ``models.transformer.dense_block`` over its blocks in ``dtype``; the
    loss the trainer's mean NLL after the final norm and the tied head)."""
    import types

    import torch

    from mxnet_tpu_torch.examples import train_transformer_lm as trainer
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import pipelined_loss

    vocab, d_model, n_heads, n_layers, d_ff, seq_len, batch = dims
    micro = PP_MICRO
    if n_layers % n_stages or batch % micro:
        raise ValueError("%d layers over %d stages, batch %d in %d microbatches"
                         % (n_layers, n_stages, batch, micro))
    cdt = tfm._torch_dtype(dtype)
    init_fn, _ = tfm.transformer_lm(vocab=vocab, d_model=d_model, n_heads=n_heads,
                                    n_layers=n_layers, d_ff=d_ff, dtype=cdt)
    full = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    per = n_layers // n_stages
    stages = {}
    for name in PP_NAMES:
        w = torch.stack([getattr(layer, name).detach() for layer in full.layers])
        stages[name] = w.reshape((n_stages, per) + tuple(w.shape[1:])).clone().requires_grad_()
    embed = full.embed.detach().clone().requires_grad_()
    ln_f = full.ln_f.detach().clone().requires_grad_()
    seq = torch.from_numpy(trainer.corpus(vocab, batch, seq_len).astype(np.int64)).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    mb = batch // micro
    pe = torch.from_numpy(tfm._sinusoid_pe(seq_len, d_model)).to(device=dev, dtype=cdt)

    def stage_fn(p, act):
        for j in range(per):
            act = tfm.dense_block(act, types.SimpleNamespace(**{k: v[j] for k, v in p.items()}),
                                  n_heads, cdt)
        return act

    def loss_fn(outs, y):
        logits = tfm.lm_head(outs.reshape((-1,) + tuple(outs.shape[2:])), ln_f, embed, cdt)
        return trainer.lm_loss(logits, y.reshape(-1, y.shape[-1]))

    def loss_for(mesh):
        f = pipelined_loss(stage_fn, loss_fn, mesh)

        def loss():
            x = embed[tokens].to(cdt) + pe[None]  # apply_fn's input
            return f(stages, x.reshape((micro, mb) + tuple(x.shape[1:])),
                     targets.reshape(micro, mb, -1))

        return loss

    return types.SimpleNamespace(stages=stages, embed=embed, ln_f=ln_f, per=per,
                                 leaves=[embed, ln_f] + list(stages.values()),
                                 loss_for=loss_for)


def pp_sgd(leaves, lr):
    """``p -= lr * g`` on every leaf with a gradient; clears them."""
    import torch

    with torch.no_grad():
        for p in leaves:
            if p.grad is not None:
                p.sub_(lr * p.grad)
                p.grad = None


def run_pp_test(dev, args, rank, size, res):
    """``--pp-test`` (see the module docstring)."""
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import make_mesh, mesh

    dims = tuple(int(v) for v in args.lm_dims.split(","))
    m = make_mesh(dp=1, pp=size, devices=[dev], processes=size)
    lm = pp_lm(dims, args.lm_dtype, dev, size)
    loss_fn = lm.loss_for(m)
    grp = mesh.axis_group(m, "pp")
    for fn in (kernels.flash_attention, kernels.flash_attention_dq, kernels.flash_attention_dkv):
        fn.launches = 0
    mesh.reset_collective_stats()
    prof = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        if args.lm_profile:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    losses, stamps, stats0, step0 = [], [], {}, {}
    t0 = time.perf_counter()
    for i in range(args.lm_steps):
        loss = loss_fn()
        loss.backward()
        for p in (lm.embed, lm.ln_f):  # partial on each process: summed over pp
            p.grad = mesh.allreduce_sum(p.grad if p.grad is not None else torch.zeros_like(p),
                                        axis=grp)
        if i == 0:
            lo, hi = grp.positions[0], grp.positions[-1] + 1
            blob = {"grad:" + k: v.grad[lo:hi].float().cpu().numpy()
                    for k, v in lm.stages.items()}
            if rank == 0:
                blob.update({"grad:embed": lm.embed.grad.cpu().numpy(),
                             "grad:ln_f": lm.ln_f.grad.cpu().numpy()})
            np.savez(os.path.join(args.out, "pp_lm_rank%d.npz" % rank), **blob)
        pp_sgd(lm.leaves, 3e-2)
        losses.append(loss.detach())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i == 0:
            stats0.update({op: dict(v) for op, v in mesh.collective_stats.items()})
            step0.update(_k4_launches())
            if prof is not None:
                prof.start()
        stamps.append(time.perf_counter())
    if prof is not None:
        prof.stop()
    wall = time.perf_counter() - t0
    n = len(losses)
    base = {"calls": 0, "seconds": 0.0, "bytes": 0}
    after = {op: {k: v[k] - stats0.get(op, base)[k] for k in base}
             for op, v in mesh.collective_stats.items()}
    per_step = lambda op, k: after.get(op, base)[k] / max(1, n - 1)  # noqa: E731
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    out = {"dims": args.lm_dims, "dtype": args.lm_dtype, "micro": PP_MICRO,
           "stages_held": grp.positions, "blocks_a_stage": lm.per,
           "losses": [float(x) for x in losses], "wall_s": wall,
           "launches": _k4_launches(), "launches_step0": step0,
           "permute_ms_per_step": 1e3 * per_step("ppermute@pp", "seconds"),
           "permute_bytes_per_step": per_step("ppermute@pp", "bytes"),
           "permute_calls_per_step": per_step("ppermute@pp", "calls"),
           "allreduce_ms_per_step": 1e3 * per_step("allreduce_sum@pp", "seconds"),
           "allreduce_bytes_per_step": per_step("allreduce_sum@pp", "bytes"),
           "step_ms_median": 1e3 * float(np.median(step_s)) if step_s else None}
    if dev.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if prof is not None and step_s:
        busy = _busy_ms(prof) / len(step_s)
        wall_ms = 1e3 * sum(step_s) / len(step_s)
        out["profile"] = {"steps": len(step_s), "wall_ms": wall_ms, "device_busy_ms": busy,
                          "idle_share": max(0.0, 1.0 - busy / wall_ms)}
    res["pp_lm"] = out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--checks", default="kvstore,barrier,fused")
    p.add_argument("--fit", default="",
                   help="fits to run, comma-separated kvstore types, +amp for bf16 AMP, "
                        "+rep for the replicated update, +localrescale for the gradient "
                        "rescaled by the local batch, :N for N steps (e.g. "
                        "dist_sync:3,dist_device_sync+amp)")
    p.add_argument("--model", default="resnet50", choices=["resnet50", "resnet8", "mlp-bn"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=64, help="rows of the job's batch")
    p.add_argument("--profile-steps", type=int, default=0)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--snap-step", type=int, default=0,
                   help="also save the weights and aux states after this step (snap:* and "
                        "snapaux:* in the npz)")
    p.add_argument("--step-test", default="",
                   help="comma-separated MODE=FILE.npz (modes: %s)" % ", ".join(STEP_MODES))
    p.add_argument("--lm", default="", help="LM legs, comma-separated: %s" % ", ".join(LM_LEGS))
    p.add_argument("--lm-dims", default="32,16,2,2,32,8,2",
                   help="vocab,d_model,n_heads,n_layers,d_ff,seq_len,batch")
    p.add_argument("--lm-steps", type=int, default=3)
    p.add_argument("--lm-experts", type=int, default=4)
    p.add_argument("--lm-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--lm-save", default="grads,params",
                   help="what rank 0 writes into lm_<leg>.npz: grads (the first step's), "
                        "params (the last step's), both, or none")
    p.add_argument("--pp-problem", default="", help="the pipeline problems' .npz files, "
                   "comma-separated (see the module docstring)")
    p.add_argument("--pp-test", action="store_true",
                   help="train the LM of --lm-dims as a pipeline over the processes")
    p.add_argument("--lm-profile", action="store_true",
                   help="profile the card over the steps after the first: busy ms a step "
                        "and the idle share")
    args = p.parse_args(argv)

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh

    if args.device == "cuda":
        # one worker's algorithms are its peer's: the ranks compare bit for
        # bit; f32 products stay f32 (no TF32), as in a one-process run they
        # are held to
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()  # the memory statistics need the card's state
    mesh.init_distributed()
    rank, size = mesh.process_index(), mesh.process_count()
    logging.basicConfig(level=logging.INFO,
                        format="[dist_check rank %d] %%(name)s: %%(message)s" % rank)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    dev = ctx.torch_device
    res = {"rank": rank, "size": size, "backend": mesh.backend(), "pid": os.getpid(),
           "started_s": time.perf_counter() - T_IMPORT}
    os.makedirs(args.out, exist_ok=True)
    with ctx:
        checks = [c for c in args.checks.split(",") if c] if args.checks != "none" else []
        if checks and size < 2:
            raise SystemExit("dist_check: the checks need a launched job of 2+ processes")
        for name in checks:
            {"kvstore": lambda: check_kvstore(mx, rank, size, res),
             "barrier": lambda: check_barrier(rank, res),
             "fused": lambda: check_fused(mx, dev, rank, size, res),
             "axes": lambda: check_axes(mx, dev, rank, size, res),
             "pp": lambda: check_pp(dev, rank, size, res)}[name]()
        for path in filter(None, args.pp_problem.split(",")):
            run_pp_problem(dev, path, args.out, rank, size, res)
        if args.pp_test:
            run_pp_test(dev, args, rank, size, res)
        for item in [i for i in args.step_test.split(",") if i]:
            mode, _, path = item.partition("=")
            run_step_test(mx, dev, mode, path, args.out, rank, size, res)
        for name in [i for i in args.fit.split(",") if i]:
            run_fit(mx, dev, ctx, args, name, rank, size, res)
        for leg in [i for i in args.lm.split(",") if i]:
            run_lm_leg(dev, leg, args, rank, size, res)
    res["ok"] = True
    res["wall_s"] = time.perf_counter() - T_IMPORT
    path = os.path.join(args.out, "rank%d.json" % rank)
    if args.ckpt and os.path.exists(path):  # an earlier attempt's (elastic)
        with open(path) as f:
            res["earlier_attempt"] = json.load(f)
    with open(path, "w") as f:
        json.dump(res, f)
    mesh.barrier("dist-check-end")
    mesh.shutdown_distributed()
    print("[dist_check rank %d of %d] ok" % (rank, size), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
