"""The model axes of the port across processes on the CPU: ``tools/
dist_check.py`` launched on two processes over gloo, held to one process
and to the JAX package.

- ``--checks axes``: the rank order of dp 1 x tp 2 (tp across the
  processes) and dp 2 x tp 2 (tp inside each, dp across) meshes, and every
  collective over one axis's processes (all-reduce, all-gather,
  reduce-scatter, broadcast, send / receive);
- ``--lm tp,sp,ep``: the transformer trainer with ``--tp 2``, ``--sp 2`` and
  ``--ep 2 --moe-experts 4`` across the two processes against one process
  (losses within 2e-4, as ``test_torch_dist.py`` holds ``--dp 2``; the
  first step's gathered gradients and the last weights within 1e-5 of
  max), both ranks' losses equal and the replicated leaves bit for bit
  equal across them;
- ``--step-test tp-step``: ``ShardedTrainStep(param_specs=...)`` over a
  dp 1 x tp 2 mesh across the processes, each holding half of each sharded
  parameter, its gathered weights and momentum against JAX's one-process
  run over a dp 1 x tp 2 mesh of the host devices within 1e-6, its armed
  guard's grad-norm² (summed over the shards) against one process's; and
  ``Module(mesh=, param_specs=).fit`` with ``checkpoint_dir``: rank 0's
  ``save_checkpoint`` against JAX's fit within 1e-6.

One launch serves every case (a module fixture), with its own timeout.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import train_transformer_lm as trainer
from mxnet_tpu_torch.models import transformer as ttfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_DIMS = (32, 16, 2, 2, 32, 8, 2)  # vocab, d_model, n_heads, n_layers, d_ff, seq_len, batch
LM_STEPS = 3
EXPERTS = 4
SPECS = {"fc1_weight": ("tp", None), "fc1_bias": ("tp",), "fc2_weight": (None, "tp")}
B, STEPS = 16, 3


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _blob(path):
    rng = np.random.RandomState(11)
    arg = {"fc1_weight": rng.uniform(-0.3, 0.3, (32, 8)), "fc1_bias": rng.uniform(-0.1, 0.1, 32),
           "fc2_weight": rng.uniform(-0.3, 0.3, (4, 32)), "fc2_bias": np.zeros(4)}
    blob = {"arg:" + k: v.astype(np.float32) for k, v in arg.items()}
    blob.update(symbol=np.array(_mlp(jmx).tojson()), steps=STEPS, local_ranks=1, lr=0.1,
                momentum=0.9, specs=np.array(json.dumps(SPECS)),
                data=rng.randn(STEPS, B, 8).astype(np.float32),
                label=rng.randint(0, 4, (STEPS, B)).astype(np.float32))
    np.savez(path, **blob)
    return blob


@pytest.fixture(scope="module")
def axes_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("axes")
    blob = _blob(str(root / "tp.npz"))
    out = root / "out"
    env = dict(os.environ)
    for k in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR", "MXTPU_AMP", "MXTPU_SHARD_UPDATE",
              "MXTPU_RUN_DIR", "MXTPU_FAULT_INJECT", "DMLC_RANK", "DMLC_NUM_WORKER",
              "MXTPU_COORDINATOR_ADDRESS", "MXNET_FIT_MULTISTEP"):
        env.pop(k, None)
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2", "python", "-m",
           "mxnet_tpu_torch.tools.dist_check", "--out", str(out), "--device", "cpu",
           "--checks", "axes", "--lm", "tp,sp,ep", "--lm-dims", ",".join(map(str, LM_DIMS)),
           "--lm-steps", str(LM_STEPS), "--lm-experts", str(EXPERTS),
           "--step-test", "tp-step=%s" % (root / "tp.npz")]
    r = subprocess.run(cmd, cwd=ROOT, env=env, timeout=240, capture_output=True, text=True)
    assert r.returncode == 0, "launch rc=%d\n%s\n%s" % (r.returncode, r.stdout[-3000:],
                                                       r.stderr[-5000:])
    res = [json.loads((out / ("rank%d.json" % i)).read_text()) for i in range(2)]
    return {"out": out, "res": res, "blob": blob}


def _of_max(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= tol * scale, "%s: max err %.3g > %g of max %.3g" % (what, err, tol, scale)


def test_axes_rank_order_and_collectives(axes_run):
    for rank, res in enumerate(axes_run["res"]):
        ax = res["axes"]
        assert ax["dp1_tp"]["coords"]["tp"] == rank and ax["dp1_tp"]["tp_ranks"] == [0, 1]
        assert [c["dp"] for c in ax["dp2_tp2"]["coords"]] == [rank, rank]
        assert ax["dp2_tp2"]["tp_positions"] == [0, 1]
        # every collective recorded under its axis
        assert {"allreduce_sum@tp", "all_gather@tp", "reduce_scatter_sum@tp", "broadcast@tp",
                "allreduce_sum@dp"} <= set(ax["stats"])


def _one_process(leg):
    vocab, d_model, n_heads, n_layers, d_ff, seq_len, batch = LM_DIMS
    got = {}

    def on_grads(i, params):
        if i == 0:
            got["grads"] = ttfm.grads_to_jax(params)

    def on_step(i, loss, params):
        got["params"] = params

    flags = {"tp": {}, "sp": {}, "ep": {"moe_experts": EXPERTS}}[leg]
    with tmx.cpu():
        losses = trainer.train(vocab=vocab, d_model=d_model, n_heads=n_heads,
                               n_layers=n_layers, d_ff=d_ff, seq_len=seq_len, batch_size=batch,
                               steps=LM_STEPS, device="cpu", log=lambda *a: None,
                               on_grads=on_grads, on_step=on_step, **flags)
    return losses, got["grads"], ttfm.params_to_jax(got["params"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("leg", ["tp", "sp", "ep"])
def test_lm_leg_matches_one_process(axes_run, leg):
    ranks = [r["lm"][leg] for r in axes_run["res"]]
    want, grads, params = _one_process(leg)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], want, atol=2e-4, rtol=0)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    # the replicated leaves stay bit for bit equal across the ranks, and so
    # do the gathered ones
    assert ranks[0]["replicated_digests"] == ranks[1]["replicated_digests"]
    assert ranks[0]["replicated_digests"]
    assert ranks[0]["digests"] == ranks[1]["digests"]
    with np.load(axes_run["out"] / ("lm_%s.npz" % leg)) as z:
        got = {k: z[k] for k in z.files}
    for k, w in _flat(grads).items():
        _of_max(got["grad:" + k], w, 1e-5, "grad " + k)
    for k, w in _flat(params).items():
        _of_max(got["param:" + k], w, 1e-5, "param " + k)
    held = ranks[0]["shapes_held"]
    d_model, d_ff = LM_DIMS[1], LM_DIMS[4]
    if leg == "tp":  # half of every tp-sharded weight in each process
        assert held["layers.0.wq"] == [d_model // 2, d_model]
        assert held["layers.0.wo"] == [d_model, d_model // 2]
        assert held["layers.0.w1"] == [d_ff // 2, d_model]
        assert held["layers.0.w2"] == [d_model, d_ff // 2]
    if leg == "ep":  # half of the experts
        assert held["layers.1.moe.w_up"][0] == EXPERTS // 2
    assert held["embed"] == [LM_DIMS[0], d_model]
    # the collectives of a step after the first: tp's all-reduces of the
    # row-parallel partials, sp's k / v gathers and gradient sums
    assert ranks[0]["collective_bytes_per_step"] > 0


def test_tp_step_matches_jax(axes_run):
    blob = axes_run["blob"]
    res = [r["steps"]["tp-step"] for r in axes_run["res"]]
    assert res[0]["digests"] == res[1]["digests"]
    assert res[0]["flat_mode"] is None and res[0]["state_sharded"]
    assert res[0]["shapes_held"]["fc1_weight"] == [16, 8]
    assert res[0]["shapes_held"]["fc2_weight"] == [4, 16]
    assert res[0]["shapes_held"]["fc2_bias"] == [4]
    with np.load(axes_run["out"] / "step_tp-step_rank0.npz") as z:
        got = {k: z[k] for k in z.files}
    opt = jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / B)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    step = jmx.parallel.ShardedTrainStep(_mlp(jmx), mesh, optimizer=opt,
                                         param_specs={k: P(*v) for k, v in SPECS.items()})
    step.compile()
    params, aux = step.place_params({k[4:]: v for k, v in blob.items() if k.startswith("arg:")},
                                    {})
    state = step.make_state(params)
    for t in range(STEPS):
        batch = {"data": jax.device_put(blob["data"][t], step.batch_sharding()),
                 "softmax_label": jax.device_put(blob["label"][t], step.batch_sharding())}
        params, aux, state, _ = step(params, aux, state, batch, t=t + 1)
    for k, v in params.items():
        _of_max(got["arg:" + k], np.asarray(v), 1e-6, k)
        _of_max(got["mom:" + k], np.asarray(state[k]), 1e-6, "momentum " + k)


def test_tp_step_guard_norm_spans_the_shards(axes_run):
    """The armed guard's grad-norm² of the two processes' step, each holding
    half of the sharded gradients, is the whole gradient's: one process's
    guard over a logical tp 2 mesh, within 1e-6, every step passing."""
    import torch

    blob = axes_run["blob"]
    got = axes_run["res"][0]["steps"]["tp-step"]["guard_diag"]
    assert got == axes_run["res"][1]["steps"]["tp-step"]["guard_diag"]
    with tmx.cpu():
        mesh = tmx.parallel.make_mesh(dp=1, tp=2, devices=[tmx.cpu()] * 2)
        opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / B)
        step = tmx.parallel.ShardedTrainStep(_mlp(tmx), mesh, optimizer=opt, param_specs=SPECS)
        step.arm_guard()
        params, aux = step.place_params(
            {k[4:]: v for k, v in blob.items() if k.startswith("arg:")}, {})
        state = step.make_state(params)
        want = []
        for t in range(STEPS):
            batch = {"data": torch.from_numpy(blob["data"][t]),
                     "softmax_label": torch.from_numpy(blob["label"][t])}
            params, aux, state, outs = step(params, aux, state, batch, t=t + 1)
            want.append(outs[-1].tolist())
    assert [row[2] for row in got] == [1.0] * STEPS
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6, atol=0)


def test_tp_module_checkpoint_matches_jax(axes_run, monkeypatch):
    blob = axes_run["blob"]
    res = [r["tp_module"] for r in axes_run["res"]]
    assert res[0]["fused"] and res[0]["flat_mode"] is None and res[0]["state_sharded"]
    assert res[0]["shapes_held"]["fc1_weight"] == [16, 8]
    assert res[0]["digests"] == res[1]["digests"]
    assert any(f.startswith("ckpt-") for f in res[0]["ckpt_files"]), res[0]["ckpt_files"]
    X, y = blob["data"].reshape(-1, 8), blob["label"].reshape(-1)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    mod = jmx.mod.Module(_mlp(jmx), context=jmx.cpu(), mesh=mesh,
                         param_specs={k: P(*v) for k, v in SPECS.items()})
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")  # the JAX store synchronous
    mod.fit(jmx.io.NDArrayIter(X, y, batch_size=B), kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k[4:]: jmx.nd.array(v) for k, v in blob.items() if k.startswith("arg:")},
            num_epoch=1)
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    saved = jmx.nd.load(str(axes_run["out"] / "tp_module-0001.params"))
    for k, w in want.items():
        assert not np.array_equal(w, blob["arg:" + k])
        _of_max(saved["arg:" + k].asnumpy(), w, 1e-6, k)
