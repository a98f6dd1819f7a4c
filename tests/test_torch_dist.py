"""The port across processes on the CPU (the process half of ROADMAP Queue 1
step 8): ``tools/dist_check.py`` launched on two processes over gloo
through the port's own launcher, held to the JAX package in one process.

- the three checks of ``tests/dist_worker.py`` (the dist kvstore's
  closed-form sum after an init broadcast, a barrier that waits, a fused
  step over a mesh that spans the processes);
- the two-process fused step on an MLP with BatchNorm (global batch
  statistics) in f32 and AMP, "shard" and "replicated", against JAX's
  one-process ``ShardedTrainStep`` over a dp = 2 mesh of the suite's host
  devices, from the same numpy parameters and batches: 1e-5 of max for f32
  (BatchNorm's moving statistics included), bf16 rounding for AMP;
- ``zero1`` against ``tests/test_parallel.py::
  test_zero1_opt_state_sharding_matches_replicated``'s run (dp = 8: four
  logical ranks in each process);
- the ``dist_sync`` Module fit (executor path, GradBucketer, each worker's
  own BatchNorm statistics) against JAX's one-process two-context
  ``kvstore="local"`` fit, and the ``dist_device_sync`` fit (the fused path
  across processes) against JAX's two-context ``kvstore="device"`` fit,
  within 1e-5 (the JAX kvstore synchronous, ``MXNET_KVSTORE_ASYNC=0``);
- the transformer trainer's ``--dp 2`` across two processes against one.

One launch serves most cases (a module fixture); each subprocess has its
own timeout.
"""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.tools import dist_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS = 16, 3
FIT_STEPS = 4


def _env(**extra):
    env = dict(os.environ)
    for k in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR", "MXTPU_AMP", "MXTPU_SHARD_UPDATE",
              "MXTPU_RUN_DIR", "MXTPU_FAULT_INJECT", "MXTPU_ELASTIC", "MXTPU_WORLD_SIZE",
              "DMLC_RANK", "DMLC_NUM_WORKER", "MXTPU_COORDINATOR_ADDRESS"):
        env.pop(k, None)
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2", PYTHONPATH=ROOT, **extra)
    return env


def launch(args, timeout=240, **env):
    """``tools/launch.py -n 2`` of ``args``; returns the CompletedProcess."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2"] + args
    return subprocess.run(cmd, cwd=ROOT, env=_env(**env), timeout=timeout,
                          capture_output=True, text=True)


def _mlp_bn_blob(path, pkg=jmx):
    """Symbol JSON, numpy parameters and STEPS global batches of the MLP
    with BatchNorm, for one dp rank in each of two processes."""
    sym = dist_check.fit_symbol(pkg, "mlp-bn")
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(B, 16), softmax_label=(B,))
    rng = np.random.RandomState(3)
    blob = {"arg:" + n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes) if n not in ("data", "softmax_label")}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        blob["aux:" + n] = (np.ones(s) if n.endswith("var") else np.zeros(s)).astype(np.float32)
    blob.update(symbol=np.array(sym.tojson()), steps=STEPS, local_ranks=1, lr=0.1, momentum=0.9,
                data=(rng.randn(STEPS, B, 16) * 2 + 0.5).astype(np.float32),
                label=rng.randint(0, 4, (STEPS, B)).astype(np.float32))
    np.savez(path, **blob)
    return blob


def _zero1_blob(path):
    """tests/test_parallel.py's zero1 run: the MLP, batch 16, Uniform(0.1)
    from np.random.seed(3), SGD lr 0.2 momentum 0.9, four steps, dp 8."""
    data = jmx.sym.Variable("data")
    net = jmx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = jmx.sym.Activation(net, act_type="relu")
    net = jmx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = jmx.sym.SoftmaxOutput(net, name="softmax")
    arg_shapes, _, _ = net.infer_shape(data=(16, 8), softmax_label=(16,))
    np.random.seed(3)
    init = jmx.initializer.Uniform(0.1)
    blob = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        arr = jmx.nd.zeros(s)
        init(n, arr)
        blob["arg:" + n] = arr.asnumpy()
    rng = np.random.RandomState(0)
    X = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 4).astype(np.float32)
    blob.update(symbol=np.array(net.tojson()), steps=4, local_ranks=4, lr=0.2, momentum=0.9,
                data=np.stack([X] * 4), label=np.stack([y] * 4))
    np.savez(path, **blob)
    return blob


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    blobs = {"mlp": _mlp_bn_blob(str(root / "mlp.npz")), "zero1": _zero1_blob(str(root / "z.npz"))}
    modes = ["f32-shard", "f32-replicated", "amp-shard", "amp-replicated"]
    steps = ",".join("%s=%s" % (m, root / "mlp.npz") for m in modes)
    steps += ",zero1=%s" % (root / "z.npz")
    out = root / "out"
    r = launch(["python", "-m", "mxnet_tpu_torch.tools.dist_check", "--out", str(out),
                "--device", "cpu", "--step-test", steps, "--fit", "dist_sync,dist_device_sync,dist_device_sync+localrescale",
                "--model", "mlp-bn", "--steps", str(FIT_STEPS), "--batch", str(B)],
               MXTPU_BUCKET_BYTES="1024")
    assert r.returncode == 0, "launch rc=%d\n%s\n%s" % (r.returncode, r.stdout[-3000:],
                                                       r.stderr[-5000:])
    res = [json.loads((out / ("rank%d.json" % i)).read_text()) for i in range(2)]
    return {"out": out, "res": res, "blobs": blobs}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _close_of_max(got, want, tol, keys=None):
    for k in keys or want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, "%s: max err %.3g > %.1g of max %.3g" % (k, err, tol, scale)


def test_three_checks_cross_the_process_boundary(dist_run, tmp_path):
    out = tmp_path / "checks"
    r = launch(["python", "-m", "mxnet_tpu_torch.tools.dist_check", "--out", str(out),
                "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-4000:]
    for rank in range(2):
        res = json.loads((out / ("rank%d.json" % rank)).read_text())
        assert res["ok"] and res["size"] == 2 and res["backend"] == "gloo"
        assert res["kvstore_value"] == res["kvstore_expected"] == 60.0
        assert res["params_identical"]
        first, last = res["fused_losses"]
        assert last < 0.5 * first
    assert json.loads((out / "rank0.json").read_text())["barrier_wait_s"] >= 1.0


def _jax_step(blob, mode, monkeypatch, dp):
    from jax.sharding import Mesh

    amp, shard, zero1 = dist_check.STEP_MODES[mode]
    monkeypatch.setenv("MXTPU_AMP", amp)
    monkeypatch.setenv("MXTPU_SHARD_UPDATE", shard)
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "0" if zero1 else "1024")
    sym = jmx.sym.load_json(str(blob["symbol"]))
    mesh = Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    X, y = blob["data"], blob["label"]
    opt = jmx.optimizer.create("sgd", learning_rate=float(blob["lr"]),
                               momentum=float(blob["momentum"]), rescale_grad=1.0 / X.shape[1])
    step = jmx.parallel.ShardedTrainStep(sym, mesh, optimizer=opt, zero1=zero1).compile()
    params, aux = step.place_params(
        {k[4:]: v for k, v in blob.items() if k.startswith("arg:")},
        {k[4:]: v for k, v in blob.items() if k.startswith("aux:")})
    state = step.make_state(params)
    params = step.amp_cast_params(params)
    for t in range(int(blob["steps"])):
        batch = {"data": jax.device_put(X[t], step.batch_sharding()),
                 "softmax_label": jax.device_put(y[t], step.batch_sharding())}
        params, aux, state, _ = step(params, aux, state, batch, t=t + 1)
    weights = step.master_params_named(state) if step.amp else params
    out = {"arg:" + k: np.asarray(v, np.float32) for k, v in weights.items()}
    out.update({"aux:" + k: np.asarray(v) for k, v in aux.items()})
    out.update({"w:" + k: np.asarray(v.astype(np.float32)) for k, v in params.items()})
    return out, step, state


@pytest.mark.parametrize("mode", ["f32-shard", "f32-replicated", "amp-shard", "amp-replicated"])
def test_two_process_step_matches_jax_dp2(dist_run, monkeypatch, mode):
    got = [_load(dist_run["out"] / ("step_%s_rank%d.npz" % (mode, r))) for r in range(2)]
    info = dist_run["res"][0]["steps"][mode]
    assert info["flat_mode"] == ("shard" if "shard" in mode else "replicated")
    assert info["amp"] == mode.startswith("amp")
    # the ranks end bit for bit equal, BatchNorm's moving statistics too
    assert info["digests"] == dist_run["res"][1]["steps"][mode]["digests"]
    want, _, _ = _jax_step(dist_run["blobs"]["mlp"], mode, monkeypatch, dp=2)
    assert sorted(got[0]) == sorted(want)
    init = dist_run["blobs"]["mlp"]
    assert any(not np.array_equal(got[0][k], init[k]) for k in init if k.startswith("arg:"))
    if mode.startswith("f32"):
        _close_of_max(got[0], want, 1e-5)
    else:
        # bf16 compute: the masters and statistics within bf16 rounding (2^-8
        # of each tensor's max), the bf16 weights within one bf16 step of it
        _close_of_max(got[0], want, 2.0 ** -8)


@pytest.mark.parametrize("mode", ["f32-shard", "amp-shard", "zero1"])
def test_sharded_state_is_each_process_block(dist_run, mode):
    """Across processes "shard" mode and zero1 hold 1/P of the sharded
    state in each process: the masters and state slabs (the momentum rows
    under zero1); gather_state gives the whole state back."""
    for rank in range(2):
        info = dist_run["res"][rank]["steps"][mode]
        assert info["state_sharded"]
        whole, held = info["state_elems_whole"], info["state_elems_held"]
        if mode == "zero1":
            # fc1's and fc2's weight rows divide dp = 8; the biases too
            assert held < whole
        else:
            # the loss scaler's two scalars are every process's
            assert held - 2 * mode.startswith("amp") == (whole - 2 * mode.startswith("amp")) // 2
    replicated = dist_run["res"][0]["steps"][mode.replace("shard", "replicated")] \
        if "shard" in mode else None
    if replicated is not None:
        assert not replicated["state_sharded"]
        assert replicated["state_elems_held"] == replicated["state_elems_whole"]


def test_zero1_matches_jax(dist_run, monkeypatch):
    got = [_load(dist_run["out"] / ("step_zero1_rank%d.npz" % r)) for r in range(2)]
    info = dist_run["res"][0]["steps"]["zero1"]
    assert info["zero1"] and info["flat_mode"] is None
    assert info["digests"] == dist_run["res"][1]["steps"]["zero1"]["digests"]
    want, step, state = _jax_step(dist_run["blobs"]["zero1"], "zero1", monkeypatch, dp=8)
    for k in want:
        if k.startswith("arg:"):
            np.testing.assert_allclose(got[0][k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # the momentum rows each process updated, gathered whole, are JAX's
    np.testing.assert_allclose(got[0]["mom:fc1_weight"], np.asarray(state["fc1_weight"]),
                               rtol=1e-5, atol=1e-6)


def test_zero1_on_logical_ranks_matches_jax(dist_run, monkeypatch):
    """zero1 on eight logical ranks of one process: the replicated update's
    numbers (as in JAX, zero1 changes layout only)."""
    import torch

    blob = dist_run["blobs"]["zero1"]
    want, _, _ = _jax_step(blob, "zero1", monkeypatch, dp=8)
    sym = tmx.sym.load_json(str(blob["symbol"]))
    with tmx.cpu():
        mesh = tmx.parallel.make_mesh(dp=8, devices=[tmx.cpu()] * 8)
        opt = tmx.optimizer.create("sgd", learning_rate=0.2, momentum=0.9, rescale_grad=1 / 16)
        step = tmx.parallel.ShardedTrainStep(sym, mesh, optimizer=opt, zero1=True)
        params, aux = step.place_params(
            {k[4:]: v for k, v in blob.items() if k.startswith("arg:")}, {})
        state = step.make_state(params)
        for t in range(4):
            batch = {"data": torch.from_numpy(blob["data"][t]),
                     "softmax_label": torch.from_numpy(blob["label"][t])}
            params, aux, state, _ = step(params, aux, state, batch, t=t + 1)
    assert step.flat_mode is None and not step.state_sharded
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want["arg:" + k], rtol=1e-5, atol=1e-6)


def _jax_fit(kvstore, monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "1024")
    for k in ("MXTPU_AMP", "MXTPU_SHARD_UPDATE"):
        monkeypatch.delenv(k, raising=False)
    X, y = dist_check.fit_data("mlp-bn", FIT_STEPS, B)
    np.random.seed(0)
    mod = jmx.mod.Module(dist_check.fit_symbol(jmx, "mlp-bn"),
                         context=[jmx.cpu(0), jmx.cpu(1)])
    mod.fit(jmx.io.NDArrayIter(X, y, batch_size=B), kvstore=kvstore, optimizer="sgd",
            optimizer_params=dict(dist_check.SGD), initializer=jmx.init.Xavier(),
            num_epoch=1)
    arg, aux = mod.get_params()
    out = {"arg:" + k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    return out


def test_dist_sync_fit_matches_jax_two_context_local(dist_run, monkeypatch):
    got = [_load(dist_run["out"] / ("fit_dist_sync_rank%d.npz" % r)) for r in range(2)]
    fit = dist_run["res"][0]["fits"]["dist_sync"]
    assert not fit["fused"] and fit["steps"] == FIT_STEPS
    assert fit["bucket_flushes_per_step"] >= 2  # MXTPU_BUCKET_BYTES=1024 splits the pushes
    want = _jax_fit("local", monkeypatch)
    args = [k for k in want if k.startswith("arg:")]
    _close_of_max(got[0], want, 1e-5, args)
    _close_of_max(got[1], want, 1e-5, args)
    # each worker keeps its own BatchNorm statistics; JAX's two contexts
    # average theirs, as the reference's executor group does
    mean_aux = {k: (got[0][k] + got[1][k]) / 2 for k in want if k.startswith("aux:")}
    assert any(not np.array_equal(got[0][k], got[1][k]) for k in mean_aux)
    _close_of_max(mean_aux, want, 1e-5, list(mean_aux))


def test_dist_device_sync_fit_matches_jax_two_context_device(dist_run, monkeypatch):
    got = [_load(dist_run["out"] / ("fit_dist_device_sync_rank%d.npz" % r)) for r in range(2)]
    fits = [dist_run["res"][r]["fits"]["dist_device_sync"] for r in range(2)]
    assert fits[0]["fused"] and fits[0]["flat_mode"] == "shard"
    assert fits[0]["digests"] == fits[1]["digests"]  # bit for bit, statistics too
    assert fits[0]["losses"] == fits[1]["losses"]
    want = _jax_fit("device", monkeypatch)
    _close_of_max(got[0], want, 1e-5)


@pytest.mark.parametrize("model", ["mlp-bn", "resnet8"])
def test_fit_data_batches_do_not_depend_on_steps(model):
    """A fit of one step and a fit of three see the same first batch (phase
    30's one-step control and witness are held to a three-step fit's first
    update)."""
    X1, y1 = dist_check.fit_data(model, 1, B)
    X3, y3 = dist_check.fit_data(model, 3, B)
    np.testing.assert_array_equal(X1, X3[:B])
    np.testing.assert_array_equal(y1, y3[:B])


def test_local_rescale_control_parts_from_jax(dist_run, monkeypatch):
    """The control of the check above: the same fused fit with the gradient
    rescaled by each process's 8 rows instead of the job's 16 (twice the
    gradient) is caught, far outside the 1e-5 limit."""
    got = _load(dist_run["out"] / "fit_dist_device_sync+localrescale_rank0.npz")
    want = _jax_fit("device", monkeypatch)
    worst = max(float(np.abs(got[k] - want[k]).max()) / max(1.0, float(np.abs(want[k]).max()))
                for k in want if k.startswith("arg:"))
    assert worst > 1e-3, worst


def test_transformer_trainer_dp2_across_processes(tmp_path):
    flags = ["--cpu", "--steps", "3", "--vocab", "32", "--d-model", "16", "--n-heads", "2",
             "--n-layers", "1", "--d-ff", "32", "--seq-len", "8", "--batch-size", "4"]
    r = launch(["python", "-m", "mxnet_tpu_torch.examples.train_transformer_lm", "--dp", "2"]
               + flags)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "mesh: dp 2 over 2 process(es)" in r.stdout
    # both ranks print to one pipe, whose lines may run together
    got = [float(v) for _, v in re.findall(r"step\s+(\d+)\s+loss\s+([0-9.]+)", r.stdout)]
    from mxnet_tpu_torch.examples import train_transformer_lm as trainer

    want = trainer.train(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, seq_len=8,
                         batch_size=4, steps=3, device="cpu", log=lambda *a: None)
    # each process prints the same global loss (4 decimals), which is one
    # process's over the whole batch
    assert len(got) == 2 * 2  # steps 0 and 2, printed by both ranks
    np.testing.assert_allclose(sorted(got), sorted([want[0], want[2]] * 2), atol=2e-4)


def test_multistep_over_processes_raises(monkeypatch):
    from mxnet_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    with tmx.cpu():
        m = tmesh.Mesh(["cpu"], {"dp": 2}, processes=2, process_rank=0)
        net = dist_check.fit_symbol(tmx, "mlp-bn")
        step = tmx.parallel.ShardedTrainStep(net, m, optimizer=tmx.optimizer.create("sgd"))
        with pytest.raises(tmx.base.MXNetError, match="cannot be captured"):
            step.compile_multi(2)


def test_multi_device_mesh_and_tp_still_raise():
    """A mesh over several devices of one process still raises (NCCL, the
    multi-card half); tp across processes and the trainer's --tp run
    (tests/test_torch_axes_dist.py holds them across two processes)."""
    import torch

    with pytest.raises(NotImplementedError, match="multi-card half"):
        tmx.parallel.make_mesh(dp=2, devices=[torch.device("cpu"), torch.device("meta")])
    m = tmx.parallel.mesh.Mesh(["cpu"] * 2, {"dp": 2, "tp": 2}, processes=2, process_rank=0)
    assert [m.coords(i)["tp"] for i in range(2)] == [0, 1] and m.positions("dp") == [0]
    from mxnet_tpu_torch.examples import train_transformer_lm as trainer

    assert trainer.main(["--cpu", "--steps", "1", "--tp", "2", "--vocab", "32", "--d-model",
                         "16", "--n-heads", "2", "--n-layers", "1", "--d-ff", "32",
                         "--seq-len", "8", "--batch-size", "2"]) == 0


_BUILDER = r"""
import os, sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
from mxnet_tpu_torch.ops import _build
_build.BUILD_DIR = Path({build!r})
_build.nvcc_path = lambda: {nvcc!r}
me = sys.argv[1]
Path({tmp!r}, "ready" + me).touch()
while not all(Path({tmp!r}, "ready" + r).exists() for r in "01"):
    time.sleep(0.01)
logs = _build.build(["slab_update"])
lib = _build.library_path("slab_update")
print(me, sorted(logs), lib.read_text().count("x"), flush=True)
"""

_FAKE_NVCC = r"""#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({count!r}, "a") as f:
    f.write("%d\n" % os.getpid())
with open(out, "w") as f:  # written slowly: a reader must never see it half done
    for _ in range(20):
        f.write("x" * 50)
        f.flush()
        time.sleep(0.05)
"""


def test_kernel_build_is_locked_across_processes(tmp_path):
    """Two processes build the same kernel at once (a launched job's first
    step): one compiles, the other waits for the lock and loads the whole
    library; no process sees a half-written one."""
    nvcc, count = tmp_path / "nvcc", tmp_path / "count"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, count=str(count)))
    nvcc.chmod(0o755)
    code = _BUILDER.format(root=ROOT, build=str(tmp_path / "kernels"), nvcc=str(nvcc),
                           tmp=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], stdout=subprocess.PIPE,
                              text=True, env=_env()) for i in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(count.read_text().split()) == 1  # one compile
    assert sorted(o[1] for o in outs) == ["['slab_update']", "[]"]
    assert all(o[2] == "1000" for o in outs)  # both loaded the whole library
    assert not list((tmp_path / "kernels").glob("*.tmp*"))
