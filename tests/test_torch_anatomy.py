"""The port's step anatomy and cost model (``telemetry/anatomy.py``,
``telemetry/costmodel.py``) and ``MXNET_FIT_MULTISTEP=auto`` against the
JAX package's on the CPU: analytic FLOPs and per-op costs equal on an
MLP, LeNet and the cifar ResNet-8; the roofline classification; the H100
peak table; interval records with the same keys and, under a patched
clock and fixed peaks, the same values (1e-12); both tuners making the
same K decisions from the same totals; an ``auto`` fit on 4 logical host
ranks ending with the K = 1 fit's bits; ``MXTPU_ANATOMY_COSTS`` changing
no bit; the fit's phase-sum invariant, the recompile detector and the
cost capture's cache."""
import importlib
import json
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import telemetry as jtm
from mxnet_tpu.module import base_module as jbase
from mxnet_tpu.telemetry import anatomy as janat
from mxnet_tpu.telemetry import costmodel as jcm
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.module import base_module as tbase
from mxnet_tpu_torch.telemetry import anatomy as tanat
from mxnet_tpu_torch.telemetry import costmodel as tcm

_ENV = ("MXNET_FIT_MULTISTEP", "MXTPU_ANATOMY_INTERVAL", "MXTPU_ANATOMY_PEAK_TFLOPS",
        "MXTPU_ANATOMY_PEAK_GBPS", "MXTPU_ANATOMY_COSTS", "MXTPU_AMP", "MXTPU_DISPATCH_TARGET_FRAC",
        "MXNET_FIT_MULTISTEP_MAX", "MXTPU_MULTISTEP_AUTO_STEPS")


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for tm in (jtm, ttm):
        tm.reset()
        tm.disable()
    with tmx.cpu():
        yield
    for tm in (jtm, ttm):
        tm.reset()
        tm.disable()


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _model(pkg, name):
    """(symbol, input shapes) of a model, built in a fresh NameManager."""
    with pkg.name.NameManager():
        if name == "mlp":
            return _mlp(pkg), {"data": (8, 8), "softmax_label": (8,)}
        if name == "lenet":
            sym = importlib.import_module(pkg.__name__ + ".models.lenet").get_symbol(
                num_classes=10)
            return sym, {"data": (4, 1, 28, 28), "softmax_label": (4,)}
        sym = importlib.import_module(pkg.__name__ + ".models.resnet").get_symbol(
            num_classes=10, num_layers=8, image_shape="3,28,28")
        return sym, {"data": (4, 3, 28, 28), "softmax_label": (4,)}


@pytest.mark.parametrize("name", ["mlp", "lenet", "resnet8"])
def test_analytic_flops_and_op_costs_equal(name):
    jsym, shapes = _model(jmx, name)
    tsym, _ = _model(tmx, name)
    assert tcm.analytic_forward_flops(tsym, **shapes) == \
        jcm.analytic_forward_flops(jsym, **shapes)
    for width in (2, 4):
        got = tcm.analytic_op_costs(tsym, dtype_bytes=width, **shapes)
        assert got == jcm.analytic_op_costs(jsym, dtype_bytes=width, **shapes)
        assert got
    step = tcm.analytic_step_cost(tsym, **shapes)
    assert step["flops"] == 3 * tcm.analytic_forward_flops(tsym, **shapes)
    assert step["bytes_accessed"] > 0


def test_classify_and_candidates_equal(monkeypatch):
    grid = [(1e12, 1e11, 1.2, 0.0), (1e11, 1e12, 1.2, 0.0), (1e11, 1e11, 1.2, 0.9),
            (1e11, 1e11, 10.0, 0.0), (None, 5e10, 0.2, None)]
    for f, b, wall, comm in grid:
        for peaks in ((1e12, 1e12), (None, None), (3e12, 2e11)):
            assert tcm.classify(f, b, wall, comm, *peaks) == jcm.classify(f, b, wall, comm,
                                                                         *peaks)
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_TFLOPS", "10")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_GBPS", "100")
    jsym, shapes = _model(jmx, "resnet8")
    tsym, _ = _model(tmx, "resnet8")
    ops = tcm.analytic_op_costs(tsym, **shapes)
    assert tcm.rank_kernel_candidates(ops, kind="cpu", top=8) == \
        jcm.rank_kernel_candidates(jcm.analytic_op_costs(jsym, **shapes), kind="cpu", top=8)


def test_h100_peak_table_and_override(monkeypatch):
    assert tcm.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989.5e12
    assert tcm.peak_flops_for_kind("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert tcm.peak_bytes_for_kind("NVIDIA H100 80GB HBM3") == 3350e9
    assert tcm.peak_flops_for_kind("NVIDIA H100 PCIe") == 756.5e12
    assert tcm.peak_bytes_for_kind("NVIDIA H100 PCIe") == 2000e9
    assert tcm.peak_flops_for_kind("NVIDIA H100 NVL", "f32") == 60e12
    assert tcm.peak_flops_for_kind("") is None and tcm.peak_bytes_for_kind("cpu") is None
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_TFLOPS", "2.5")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_GBPS", "10")
    for dtype in (None, "f32", "bf16"):
        assert tcm.peak_flops_for_kind("cpu", dtype) == jcm.peak_flops_for_kind("cpu", dtype)
    assert tcm.peak_bytes_for_kind("cpu") == jcm.peak_bytes_for_kind("cpu") == 10e9


class _Compiled:
    def __init__(self, cost):
        self.cost = cost

    def cost_analysis(self):
        return {"flops": self.cost["flops"], "bytes accessed": self.cost["bytes_accessed"]}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _interval_records(tm, anat, monkeypatch, tmp_path, name, thunk, steps):
    """Two anatomy intervals from the same phase observations under a
    patched clock, with the package's cost capture of a 4-step group."""
    clock = _Clock()
    monkeypatch.setattr(anat.time, "perf_counter", clock)
    monkeypatch.setattr(anat, "_kind_cache", "cpu")
    jl = str(tmp_path / ("%s.jsonl" % name))
    tm.enable(jsonl=jl)
    anat.capture_cost(7, ("multi", 4), thunk, steps=steps, dtype="f32")
    anat.note_multistep(4, settled=False, dispatch_frac=0.25)
    anat.begin_loop()
    rng = np.random.RandomState(5)
    for _ in range(2):
        for phase in ("io.feed_wait_seconds", "module.stage_host_seconds",
                      "module.dispatch_host_seconds", "module.output_sync_seconds",
                      "parallel.collective_seconds"):
            for _ in range(4):
                tm.histogram(phase).observe(float(rng.rand() * 1e-3))
        clock.t += 0.0625
        anat.on_steps(4)
    anat.emit_interval(force=True)
    recs = [json.loads(line) for line in open(jl)]
    return [r for r in recs if r["type"] == "anatomy"]


def test_interval_records_same_keys_and_values(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_ANATOMY_INTERVAL", "8")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_TFLOPS", "0.001")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_GBPS", "10")
    step = {"flops": 1.25e7, "bytes_accessed": 3.5e6}
    # XLA's cost of a K-step scan is already one step's; the port's thunk
    # counts the K steps and capture_cost divides them back
    j = _interval_records(jtm, janat, monkeypatch, tmp_path, "jax",
                          lambda: _Compiled(step), steps=1)
    t = _interval_records(ttm, tanat, monkeypatch, tmp_path, "port",
                          lambda: {k: 4 * v for k, v in step.items()}, steps=4)
    assert len(j) == len(t) == 1
    skip = {"t", "pid", "host", "rank"}
    assert set(t[0]) == set(j[0])

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "."))
            else:
                out[prefix + k] = v
        return out

    jf, tf = flat({k: v for k, v in j[0].items() if k not in skip}), \
        flat({k: v for k, v in t[0].items() if k not in skip})
    assert set(jf) == set(tf)
    for k, v in jf.items():
        if isinstance(v, float):
            assert abs(tf[k] - v) <= 1e-12 * max(1.0, abs(v)), (k, tf[k], v)
        else:
            assert tf[k] == v, k
    assert 0 < t[0]["mfu"] <= 1
    total = sum(t[0]["phases"].values()) + t[0]["unattributed_seconds"]
    assert total == pytest.approx(t[0]["wall_seconds"], rel=1e-12, abs=1e-15)


def _feed_tuner(tuner, tm, monkeypatch, groups):
    """Run ``after_group`` over synthetic groups: each adds (wall, dispatch,
    stage, input) seconds; returns K after each group."""
    clock = _Clock()
    totals = {"dispatch": 0.0, "stage": 0.0, "input": 0.0}
    monkeypatch.setattr(type(tuner), "_totals", lambda self: dict(totals))
    ks = []
    with monkeypatch.context() as m:
        m.setattr(time, "perf_counter", clock)
        for wall, disp, stage, feed in groups:
            clock.t += wall
            totals["dispatch"] += disp
            totals["stage"] += stage
            totals["input"] += feed
            tuner.after_group(tuner.k)
            ks.append((tuner.k, tuner.settled))
    return ks


@pytest.mark.parametrize("profile", ["grows_then_settles", "settles_at_once", "hits_cap"])
def test_tuners_make_the_same_decisions(monkeypatch, profile):
    monkeypatch.setenv("MXTPU_MULTISTEP_AUTO_STEPS", "4")
    monkeypatch.setenv("MXNET_FIT_MULTISTEP_MAX", "16")
    rng = np.random.RandomState(len(profile))
    groups = []
    for i in range(40):
        share = {"grows_then_settles": 0.5 / (1 + i), "settles_at_once": 0.01,
                 "hits_cap": 0.9}[profile]
        wall = 0.01 + rng.rand() * 1e-3
        stage = wall * 0.05
        groups.append((wall, stage + wall * share * 0.5, stage, wall * 0.01))
    ttm.enable()
    jtm.enable()
    out = {}
    for name, base in (("jax", jbase), ("port", tbase)):
        tuner = base._MultistepAutoTuner()
        out[name] = _feed_tuner(tuner, ttm if name == "port" else jtm, monkeypatch, groups)
    assert out["port"] == out["jax"]
    assert out["port"][-1][1]  # settled


def _blobs(n=128, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, 8) * 3
    x = np.concatenate([c + rng.randn(n // 4, 8) * 0.3 for c in centers]).astype("f")
    y = np.repeat(np.arange(4), n // 4).astype("f")
    perm = rng.permutation(n)
    return x[perm], y[perm]


def _weights():
    rng = np.random.RandomState(3)
    shapes = {"fc1_weight": (16, 8), "fc1_bias": (16,), "fc2_weight": (4, 16), "fc2_bias": (4,)}
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32) for n, s in shapes.items()}


def _port_fit(monkeypatch, k, num_epoch=3, momentum=0.9):
    if k == 1:
        monkeypatch.delenv("MXNET_FIT_MULTISTEP", raising=False)
    else:
        monkeypatch.setenv("MXNET_FIT_MULTISTEP", str(k))
    it = tmx.io.NDArrayIter(*_blobs(), batch_size=8)
    mod = tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(i) for i in range(4)])
    args = {n: tmx.nd.array(v) for n, v in _weights().items()}
    mod.fit(it, kvstore="device", optimizer="sgd", num_epoch=num_epoch, arg_params=args,
            optimizer_params={"learning_rate": 0.1, "momentum": momentum})
    assert mod._fused_trainer is not None
    arg, _ = mod.get_params()
    return mod, {n: a.asnumpy() for n, a in arg.items()}


def test_auto_fit_ends_with_the_k1_fit_bits(monkeypatch, tmp_path):
    """The tuner grows K over 4 logical host ranks (the CPU's dispatch is
    most of its wall) and the fit ends with the eager fit's bits."""
    _, want = _port_fit(monkeypatch, 1)
    jl = str(tmp_path / "t.jsonl")
    ttm.enable(jsonl=jl)
    monkeypatch.setenv("MXTPU_MULTISTEP_AUTO_STEPS", "2")
    monkeypatch.setenv("MXNET_FIT_MULTISTEP_MAX", "4")
    mod, got = _port_fit(monkeypatch, "auto")
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    recs = [json.loads(line) for line in open(jl)]
    decisions = [r for r in recs if r["type"] == "multistep_auto"]
    assert decisions and decisions[-1]["settled"], decisions
    assert {g["k"] for g in mod._fused_trainer.group_stats()} <= {decisions[-1]["k"]}
    anat = [r for r in recs if r["type"] == "anatomy"]
    assert anat and all(r["multistep"]["auto"] for r in anat)


def test_auto_without_telemetry_freezes_at_k2(monkeypatch):
    _, want = _port_fit(monkeypatch, 2, num_epoch=1)
    _, got = _port_fit(monkeypatch, "auto", num_epoch=1)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_cost_capture_changes_no_bit(monkeypatch, tmp_path):
    ttm.enable(jsonl=str(tmp_path / "a.jsonl"))
    out = []
    for costs in ("1", "0"):
        monkeypatch.setenv("MXTPU_ANATOMY_COSTS", costs)
        ttm.reset()
        ttm.enable(jsonl=str(tmp_path / ("c%s.jsonl" % costs)))
        out.append(_port_fit(monkeypatch, 2, num_epoch=1)[1])
    for n in out[0]:
        np.testing.assert_array_equal(out[0][n], out[1][n], err_msg=n)
    priced = [json.loads(line) for line in open(str(tmp_path / "c1.jsonl"))]
    assert any("flops_per_step" in r for r in priced if r["type"] == "anatomy")
    unpriced = [json.loads(line) for line in open(str(tmp_path / "c0.jsonl"))]
    assert not any("flops_per_step" in r for r in unpriced if r["type"] == "anatomy")


def test_fit_anatomy_phase_sum_invariant(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_ANATOMY_INTERVAL", "4")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_TFLOPS", "1000")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_GBPS", "1000")
    jl = str(tmp_path / "t.jsonl")
    ttm.enable(jsonl=jl)
    x, y = _blobs(64)
    mod = tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(i) for i in range(4)])
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), kvstore="device", optimizer="sgd",
            num_epoch=2, optimizer_params={"learning_rate": 0.05})
    recs = [json.loads(line) for line in open(jl)]
    anat = [r for r in recs if r["type"] == "anatomy"]
    assert len(anat) >= 4 and sum(r["steps"] for r in anat) == 16
    for r in anat:
        assert set(r["phases"]) == {"input_wait", "stage_host", "dispatch_host",
                                    "device_sync", "collective"}
        assert abs(sum(r["phases"].values()) + r["unattributed_seconds"]
                   - r["wall_seconds"]) < 1e-9
        assert r["recompiles"] == 0 and "flops_per_step" in r
        assert r["roofline"]["bound"] in ("compute", "memory", "comm", "host", "unknown")
    ops = [r for r in recs if r["type"] == "op_costs"]
    assert len(ops) == 1 and ops[0]["n_ops"] > 0
    assert not [r for r in recs if r["type"] == "recompile"]
    assert ttm.snapshot()["anatomy.cost_cache_hits"]["streams"][0]["value"] > 0


def test_fit_recompile_flagged_once_per_new_shape(tmp_path):
    jl = str(tmp_path / "t.jsonl")
    ttm.enable(jsonl=jl)
    mod = tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(i) for i in range(4)])

    def fit(batch):
        x, y = _blobs(64)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), kvstore="device",
                optimizer="sgd", num_epoch=1, optimizer_params={"learning_rate": 0.05})

    def recompiles():
        return [json.loads(line) for line in open(jl)
                if json.loads(line)["type"] == "recompile"]

    fit(8)
    assert recompiles() == []
    fit(4)
    recs = recompiles()
    assert len(recs) == 1, recs
    assert recs[0]["diff"]["changed"]["data"]["shape"] == {"was": [8, 8], "now": [4, 8]}
    fit(4)
    assert len(recompiles()) == 1


def test_auto_fit_tail_after_settling_records_no_recompile(monkeypatch, tmp_path):
    """A depth that grows is a recompile (on the card a new capture); once
    the tuner has settled, the epoch's trailing partial group runs the
    eager single step, whose first signature is that program's warm-up."""
    for k, v in (("MXNET_FIT_MULTISTEP", "auto"), ("MXTPU_DISPATCH_TARGET_FRAC", "0"),
                 ("MXNET_FIT_MULTISTEP_MAX", "4"), ("MXTPU_MULTISTEP_AUTO_STEPS", "1"),
                 ("MXTPU_ANATOMY_INTERVAL", "4")):
        monkeypatch.setenv(k, v)
    jl = str(tmp_path / "t.jsonl")
    ttm.enable(jsonl=jl)
    # 14 batches: K = 2 twice (skip, grow), K = 4 twice (skip, settle), a tail of 2
    x, y = _blobs(112)
    mod = tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(i) for i in range(4)])
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), kvstore="device", optimizer="sgd",
            num_epoch=1, optimizer_params={"learning_rate": 0.05})
    recs = [json.loads(line) for line in open(jl)]
    decisions = [r for r in recs if r["type"] == "multistep_auto"]
    assert [(d["k"], d["settled"]) for d in decisions] == [(4, False), (4, True)], decisions
    settled_at = decisions[-1]["t"]
    anat = [r for r in recs if r["type"] == "anatomy"]
    assert sum(r["steps"] for r in anat) == 14
    after = [r for r in anat if r["t"] > settled_at]
    assert after and all(r["recompiles"] == 0 for r in after), after
    (grown,) = [r for r in recs if r["type"] == "recompile"]
    assert grown["t"] <= settled_at
    assert grown["diff"]["changed"]["data"]["shape"] == {"was": [2, 8, 8], "now": [4, 8, 8]}
    steps = {s["labels"]["path"]: s["value"]
             for s in ttm.snapshot()["train_step.steps"]["streams"]}
    assert steps == {"multi": 12, "single": 2}, steps


def test_capture_cost_cache_hit_miss():
    ttm.enable()
    calls = []

    def thunk():
        calls.append(1)
        return {"flops": 100.0, "bytes_accessed": 40.0}

    m0, h0 = tanat._C_COST_MISSES.value(), tanat._C_COST_HITS.value()
    c1 = tanat.capture_cost(1, ("single", "sig"), thunk)
    assert c1 == {"flops": 100.0, "bytes_accessed": 40.0}
    assert tanat.capture_cost(1, ("single", "sig"), thunk) == c1 and len(calls) == 1
    assert tanat._C_COST_MISSES.value() - m0 == 1 and tanat._C_COST_HITS.value() - h0 == 1
    assert tanat.capture_cost(2, ("multi",), thunk, steps=4) == {"flops": 25.0,
                                                                 "bytes_accessed": 10.0}

    def bad():
        calls.append(2)
        raise RuntimeError("no cost")

    assert tanat.capture_cost(3, ("single",), bad) is None
    assert tanat.capture_cost(3, ("single",), bad) is None
    assert calls.count(2) == 1


def test_fingerprint_diff_and_plan_miss_agree():
    prev = {"inputs": {"data": {"shape": [8, 8], "dtype": "float32", "sharding": "S(x)"},
                       "w": {"shape": [8, 4], "dtype": "float32", "sharding": "R"}},
            "mesh": "{'x': 4}"}
    now = {"inputs": {"data": {"shape": [4, 8], "dtype": "float32", "sharding": "S(x)"},
                      "b": {"shape": [4], "dtype": "float32", "sharding": "R"}},
           "mesh": "{'x': 8}"}
    assert tanat.fingerprint_diff(prev, now) == janat.fingerprint_diff(prev, now)
    ttm.enable()
    c0 = tanat._C_RECOMPILES.value()
    tanat.note_plan_miss(991, (("data", (8, 8), "float32", "S"),))
    assert tanat._C_RECOMPILES.value() == c0
    tanat.note_plan_miss(991, (("data", (4, 8), "float32", "S"),))
    assert tanat._C_RECOMPILES.value() == c0 + 1
    tanat.note_plan_miss(992, (("data", (8, 8), "float32", "S"),))
    assert tanat._C_RECOMPILES.value() == c0 + 1
