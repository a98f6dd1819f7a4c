"""The port's perf tools (``mxnet_tpu_torch/tools/{trace_summary,
perf_doctor,fleet_top}.py``) against the repo's (``tools/``) on the same
inputs, made from a seed: the same span and anatomy tables, the same
doctor's report (its hardware advice aside), the same fleet table and
Prometheus checks; their self-tests; and the doctor on a real fit's
JSONL of the port."""
import json

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.tools import fleet_top as tfleet_top
from mxnet_tpu_torch.tools import perf_doctor as tdoc
from mxnet_tpu_torch.tools import trace_summary as tsum
from tools import fleet_top as jfleet_top
from tools import perf_doctor as jdoc
from tools import trace_summary as jsum

PHASES = ("input_wait", "stage_host", "dispatch_host", "device_sync", "collective")


def _jsonl(path, seed=0, intervals=6):
    """A telemetry stream: spans, anatomy intervals (a warm-up first),
    recompiles, an op-cost table and a metrics snapshot."""
    rng = np.random.RandomState(seed)
    recs = []
    t = 1000.0
    for i in range(30):
        name = ("fit.step", "module.update", "train_step.dispatch")[i % 3]
        dur = float(rng.rand() * 0.01)
        recs.append({"type": "span", "name": name, "ts": t, "dur": dur, "depth": i % 3,
                     "thread": 1, "attrs": {}})
        t += dur
    for i in range(intervals):
        phases = {p: float(rng.rand() * 0.02) for p in PHASES}
        unattr = 1.5 if i == 0 else float(rng.rand() * 0.005)
        wall = sum(phases.values()) + unattr
        recs.append({"type": "anatomy", "t": t + i, "interval": i, "step_end": 8 * (i + 1),
                     "steps": 8, "wall_seconds": wall, "step_ms": 1000 * wall / 8,
                     "phases": phases, "unattributed_seconds": wall - sum(phases.values()),
                     "recompiles": int(i == 2), "flops_per_step": 1e9, "bytes_per_step": 3e8,
                     "mfu": float(rng.rand() * 0.5), "device_kind": "",
                     "multistep": {"k": 4, "auto": True, "settled": i > 2,
                                   "dispatch_frac": 0.03},
                     "roofline": {"t_compute": 0.01, "t_memory": 0.02, "t_comm": None,
                                  "bound": "host"}})
    recs.append({"type": "recompile", "t": t, "program": 3,
                 "diff": {"changed": {"data": {"shape": {"was": [8, 8], "now": [4, 8]}}},
                          "added": [], "removed": []}})
    recs.append({"type": "op_costs", "t": t, "device_kind": "", "compute_dtype": "bf16",
                 "n_ops": 3, "ops": [
                     {"name": "bn0", "op": "BatchNorm", "flops": 8e6, "bytes": 6e6,
                      "numel_out": 1000000},
                     {"name": "relu0", "op": "Activation", "flops": 1e6, "bytes": 4e6,
                      "numel_out": 1000000},
                     {"name": "conv0", "op": "Convolution", "flops": 9e9, "bytes": 3e6,
                      "numel_out": 1000000}]})
    hist = {"kind": "histogram", "streams": [{"labels": {"epoch": "0"}, "sum": 0.4,
                                              "count": 48, "counts": [0] * 5 + [40, 8] + [0] * 10,
                                              "buckets": [0.0005, 0.001, 0.0025, 0.005, 0.0075,
                                                          0.01, 0.025, 0.05, 0.075, 0.1, 0.25,
                                                          0.5, 0.75, 1.0, 2.5, 5.0]}]}
    recs.append({"type": "metrics", "ts": t, "seq": 1, "metrics": {
        "fit.step_seconds": hist,
        "serve.requests": {"kind": "counter", "streams": [{"labels": {}, "value": 12}]},
        "serve.batches": {"kind": "counter", "streams": [{"labels": {}, "value": 4}]},
        "guard.trips": {"kind": "counter", "streams": [{"labels": {}, "value": 1}]}}})
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_summary_same_tables(tmp_path, seed):
    path = str(tmp_path / "t.jsonl")
    _jsonl(path, seed)
    assert tsum.summarize_many([path]) == jsum.summarize_many([path])
    assert tsum.summarize_many([path], top=2) == jsum.summarize_many([path], top=2)
    assert tsum.format_anatomy(tsum.load_anatomy(path)) == \
        jsum.format_anatomy(jsum.load_anatomy(path))


@pytest.mark.parametrize("keep_all", [False, True])
def test_perf_doctor_same_report(tmp_path, monkeypatch, keep_all):
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_TFLOPS", "100")
    monkeypatch.setenv("MXTPU_ANATOMY_PEAK_GBPS", "1000")
    path = str(tmp_path / "t.jsonl")
    _jsonl(path, 3)

    def lines(text):
        # the candidates' footer names each package's kernel route
        return [line for line in text.splitlines() if not line.startswith("  (per forward")]

    got = tdoc.report(path, keep_all=keep_all)
    assert lines(got) == lines(jdoc.report(path, keep_all=keep_all))
    assert "diagnosis: largest cost is" in got and "kernel candidates" in got
    assert "hand-written CUDA" in got


def test_perf_doctor_amp_advice_on_the_card():
    recs = [{"compute_dtype": "f32", "device_kind": "NVIDIA H100 80GB HBM3"}]
    assert "MXTPU_AMP=bf16" in tdoc.amp_advice(recs)
    assert tdoc.amp_advice([{"compute_dtype": "bf16", "device_kind": "NVIDIA H100 80GB HBM3"}]) \
        is None
    assert tdoc.amp_advice([{"compute_dtype": "f32", "device_kind": ""}]) is None


def test_fleet_top_same_table_and_checks(tmp_path):
    for rank in range(3):
        jfleet_top._write_rank(str(tmp_path), rank, intervals=3,
                               slow_phase="device_sync" if rank == 1 else None,
                               slow=0.05 if rank == 1 else 0.0)
    j = jfleet_top.fleet.FleetAggregator(str(tmp_path)).refresh().summary()
    t = tfleet_top.fleet.FleetAggregator(str(tmp_path)).refresh().summary()
    strip = ("hb_age", "prog_age", "clock_offset")
    for s in (j, t):
        for pr in s["per_rank"].values():
            for k in strip:
                pr[k] = None
    assert tfleet_top.render_table(t) == jfleet_top.render_table(j)
    text = tfleet_top.fleet.FleetAggregator(str(tmp_path)).refresh().registry.render_prometheus()
    assert tfleet_top.check_prometheus_text(text) == jfleet_top.check_prometheus_text(text) == []
    bad = 'metric{le="nope} 1\n'
    assert tfleet_top.check_prometheus_text(bad) == jfleet_top.check_prometheus_text(bad)


@pytest.mark.parametrize("tool", [tsum, tdoc, tfleet_top])
def test_self_tests(tool, capsys):
    if tool is tfleet_top:
        with pytest.raises(SystemExit) as exc:
            tool.main(["--self-test"])
        assert exc.value.code == 0
    else:
        assert tool.main(["--self-test"]) == 0


def test_doctor_on_a_fit_of_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_ANATOMY_INTERVAL", "4")
    path = str(tmp_path / "fit.jsonl")
    ttm.reset()
    ttm.enable(jsonl=path)
    try:
        with tmx.cpu():
            rng = np.random.RandomState(0)
            x, y = rng.randn(64, 8).astype("f"), rng.randint(0, 4, 64).astype("f")
            data = tmx.sym.Variable("data")
            net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc1")
            net = tmx.sym.SoftmaxOutput(net, name="softmax")
            mod = tmx.mod.Module(net, context=[tmx.cpu(i) for i in range(4)])
            mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), kvstore="device", num_epoch=1,
                    optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    finally:
        ttm.reset()
        ttm.disable()
    text = tdoc.report(path)
    assert "== step anatomy ==" in text and "diagnosis: largest cost is" in text
    assert tsum.main([path, "--anatomy"]) == 0
    assert tsum.main([path]) == 0
