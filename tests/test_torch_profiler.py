"""The port's profiler (``mxnet_tpu_torch/profiler.py``) on the CPU: the
host chrome trace as the JAX package writes it (complete events, the
auto-flush on stop, ``scope`` / ``record_event``), ``torch.profiler``
driven by ``profiler_set_state`` with telemetry spans as
``record_function`` ranges in the exported Kineto trace,
``start_trace`` / ``stop_trace`` and the JAX names that raise, and
``attribute_trace``: device ms by kernel (K1–K5 labelled) and by the
framework op whose range encloses each kernel's launch, on a Kineto
trace made from a seed."""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttm


@pytest.fixture(autouse=True)
def _isolate():
    ttm.reset()
    ttm.disable()
    yield
    if tprof._state["running"]:
        tprof.profiler_set_state("stop")
    ttm.reset()
    ttm.disable()


def _host_trace(prof, path):
    prof.profiler_set_config(mode="all", filename=path)
    prof.profiler_set_state("run")
    prof.record_event("fwd", 0.0, 1000.0)
    prof.record_event_complete("bwd", 1500.0, 500.0, category="framework", args={"k": 3})
    with prof.scope("upd"):
        pass
    prof.profiler_set_state("stop")  # the auto-flush writes the file
    return json.load(open(path))["traceEvents"]


def test_host_trace_like_the_jax_packages(tmp_path):
    j = _host_trace(jprof, str(tmp_path / "j.json"))
    t = _host_trace(tprof, str(tmp_path / "t.json"))

    def shape(events):
        return [(e["name"], e["ph"], e.get("cat"), e.get("args") if e["ph"] == "X" and
                 e["name"] != "upd" else None) for e in events if e["ph"] == "X"]

    assert shape(t) == shape(j)
    assert [e for e in t if e["ph"] == "M"][0]["args"]["name"] == "mxnet_tpu_torch host"
    # idempotent: an explicit dump rewrites the same events
    tprof.dump_profile()
    assert [e["name"] for e in json.load(open(str(tmp_path / "t.json")))["traceEvents"]] == \
        [e["name"] for e in t]
    assert os.path.exists(tprof.kineto_path(str(tmp_path / "t.json")))


def test_spans_become_ranges_in_the_kineto_trace(tmp_path):
    import torch

    ttm.enable()
    tprof.profiler_set_config(filename=str(tmp_path / "p.json"))
    tprof.profiler_set_state("run")
    with ttm.span("fit.step"):
        with ttm.span("module.update"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    tprof.profiler_set_state("stop")
    events = json.load(open(tprof.kineto_path()))["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"fit.step", "module.update"} <= set(ranges)
    outer, inner = ranges["fit.step"], ranges["module.update"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    mm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] in ("aten::mm",
                                                                          "aten::matmul")]
    assert mm and inner["ts"] <= mm[0]["ts"] <= inner["ts"] + inner["dur"]


def test_start_stop_trace_and_the_jax_names(tmp_path):
    import torch

    tprof.start_trace(str(tmp_path / "tr"))
    with pytest.raises(RuntimeError):
        tprof.start_trace(str(tmp_path / "tr"))
    ttm.enable()
    with ttm.span("traced"):
        torch.ones(8).sum()
    path = tprof.stop_trace()
    assert path == str(tmp_path / "tr" / "kineto.json")
    assert "traced" in {e["name"] for e in json.load(open(path))["traceEvents"]
                        if e.get("cat") == "user_annotation"}
    for fn in (tprof.start_jax_trace, lambda *_: tprof.stop_jax_trace()):
        with pytest.raises(NotImplementedError, match="start_trace"):
            fn(str(tmp_path))


def _kineto(rng, path):
    """A Kineto-format trace: two framework ranges on the host thread,
    launches inside them (one outside any), and the device kernels each
    launch's correlation id points at; returns the expected tables."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "train_step.dispatch", "pid": 1,
               "tid": 7, "ts": 0.0, "dur": 1000.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::convolution_backward", "pid": 1,
               "tid": 7, "ts": 100.0, "dur": 200.0},
              {"ph": "X", "cat": "user_annotation", "name": "module.sync_params", "pid": 1,
               "tid": 7, "ts": 2000.0, "dur": 500.0},
              {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "pid": 1,
               "tid": 7, "ts": 0.0, "dur": 5000.0}]
    names = ["conv_wgrad_sm90<64, 1, 0, 1>", "conv_dgrad_sm90<64, 1>", "slab_update_kernel",
             "conv_wgrad_reduce_kernel", "volta_sgemm", "my_rtc_kernel"]
    kernels, ops = {}, {}
    corr = 0
    for i in range(40):
        corr += 1
        name = names[int(rng.randint(len(names)))]
        where = int(rng.randint(4))
        ts = {0: 50.0, 1: 150.0, 2: 2100.0, 3: 3000.0}[where]
        op = {0: "train_step.dispatch", 1: "aten::convolution_backward",
              2: "module.sync_params", 3: "?"}[where]
        dur = float(rng.randint(1, 100))
        cat = "cuda_driver" if name == "my_rtc_kernel" else "cuda_runtime"
        events.append({"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": 1, "tid": 7,
                       "ts": ts + i * 0.01, "dur": 1.0, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
                       "ts": 10000.0 + i, "dur": dur, "args": {"correlation": corr}})
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += dur / 1e3
        k[1] += 1
        o = ops.setdefault(op, [0.0, 0])
        o[0] += dur / 1e3
        o[1] += 1
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return kernels, ops


def test_attribute_trace_by_kernel_and_by_op(tmp_path):
    path = str(tmp_path / "k.json")
    kernels, ops = _kineto(np.random.RandomState(21), path)
    tprof.register_kernel_label("my_rtc_kernel", "K5")
    out = tprof.attribute_trace(path, top=None)
    got = {r["kernel"]: (r["ms"], r["launches"], r["label"]) for r in out["kernels"]}
    labels = {"conv_wgrad_sm90<64, 1, 0, 1>": "K2", "conv_dgrad_sm90<64, 1>": "K3",
              "slab_update_kernel": "K1", "conv_wgrad_reduce_kernel": "K2",
              "volta_sgemm": None, "my_rtc_kernel": "K5"}
    assert got.keys() == kernels.keys()
    for name, (ms, n) in kernels.items():
        assert got[name][0] == pytest.approx(ms) and got[name][1] == n
        assert got[name][2] == labels[name]
    byop = {r["op"]: (r["ms"], r["launches"]) for r in out["ops"]}
    assert byop.keys() == ops.keys()
    for name, (ms, n) in ops.items():
        assert byop[name][0] == pytest.approx(ms) and byop[name][1] == n
    assert out["device_ms"] == pytest.approx(sum(ms for ms, _ in kernels.values()))
    assert out["unattributed_ms"] == pytest.approx(ops.get("?", [0.0])[0])
    assert [r["ms"] for r in out["kernels"]] == sorted((r["ms"] for r in out["kernels"]),
                                                       reverse=True)
    assert len(tprof.attribute_trace(path, top=2)["kernels"]) == 2


def test_attribute_trace_reads_a_directory_and_gz(tmp_path):
    import gzip

    path = str(tmp_path / "k.json")
    _kineto(np.random.RandomState(3), path)
    with open(path, "rb") as src, gzip.open(str(tmp_path / "d" / "k.json.gz")
                                            if os.makedirs(str(tmp_path / "d")) is None
                                            else None, "wb") as dst:
        dst.write(src.read())
    a = tprof.attribute_trace(path)
    b = tprof.attribute_trace(str(tmp_path / "d"))
    assert a == b
    with pytest.raises(FileNotFoundError):
        tprof.attribute_trace(str(tmp_path / "empty_dir_missing"))


def test_profiler_set_state_rejects_unknown():
    with pytest.raises(ValueError):
        tprof.profiler_set_state("pause")
    assert jmx.profiler is jprof
