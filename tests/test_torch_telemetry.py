"""The port's telemetry (``mxnet_tpu_torch/telemetry``) against the JAX
package's on the CPU: the registry (the same metric operations give the
same Prometheus text, snapshots and percentiles; the label-cardinality
guard; ``union_edges`` / ``rebucket_counts``), spans (nesting, the
thread-local stack, errors, the JSONL sink), the exporters (JSONL and
Prometheus files, the fleet sink, ``sample_device_memory`` on the host),
the instrument sites under the JAX package's names (fit, Module,
executor, kvstore, Speedometer), and that no new module of the port
imports JAX or the JAX package."""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import telemetry as jtm
from mxnet_tpu.telemetry import registry as jreg
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.telemetry import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEW_MODULES = ("mxnet_tpu_torch.telemetry", "mxnet_tpu_torch.telemetry.tracer",
               "mxnet_tpu_torch.telemetry.export", "mxnet_tpu_torch.telemetry.costmodel",
               "mxnet_tpu_torch.telemetry.anatomy", "mxnet_tpu_torch.telemetry.fleet",
               "mxnet_tpu_torch.profiler", "mxnet_tpu_torch.monitor",
               "mxnet_tpu_torch.visualization", "mxnet_tpu_torch.tools.perf_doctor",
               "mxnet_tpu_torch.tools.trace_summary", "mxnet_tpu_torch.tools.fleet_top",
               "mxnet_tpu_torch.tools.serve")


@pytest.fixture(autouse=True)
def _isolate():
    for tm in (jtm, ttm):
        tm.reset()
        tm.disable()
    with tmx.cpu():
        yield
    for tm in (jtm, ttm):
        tm.reset()
        tm.disable()


def _same_ops(reg, seed=0):
    """One seeded sequence of metric operations on ``reg`` (a Registry of
    either package)."""
    rng = np.random.RandomState(seed)
    c = reg.counter("t.bytes", "byte counter")
    g = reg.gauge("t.depth", "a gauge")
    h = reg.histogram("t.lat", "latency")
    h2 = reg.histogram("t.edges", "own edges", buckets=(0.1, 1.0, 10.0))
    for i in range(200):
        c.inc(int(rng.randint(1, 100)), direction=("tx", "rx")[i % 2])
        g.set(float(rng.rand()), queue="q%d" % (i % 3))
        h.observe(float(rng.exponential(0.05)), op="fwd" if i % 3 else "bwd")
        h2.observe(float(rng.exponential(2.0)))
    g.inc(3, queue="q0")
    g.dec(1, queue="q1")
    h.observe(100.0)  # +Inf only
    return h


def _pair():
    jreg.set_enabled(True)
    treg.set_enabled(True)
    return jreg.Registry(), treg.Registry()


def test_same_operations_same_prometheus_text_snapshot_percentiles():
    jr, tr = _pair()
    jh, th = _same_ops(jr), _same_ops(tr)
    assert tr.render_prometheus() == jr.render_prometheus()
    assert tr.snapshot() == jr.snapshot()
    for q in (0, 1, 10, 50, 90, 99, 99.9, 100):
        for labels in ({"op": "fwd"}, {"op": "bwd"}, {}):
            assert th.percentile(q, **labels) == jh.percentile(q, **labels)
    for name in ("t.bytes", "t.depth", "t.lat", "t.edges", "absent"):
        assert tr.total(name) == jr.total(name)


@pytest.mark.parametrize("q", [50, 99])
def test_percentile_from_counts_agrees(q):
    rng = np.random.RandomState(int(q))
    edges = tuple(sorted(rng.rand(12) * 3))
    counts = [int(v) for v in rng.randint(0, 9, len(edges) + 1)]
    n = sum(counts)
    total = float(rng.rand() * n)
    assert treg.percentile_from_counts(edges, counts, n, total, q) == \
        jreg.percentile_from_counts(edges, counts, n, total, q)


def test_union_edges_and_rebucket_counts_agree():
    a, b = (0.1, 1.0, 10.0), (0.5, 1.0, 5.0, 20.0)
    assert treg.union_edges(a, b) == jreg.union_edges(a, b)
    dst = treg.union_edges(a, b)
    counts = [3, 4, 5, 6]
    assert treg.rebucket_counts(counts, a, dst) == jreg.rebucket_counts(counts, a, dst)


def test_merge_snapshot_same_registry_text():
    jr, tr = _pair()
    _same_ops(jr, seed=1)
    snap = jr.snapshot()
    outs = []
    for reg in (jreg.Registry(), treg.Registry()):
        assert reg.merge_snapshot(snap, rank=2, seq=1)
        assert not reg.merge_snapshot(snap, rank=2, seq=1)  # idempotent per (rank, seq)
        outs.append(reg.render_prometheus())
    assert outs[0] == outs[1]


def test_label_cardinality_guard(monkeypatch, caplog):
    ttm.enable()
    monkeypatch.setenv("MXTPU_METRIC_MAX_LABELS", "4")
    c = ttm.counter("t.cardinality", "guarded counter")
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.telemetry"):
        for i in range(10):
            c.inc(1, route="r%d" % i)
    assert len(c.label_sets()) == 5
    assert c.value(overflow="true") == 6
    warns = [r for r in caplog.records if "MXTPU_METRIC_MAX_LABELS" in r.getMessage()]
    assert len(warns) == 1
    c.inc(1, route="r0")
    assert c.value(route="r0") == 2
    h = ttm.histogram("t.cardhist", "guarded histogram")
    for i in range(6):
        h.observe(0.01, route="r%d" % i)
    assert h.count(overflow="true") == 2


def test_disabled_is_guarded_noop():
    c = ttm.counter("t.off", "off")
    c.inc(5)
    assert c.value() == 0
    assert ttm.span("t.a") is ttm.span("t.b")  # the shared null span


def test_span_nesting_jsonl_and_chrome_trace(tmp_path):
    from mxnet_tpu_torch import profiler

    jl = str(tmp_path / "t.jsonl")
    ttm.enable(jsonl=jl)
    profiler.profiler_set_config(filename=str(tmp_path / "profile.json"))
    profiler.profiler_set_state("run")
    with ttm.span("outer", step=1):
        with ttm.span("inner"):
            assert ttm.current_span().name == "inner"
    profiler.profiler_set_state("stop")
    with pytest.raises(ValueError):
        with ttm.span("broken"):
            raise ValueError("x")
    spans = [json.loads(line) for line in open(jl)]
    by = {s["name"]: s for s in spans if s["type"] == "span"}
    assert by["inner"]["depth"] == 1 and by["inner"]["attrs"]["parent"] == "outer"
    assert by["outer"]["attrs"]["step"] == 1 and by["broken"]["attrs"]["error"] == "ValueError"
    assert all({"rank", "pid", "host"} <= set(s) for s in spans)
    host = json.load(open(str(tmp_path / "profile.json")))["traceEvents"]
    assert {"outer", "inner"} <= {e["name"] for e in host if e.get("ph") == "X"}
    # while the profiler ran, each span was a record_function range too
    kineto = json.load(open(profiler.kineto_path()))["traceEvents"]
    ranges = {e["name"] for e in kineto if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= ranges, sorted(ranges)[:20]
    assert ttm.histogram("mxtpu.span_seconds").count(span="inner") == 1


def test_spans_are_thread_local():
    import threading

    ttm.enable()
    seen = {}

    def work(name):
        with ttm.span(name):
            seen[name] = ttm.current_span().parent

    with ttm.span("main"):
        t = threading.Thread(target=work, args=("worker",))
        t.start()
        t.join()
    assert seen["worker"] is None


def test_jsonl_and_prometheus_file_export(tmp_path):
    jl, prom = str(tmp_path / "t.jsonl"), str(tmp_path / "t.prom")
    ttm.enable(jsonl=jl, prometheus=prom, prometheus_interval=0)
    ttm.counter("t.flushed", "flushed").inc(3)
    ttm.flush()
    recs = [json.loads(line) for line in open(jl)]
    metrics = [r for r in recs if r["type"] == "metrics"]
    assert metrics and metrics[-1]["metrics"]["t.flushed"]["streams"][0]["value"] == 3
    assert "mxtpu_t_flushed 3" in open(prom).read()


def test_fleet_sink_and_clock_handshake(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_RUN_DIR", str(tmp_path))
    monkeypatch.setenv("DMLC_RANK", "3")
    monkeypatch.setattr(ttm.export, "_handshake_done", False)
    ttm.enable()
    assert ttm.jsonl_path() == str(tmp_path / "telemetry_r3.jsonl")
    with ttm.span("t.fleet"):
        pass
    rec = json.loads(open(ttm.jsonl_path()).readline())
    assert rec["rank"] == 3
    clock = json.load(open(str(tmp_path / "clock_3.json")))
    assert clock["rank"] == 3 and {"wall", "mono"} <= set(clock)


def test_sample_device_memory_on_host_records_nothing():
    ttm.enable()
    ttm.sample_device_memory()
    assert not [n for n in ttm.snapshot() if n.startswith("device.memory.")]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n" % (NEW_MODULES,))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=240)
    # and not in the source either (the tools load the port's modules)
    for name in NEW_MODULES:
        path = os.path.join(REPO, *name.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *name.split("."), "__init__.py")
        src = open(path).read()
        assert "import jax" not in src and "from jax" not in src, name
        assert "from mxnet_tpu." not in src and "import mxnet_tpu\n" not in src, name


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _blobs(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 8).astype("f"), rng.randint(0, 4, n).astype("f")


def _span_names(path):
    return {json.loads(line).get("name") for line in open(path)
            if json.loads(line).get("type") == "span"}


@pytest.mark.parametrize("kvstore", ["device", "local"])
def test_fit_records_the_jax_names(tmp_path, kvstore):
    """A Module.fit on four logical host ranks (fused with 'device', the
    executor and kvstore path with 'local') records the JAX package's
    span and metric names."""
    out = {}
    for name, pkg, tm in (("jax", jmx, jtm), ("port", tmx, ttm)):
        jl = str(tmp_path / ("%s.jsonl" % name))
        tm.enable(jsonl=jl)
        x, y = _blobs()
        mod = pkg.mod.Module(_mlp(pkg), context=[pkg.cpu(i) for i in range(4)])
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), kvstore=kvstore, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, num_epoch=1,
                batch_end_callback=pkg.callback.Speedometer(16, 2))
        tm.flush()
        snap = tm.snapshot()
        used = {n for n, m in snap.items()
                if any(s.get("count", s.get("value")) for s in m["streams"])}
        out[name] = (_span_names(jl), used)
        tm.reset()
        tm.disable()
    jspans, jused = out["jax"]
    tspans, tused = out["port"]
    # the spans and metrics of the loop, the module and the store; the JAX
    # package's compile, engine and device-feed ones have no counterpart
    want_spans = {"fit.step", "module.update", "module.sync_params"}
    if kvstore == "device":
        want_spans.add("train_step.dispatch")
    else:
        want_spans |= {"executor.fwdbwd", "model.update_params"}
    assert want_spans <= jspans and want_spans <= tspans, (jspans, tspans)
    want = {"fit.step_seconds", "fit.epoch_seconds", "mxtpu.span_seconds",
            "fit.samples_per_sec"}
    if kvstore == "device":
        want |= {"module.dispatch_host_seconds", "module.stage_host_seconds",
                 "module.output_sync_seconds", "train_step.steps", "train_step.flat_buckets",
                 "kvstore.bucket_bytes"}
    else:
        want |= {"executor.step_seconds", "kvstore.push_bytes", "kvstore.pull_bytes",
                 "kvstore.push_seconds", "kvstore.pull_seconds", "parallel.collective_seconds"}
    assert want <= jused and want <= tused, (want - jused, want - tused)
