"""The port's fleet plane (``telemetry/fleet.py``) against the JAX
package's on the CPU: the same report (summary, evidence, advice) from the
same synthetic run directory, the same clock offsets and liveness, the
skew decomposition's invariants, and ``/metrics`` scraped in the same
format (the endpoint alone, through ``telemetry.enable(metrics_port=)``
and through ``tools/serve.py --metrics-port``)."""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu  # noqa: F401  (the JAX package's import path)
from mxnet_tpu import telemetry as jtm
from mxnet_tpu.telemetry import fleet as jfleet
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.telemetry import fleet as tfleet
from mxnet_tpu_torch.tools import fleet_top

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolate():
    for tm in (jtm, ttm):
        tm.reset()
        tm.disable()
    yield
    for tm in (jtm, ttm):
        tm.reset()
        tm.disable()


def _run_dir(root, ranks=3, intervals=4, seed=0):
    """A seeded synthetic run dir: per-rank anatomy streams (one rank slow
    in its input phase), metrics snapshots with guard counters, clock
    handshakes and heartbeat files."""
    rng = np.random.RandomState(seed)
    fleet_top._write_rank(str(root), 0, intervals)
    fleet_top._write_rank(str(root), 1, intervals, extra_metrics={
        "guard.trips": {"kind": "counter", "streams": [{"labels": {}, "value": 2}]}})
    fleet_top._write_rank(str(root), 2, intervals, slow_phase="input_wait",
                          slow=0.1 + float(rng.rand()) * 0.1)
    now = time.time()
    for r in range(ranks):
        os.utime(os.path.join(str(root), "clock_%d.json" % r), (now + r, now + r))
        os.utime(os.path.join(str(root), "hb_%d" % r), (now - 2 * r, now - 2 * r))
    open(os.path.join(str(root), "stall_1"), "w").close()
    return str(root)


def _strip_ages(obj):
    """The report without the fields read from the clock at call time."""
    if isinstance(obj, dict):
        return {k: _strip_ages(v) for k, v in obj.items()
                if k not in ("hb_age", "prog_age", "clock_offset", "t_aligned")}
    if isinstance(obj, list):
        return [_strip_ages(v) for v in obj]
    return obj


def test_same_report_on_the_same_run_dir(tmp_path):
    run = _run_dir(tmp_path)
    j = jfleet.FleetAggregator(run).refresh()
    t = tfleet.FleetAggregator(run).refresh()
    assert _strip_ages(t.summary()) == _strip_ages(j.summary())
    assert _strip_ages(t.evidence()) == _strip_ages(j.evidence())
    assert t.advice() == j.advice()
    assert t.registry.render_prometheus() == j.registry.render_prometheus()
    assert t.summary()["straggler"] == 2 and t.summary()["bottleneck"] == "input"
    offs_j, offs_t = jfleet.read_clock_offsets(run), tfleet.read_clock_offsets(run)
    assert offs_t.keys() == offs_j.keys()
    for r in offs_t:
        assert offs_t[r]["offset"] == pytest.approx(offs_j[r]["offset"], abs=1e-6)
    now = time.time()
    assert tfleet.read_liveness(run, now=now) == jfleet.read_liveness(run, now=now)
    assert tfleet.discover(run) == jfleet.discover(run)


def test_decompose_keeps_its_invariants(tmp_path):
    run = _run_dir(tmp_path, intervals=3)
    agg = tfleet.FleetAggregator(run).refresh()
    for _, per in agg.intervals():
        d = agg.decompose(per)
        assert agg.check_interval(per, d) == []
        assert d == jfleet.FleetAggregator.decompose(per)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.headers.get("Content-Type"), r.read().decode()


def test_metrics_endpoint_scrapes_in_the_same_format(tmp_path):
    snap = {"fit.steps": {"kind": "counter", "streams": [{"labels": {}, "value": 12}]},
            "lat": {"kind": "histogram", "streams": [
                {"labels": {"op": "push"}, "sum": 2.0, "count": 3, "counts": [1, 2, 0],
                 "buckets": [1.0, 2.0]}]}}
    bodies = []
    for fleet in (jfleet, tfleet):
        reg = fleet.Registry()
        reg.merge_snapshot(snap, rank=0, seq=1)
        srv = fleet.MetricsServer(0, registry=reg, run_dir=str(tmp_path)).start()
        try:
            assert srv.addr == "127.0.0.1"
            base = "http://127.0.0.1:%d" % srv.port
            ctype, body = _get(base + "/metrics")
            assert ctype == fleet.PROM_CONTENT_TYPE
            bodies.append(body)
            ctype, health = _get(base + "/healthz")
            assert ctype == "application/json" and json.loads(health)["status"] == "ok"
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(base + "/nope")
            assert exc.value.code == 404
        finally:
            srv.stop()
    assert bodies[1] == bodies[0]
    assert fleet_top.check_prometheus_text(bodies[1]) == []


def test_enable_starts_singleton_endpoint():
    ttm.enable(metrics_port=0)
    try:
        srv = tfleet._server
        assert srv is not None
        ttm.enable(metrics_port=0)
        assert tfleet._server is srv
        ttm.counter("t.scraped", "scraped").inc(4)
        _, body = _get("http://127.0.0.1:%d/metrics" % srv.port)
        assert fleet_top.check_prometheus_text(body) == []
        assert "mxtpu_t_scraped 4" in body
    finally:
        ttm.reset()


def test_serve_metrics_port_serves_metrics_and_healthz(tmp_path):
    """``tools/serve.py --metrics-port 0`` on the host: requests over the
    socket, then /metrics counts them and /healthz answers; SIGTERM drains
    the server to exit 0."""
    from mxnet_tpu_torch.tools import serve as serve_tool

    bundle = str(tmp_path / "lenet.pred")
    serve_tool._build_toy_bundle(bundle)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve", "--bundle", bundle, "--input",
         "data=1x28x28", "--cpu", "--port", "0", "--metrics-port", "0", "--max-batch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    try:
        ports, lines = {}, []
        deadline = time.time() + 120
        while len(ports) < 2 and time.time() < deadline:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            m = re.match(r"(serving|metrics) on [\d.]+:(\d+)", line)
            if m:
                ports[m.group(1)] = int(m.group(2))
        assert len(ports) == 2, lines
        rng = np.random.RandomState(1)
        with socket.create_connection(("127.0.0.1", ports["serving"]), 30) as s:
            f = s.makefile("rwb")
            for _ in range(5):
                x = rng.randn(1, 28, 28).astype(np.float32)
                f.write((json.dumps({"inputs": {"data": x.tolist()}}) + "\n").encode())
                f.flush()
                assert "outputs" in json.loads(f.readline().decode())
        ctype, body = _get("http://127.0.0.1:%d/metrics" % ports["metrics"])
        assert fleet_top.check_prometheus_text(body) == []
        assert re.search(r"^mxtpu_serve_requests 5$", body, re.M), body[:1000]
        _, health = _get("http://127.0.0.1:%d/healthz" % ports["metrics"])
        assert json.loads(health)["status"] == "ok"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
