"""The PyTorch port's ServingEngine, int8 quantization, recompile
accounting, model server and serving bench, held against the JAX package
on the CPU: tests/test_serving.py's engine cases (coalesced rows bit for bit
against solo dispatch in the same bucket, drain, a missing input), its
int8 cases (``q`` and ``scale`` and ``dequantize`` bit for bit against the
JAX package's, top-1 agreement at least 0.99) and its zero-recompile case
read from the port's ``anatomy.recompiles``; the anatomy detector's rules
against JAX's; ``tools/serve.py --self-test --cpu`` and a SIGTERM drain as
subprocesses; ``tools/serving_bench.py`` with ``SERVE_SMOKE=1 --cpu``. The
bench's closed-loop speedup gate (at least 3x) is held on the card
(chip_smoke.py phase 22 (b)), not on a shared host."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import predict as jpredict
from mxnet_tpu.serving import engine as jse  # noqa: F401  (registers the JAX serve.* metrics)
from mxnet_tpu.serving import quant as jquant
from mxnet_tpu.telemetry import anatomy as janatomy
from mxnet_tpu.telemetry import registry as jregistry
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import mlp as tmlp
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serving import buckets, quant
from mxnet_tpu_torch.serving import engine as se
from mxnet_tpu_torch.serving.decode import GenerationEngine
from mxnet_tpu_torch.serving.engine import ServeClosed, ServingEngine
from mxnet_tpu_torch.telemetry import anatomy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TFM_DIMS = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32)


@pytest.fixture
def telemetry_on():
    was = telemetry.enabled()
    telemetry.enable()
    yield
    telemetry.registry.set_enabled(was)


def _mlp_params(in_dim=16):
    sym = tmlp.get_symbol(num_classes=10, hidden=(32,))
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(1, in_dim))
    return sym, {n: (rng.randn(*s) * 0.2).astype(np.float32)
                 for n, s in zip(sym.list_arguments(), arg_shapes)
                 if n not in ("data", "softmax_label")}


def _mlp_predictor(in_dim=16, quant=""):
    """tests/test_serving.py's MLP predictor, in the port on the host."""
    sym, params = _mlp_params(in_dim)
    with tmx.cpu():
        nd_params = {"arg:%s" % n: tmx.nd.array(v) for n, v in params.items()}
    return tpredict.Predictor(sym.tojson(), nd_params, {"data": (1, in_dim)},
                              ctx=tmx.cpu(), quant=quant)


def _jax_mlp_predictor(in_dim=16, quant=""):
    sym, params = _mlp_params(in_dim)
    nd_params = {"arg:%s" % n: jmx.nd.array(v) for n, v in params.items()}
    return jpredict.Predictor(sym.tojson(), nd_params, {"data": (1, in_dim)}, quant=quant)


# ---------------------------------------------------------------------------
# engine batching correctness (tests/test_serving.py:83-152)
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_engine_coalesces_and_rows_are_bitwise(telemetry_on):
    """Co-batched rows are BITWISE what the same row produces alone at the
    same position in the same bucket, allclose to the batch-1 dispatch,
    and within 1e-5 of the JAX engine's rows."""
    p = _mlp_predictor()
    eng = ServingEngine(p, max_batch=4, batch_timeout_ms=200.0)
    eng.start()
    batches0 = se._C_BATCHES.value()
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 16).astype(np.float32)
    futs = [eng.submit(data=xs[i]) for i in range(3)]
    outs = [f.result(30.0) for f in futs]
    eng.drain()
    assert se._C_BATCHES.value() - batches0 == 1  # one coalesced call

    jp = _jax_mlp_predictor()
    for i in range(3):
        solo = np.zeros((4, 16), np.float32)
        solo[i] = xs[i]
        same_bucket = p.predict_batch(data=solo)[0][i]
        assert outs[i][0].tobytes() == same_bucket.tobytes()
        unbatched = p.predict_batch(data=xs[i][None])[0][0]
        assert np.allclose(outs[i][0], unbatched, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(outs[i][0], np.asarray(jp.predict_batch(data=solo)[0])[i],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(120)
def test_engine_drain_finishes_inflight_and_rejects_new():
    p = _mlp_predictor()
    eng = ServingEngine(p, max_batch=4, batch_timeout_ms=1.0)
    eng.start()
    futs = [eng.submit(data=np.zeros(16, np.float32)) for _ in range(6)]
    eng.drain()
    for f in futs:  # everything accepted before drain completes
        assert len(f.result(1.0)) == 1
    with pytest.raises(ServeClosed):
        eng.submit(data=np.zeros(16, np.float32))
    eng.drain()  # idempotent


def test_engine_missing_input_rejected():
    p = _mlp_predictor()
    eng = ServingEngine(p, max_batch=2, batch_timeout_ms=1.0)
    with pytest.raises(MXNetError):
        eng.submit(wrong_name=np.zeros(16, np.float32))
    with pytest.raises(ServeClosed):  # not started
        eng.submit(data=np.zeros(16, np.float32))


def test_engine_keeps_the_order_of_other_signatures(monkeypatch):
    """_take_batch pops the head-of-line signature only; the rest keep
    their order."""
    p = _mlp_predictor()
    eng = ServingEngine(p, max_batch=4, batch_timeout_ms=0.0)
    eng._stopped = False
    a = [eng.submit(data=np.zeros(16, np.float32)) for _ in range(2)]
    b = eng.submit(data=np.zeros(16, np.float64))
    c = eng.submit(data=np.zeros(16, np.float32))
    d = eng.submit(data=np.zeros(16, np.float64))
    assert eng._take_batch() == a + [c]
    assert list(eng._queue) == [b, d]


def test_engine_knobs_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_MAX_BATCH", "16")
    monkeypatch.setenv("MXTPU_SERVE_BATCH_TIMEOUT_MS", "5")
    eng = ServingEngine(_mlp_predictor())
    assert eng.max_batch == 16 and eng.batch_buckets == [1, 2, 4, 8, 16]
    assert eng.batch_timeout == pytest.approx(0.005)


def test_engine_metrics_have_the_jax_names(telemetry_on):
    p = _mlp_predictor()
    eng = ServingEngine(p, max_batch=2, batch_timeout_ms=1.0).start()
    for f in [eng.submit(data=np.zeros(16, np.float32)) for _ in range(3)]:
        f.result(30.0)
    eng.drain()
    names = {"serve.queue_wait_seconds", "serve.e2e_seconds", "serve.queue_depth",
             "serve.batch_occupancy", "serve.requests", "serve.batches", "serve.pad_rows"}
    snap = telemetry.snapshot()
    assert names <= set(snap)
    for name in names:
        assert snap[name]["kind"] == jregistry.REGISTRY.get(name).kind


# ---------------------------------------------------------------------------
# int8 (tests/test_serving.py:197-236)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 64), (10, 32), (16, 3, 3, 3), (4, 200)])
def test_quantized_tensor_bits_equal_jax(shape):
    w = np.random.RandomState(3).randn(*shape).astype(np.float32)
    w[1] = 0.0  # a zero channel takes scale 1
    t, j = quant.QuantizedTensor.quantize(w), jquant.QuantizedTensor.quantize(w)
    assert t.q.dtype == np.int8 and t.q.tobytes() == j.q.tobytes()
    assert t.scale.dtype == np.float32 and t.scale.tobytes() == j.scale.tobytes()
    assert t.shape == j.shape and t.nbytes == j.nbytes
    back, jback = t.dequantize(), j.dequantize()
    assert back.dtype == jback.dtype and back.tobytes() == jback.tobytes()
    # symmetric per-channel int8: worst-case error is scale/2 per entry
    assert np.abs(back - w).max() <= (np.abs(w).max(axis=1 if w.ndim == 2 else (1, 2, 3))
                                      / 127).max()


def test_quantize_arg_params_picks_the_jax_tensors():
    _, params = _mlp_params()
    params["emb_weight"] = np.ones((3,), np.float32)  # 1-D: passes through
    params["tiny_weight"] = np.ones((4, 4), np.float32)  # < 64 elements
    t, j = quant.quantize_arg_params(params), jquant.quantize_arg_params(params)
    assert {n for n, v in t.items() if isinstance(v, quant.QuantizedTensor)} == \
        {n for n, v in j.items() if isinstance(v, jquant.QuantizedTensor)} == \
        {"fc1_weight", "fc2_weight"}
    for n in params:
        assert quant.maybe_dequantize(t[n]).tobytes() == jquant.maybe_dequantize(j[n]).tobytes()
    a = np.random.RandomState(5).randn(40, 10)
    assert quant.top1_agreement(a, a) == 1.0
    assert quant.top1_agreement(a, -a) == jquant.top1_agreement(a, -a)


def test_int8_quant_parity():
    f32 = _mlp_predictor()
    i8 = _mlp_predictor(quant="int8")
    xs = np.random.RandomState(2).randn(32, 16).astype(np.float32)
    a = f32.predict_batch(data=xs)[0]
    b = i8.predict_batch(data=xs)[0]
    assert quant.top1_agreement(a, b) >= 0.99
    jb = np.asarray(_jax_mlp_predictor(quant="int8").predict_batch(data=xs)[0])
    np.testing.assert_allclose(b, jb, rtol=1e-5, atol=1e-5)


def test_int8_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_QUANT", "int8")
    p = _mlp_predictor(quant=None)
    assert p.quant == "int8"
    assert isinstance(p._arg_params["fc1_weight"], quant.QuantizedTensor)


# ---------------------------------------------------------------------------
# recompile accounting (tests/test_serving.py:332-361)
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_zero_steady_state_recompiles_mixed_shapes(telemetry_on):
    """After warm-up, a mixed-shape request stream (every batch bucket,
    every prompt-length bucket) never compiles anew: the port's anatomy
    recompile counter and plan-miss counter stay flat."""
    p = _mlp_predictor()
    p.compile([{"data": (b, 16)} for b in buckets.bucket_ladder(4)])
    init_fn, _ = ttfm.transformer_lm(**_TFM_DIMS)
    model = ttfm.transformer_lm_serving(max_len=16, **_TFM_DIMS)
    gen = GenerationEngine(ttfm.params_from_jax(init_fn(0), device="cpu"), model,
                           slots=2, max_len=16, device="cpu")
    gen.compile()  # warm-up: every (count x length) bucket

    misses = telemetry.REGISTRY.get("executor.dispatch_plan_misses")
    r0, m0, seen0 = anatomy._C_RECOMPILES.value(), misses.value(), set(gen._seen_sigs)
    rng = np.random.RandomState(4)
    for b in (1, 3, 2, 4, 1, 4, 2, 3):  # mixed batch buckets
        xs = rng.randn(b, 16).astype(np.float32)
        bucket = buckets.covering_value(buckets.bucket_ladder(4), b)
        p.predict_batch(data=buckets.pad_batch(list(xs), bucket))
    for n in (3, 9, 2, 14):  # mixed prompt lengths
        gen.submit(rng.randint(1, 32, size=n), max_new=2)
    for _ in range(30):
        if not gen.step() and not gen._pending:
            break
    assert anatomy._C_RECOMPILES.value() - r0 == 0
    assert misses.value() - m0 == 0 and gen._seen_sigs == seen0


@pytest.mark.parametrize("enabled", [True, False])
def test_note_plan_miss_counts_as_jax(enabled):
    """The same miss sequence through both detectors: a program's first
    signature is its warm-up, each later new one counts; nothing counts
    while telemetry is off."""
    t_was, j_was = telemetry.enabled(), jregistry.enabled()
    telemetry.registry.set_enabled(enabled)
    jregistry.set_enabled(enabled)
    try:
        sig = lambda b: (("data", (b, 16), "float32", "serve"),)  # noqa: E731
        uid = "test:%d:%s" % (os.getpid(), enabled)
        t0, j0 = anatomy._C_RECOMPILES.value(), janatomy._C_RECOMPILES.value()
        for b in (1, 2, 4):
            anatomy.note_plan_miss(uid, sig(b))
            janatomy.note_plan_miss(uid, sig(b))
        anatomy.note_plan_miss(uid + ":other", sig(1))
        janatomy.note_plan_miss(uid + ":other", sig(1))
        t_n, j_n = anatomy._C_RECOMPILES.value() - t0, janatomy._C_RECOMPILES.value() - j0
        assert t_n == j_n == (2 if enabled else 0)
        diff = anatomy.fingerprint_diff(anatomy._fingerprint(uid, sig(1)),
                                        anatomy._fingerprint(uid, sig(2)))
        assert diff == janatomy.fingerprint_diff(janatomy._fingerprint(uid, sig(1)),
                                                 janatomy._fingerprint(uid, sig(2)))
    finally:
        telemetry.registry.set_enabled(t_was)
        jregistry.set_enabled(j_was)


# ---------------------------------------------------------------------------
# tools/serve.py and tools/serving_bench.py as subprocesses
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for k in ("MXTPU_SERVE_QUANT", "MXTPU_METRICS_PORT", "XLA_FLAGS",
              "JAX_COMPILATION_CACHE_DIR"):
        env.pop(k, None)
    return env


@pytest.mark.timeout(300)
def test_serve_self_test_subprocess():
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve", "--self-test", "--cpu"],
        capture_output=True, text=True, timeout=280, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "serve self-test PASSED" in r.stdout


@pytest.mark.timeout(300)
def test_sigterm_drains_and_exits_zero(tmp_path):
    from mxnet_tpu_torch.tools import serve as serve_tool

    bundle = str(tmp_path / "lenet.pred")
    serve_tool._build_toy_bundle(bundle)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve", "--bundle", bundle,
         "--input", "data=1x28x28", "--port", "0", "--cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert "serving on" in line, line
        port = int(line.split(":")[-1].split(" ")[0].strip("()"))
        with socket.create_connection(("127.0.0.1", port), 30) as s:
            f = s.makefile("rwb")
            x = np.zeros((1, 28, 28), np.float32)
            f.write((json.dumps({"inputs": {"data": x.tolist()}}) + "\n").encode())
            f.flush()
            reply = json.loads(f.readline().decode())
            assert len(reply["outputs"][0]) == 10, reply
            # the in-flight request is answered; now ask for drain
            proc.terminate()  # SIGTERM
            rc = proc.wait(timeout=120)
        assert rc == 0
        rest = proc.stdout.read()
        assert "draining" in rest and "drained, bye" in rest
    finally:
        if proc.poll() is None:
            proc.kill()


def test_toy_bundle_bytes_equal_the_jax_tool(tmp_path):
    """The port's self-test bundle is the JAX tool's, byte for byte (both
    built in fresh processes, where auto names start at 0)."""
    paths = {}
    for pkg, mod in (("jax", "serve"), ("port", "mxnet_tpu_torch.tools.serve")):
        paths[pkg] = str(tmp_path / ("%s.pred" % pkg))
        code = ("import sys; sys.path.insert(0, %r); import %s as s; s._build_toy_bundle(%r)"
                % (os.path.join(REPO, "tools") if pkg == "jax" else REPO, mod, paths[pkg]))
        env = _env()
        env["JAX_PLATFORMS"] = "cpu"
        subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO,
                       timeout=120)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()


def test_serve_refuses_unported_options(tmp_path):
    from mxnet_tpu_torch.tools import serve as serve_tool

    # --checkpoint is ported (tests/test_torch_resilience.py); it needs --symbol
    with pytest.raises(SystemExit, match="needs --symbol"):
        serve_tool.main(["--checkpoint", str(tmp_path), "--input", "data=4", "--cpu"])
    # --metrics-port is ported: the self-test serves /metrics and /healthz
    # beside its 100 requests (the server itself: tests/test_torch_fleet.py)
    from mxnet_tpu_torch import telemetry

    try:
        assert serve_tool.main(["--self-test", "--cpu", "--metrics-port", "0"]) == 0
    finally:
        telemetry.reset()
        telemetry.disable()


@pytest.mark.timeout(300)
def test_serving_bench_smoke_cpu(tmp_path):
    out = str(tmp_path / "serve.json")
    env = _env()
    env["SERVE_SMOKE"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serving_bench", "--cpu", "--out", out],
        capture_output=True, text=True, timeout=280, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    res = json.load(open(out))
    assert res["steady_state_recompiles"] == 0 and res["steady_state_plan_misses"] == 0
    for key in ("closed_loop", "open_loop", "decode", "quant", "max_batch",
                "batch_timeout_ms"):
        assert key in res, key
    for key in ("sequential_rps", "batched_rps", "speedup", "raw_dispatch_rps",
                "mean_batch_occupancy", "trials"):
        assert key in res["closed_loop"], key
    for key in ("latency_p50_ms", "latency_p99_ms", "achieved_rps"):
        assert key in res["open_loop"], key
    assert res["decode"]["tokens"] == 4 * 4
    assert res["quant"]["top1_agreement"] >= 0.99
    assert "speedup" not in res["gates"]  # held on the card, not on the host
