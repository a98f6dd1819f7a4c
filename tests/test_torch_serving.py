"""The PyTorch port's serving slice (mxnet_tpu_torch) held against the JAX
package on the CPU: parameters carried across with params_from_jax, the
full forward, prefill + KV-cached decode, and GenerationEngine's mid-flight
admission; plus the port's import hygiene and its refusal to run on the
CPU unless asked."""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.serving import buckets as jbuckets
from mxnet_tpu.serving.decode import GenerationEngine as JaxGenerationEngine
from mxnet_tpu.telemetry import registry as jregistry
from mxnet_tpu_torch import context, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serving import ServeClosed, buckets
from mxnet_tpu_torch.serving.decode import GenerationEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")
DIMS = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]  # tests/test_serving.py's


def _port_params(dtype=torch.float32, seed=0):
    init_fn, _ = ttfm.transformer_lm(dtype=dtype, **DIMS)
    return ttfm.params_from_jax(init_fn(seed), device="cpu", dtype=dtype)


def test_init_fn_bit_identical_to_jax():
    j_tree = jtfm.transformer_lm(**DIMS)[0](0)
    t_tree = ttfm.transformer_lm(**DIMS)[0](0)
    assert sorted(j_tree) == sorted(t_tree)
    for key in j_tree:
        if isinstance(j_tree[key], dict):
            assert sorted(j_tree[key]) == sorted(t_tree[key])
            for name in j_tree[key]:
                np.testing.assert_array_equal(t_tree[key][name], j_tree[key][name])
        else:
            np.testing.assert_array_equal(t_tree[key], j_tree[key])


def test_params_from_jax_layout_and_dtypes():
    tree = jtfm.transformer_lm(**DIMS)[0](0)
    # jax arrays, bf16 included, are accepted as leaves
    tree["l1"] = {k: jnp.asarray(v, jnp.bfloat16) for k, v in tree["l1"].items()}
    p = ttfm.params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert p.embed.dtype == torch.float32 and p.device == torch.device("cpu")
    assert len(p.layers) == DIMS["n_layers"]
    for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
        w = getattr(p.layers[0], name)
        assert w.dtype == torch.bfloat16 and not w.requires_grad
        ref = torch.from_numpy(tree["l0"][name]).T.to(torch.bfloat16)
        assert torch.equal(w, ref)  # stored [out, in], as nn.Linear keeps it
    np.testing.assert_array_equal(
        p.layers[1].w1.float().numpy(), np.asarray(tree["l1"]["w1"], np.float32).T)


@pytest.mark.timeout(120)
def test_generation_engine_sp_mesh_matches_jax():
    """GenerationEngine(mesh=sp 2): its prefills run ring attention over two
    sequence blocks, and its continuations equal the JAX engine's with
    mesh=make_mesh(sp=2), f32 at small width."""
    from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    tree = jtfm.transformer_lm(**DIMS)[0](0)
    prompts = PROMPTS + [list(range(1, 12))]
    j_gen = JaxGenerationEngine(
        tree, jtfm.transformer_lm_serving(max_len=16, dtype=jnp.float32, **DIMS),
        slots=2, max_len=16, mesh=jmake_mesh(sp=2))
    t_gen = GenerationEngine(
        ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32),
        ttfm.transformer_lm_serving(max_len=16, dtype=torch.float32, **DIMS),
        slots=2, max_len=16, mesh=make_mesh(sp=2, devices=["cpu"] * 2), device="cpu")
    results = []
    for gen in (j_gen, t_gen):
        reqs = [gen.submit(p, max_new=4) for p in prompts]
        for _ in range(40):
            if all(r.done.is_set() for r in reqs):
                break
            gen.step()
        results.append([r.result(0) for r in reqs])
    assert results[1] == results[0]
    assert [len(r) for r in results[1]] == [4] * len(prompts)


@pytest.mark.timeout(120)
def test_transformer_forward_matches_jax():
    """f32 full forward, 1e-4: XLA and ATen sum the matmuls in different
    orders."""
    j_init, j_apply = jtfm.transformer_lm(dtype=jnp.float32, **DIMS)
    _, t_apply = ttfm.transformer_lm(dtype=torch.float32, **DIMS)
    tokens = np.random.RandomState(1).randint(0, DIMS["vocab"], (2, 12))
    ref = np.asarray(j_apply(j_init(0), jnp.asarray(tokens, jnp.int32)))
    got = t_apply(_port_params(), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 12, DIMS["vocab"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def _serve_both(j_dtype, t_dtype, n_steps=4):
    """Prefill PROMPTS then n_steps greedy decode steps in both packages,
    each fed the JAX package's greedy tokens; yields (jax, port) logits."""
    tree = jtfm.transformer_lm(**DIMS)[0](0)
    j_init_cache, j_prefill, j_decode = jtfm.transformer_lm_serving(
        max_len=16, dtype=j_dtype, **DIMS)
    t_init_cache, t_prefill, t_decode = ttfm.transformer_lm_serving(
        max_len=16, dtype=t_dtype, **DIMS)
    params = ttfm.params_from_jax(tree, device="cpu", dtype=t_dtype)
    lengths = np.array([len(p) for p in PROMPTS], np.int32)
    toks = np.zeros((3, 8), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    slots = np.arange(3, dtype=np.int32)
    j_cache, j_last = j_prefill(tree, j_init_cache(3), jnp.asarray(toks),
                                jnp.asarray(slots), jnp.asarray(lengths))
    t_cache, t_last = t_prefill(params, t_init_cache(3, device="cpu"),
                                torch.from_numpy(toks), torch.from_numpy(slots),
                                torch.from_numpy(lengths))
    yield np.asarray(j_last, np.float32), t_last.numpy()
    step = np.argmax(np.asarray(j_last), axis=-1).astype(np.int32)
    for _ in range(n_steps):
        j_cache, j_logits = j_decode(tree, j_cache, jnp.asarray(step))
        t_cache, t_logits = t_decode(params, t_cache, torch.from_numpy(step))
        yield np.asarray(j_logits, np.float32), t_logits.numpy()
        step = np.argmax(np.asarray(j_logits), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(t_cache["pos_map"].numpy(), np.asarray(j_cache["pos_map"]))
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(j_cache["length"]))


@pytest.mark.timeout(120)
def test_prefill_and_decode_match_jax_f32():
    """Mixed-length prompts (tests/test_serving.py's): prefill last-token
    logits and 4 decode steps at 1e-4, greedy tokens equal."""
    n = 0
    for ref, got in _serve_both(jnp.float32, torch.float32):
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        n += 1
    assert n == 5


@pytest.mark.timeout(120)
def test_prefill_and_decode_match_jax_bf16():
    """The same in bf16 at atol 5e-2 on logits. Tokens are not compared:
    the two frameworks round to bf16 inside different kernels (matmul
    accumulation, gelu's internal precision), so logits differ by a few
    bf16 ulps and a near-tie argmax may go either way."""
    n = 0
    for ref, got in _serve_both(jnp.bfloat16, torch.bfloat16):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2)
        n += 1
    assert n == 5


@pytest.mark.timeout(120)
def test_generation_engine_midflight_matches_jax():
    """3 requests on 2 slots (tests/test_serving.py's mid-flight case): the
    third is admitted into the slot the first frees; every continuation
    equals the JAX engine's for the same prompts and budgets."""
    tree = jtfm.transformer_lm(**DIMS)[0](0)
    prompts = {"a": [1, 2, 3], "b": [4, 5, 6, 7], "c": [8, 9]}
    budget = {"a": 3, "b": 6, "c": 2}

    j_gen = JaxGenerationEngine(
        tree, jtfm.transformer_lm_serving(max_len=16, dtype=jnp.float32, **DIMS),
        slots=2, max_len=16)
    t_gen = GenerationEngine(
        ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32),
        ttfm.transformer_lm_serving(max_len=16, dtype=torch.float32, **DIMS),
        slots=2, max_len=16, device="cpu")
    results = []
    for gen in (j_gen, t_gen):
        gen.compile()
        reqs = {k: gen.submit(prompts[k], max_new=budget[k]) for k in prompts}
        assert gen.step()
        assert gen.active == 2 and reqs["c"].t_admit is None
        for _ in range(40):
            if all(r.done.is_set() for r in reqs.values()):
                break
            gen.step()
        assert reqs["c"].t_admit is not None
        assert gen.active == 0 and sorted(gen._free) == [0, 1]
        results.append({k: reqs[k].result(0) for k in prompts})
    assert results[1] == results[0]
    assert all(len(results[1][k]) == budget[k] for k in prompts)


@pytest.mark.timeout(120)
def test_note_dispatch_accounting_matches_jax():
    """Both engines, warmed for one prompt length only, note the same
    dispatch signatures over the same stream (a prefill bucket first seen
    after compile() included), count the same recompiles (none: each
    (engine, bucket) program's first signature is its warm-up), and give
    the same continuations."""
    from mxnet_tpu.telemetry import anatomy as janatomy
    from mxnet_tpu_torch.telemetry import anatomy

    tree = jtfm.transformer_lm(**DIMS)[0](0)
    j_gen = JaxGenerationEngine(
        tree, jtfm.transformer_lm_serving(max_len=16, dtype=jnp.float32, **DIMS),
        slots=2, max_len=16)
    t_gen = GenerationEngine(
        ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32),
        ttfm.transformer_lm_serving(max_len=16, dtype=torch.float32, **DIMS),
        slots=2, max_len=16, device="cpu")
    was, j_was = telemetry.enabled(), jregistry.enabled()
    telemetry.enable()
    jregistry.set_enabled(True)
    try:
        results, seen, recompiles = [], [], []
        for gen, counter in ((j_gen, janatomy._C_RECOMPILES), (t_gen, anatomy._C_RECOMPILES)):
            gen.compile(prompt_lengths=[3])
            after_compile = set(gen._seen_sigs)
            r0 = counter.value()
            reqs = [gen.submit(p, max_new=3) for p in ([1, 2, 3], list(range(1, 13)), [4, 5])]
            for _ in range(40):
                if all(r.done.is_set() for r in reqs):
                    break
                gen.step()
            results.append([r.result(0) for r in reqs])
            seen.append((after_compile, set(gen._seen_sigs)))
            recompiles.append(counter.value() - r0)
    finally:
        telemetry.registry.set_enabled(was)
        jregistry.set_enabled(j_was)
    assert seen[1] == seen[0]
    assert (("prefill", (2, 16), "int32", "serve"),) in seen[1][1] - seen[1][0]
    assert recompiles == [0, 0]
    assert results[1] == results[0]


@pytest.mark.timeout(120)
def test_generation_engine_thread_drain_and_prompt_cap():
    gen = GenerationEngine(
        _port_params(),
        ttfm.transformer_lm_serving(max_len=16, dtype=torch.float32, **DIMS),
        slots=2, max_len=16, device="cpu")
    with pytest.raises(MXNetError):
        gen.submit(list(range(1, 20)))  # prompt longer than the window
    gen.start()
    fut = gen.submit([1, 2, 3], max_new=2)
    gen.drain()
    assert len(fut.result(0)) == 2  # in-flight finished during drain
    with pytest.raises(ServeClosed):
        gen.submit([1, 2], max_new=1)


@pytest.mark.timeout(120)
def test_generation_engine_concurrent_submitters():
    """More submitting threads than cores against the serving thread, with
    a short switch interval: every request finishes with its budget and
    every slot returns to the free list (a lost update breaks either)."""
    import threading

    gen = GenerationEngine(
        _port_params(),
        ttfm.transformer_lm_serving(max_len=16, dtype=torch.float32, **DIMS),
        slots=3, max_len=16, device="cpu").start(precompile=False)
    n_threads = 2 * (os.cpu_count() or 4)
    futures, lock = [], threading.Lock()

    def client(i):
        for j in range(3):
            fut = gen.submit([1 + (i + j) % 30, 2], max_new=1 + (i + j) % 3)
            with lock:
                futures.append(fut)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for fut in futures:
            assert len(fut.result(timeout=60)) == fut.max_new
    finally:
        sys.setswitchinterval(old)
        gen.drain(timeout=60)
    assert len(futures) == 3 * n_threads
    assert gen.active == 0 and sorted(gen._free) == [0, 1, 2]


@pytest.mark.timeout(60)
def test_generation_engine_thread_failure_reaches_every_request():
    """A model error inside the serving thread fails the waiting requests
    at once instead of leaving them to time out, and closes the engine."""
    init_cache, prefill, decode_step = ttfm.transformer_lm_serving(
        max_len=16, dtype=torch.float32, **DIMS)
    calls = []

    def failing_decode(params, cache, tokens):
        calls.append(1)
        raise RuntimeError("device fault")

    gen = GenerationEngine(_port_params(), (init_cache, prefill, failing_decode),
                           slots=2, max_len=16, device="cpu")
    reqs = [gen.submit(p, max_new=4) for p in PROMPTS]
    gen.start(precompile=False)
    for req in reqs:
        with pytest.raises(RuntimeError, match="device fault"):
            req.result(timeout=30)
    assert calls
    with pytest.raises(ServeClosed):
        gen.submit([1, 2], max_new=1)
    gen.drain(timeout=30)
    assert gen._thread is None


def test_trace_summary_charges_device_time_to_calls():
    """trace_serving's accounting on a made-up trace: each kernel goes to
    the call that started last before it; the idle share is what the
    kernels leave of the window."""
    from types import SimpleNamespace as NS

    from mxnet_tpu_torch.tools import trace_serving

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = lambda name, a, b, dev: NS(name=name, device_type=dev,  # noqa: E731
                                    time_range=NS(start=a, end=b))
    events = [
        ev("mxtt.prefill", 0, 5, cpu), ev("flash", 1, 41, cuda),
        ev("gemm", 41, 61, cuda), ev("mxtt.decode_step", 70, 72, cpu),
        ev("gemm", 75, 85, cuda), ev("mxtt.decode_step", 90, 92, cpu),
        ev("gemm", 95, 100, cuda), ev("early", -10, -5, cuda),
        ev("mxtt.decode_step", 75, 85, cuda),  # the range mirrored on the device
    ]
    s = trace_serving.summarize(events)
    assert s["window_ms"] == 0.1 and s["device_busy_ms"] == 0.075
    assert abs(s["device_idle_share"] - 0.25) < 1e-12
    assert s["calls"]["mxtt.prefill"] == {
        "calls": 1, "device_us": 60.0, "kernels": 2, "kernels_per_call": 2.0,
        "device_ms_per_call": 0.06}
    assert s["calls"]["mxtt.decode_step"]["kernels_per_call"] == 1.0
    assert [k["name"] for k in s["top_kernels"]] == ["flash", "gemm"]
    with pytest.raises(RuntimeError):
        trace_serving.summarize([ev("gemm", 0, 1, cuda)])


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        context.default_device()
    tree = jtfm.transformer_lm(**DIMS)[0](0)
    with pytest.raises(MXNetError):
        ttfm.params_from_jax(tree)
    model = ttfm.transformer_lm_serving(max_len=16, **DIMS)
    with pytest.raises(MXNetError):
        model[0](2)
    with pytest.raises(MXNetError):
        GenerationEngine(_port_params(), model, slots=2, max_len=16)


def test_engine_refuses_params_on_another_device():
    class OnCard:
        device = torch.device("cuda", 0)

    model = ttfm.transformer_lm_serving(max_len=16, **DIMS)
    with pytest.raises(MXNetError):
        GenerationEngine(OnCard(), model, slots=2, max_len=16, device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch, mxnet_tpu_torch.serving.decode\n"
        "import mxnet_tpu_torch.models.transformer, mxnet_tpu_torch.ops.kernels\n"
        "import mxnet_tpu_torch.examples.train_transformer_lm\n"
        "import mxnet_tpu_torch.tools.transformer_bench, mxnet_tpu_torch.tools.trace_serving\n"
        "import mxnet_tpu_torch.name, mxnet_tpu_torch.attribute, mxnet_tpu_torch.symbol\n"
        "import mxnet_tpu_torch.executor, mxnet_tpu_torch.models.resnet\n"
        "import mxnet_tpu_torch.ops.registry, mxnet_tpu_torch.ops.utils, mxnet_tpu_torch.ops.nn\n"
        "import mxnet_tpu_torch.ops.elemwise, mxnet_tpu_torch.ops.matrix\n"
        "import mxnet_tpu_torch.tools.resnet_bench\n"
        "import mxnet_tpu_torch.predict, mxnet_tpu_torch.serving.engine\n"
        "import mxnet_tpu_torch.serving.quant, mxnet_tpu_torch.telemetry.anatomy\n"
        "import mxnet_tpu_torch.tools.serve, mxnet_tpu_torch.tools.serving_bench\n"
        "bad = [m for m in ('jax', 'jaxlib', 'mxnet_tpu') if m in sys.modules]\n"
        "built = [m for m in sys.modules if m.startswith('triton')]\n"
        "print(bad, built)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax|import mxnet_tpu(?!_torch)"
                     r"|from mxnet_tpu(?!_torch)[ .])", re.M)
    scanned = 0
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                assert not pat.search(src), os.path.join(root, f)
                scanned += 1
    assert scanned >= 38
    for new in ("predict.py", "serving/engine.py", "serving/quant.py",
                "telemetry/anatomy.py", "tools/serve.py", "tools/serving_bench.py"):
        assert os.path.exists(os.path.join(PKG, new)), new


@pytest.mark.parametrize("cap,base", [(1, 1), (6, 1), (8, 1), (2048, 8), (16, 8)])
def test_buckets_match_jax(cap, base):
    ladder = buckets.bucket_ladder(cap, base=base)
    assert ladder == jbuckets.bucket_ladder(cap, base=base)
    for size in range(0, cap + 3):
        assert buckets.covering_value(ladder, size) == jbuckets.covering_value(ladder, size)


def test_histogram_snapshot_reads_back_in_jax():
    """The port's histogram snapshot has the JAX package's shape: merged
    into a JAX registry it gives the same percentiles."""
    was = telemetry.enabled()
    telemetry.enable()
    try:
        reg = telemetry.registry.Registry()
        h = reg.histogram("t.seconds")
        for x in np.random.RandomState(0).exponential(0.01, 200):
            h.observe(float(x))
    finally:
        telemetry.registry.set_enabled(was)
    assert h.count() == 200
    jreg = jregistry.Registry()
    assert jreg.merge_snapshot(reg.snapshot())
    jh = jreg.get("t.seconds")
    assert jh.kind == "histogram" and jh.count() == 200
    for q in (0, 50, 90, 99, 100):
        assert h.percentile(q) == jh.percentile(q)
