"""The training guardrails of the PyTorch port
(``mxnet_tpu_torch/resilience/guardrail.py``, the gate of
``ShardedTrainStep.arm_guard`` and ``fit(guardrails="auto")``) on the CPU,
held to the JAX package.

The monitor: the same value streams through both packages'
``GuardrailMonitor`` give the same verdicts, thresholds and health blobs
(the cases of ``tests/test_guardrail.py:50-94`` and a long random stream).
The fit-level cases of ``tests/test_guardrail.py:183-379`` run on a dp-4
fused Module of four logical host ranks, each eagerly (``eager``), at
``MXNET_FIT_MULTISTEP=2`` (``k2``) and, where they make sense in bf16, on
the AMP path (``amp``, ``amp_k2``), where the gate is the flag K1's plain
version reads: a guarded run with no anomaly is bit for bit an unguarded
one; a NaN step leaves every state tensor bit for bit as the step before
(the loss scaler aside, which backs off); a NaN step and a loss spike are
skipped and the run converges to the clean loss (rtol 1e-4, the convex
linear model); a rewind lands on the last good checkpoint and converges;
a spent rewind budget exits 78 with a verdict that the repo's
``tools/watchdog.py`` and JAX's ``read_verdict`` parse; a SIGKILL inside a
rewind still converges on relaunch; retention never evicts the newest
known-good checkpoint. Also: the port's guarded NaN fit agrees with
JAX's within the fit-parity tolerance, re-thresholding keeps the step
groups (no rebuild, so no recapture on the card) while arming drops them,
and K1's plain version with the gated flag returns its inputs bit for
bit."""
import json
import logging
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.resilience import guardrail as jguard
from mxnet_tpu_torch import resilience
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.resilience import checkpoint as ck
from mxnet_tpu_torch.resilience import guardrail

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV = ("MXTPU_AMP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES", "MXNET_FIT_MULTISTEP",
        "MXTPU_FAULT_INJECT", "MXTPU_GUARD_REWIND_AFTER", "MXTPU_GUARD_MAX_REWINDS",
        "MXTPU_GUARD_ZMAX", "MXTPU_RUN_DIR", "MXTPU_CKPT_KEEP")

MODES = {"eager": {}, "k2": {"MXNET_FIT_MULTISTEP": "2"}, "amp": {"MXTPU_AMP": "bf16"},
         "amp_k2": {"MXTPU_AMP": "bf16", "MXNET_FIT_MULTISTEP": "2"}}


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    # a small detector window (warm by step 4 of an 8-step epoch)
    monkeypatch.setenv("MXTPU_GUARD_WINDOW", "3")
    monkeypatch.setenv(ck.ENV_INTERVAL, "4")
    with tmx.cpu():
        yield


def _mode(monkeypatch, mode):
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# the monitor, against the JAX package's
# ---------------------------------------------------------------------------

def _streams():
    rng = np.random.RandomState(11)
    noisy = [(s, 1.0 + 0.1 * rng.randn(), 2.0 + 0.2 * rng.rand(), 1.0) for s in range(1, 120)]
    noisy[60] = (61, 1e6, 2.0, 1.0)
    noisy[61] = (62, 1.0, float("inf"), 1.0)
    noisy[62] = (63, 1.0, 1e30, 0.0)
    noisy[90] = (91, float("nan"), 2.0, 1.0)
    return {
        "warmup_then_trip": (dict(window=4, zmax=10.0, rewind_after=3),
                             [(1, 1000.0, 1.0, 1.0)] + [(s, 1.0, 1.0, 1.0) for s in range(2, 6)]
                             + [(6, 1e6, 1.0, 1.0), (7, 1.0, 1.0, 1.0)]),
        "nonfinite_in_warmup": (dict(window=64, rewind_after=2),
                                [(1, float("nan"), 1.0, 1.0), (2, 1.0, float("inf"), 1.0)]),
        "gate_skips_escalate": (dict(window=64, rewind_after=3),
                                [(s, 1.0, 1e30, 0.0) for s in (1, 2, 3)]),
        "threshold_warms": (dict(window=3, zmax=10.0),
                            [(s, 1.0, 2.0, 1.0) for s in (1, 2, 3)]),
        "health_blob": (dict(window=4, rewind_after=2),
                        [(s, float(s % 3), 1.0 + 0.1 * s, 1.0) for s in range(1, 6)]
                        + [(6, float("nan"), 1.0, 1.0)]),
        "long_noisy": (dict(window=16, zmax=6.0, rewind_after=2), noisy),
    }


@pytest.mark.parametrize("case", sorted(_streams()))
def test_monitor_matches_the_jax_package(case):
    kwargs, stream = _streams()[case]
    mine, theirs = guardrail.GuardrailMonitor(**kwargs), jguard.GuardrailMonitor(**kwargs)
    assert mine.gate_threshold() == theirs.gate_threshold() == float("inf")
    for step, loss, gn2, ok in stream:
        assert mine.observe(step, loss, gn2, ok) == theirs.observe(step, loss, gn2, ok), step
        assert mine.gate_threshold() == theirs.gate_threshold(), step
        assert (mine.trips, mine.skips, mine.consecutive, mine.last_clean_step) == \
            (theirs.trips, theirs.skips, theirs.consecutive, theirs.last_clean_step), step
    blob = mine.health_blob(stream[-1][0])
    assert blob == theirs.health_blob(stream[-1][0])
    fresh_mine, fresh_theirs = guardrail.GuardrailMonitor(**kwargs), jguard.GuardrailMonitor(**kwargs)
    fresh_mine.restore(blob)
    fresh_theirs.restore(theirs.health_blob(stream[-1][0]))
    assert fresh_mine.health_blob(0) == fresh_theirs.health_blob(0)
    assert fresh_mine.gate_threshold() == fresh_theirs.gate_threshold()


def test_monitor_unit_behaviour():
    mon = guardrail.GuardrailMonitor(window=4, zmax=10.0, rewind_after=3)
    assert mon.observe(1, 1000.0, 1.0, 1.0) == "ok"
    for step in range(2, 6):
        assert mon.observe(step, 1.0, 1.0, 1.0) == "ok"
    assert mon.observe(6, 1e6, 1.0, 1.0) == "skip"
    assert mon.loss.med < 1000.0
    assert mon.observe(7, 1.0, 1.0, 1.0) == "ok" and mon.last_clean_step == 7
    guardrail.GuardrailMonitor().restore(None)
    guardrail.GuardrailMonitor().restore({"bogus": 1})
    assert resilience.EXIT_GUARDRAIL == jguard.EXIT_GUARDRAIL == 78


def test_verdict_bytes_match_the_jax_package(tmp_path, monkeypatch):
    verdict = {"action": "abort", "reason": "nan", "step": 9, "t": 1.5, "budget": 0}
    monkeypatch.setenv("MXTPU_RUN_DIR", str(tmp_path / "a"))
    (mine,) = guardrail.write_verdict(verdict)
    monkeypatch.setenv("MXTPU_RUN_DIR", str(tmp_path / "b"))
    (theirs,) = jguard.write_verdict(verdict)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert guardrail.read_verdict(str(tmp_path / "b")) == jguard.read_verdict(str(tmp_path / "a"))
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / guardrail.VERDICT_FILE).write_text("{torn")
    assert guardrail.read_verdict(str(tmp_path / "c")) is None


# ---------------------------------------------------------------------------
# fit(): bitwise parity, skip, rewind, verdict
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _linear(pkg):
    """Convex (linear softmax): a unique minimum, so a recovered run must
    land on the clean run's final loss."""
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=4, name="fc1")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data():
    rng = np.random.RandomState(42)
    return rng.randn(64, 8).astype(np.float32), rng.randint(0, 4, 64).astype(np.float32)


def _blob_iter(pkg):
    x, y = _data()
    return pkg.io.NDArrayIter(x, y, batch_size=8)


def _fit(ckpt_dir, sym=None, guardrails=None, num_epoch=60, resume=None, pkg=tmx,
         callback=None):
    np.random.seed(0)
    pkg.random.seed(0)
    mod = pkg.mod.Module(sym or _linear(pkg), context=[pkg.cpu(i) for i in range(4)])
    mod.fit(_blob_iter(pkg), eval_metric=pkg.metric.create("acc"), kvstore="device",
            optimizer="sgd", optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=pkg.init.Uniform(0.1), num_epoch=num_epoch, checkpoint_dir=ckpt_dir,
            resume=resume, guardrails=guardrails, batch_end_callback=callback)
    assert mod._fused_trainer is not None
    return mod


def _params_of(mod):
    arg, aux = mod.get_params()
    out = {k: np.asarray(v.asnumpy()) for k, v in arg.items()}
    out.update({"aux:" + k: np.asarray(v.asnumpy()) for k, v in aux.items()})
    return out


def _final_loss(mod, pkg=tmx):
    _, y = _data()
    probs = mod.predict(_blob_iter(pkg)).asnumpy()
    return float(-np.mean(np.log(probs[np.arange(len(y)), y.astype(int)] + 1e-12)))


def _fused_state(mod):
    """Every state tensor of the fused path, as numpy bits."""
    owner = mod._fused_owner
    out = {}
    for kind, tree in (("param", owner._fused_params), ("aux", owner._fused_aux),
                       ("opt", owner._fused_opt)):
        for name, v in tree.items():
            for j, t in enumerate(v if isinstance(v, tuple) else (v,)):
                if t is not None:
                    t = t.detach()
                    out["%s:%s.%d" % (kind, name, j)] = (
                        t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_zero_anomaly_guard_run_is_bitwise_identical(tmp_path, monkeypatch, mode):
    _mode(monkeypatch, mode)
    ref = _fit(str(tmp_path / "ref"), sym=_mlp(tmx), num_epoch=2)
    guarded = _fit(str(tmp_path / "g"), sym=_mlp(tmx), guardrails="auto", num_epoch=2)
    assert guarded._fused_trainer.guard and not ref._fused_trainer.guard
    rp, gp = _params_of(ref), _params_of(guarded)
    assert set(rp) == set(gp)
    for k in rp:
        np.testing.assert_array_equal(rp[k], gp[k], err_msg=k)
    rs, gs = _fused_state(ref), _fused_state(guarded)
    for k in rs:
        np.testing.assert_array_equal(rs[k], gs[k], err_msg=k)
    health = ck.read_manifest(ck.step_dir(str(tmp_path / "g"), 16))["health"]
    assert health["clean"] and health["trips"] == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_nan_step_leaves_the_state_of_the_step_before(tmp_path, monkeypatch, mode):
    """NaN data at step 6: every master, state, working param and aux bit
    after step 6 is the bit after step 5 (at K = 2 step 6 closes a group,
    whose state is held to the eager run's after step 5); the AMP scaler
    backs off (scale halves, good resets)."""
    _mode(monkeypatch, mode)
    k = int(MODES[mode].get("MXNET_FIT_MULTISTEP", 1))
    snaps = {}

    def grab(p):
        snaps[p.nbatch + 1] = _fused_state(p.locals["self"])

    monkeypatch.setenv("MXNET_FIT_MULTISTEP", "1")
    _fit(str(tmp_path / "eager"), sym=_mlp(tmx), guardrails="auto", num_epoch=1, callback=grab)
    after5 = snaps[5]
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", str(k))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad_at_step=6,mode=%s" % mode)
    snaps.clear()
    mod = _fit(str(tmp_path / "nan"), sym=_mlp(tmx), guardrails="auto", num_epoch=1,
               callback=grab)
    after6 = snaps[6]
    scaler = {"opt:__amp_scale__.0", "opt:__amp_good__.0"}
    assert sorted(after6) == sorted(after5)
    for name in set(after5) - scaler:
        np.testing.assert_array_equal(after6[name], after5[name], err_msg=name)
    if "MXTPU_AMP" in MODES[mode]:
        assert after6["opt:__amp_scale__.0"] == after5["opt:__amp_scale__.0"] * 0.5
        assert after6["opt:__amp_good__.0"] == 0.0
    for name, v in _params_of(mod).items():
        assert np.isfinite(v).all(), name
    health = ck.read_manifest(ck.step_dir(str(tmp_path / "nan"), 8))["health"]
    assert health["skips"] == 1


@pytest.mark.parametrize("mode", ["eager", "k2"])
def test_nan_grad_is_skipped_and_run_converges(tmp_path, monkeypatch, mode):
    _mode(monkeypatch, mode)
    ref_loss = _final_loss(_fit(str(tmp_path / "ref")))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad_at_step=7,mode=%s" % mode)
    mod = _fit(str(tmp_path / "nan"), guardrails="auto")
    for k, v in _params_of(mod).items():
        assert np.isfinite(v).all(), k
    np.testing.assert_allclose(_final_loss(mod), ref_loss, rtol=1e-4)


@pytest.mark.parametrize("mode", ["eager", "k2"])
def test_loss_spike_is_skipped_and_run_converges(tmp_path, monkeypatch, caplog, mode):
    _mode(monkeypatch, mode)
    ref_loss = _final_loss(_fit(str(tmp_path / "ref")))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "loss_spike_at_step=6,mode=%s" % mode)
    with caplog.at_level(logging.WARNING):
        mod = _fit(str(tmp_path / "spike"), guardrails="auto")
    assert any("skipped step 6" in r.message for r in caplog.records), \
        [r.message for r in caplog.records]
    np.testing.assert_allclose(_final_loss(mod), ref_loss, rtol=1e-4)


@pytest.mark.parametrize("mode", ["eager", "k2"])
def test_rewind_to_last_good_and_converge(tmp_path, monkeypatch, caplog, mode):
    _mode(monkeypatch, mode)
    ref_loss = _final_loss(_fit(str(tmp_path / "ref")))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad_at_step=11,mode=%s" % mode)
    monkeypatch.setenv("MXTPU_GUARD_REWIND_AFTER", "1")
    with caplog.at_level(logging.WARNING):
        mod = _fit(str(tmp_path / "rw"), guardrails="auto")
    assert any("rewound to last-good step 8" in r.message for r in caplog.records), \
        [r.message for r in caplog.records]
    np.testing.assert_allclose(_final_loss(mod), ref_loss, rtol=1e-4)


@pytest.mark.parametrize("mode", ["eager", "k2", "amp"])
def test_rewind_budget_exhaustion_exits_with_verdict(tmp_path, monkeypatch, mode):
    _mode(monkeypatch, mode)
    ckpt = str(tmp_path / "ck")
    run_dir = str(tmp_path / "run")
    monkeypatch.setenv("MXTPU_RUN_DIR", run_dir)
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad_at_step=13,mode=%s" % mode)
    monkeypatch.setenv("MXTPU_GUARD_REWIND_AFTER", "1")
    monkeypatch.setenv("MXTPU_GUARD_MAX_REWINDS", "0")
    with pytest.raises(SystemExit) as exc:
        _fit(ckpt, guardrails="auto")
    assert exc.value.code == resilience.EXIT_GUARDRAIL == 78
    verdict = json.load(open(os.path.join(ckpt, guardrail.VERDICT_FILE)))
    assert verdict["type"] == "guardrail"
    assert verdict["action"] == "abort" and verdict["budget"] == 0
    # the monitor votes at the group boundary: step 13 eagerly, 14 at K = 2
    assert verdict["step"] == (14 if mode == "k2" else 13)
    # the readers of the verdict: the repo's watchdog and JAX's read_verdict
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import watchdog as wd

    assert jguard.read_verdict(run_dir) == verdict
    record = wd._record_guardrail(run_dir, wd.EXIT_GUARDRAIL)
    assert record["type"] == "guardrail" and record["rc"] == 78 and record["step"] == verdict["step"]
    rows = [json.loads(ln) for ln in open(os.path.join(run_dir, "decisions.jsonl"))]
    assert rows[0]["reason"] == verdict["reason"]


def test_guarded_nan_fit_agrees_with_the_jax_package(tmp_path, monkeypatch):
    """The same guarded fit with NaN data at step 6 in both packages: both
    skip it and end within the fit-parity tolerance."""
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad_at_step=6,pkg=port")
    mine = _params_of(_fit(str(tmp_path / "t"), sym=_mlp(tmx), guardrails="auto", num_epoch=2))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad_at_step=6,pkg=jax")
    theirs = _params_of(_fit(str(tmp_path / "j"), sym=_mlp(jmx), guardrails="auto",
                             num_epoch=2, pkg=jmx))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=2e-4, atol=2e-5, err_msg=k)
    mh = ck.read_manifest(ck.step_dir(str(tmp_path / "t"), 16))["health"]
    jh = ck.read_manifest(ck.step_dir(str(tmp_path / "j"), 16))["health"]
    assert (mh["skips"], mh["trips"], mh["last_clean_step"]) == \
        (jh["skips"], jh["trips"], jh["last_clean_step"]) == (1, 1, 16)


def test_rethreshold_keeps_the_groups_and_arming_drops_them(monkeypatch):
    """A new threshold is written into the device scalar the step reads: the
    step groups (on the card, their captured graphs) stay; arming replaces
    the step, so it drops them; a zero threshold gates every step."""
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", "2")
    mod = _fit(None, sym=_mlp(tmx), num_epoch=1)
    trainer = mod._fused_trainer
    assert len(trainer._groups) == 1
    trainer.arm_guard()
    assert trainer._groups == {}
    x, y = _data()
    batches = [tmx.io.DataBatch([tmx.nd.array(x[i:i + 8])], [tmx.nd.array(y[i:i + 8])])
               for i in (0, 8)]
    mod.update_multi(batches)
    group = next(iter(trainer._groups.values()))
    before = _fused_state(mod)
    trainer.guard_threshold = 0.0
    assert trainer.guard_threshold == 0.0 and float(trainer._guard_thr) == 0.0
    mod.update_multi(batches)
    assert next(iter(trainer._groups.values())) is group and len(trainer._groups) == 1
    after = _fused_state(mod)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    diag = mod._drain_guard_diag()
    assert [t for t, _ in diag] == [9, 10, 11, 12]
    assert [d[2] for _, d in diag] == [1.0, 1.0, 0.0, 0.0]
    assert all(d[1] > 0 for _, d in diag)


@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_gated_flag_returns_k1_plain_inputs_bitwise(kind):
    """The gate's flag, a device scalar ``finite and gn2 <= thr``, through
    K1's wrapper (its plain version on the CPU): every output is its input,
    the bf16 copy the bf16 of the old master."""
    g = torch.Generator().manual_seed(3)
    size = 1000
    w = torch.randn(size, generator=g)
    grad = (torch.randn(size, generator=g) * 4).bfloat16()
    states = tuple((torch.randn(size, generator=g) * 0.1).abs()
                   for _ in range(kernels.SLAB_STATE_SLOTS[kind]))
    gn2 = torch.linalg.vector_norm(grad, dtype=torch.float32).square()
    flag = (torch.isfinite(gn2) & (gn2 <= torch.tensor(1.0))).float()
    assert float(flag) == 0.0
    entry = kernels.SlabEntry(w.clone(), grad, tuple(s.clone() for s in states), 0.05, 1e-4,
                              None)
    (new_w, new_states, w16), = kernels.fused_slab_update_multi(
        kind, [entry], torch.tensor(1.0 / 128), flag, rescale_grad=1 / 32,
        clip_gradient=None, momentum=0.9)
    assert torch.equal(new_w, w)
    assert all(torch.equal(a, b) for a, b in zip(new_states, states))
    assert torch.equal(w16, w.bfloat16())


# ---------------------------------------------------------------------------
# SIGKILL during a rewind chain (subprocess)
# ---------------------------------------------------------------------------

_CHAIN_SCRIPT = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import mxnet_tpu_torch as mx

    def linear():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=4, name="fc1")
        return mx.sym.SoftmaxOutput(net, name="softmax")

    def blob():
        rng = np.random.RandomState(42)
        return mx.io.NDArrayIter(rng.randn(64, 8).astype(np.float32),
                                 rng.randint(0, 4, 64).astype(np.float32),
                                 batch_size=8)

    np.random.seed(0); mx.random.seed(0)
    with mx.cpu():
        mod = mx.mod.Module(linear(), context=[mx.cpu(i) for i in range(4)])
        mod.fit(blob(), eval_metric=mx.metric.create("acc"), kvstore="device",
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Uniform(0.1), num_epoch=60,
                checkpoint_dir=sys.argv[1], resume=sys.argv[2] or None,
                guardrails="auto")
        rng = np.random.RandomState(42)
        rng.randn(64, 8)
        labels = rng.randint(0, 4, 64)
        probs = mod.predict(blob()).asnumpy()
    loss = float(-np.mean(np.log(probs[np.arange(64), labels] + 1e-12)))
    print("FINAL_LOSS %%.9f" %% loss)
""")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mode", ["eager", "k2"])
def test_sigkill_during_rewind_chain_still_converges(tmp_path, mode):
    """An anomaly votes rewind and the process is SIGKILLed inside the
    rewind handler; the relaunch (resume="auto" under guardrails) restarts
    from the last healthy checkpoint and converges to the clean loss."""
    script = str(tmp_path / "chain_job.py")
    with open(script, "w") as f:
        f.write(_CHAIN_SCRIPT % {"repo": REPO})
    env = dict(os.environ, MXTPU_GUARD_WINDOW="3", MXTPU_GUARD_REWIND_AFTER="1",
               **MODES[mode])
    for k in ("MXTPU_FAULT_INJECT", "XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR"):
        env.pop(k, None)
    env[ck.ENV_INTERVAL] = "4"

    ref = subprocess.run([sys.executable, script, str(tmp_path / "ref"), ""],
                         capture_output=True, text=True, env=env, timeout=240)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_loss = float(ref.stdout.split("FINAL_LOSS")[1].split()[0])

    crash_env = dict(env, MXTPU_FAULT_INJECT="nan_grad_at_step=11,kill_at_rewind=1")
    ckpt = str(tmp_path / "chain")
    crash = subprocess.run([sys.executable, script, ckpt, ""], capture_output=True,
                           text=True, env=crash_env, timeout=240)
    assert crash.returncode == -signal.SIGKILL, (crash.returncode, crash.stderr[-2000:])
    assert ck.list_checkpoints(ckpt), "no checkpoint before the kill"

    resumed = subprocess.run([sys.executable, script, ckpt, "auto"], capture_output=True,
                             text=True, env=env, timeout=240)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    res_loss = float(resumed.stdout.split("FINAL_LOSS")[1].split()[0])
    np.testing.assert_allclose(res_loss, ref_loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# the health stamp and retention
# ---------------------------------------------------------------------------

def _state(step, clean=None):
    state = {
        "module": {"arg": {"w": np.full((2, 2), float(step), dtype=np.float32)},
                   "aux": {}, "opt": {"kind": "none"}},
        "epoch": 0, "nbatch": 0, "global_step": step, "metric": None, "rng": {},
    }
    if clean is not None:
        state["health"] = {"clean": clean, "step": step,
                           "last_clean_step": step if clean else step - 1,
                           "trips": 0 if clean else 1, "skips": 0}
    return state


def test_retention_never_evicts_newest_known_good(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for step, clean in ((10, True), (20, False), (30, False), (40, False)):
        mgr.save(_state(step, clean=clean), step)
    steps = ck.list_checkpoints(str(tmp_path))
    assert 10 in steps and 20 not in steps, steps
    assert mgr.last_good() == ck.step_dir(str(tmp_path), 10)
    assert mgr.load_last_good()["global_step"] == 10
    mgr.save(_state(50, clean=True), 50)
    mgr.save(_state(60, clean=False), 60)
    assert mgr.last_good() == ck.step_dir(str(tmp_path), 50)
    assert 10 not in ck.list_checkpoints(str(tmp_path))


def test_last_good_skips_unclean_and_unstamped_counts_as_good(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=5)
    mgr.save(_state(10), 10)
    mgr.save(_state(20, clean=False), 20)
    assert mgr.last_good() == ck.step_dir(str(tmp_path), 10)
    assert mgr.load_last_good()["global_step"] == 10
    empty = ck.CheckpointManager(str(tmp_path / "empty"))
    assert empty.last_good() is None and empty.load_last_good() is None


def test_guardrails_need_a_checkpoint_dir_and_auto(tmp_path):
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _fit(None, guardrails="auto", num_epoch=1)
    with pytest.raises(ValueError, match='must be "auto"'):
        _fit(str(tmp_path), guardrails="on", num_epoch=1)
