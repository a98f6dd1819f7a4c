"""The PyTorch port's fused data-parallel step (``parallel/train_step.py``)
held against the JAX package's ``ShardedTrainStep`` on the CPU, the JAX
side on the virtual host devices of ``tests/conftest.py``, the port on a
mesh of logical ranks that share the host:

- ``_FlatUpdatePlan`` gives the same buckets (representative index,
  views, offsets, padding) for an MLP and ResNet-50's parameters at
  dp 2 / 4 / 8, f32 and AMP;
- ``Module.fit`` through the f32 fused path (``kvstore="device"`` on four
  contexts) ends within 1e-5 of each tensor's max of JAX's; the port's
  "shard" and "replicated" flat modes agree bit for bit; a zero bucket
  cap takes the per-parameter path, which matches JAX's too;
- the AMP update alone (``_apply_optimizer_flat_amp``) on the same masters,
  states and bf16 gradients: masters and states within rtol 1e-6, the bf16
  working params and the loss scaler equal, for sgd_mom and adam (K1; the
  JAX side runs its Pallas K1 in interpret mode) and rmsprop (the generic
  branch through ``Optimizer.update``), with a skipped step among them;
- ``Module.fit`` under ``MXTPU_AMP=bf16`` (sgd_mom and adam, dp 4): the
  working params are bf16(masters) bit for bit, ``get_params`` the f32
  masters, and the masters are within twice JAX's own AMP-vs-f32 spread of
  JAX's (the bf16 backward rounds its sums in another order in each
  package);
- overflow skip and loss-scale growth (tests/test_amp.py:212-282), the
  decline at dp = 1, and the optimizer-state file read by the other
  package."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import train_step as jts
from mxnet_tpu_torch.parallel import train_step as tts


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in ("MXTPU_AMP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES", "MXTPU_LOSS_SCALE",
              "MXTPU_LOSS_SCALE_WINDOW", "MXTPU_FUSED_UPDATE_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    with tmx.cpu():
        yield


def _mlp(pkg, num_hidden=16, num_classes=4):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=num_classes, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _param_shapes(pkg, symbol, data_shape):
    shapes = symbol.infer_shape(data=data_shape, softmax_label=(data_shape[0],))[0]
    return {n: tuple(s) for n, s in zip(symbol.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _resnet50(pkg):
    mod = __import__(pkg.__name__ + ".models.resnet", fromlist=["get_symbol"])
    with pkg.name.NameManager():
        return mod.get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224")


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("model", ["mlp", "resnet50"])
def test_flat_plan_matches_jax(model, dp, amp):
    plans = {}
    for pkg, mod in ((jmx, jts), (tmx, tts)):
        if model == "mlp":
            symbol, dshape = _mlp(pkg), (16, 8)
        else:
            symbol, dshape = _resnet50(pkg), (2, 3, 224, 224)
        shapes = _param_shapes(pkg, symbol, dshape)
        names = list(shapes)
        opt = pkg.optimizer.create("sgd", momentum=0.9, param_idx2name=dict(enumerate(names)))
        plan = mod._FlatUpdatePlan(names, shapes, dict.fromkeys(names, "float32"), opt, dp,
                                   4 * 1024 * 1024, comm_itemsize=2 if amp else None)
        plans[pkg] = [(b.rep_index, b.dtype, [tuple(v[:4]) + (tuple(v[4]),) for v in b.views],
                       b.size, b.padded) for b in plan.buckets]
    assert plans[tmx] == plans[jmx]
    assert len(plans[tmx]) > (1 if model == "mlp" else 10)


def _fit(pkg, ndev, optname="sgd", num_epoch=2, hidden=16):
    """tests/test_amp.py's ``_fit_mlp`` in either package."""
    np.random.seed(0)
    pkg.random.seed(0)
    rng = np.random.RandomState(42)
    X = rng.randn(128, 8).astype(np.float32)
    y = rng.randint(0, 4, 128).astype(np.float32)
    it = pkg.io.NDArrayIter(X, y, batch_size=16)
    mod = pkg.mod.Module(_mlp(pkg, hidden), context=[pkg.cpu(i) for i in range(ndev)])
    metric = pkg.metric.create("acc")
    opt_params = {"learning_rate": 0.1 if optname == "sgd" else 0.01,
                  "rescale_grad": 1.0 / 16}
    if optname == "sgd":
        opt_params["momentum"] = 0.9
    mod.fit(it, eval_metric=metric, kvstore="device", optimizer=optname,
            optimizer_params=opt_params, initializer=pkg.init.Uniform(0.1),
            num_epoch=num_epoch)
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, metric.get()[1]


def _assert_close_of_max(got, want, tol):
    assert sorted(got) == sorted(want)
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        np.testing.assert_allclose(got[n] / scale, want[n] / scale, rtol=0, atol=tol, err_msg=n)


@pytest.mark.parametrize("optname", ["sgd", "adam"])
def test_fp32_fused_fit_matches_jax(optname):
    jmod, jp, jm = _fit(jmx, 4, optname)
    tmod, tp, tm = _fit(tmx, 4, optname)
    for mod in (jmod, tmod):
        assert mod._fused_trainer is not None and mod._fused_trainer.flat_mode == "shard"
        assert not mod._fused_trainer.amp
    _assert_close_of_max(tp, jp, 1e-5)
    assert tm == jm
    assert tmod._optimizer.num_update == jmod._optimizer.num_update == 16
    assert tmod._optimizer._index_update_count == jmod._optimizer._index_update_count


def test_shard_and_replicated_modes_agree_bitwise(monkeypatch):
    runs = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("MXTPU_SHARD_UPDATE", mode)
        mod, params, _ = _fit(tmx, 4, "sgd")
        assert mod._fused_trainer.flat_mode == ("shard" if mode == "1" else "replicated")
        runs[mode] = params
    for n in runs["1"]:
        np.testing.assert_array_equal(runs["1"][n], runs["0"][n], err_msg=n)


def test_zero_bucket_cap_takes_the_per_param_path(monkeypatch):
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "0")
    _, init_params, _ = _fit(tmx, 4, "sgd", num_epoch=0)
    jmod, jp, _ = _fit(jmx, 4, "sgd")
    tmod, tp, metric = _fit(tmx, 4, "sgd")
    assert tmod._fused_trainer is not None and tmod._fused_trainer.flat_mode is None
    assert jmod._fused_trainer.flat_mode is None
    assert np.isfinite(metric)
    assert any(not np.array_equal(tp[n], init_params[n]) for n in tp)  # it trains
    _assert_close_of_max(tp, jp, 1e-5)


# ---------------------------------------------------------------------------
# the AMP update alone
# ---------------------------------------------------------------------------

def _trainers(optname, dp=4, batch=16, lr_mult=None):
    """Both packages' trainers on the MLP over a dp mesh, from the same
    initial params (one np.random seed), with AMP on; ``lr_mult`` per
    parameter name where given."""
    from jax.sharding import Mesh

    out = {}
    for pkg in (jmx, tmx):
        net = _mlp(pkg, num_hidden=40)
        if pkg is jmx:
            mesh = Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
        else:
            mesh = tmx.parallel.make_mesh(dp=dp, devices=[tmx.cpu()] * dp)
        kw = dict(learning_rate=0.1, momentum=0.9) if optname == "sgd" else \
            dict(learning_rate=0.01)
        o = pkg.optimizer.create(optname, rescale_grad=1.0 / batch, wd=1e-4,
                                 param_idx2name=dict(enumerate(
                                     ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"])),
                                 **kw)
        if lr_mult:
            o.set_lr_mult(lr_mult)
        trainer = pkg.parallel.ShardedTrainStep(net, mesh, optimizer=o).compile()
        shapes = {"data": (batch, 8), "softmax_label": (batch,)}
        arg_shapes, _, _ = net.infer_shape(**shapes)
        np.random.seed(5)
        state = trainer.init(dict(zip(net.list_arguments(), arg_shapes)),
                             pkg.init.Uniform(0.1))
        out[pkg] = (trainer,) + tuple(state)
    return out


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _flat(state):
    out = {}
    for k, v in state.items():
        for j, x in enumerate(v if isinstance(v, tuple) else (v,)):
            out["%s.%d" % (k, j)] = _np(x)
    return out


def _check_amp_updates(both):
    """Four AMP updates (``_apply_optimizer_flat_amp``) in both packages on
    the same bf16 gradients, the third one non-finite: masters and states
    within rtol 1e-6, the bf16 working params and the loss scaler equal, the
    skipped step bit for bit."""
    (jt, jparams, _, jopt), (tt, tparams, _, topt) = both[jmx], both[tmx]
    jupdate = jax.jit(jt._apply_optimizer_flat_amp)
    rng = np.random.RandomState(9)
    for t in (1, 2, 3, 4):
        grads = {n: (rng.randn(*p.shape) * 3e4).astype(np.float32) for n, p in tparams.items()}
        if t == 3:  # a non-finite step: skipped bit for bit, scale halved
            grads["fc2_bias"][1] = np.inf
        jg = {n: jnp.asarray(g, jnp.bfloat16) for n, g in grads.items()}
        tg = {n: torch.from_numpy(g).to(torch.bfloat16) for n, g in grads.items()}
        before = _flat(topt)
        jparams, jopt = jupdate(jparams, jg, jopt, jnp.float32(jt.optimizer.lr), jnp.float32(t))
        with torch.no_grad():
            tparams, topt = tt._apply_optimizer_flat_amp(tparams, tg, topt, tt.optimizer.lr, t)
        got, want = _flat(topt), _flat(jopt)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        for n in tparams:
            assert tparams[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(tparams[n]), _np(jparams[n]), err_msg=n)
        if t == 3:
            for k, v in before.items():
                if not k.startswith(("__amp", )):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert float(topt[tt.AMP_GOOD_KEY]) == float(jopt[jt.AMP_GOOD_KEY]) == \
            (0.0 if t == 3 else (t if t < 3 else t - 3))
        assert float(topt[tt.AMP_SCALE_KEY]) == float(jopt[jt.AMP_SCALE_KEY]) == \
            2.0 ** 15 / (2 if t >= 3 else 1)
    return tparams, topt


@pytest.mark.parametrize("optname", ["sgd", "adam", "rmsprop"])
def test_amp_update_matches_jax(monkeypatch, optname):
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_FUSED_UPDATE_KERNEL", "1")  # JAX: its Pallas K1, interpreted
    both = _trainers(optname)
    jt, tt = both[jmx][0], both[tmx][0]
    assert jt.amp and tt.amp and tt.flat_mode == jt.flat_mode == "shard"
    _check_amp_updates(both)


@pytest.mark.parametrize("shard", ["1", "0"])
def test_amp_update_makes_one_k1_call_a_step_over_every_bucket(monkeypatch, shard):
    """A plan of several buckets (a small bucket cap; lr_mult on fc1 and the
    biases' zero wd_mult make four (lr_mult, wd_mult) groups) under Adam:
    one ``fused_slab_update_multi`` call a step holding every (bucket,
    chunk) — a bucket in "shard" mode, its dp chunks in "replicated" mode
    — each with its bucket's lr and wd, matching JAX's update."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_FUSED_UPDATE_KERNEL", "1")
    monkeypatch.setenv("MXTPU_SHARD_UPDATE", shard)
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "512")
    calls = []
    multi = tts.kernels.fused_slab_update_multi

    def counted(kind, entries, *args, **kw):
        calls.append((kind, [(e.w.shape[0], float(e.lr), float(e.wd)) for e in entries]))
        return multi(kind, entries, *args, **kw)

    monkeypatch.setattr(tts.kernels, "fused_slab_update_multi", counted)
    both = _trainers("adam", lr_mult={"fc1_weight": 0.5, "fc1_bias": 0.5})
    jt, tt = both[jmx][0], both[tmx][0]
    assert tt.flat_mode == jt.flat_mode == ("shard" if shard == "1" else "replicated")
    _check_amp_updates(both)
    plan = tt._flat_plan
    assert len(plan.buckets) >= 3
    chunks = 1 if shard == "1" else 4
    sizes = [b.padded // chunks for b in plan.buckets for _ in range(chunks)]
    assert [k for k, _ in calls] == ["adam"] * 4
    for _, entries in calls:
        assert [n for n, _, _ in entries] == sizes
        assert len({lr for _, lr, _ in entries}) >= 2 and len({wd for _, _, wd in entries}) >= 2


def _masters(mod):
    owner = mod._fused_owner
    return {k: _np(v) for k, v in owner._fused_trainer.master_params_named(
        owner._fused_opt).items()}


@pytest.mark.parametrize("optname", ["sgd", "adam"])
def test_amp_fit_matches_jax(monkeypatch, optname):
    """The engage and master invariant of tests/test_amp.py:112-139 in the
    port; the port's masters against JAX's within twice JAX's own
    AMP-vs-f32 spread (plus one bf16 ulp of the tensor's max)."""
    _, jf32, _ = _fit(jmx, 4, optname, hidden=16)
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_FUSED_UPDATE_KERNEL", "1")
    jmod, _, jmetric = _fit(jmx, 4, optname)
    tmod, targ, tmetric = _fit(tmx, 4, optname)
    tr = tmod._fused_owner._fused_trainer
    assert tr.amp and tr.flat_mode == "shard"
    assert np.isfinite(tmetric)
    masters = _masters(tmod)
    for name, p in tmod._fused_owner._fused_params.items():
        assert p.dtype == torch.bfloat16, name
        mt = torch.from_numpy(masters[name])
        assert masters[name].dtype == np.float32
        assert torch.equal(p, mt.to(torch.bfloat16)), "%s != bf16(master)" % name
    for name, v in targ.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, masters[name])
    assert float(tmod._fused_owner._fused_opt[tr.AMP_SCALE_KEY]) >= 1.0
    jmasters = _masters(jmod)
    for n, want in jmasters.items():
        spread = float(np.abs(want - jf32[n]).max())
        ulp = 2.0 ** (np.floor(np.log2(max(float(np.abs(want).max()), 1e-30))) - 7)
        err = float(np.abs(masters[n] - want).max())
        assert err <= 2 * spread + ulp, (n, err, spread)
    assert abs(tmetric - jmetric) < 0.05


# ---------------------------------------------------------------------------
# loss scaler, dp = 1, state files
# ---------------------------------------------------------------------------

def _direct_trainer(ndev, batch=16, in_dim=8):
    """tests/test_amp.py's ``_direct_trainer`` in the port."""
    net = _mlp(tmx)
    mesh = tmx.parallel.make_mesh(dp=ndev, devices=[tmx.cpu()] * ndev)
    o = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / batch)
    trainer = tmx.parallel.ShardedTrainStep(net, mesh, optimizer=o).compile()
    shapes = {"data": (batch, in_dim), "softmax_label": (batch,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    params, aux, state = trainer.init(dict(zip(net.list_arguments(), arg_shapes)),
                                      tmx.initializer.Uniform(0.1))
    return trainer, params, aux, state


def _batch(X, y):
    return {"data": torch.from_numpy(X), "softmax_label": torch.from_numpy(y)}


def _snap(d):
    return {k: v.clone() for k, v in d.items()}


def test_amp_overflow_skips_bitwise_and_recovers(monkeypatch):
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_SHARD_UPDATE", "1")
    trainer, params, aux, state = _direct_trainer(2)
    assert trainer.amp
    rng = np.random.RandomState(3)
    X = rng.randn(16, 8).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    params, aux, state, _ = trainer(params, aux, state, _batch(X, y), t=1)
    snap_p, snap_s = _snap(params), _snap(state)
    scale0 = float(state[trainer.AMP_SCALE_KEY])
    assert float(state[trainer.AMP_GOOD_KEY]) == 1.0
    X_bad = X.copy()
    X_bad[0, 0] = np.inf
    params, aux, state, _ = trainer(params, aux, state, _batch(X_bad, y), t=2)
    for k, v in params.items():
        assert torch.equal(v, snap_p[k]), "param %s changed" % k
    for k, v in state.items():
        if k not in (trainer.AMP_SCALE_KEY, trainer.AMP_GOOD_KEY):
            assert torch.equal(v, snap_s[k]), "state %s changed" % k
    assert float(state[trainer.AMP_SCALE_KEY]) == scale0 / 2
    assert float(state[trainer.AMP_GOOD_KEY]) == 0.0
    params, aux, state, _ = trainer(params, aux, state, _batch(X, y), t=3)
    assert any(not torch.equal(v, snap_p[k]) for k, v in params.items())
    assert float(state[trainer.AMP_GOOD_KEY]) == 1.0
    assert float(state[trainer.AMP_SCALE_KEY]) == scale0 / 2
    for v in params.values():
        assert bool(torch.isfinite(v.float()).all())


def test_amp_scale_growth(monkeypatch):
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "8")
    monkeypatch.setenv("MXTPU_LOSS_SCALE_WINDOW", "3")
    trainer, params, aux, state = _direct_trainer(2)
    assert trainer.amp and float(state[trainer.AMP_SCALE_KEY]) == 8.0
    rng = np.random.RandomState(5)
    batch = _batch(rng.randn(16, 8).astype(np.float32),
                   rng.randint(0, 4, 16).astype(np.float32))
    for t in (1, 2):
        params, aux, state, _ = trainer(params, aux, state, batch, t=t)
        assert float(state[trainer.AMP_SCALE_KEY]) == 8.0
        assert float(state[trainer.AMP_GOOD_KEY]) == t
    params, aux, state, _ = trainer(params, aux, state, batch, t=3)
    assert float(state[trainer.AMP_SCALE_KEY]) == 16.0
    assert float(state[trainer.AMP_GOOD_KEY]) == 0.0


def test_amp_declines_at_dp1(monkeypatch, caplog):
    """tests/test_amp.py:142-159: one context takes no fused path; a dp = 1
    mesh takes it without the flat update, and AMP declines with JAX's
    warning and runs f32."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    mod, _, metric = _fit(tmx, 1, "sgd", num_epoch=1)
    assert mod._fused_trainer is None and np.isfinite(metric)
    rng = np.random.RandomState(42)
    it = tmx.io.NDArrayIter(rng.randn(64, 8).astype(np.float32),
                            rng.randint(0, 4, 64).astype(np.float32), batch_size=16)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu(),
                         mesh=tmx.parallel.make_mesh(dp=1, devices=[tmx.cpu()]))
    with caplog.at_level(logging.WARNING):
        mod.fit(it, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "rescale_grad": 1.0 / 16},
                initializer=tmx.init.Uniform(0.1), num_epoch=1)
    tr = mod._fused_trainer
    assert tr is not None and tr.flat_mode is None and not tr.amp
    assert "MXTPU_AMP=bf16 ignored" in caplog.text
    assert all(p.dtype == torch.float32 for p in mod._fused_params.values())


def test_mesh_spanning_two_devices_raises():
    with pytest.raises(NotImplementedError, match="NCCL"):
        tmx.parallel.make_mesh(dp=2, devices=[torch.device("cpu"), torch.device("meta")])


@pytest.mark.parametrize("amp", [False, True])
def test_optimizer_state_file_crosses_packages(monkeypatch, tmp_path, amp):
    """The port's fused ``save_optimizer_states`` (per-parameter numpy
    trees, the scaler under AMP) loads into the JAX package's fused Module,
    and back: the flat slabs rebuilt on each side are equal."""
    if amp:
        monkeypatch.setenv("MXTPU_AMP", "bf16")
    tmod, _, _ = _fit(tmx, 4, "sgd", num_epoch=1)
    jmod, _, _ = _fit(jmx, 4, "sgd", num_epoch=1)
    fname = str(tmp_path / "opt.states")
    tmod.save_optimizer_states(fname)
    jmod.load_optimizer_states(fname)
    jstate = jmod._fused_opt_host_state()
    tstate = tmod._fused_opt_host_state()
    assert jstate["t"] == tstate["t"] == 8
    assert jstate.get("amp") == tstate.get("amp")
    for n, v in tstate["state"].items():
        np.testing.assert_array_equal(np.asarray(jstate["state"][n]), v, err_msg=n)
    jmod.save_optimizer_states(fname)
    tmod.load_optimizer_states(fname)
    again = tmod._fused_opt_host_state()
    for n, v in tstate["state"].items():
        np.testing.assert_array_equal(again["state"][n], v, err_msg=n)
