"""The PyTorch port's optimizers, initializers and lr schedules held against
the JAX package's on the CPU. Every optimizer the port registers runs four
updates on the same weight, gradient and state in both packages, with
lr_mult / wd_mult, gradient clipping and an lr scheduler: weights and
states within 1e-6. Initializers give equal arrays under one
``np.random`` seed (both draw from numpy); schedules give equal values.
SGLD's noise cannot repeat JAX's threefry draws: it is held by its moments
and by repeating from one seed."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


OPTIMIZERS = {
    "sgd": dict(momentum=0.9),
    "sgd_plain": dict(),
    "nag": dict(momentum=0.9),
    "ccsgd": dict(momentum=0.5),
    "dcasgd": dict(momentum=0.9, lamda=0.1),
    "adam": dict(beta1=0.8, beta2=0.99),
    "adagrad": dict(eps=1e-6),
    "rmsprop": dict(gamma1=0.8),
    "rmsprop_centered": dict(gamma1=0.8, gamma2=0.7, centered=True, clip_weights=2.0),
    "adadelta": dict(rho=0.8),
    "ftrl": dict(lamda1=0.05, beta=1.5),
    "test": dict(),
}
NAMES = {0: "fc_weight", 1: "fc_bias"}


def _make(pkg, name, kwargs, scheduled):
    sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5) if scheduled else None
    opt = pkg.optimizer.create(name.split("_")[0] if name != "sgd_plain" else "sgd",
                               learning_rate=0.1, wd=0.01, rescale_grad=0.5,
                               clip_gradient=1.5, lr_scheduler=sched, param_idx2name=NAMES,
                               **kwargs)
    opt.set_lr_mult({"fc_weight": 0.7})
    opt.set_wd_mult({"fc_bias": 0.3})
    return opt


def _state_np(st):
    if st is None:
        return []
    if isinstance(st, tuple):
        return [x for s in st for x in _state_np(s)]
    return [st.asnumpy()]


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name, scheduled):
    rng = np.random.RandomState(3)
    shapes = {0: (4, 5), 1: (5,)}
    w0 = {i: rng.randn(*s).astype(np.float32) for i, s in shapes.items()}
    grads = [{i: (rng.randn(*s) * 2).astype(np.float32) for i, s in shapes.items()}
             for _ in range(4)]
    jopt = _make(jmx, name, OPTIMIZERS[name], scheduled)
    topt = _make(tmx, name, OPTIMIZERS[name], scheduled)
    jw = {i: jmx.nd.array(v) for i, v in w0.items()}
    tw = {i: tmx.nd.array(v) for i, v in w0.items()}
    jst = {i: jopt.create_state(i, jw[i]) for i in shapes}
    tst = {i: topt.create_state(i, tw[i]) for i in shapes}
    for g in grads:
        for i in shapes:
            jopt.update(i, jw[i], jmx.nd.array(g[i]), jst[i])
            topt.update(i, tw[i], tmx.nd.array(g[i]), tst[i])
        for i in shapes:
            np.testing.assert_allclose(tw[i].asnumpy(), jw[i].asnumpy(), rtol=1e-6, atol=1e-6,
                                       err_msg="%s weight %d" % (name, i))
            for a, b in zip(_state_np(tst[i]), _state_np(jst[i])):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg="%s state %d" % (name, i))
    assert topt.num_update == jopt.num_update
    assert topt._index_update_count == jopt._index_update_count


def test_registries_match_and_sgld_raises():
    """The registries match; SGLD, which raised until it was ported,
    constructs and steps."""
    assert sorted(tmx.optimizer.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
    opt = tmx.optimizer.create("sgld", learning_rate=0.01)
    w = tmx.nd.ones((3,))
    opt.update(0, w, tmx.nd.zeros((3,)), opt.create_state(0, w))
    assert np.isfinite(w.asnumpy()).all()


def _sgld_steps(pkg, seed, steps=3, n=20000, opt=None):
    """Weights after ``steps`` SGLD updates of a zero weight by a constant
    gradient, from ``pkg.random.seed(seed)`` (no seeding for None), by
    ``opt`` or a new optimizer."""
    if seed is not None:
        pkg.random.seed(seed)
    if opt is None:
        opt = pkg.optimizer.create("sgld", learning_rate=0.04, wd=0.5, rescale_grad=0.5)
    w = pkg.nd.array(np.full((n,), 0.3, np.float32))
    g = pkg.nd.array(np.full((n,), 2.0, np.float32))
    for _ in range(steps):
        opt.update(0, w, g, opt.create_state(0, w))
    return w.asnumpy()


def test_sgld_moments_match_jax():
    """One step: w - lr/2 (rescale * g + wd * w) + N(0, lr); the mean and the
    standard deviation of 20000 draws in each package match the formula
    within four standard errors."""
    n, lr = 20000, 0.04
    want_mean = 0.3 - lr / 2 * (0.5 * 2.0 + 0.5 * 0.3)
    for pkg in (jmx, tmx):
        w = _sgld_steps(pkg, 5, steps=1, n=n)
        assert abs(w.mean() - want_mean) < 4 * np.sqrt(lr / n), pkg.__name__
        assert abs(w.std() - np.sqrt(lr)) < 4 * np.sqrt(lr / (2 * n)), pkg.__name__
        noise = w - want_mean
        assert abs(np.mean(noise ** 3)) < 4 * np.sqrt(15 * lr ** 3 / n)  # symmetric


def test_sgld_repeats_from_one_seed():
    a, b, c = _sgld_steps(tmx, 11), _sgld_steps(tmx, 11), _sgld_steps(tmx, 12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sgld_reseeds_and_leaves_numpy_alone(monkeypatch):
    """``mx.random.seed`` restarts an existing optimizer's draws; with no
    seed set, SGLD's draws take nothing from numpy's global stream."""
    opt = tmx.optimizer.create("sgld", learning_rate=0.04, wd=0.5, rescale_grad=0.5)
    a = _sgld_steps(tmx, 11, n=64, opt=opt)
    b = _sgld_steps(tmx, 11, n=64, opt=opt)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _sgld_steps(tmx, 11, n=64))
    monkeypatch.setattr(tmx.random._st(), "seed", None)
    np.random.seed(7)
    want = np.random.rand(4)
    np.random.seed(7)
    c = _sgld_steps(tmx, None, n=64, opt=opt)
    np.testing.assert_array_equal(np.random.rand(4), want)
    assert not np.array_equal(a, c)


def test_updater_states_round_trip():
    opt = tmx.optimizer.create("adam", learning_rate=0.01)
    up = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(np.ones((3, 2), np.float32))
    up(0, tmx.nd.array(np.full((3, 2), 0.5, np.float32)), w)
    blob = up.get_states()
    up2 = tmx.optimizer.get_updater(opt)
    up2.set_states(blob)
    for a, b in zip(up.states[0], up2.states[0]):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


INITS = [
    ("Uniform", dict(scale=0.3)), ("Normal", dict(sigma=0.2)), ("Xavier", dict()),
    ("Xavier", dict(rnd_type="gaussian", factor_type="in", magnitude=2)),
    ("MSRAPrelu", dict(slope=0.1)), ("Orthogonal", dict()), ("Zero", dict()),
    ("One", dict()), ("Constant", dict(value=0.25)), ("Bilinear", dict()),
    ("LSTMBias", dict(forget_bias=2.0)),
]


@pytest.mark.parametrize("name,kwargs", INITS)
def test_initializer_matches_jax(name, kwargs):
    shapes = {"conv_weight": (8, 4, 3, 3), "fc_weight": (12, 7), "fc_bias": (12,),
              "bn_gamma": (4,), "bn_beta": (4,), "bn_moving_mean": (4,), "bn_moving_var": (4,)}
    if name == "Bilinear":  # an upsampling filter: 4-D weights only
        del shapes["fc_weight"]
    out = {}
    for pkg in (jmx, tmx):
        init = getattr(pkg.init, name)(**kwargs)
        np.random.seed(11)
        arrs = {}
        for n, s in shapes.items():
            arr = pkg.nd.zeros(s)
            init(pkg.init.InitDesc(n), arr)
            arrs[n] = arr.asnumpy()
        out[pkg] = arrs
    for n in shapes:
        np.testing.assert_array_equal(out[tmx][n], out[jmx][n], err_msg=n)


def test_mixed_and_load_match_jax():
    src = {"arg:fc_weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for pkg in (jmx, tmx):
        init = pkg.init.Mixed(["fc_.*", ".*"], [pkg.init.Load(src), pkg.init.Constant(3.0)])
        a, b = pkg.nd.zeros((2, 3)), pkg.nd.zeros((4,))
        init("fc_weight", a)
        init("other", b)
        np.testing.assert_array_equal(a.asnumpy(), src["arg:fc_weight"])
        np.testing.assert_array_equal(b.asnumpy(), np.full(4, 3.0, np.float32))


def test_lr_schedules_match_jax():
    for make in (lambda p: p.lr_scheduler.FactorScheduler(step=3, factor=0.7,
                                                          stop_factor_lr=1e-3),
                 lambda p: p.lr_scheduler.MultiFactorScheduler(step=[2, 5, 9], factor=0.5)):
        js, ts = make(jmx), make(tmx)
        js.base_lr = ts.base_lr = 0.2
        assert [ts(n) for n in range(30)] == [js(n) for n in range(30)]
