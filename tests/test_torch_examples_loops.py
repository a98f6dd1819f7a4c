"""The port's examples with a hand-written loop (``mxnet_tpu_torch/
examples/``: bayesian_sgld, train_gan, reinforce_gridworld) against their
JAX twins under ``examples/`` on the CPU. Where the framework's generator
enters (SGLD's noise) the run is held by repeat from one seed and by its
own outcome (the analytic posterior); the GAN's two Modules and the
policy's executor are held step for step from the same parameters within
1e-5 of max (f32), and the runs by their outcomes."""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import bayesian_sgld, reinforce_gridworld, train_gan
from mxnet_tpu_torch.io import DataBatch
from torch_example_parity import one_thread  # noqa: F401 (autouse)
from torch_example_parity import assert_same_symbol, fresh, jax_example, of_max, run_port


def test_bayesian_sgld_matches_the_analytic_posterior_and_repeats():
    runs = [run_port(bayesian_sgld, []) for _ in range(2)]  # each asserts the posterior
    assert all(0.65 < r < 1.35 for r in runs[0]["std_ratio"])
    np.testing.assert_array_equal(runs[0]["draws"], runs[1]["draws"])
    assert np.ptp(runs[0]["draws"], axis=0).min() > 0


def _gan_pair(batch=32, nz=8, lr=0.01):
    """The port's and the JAX example's generator and discriminator, the
    port's holding the JAX ones' initial parameters."""
    j = jax_example("train_gan")
    np.random.seed(0)
    jgen, jdisc = j.build_modules(jmx, batch, nz, lr)
    with tmx.cpu():
        tgen, tdisc = train_gan.build_modules(batch, nz, lr, tmx.cpu())
        for t, jm in ((tgen, jgen), (tdisc, jdisc)):
            arg, aux = jm.get_params()
            t.set_params({k: tmx.nd.array(v.asnumpy()) for k, v in arg.items()},
                         {k: tmx.nd.array(v.asnumpy()) for k, v in aux.items()})
    return (tgen, tdisc), (jgen, jdisc)


def _gan_step(mx, gen, disc, noise, real, batch, DB):
    ones, zeros = mx.nd.ones((batch, 1)), mx.nd.zeros((batch, 1))
    gen.forward(DB(data=[mx.nd.array(noise)], label=[]), is_train=True)
    fake = gen.get_outputs()[0]
    seen = [fake.asnumpy()]
    for x, lab in ((mx.nd.array(real), ones), (fake, zeros)):
        disc.forward(DB(data=[x], label=[lab]), is_train=True)
        disc.backward()
        disc.update()
        seen.append(disc.get_outputs()[0].asnumpy())
    disc.forward(DB(data=[fake], label=[ones]), is_train=True)
    disc.backward()
    grad = disc.get_input_grads()[0]
    seen.append(grad.asnumpy())
    gen.backward([grad])
    gen.update()
    return seen


def test_train_gan_matches_jax_step_for_step():
    batch = 32
    (tgen, tdisc), (jgen, jdisc) = _gan_pair(batch)
    j = jax_example("train_gan")
    assert tgen.symbol.list_arguments() == jgen.symbol.list_arguments()
    assert tdisc.symbol.list_arguments() == jdisc.symbol.list_arguments()
    rng = np.random.RandomState(0)
    for step in range(3):
        noise = rng.randn(batch, 8).astype(np.float32)
        real = (train_gan.TARGET_MEAN + 0.3 * rng.randn(batch, 2)).astype(np.float32)
        want = _gan_step(jmx, jgen, jdisc, noise, real, batch, jmx.io.DataBatch)
        with tmx.cpu():
            got = _gan_step(tmx, tgen, tdisc, noise, real, batch, DataBatch)
        for i, (g, w) in enumerate(zip(got, want)):
            of_max(g, w, 1e-5, "step %d, value %d" % (step, i))
    np.testing.assert_array_equal(train_gan.TARGET_MEAN, j.TARGET_MEAN)


def test_train_gan_repeats_and_its_discriminator_learns():
    outs = []
    for _ in range(2):
        np.random.seed(0)  # the initializers draw from numpy's generator
        outs.append(train_gan.train(steps=40, batch=32, log=None, ctx=tmx.cpu()))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (512, 2) and np.all(np.isfinite(outs[0]))
    (gen, disc), _ = _gan_pair(32)
    rng = np.random.RandomState(1)
    with tmx.cpu():
        for _ in range(30):
            noise = rng.randn(32, 8).astype(np.float32)
            real = (train_gan.TARGET_MEAN + 0.3 * rng.randn(32, 2)).astype(np.float32)
            _gan_step(tmx, gen, disc, noise, real, 32, DataBatch)
        real = (train_gan.TARGET_MEAN + 0.3 * rng.randn(32, 2)).astype(np.float32)
        disc.forward(DataBatch([tmx.nd.array(real)], [tmx.nd.ones((32, 1))]), is_train=False)
        p_real = disc.get_outputs()[0].asnumpy().mean()
        gen.forward(DataBatch([tmx.nd.array(rng.randn(32, 8).astype(np.float32))], []),
                    is_train=False)
        disc.forward(DataBatch([gen.get_outputs()[0]], [tmx.nd.zeros((32, 1))]), is_train=False)
        p_fake = disc.get_outputs()[0].asnumpy().mean()
    assert p_real > p_fake + 0.05, (p_real, p_fake)


def test_reinforce_policy_matches_jax_and_improves():
    j = jax_example("reinforce_gridworld")
    tsym, jsym = fresh(tmx, reinforce_gridworld.build_policy), fresh(jmx, j.build_policy)
    n = 64
    assert_same_symbol(tsym, jsym, state=(n,), action=(n,), advantage=(n,))
    rng = np.random.RandomState(0)
    feed = {"state": rng.randint(0, 25, n).astype(np.float32),
            "action": rng.randint(0, 4, n).astype(np.float32),
            "advantage": rng.randn(n).astype(np.float32)}
    np.random.seed(0)
    jexe = jsym.simple_bind(ctx=jmx.cpu(), grad_req="write", **{k: (n,) for k in feed})
    init = jmx.init.Xavier()
    for name, arr in jexe.arg_dict.items():
        if name not in feed:
            init(jmx.init.InitDesc(name), arr)
    with tmx.cpu():
        texe = tsym.simple_bind(ctx=tmx.cpu(), grad_req="write", **{k: (n,) for k in feed})
        for name, arr in jexe.arg_dict.items():
            texe.arg_dict[name][:] = feed[name] if name in feed else arr.asnumpy()
        for name in feed:
            jexe.arg_dict[name][:] = feed[name]
        want = [o.asnumpy() for o in jexe.forward(is_train=True)]
        jexe.backward()
        got = [o.asnumpy() for o in texe.forward(is_train=True)]
        texe.backward()
        for i, (g, w) in enumerate(zip(got, want)):
            of_max(g, w, 1e-5, "output %d" % i)
        for name in jexe.grad_dict:
            if name not in feed:
                of_max(texe.grad_dict[name].asnumpy(), jexe.grad_dict[name].asnumpy(), 1e-5,
                       "grad " + name)
    assert reinforce_gridworld.step(3, 1) == j.step(3, 1)
    res = run_port(reinforce_gridworld, ["--iters", "35"])
    assert res["final"] > res["base"] + 0.5
