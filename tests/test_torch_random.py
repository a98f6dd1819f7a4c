"""The PyTorch port's samplers and seed (mx.random) on the CPU. Streams
cannot match the JAX package's threefry keys, so each sampler is held by
its moments, beside the JAX package's own draws of the same shape; plus
tests/test_random.py's seed determinism, ``out=``, and sampling inside a
bound graph."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


# (sampler, positional args, mean, std) of the distribution
SAMPLERS = [
    ("uniform", (-2.0, 2.0), 0.0, 4.0 / np.sqrt(12.0)),
    ("normal", (1.0, 3.0), 1.0, 3.0),
    ("gamma", (2.0, 2.0), 4.0, np.sqrt(2.0) * 2.0),
    ("exponential", (2.0,), 0.5, 0.5),
    ("poisson", (3.0,), 3.0, np.sqrt(3.0)),
    ("negative_binomial", (4, 0.5), 4.0, np.sqrt(8.0)),
    ("generalized_negative_binomial", (2.0, 0.5), 2.0, np.sqrt(2.0 + 0.5 * 4.0)),
]


@pytest.mark.parametrize("name,args,mean,std", SAMPLERS, ids=[s[0] for s in SAMPLERS])
def test_sampler_moments(name, args, mean, std):
    """Mean within 5 standard errors and std within 10% of the
    distribution's, for the port and for the JAX package alike."""
    n = 20000
    tmx.random.seed(7)
    jmx.random.seed(7)
    for pkg in (tmx, jmx):
        x = getattr(pkg.random, name)(*args, shape=(n,)).asnumpy().astype(np.float64)
        assert x.shape == (n,) and x.dtype == np.float64
        assert abs(x.mean() - mean) < 5 * std / np.sqrt(n), (pkg.__name__, x.mean(), mean)
        assert abs(x.std() - std) < 0.1 * std, (pkg.__name__, x.std(), std)
    x = tmx.random.uniform(-2.0, 2.0, shape=(n,)).asnumpy()
    assert x.min() >= -2 and x.max() <= 2


def test_seed_determinism_and_state():
    tmx.random.seed(42)
    a = tmx.random.uniform(0, 1, shape=(10,)).asnumpy()
    tmx.random.seed(42)
    b = tmx.random.uniform(0, 1, shape=(10,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    state = tmx.random.get_state()
    c = tmx.random.uniform(0, 1, shape=(10,)).asnumpy()
    assert not np.array_equal(b, c)
    tmx.random.set_state(state)
    np.testing.assert_array_equal(tmx.random.uniform(0, 1, shape=(10,)).asnumpy(), c)
    d = tmx.nd.uniform(low=0, high=1, shape=(3,), dtype="float64")
    assert d.dtype == np.float64


def test_state_round_trip_follows_the_context():
    """Under ``with mx.cpu():`` get_state/set_state with no device restore
    the stream mx.nd.uniform draws from (the host's)."""
    tmx.random.seed(3)
    tmx.nd.uniform(low=0, high=1, shape=(4,))
    state = tmx.random.get_state()
    want = tmx.nd.uniform(low=0, high=1, shape=(6,)).asnumpy()
    assert not np.array_equal(want, tmx.nd.uniform(low=0, high=1, shape=(6,)).asnumpy())
    tmx.random.set_state(state)
    np.testing.assert_array_equal(tmx.nd.uniform(low=0, high=1, shape=(6,)).asnumpy(), want)
    np.testing.assert_array_equal(tmx.random.get_state(), tmx.random.get_state(tmx.cpu()))


def test_state_without_context_is_the_cards(monkeypatch):
    """With no context entered the default device is gpu(0): get_state()
    snapshots the card's stream, and raises MXNetError without a card."""
    monkeypatch.setattr(tmx.context.Context._default_ctx, "value", None)
    if torch.cuda.is_available():
        state = tmx.random.get_state()
        np.testing.assert_array_equal(state, tmx.random.get_state(tmx.gpu(0)))
    else:
        with pytest.raises(tmx.MXNetError):
            tmx.random.get_state()
        with pytest.raises(tmx.MXNetError):
            tmx.random.set_state(np.zeros(8, np.uint8))


def test_out_kwarg_shape():
    a = tmx.nd.zeros((3, 4))
    t = a._data
    tmx.random.uniform(0, 1, out=a)
    assert a.shape == (3, 4) and a._data is t
    assert a.asnumpy().std() > 0


def test_symbol_random_ops_draw_per_forward():
    """A sampling node inside a bound graph draws from the device's
    generator on each forward (tests/test_random.py's graph case)."""
    s = tmx.sym.uniform(low=0.0, high=1.0, shape=(100,))
    exe = s.bind(tmx.cpu(), {})
    exe.forward()
    a = exe.outputs[0].asnumpy().copy()
    exe.forward()
    b = exe.outputs[0].asnumpy()
    assert not np.array_equal(a, b)
    assert 0.0 <= a.min() and a.max() <= 1.0 and abs(a.mean() - 0.5) < 0.15
    with pytest.raises(tmx.MXNetError, match="rng"):
        tmx.executor._GraphProgram(s)({}, {}, None, False)


def test_recorded_sampler_replays_the_same_draw():
    """autograd replays a sampling op with the generator state it drew
    from, so the gradient sees the forward's noise."""
    x = tmx.nd.array(np.ones(5, np.float32))
    gx = tmx.nd.zeros(5)
    tmx.autograd.mark_variables([x], [gx])
    with tmx.autograd.train_section():
        noise = tmx.nd.normal(loc=0, scale=1, shape=(5,))
        y = x * noise
    tmx.autograd.backward([y])
    np.testing.assert_array_equal(gx.asnumpy(), noise.asnumpy())
