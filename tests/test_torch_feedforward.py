"""The PyTorch port's ``model.FeedForward`` held against the JAX package's
on the CPU (``tests/test_module.py::test_feedforward_trainer_end_to_end``):
``fit`` on numpy arrays, ``predict``, ``score``, ``save`` / ``load`` and
``create``, from the same seeds in both packages (parameters and
predictions within 1e-5 of their max, equal scores), and the checkpoint it
saves loading in the other package.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    with tmx.cpu():
        yield


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(128, 10).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    return X, y


def _net(pkg):
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                                        num_hidden=2, name="fc"),
                                 name="softmax")


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(got[k]) / scale, np.asarray(v) / scale, rtol=0,
                                   atol=TOL, err_msg=k)


def _numpy(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _end_to_end(pkg, tmp_path):
    X, y = _data()
    np.random.seed(0)
    model = pkg.model.FeedForward(_net(pkg), ctx=pkg.cpu(), num_epoch=6, optimizer="sgd",
                                  learning_rate=0.3, numpy_batch_size=32)
    model.fit(X, y)
    probs = model.predict(X)
    score = model.score(pkg.io.NDArrayIter(X, y, batch_size=32))
    prefix = str(tmp_path / ("ff_" + pkg.__name__))
    model.save(prefix, 6)
    loaded = pkg.model.FeedForward.load(prefix, 6, ctx=pkg.cpu(), numpy_batch_size=32)
    return model, probs, score, loaded.predict(X), prefix


def test_feedforward_trainer_end_to_end_matches_jax(tmp_path):
    jm, jprobs, jscore, jprobs2, _ = _end_to_end(jmx, tmp_path)
    tm, tprobs, tscore, tprobs2, _ = _end_to_end(tmx, tmp_path)
    X, y = _data()
    assert tprobs.shape == (128, 2)
    acc = ((tprobs[:, 1] > tprobs[:, 0]).astype(np.float32) == y).mean()
    assert acc > 0.9, acc
    assert tscore[0] > 0.9 and tscore == jscore
    _close(_numpy(tm.arg_params), _numpy(jm.arg_params))
    np.testing.assert_allclose(tprobs, jprobs, rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(tprobs2, tprobs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tprobs2, jprobs2, rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_feedforward_checkpoint_loads_in_the_other_package(tmp_path, writer):
    src, dst = (tmx, jmx) if writer == "port" else (jmx, tmx)
    model, probs, _, _, prefix = _end_to_end(src, tmp_path)
    X, _ = _data()
    other = dst.model.FeedForward.load(prefix, 6, ctx=dst.cpu(), numpy_batch_size=32)
    assert other.begin_epoch == 6
    _close(_numpy(other.arg_params), _numpy(model.arg_params))
    np.testing.assert_allclose(other.predict(X), probs, rtol=TOL, atol=1e-6)


def test_feedforward_create_equals_a_module_fit():
    """FeedForward.create over 4 batches against Module.fit on the same
    iterator (the data order and the initial weights from one numpy
    seed), then predict and score (num_batch honoured)."""
    X, y = _data()
    np.random.seed(1)
    ff = tmx.model.FeedForward.create(_net(tmx), X, y, ctx=tmx.cpu(), num_epoch=1,
                                      initializer=tmx.init.Xavier(), numpy_batch_size=32,
                                      learning_rate=0.1, momentum=0.9)
    np.random.seed(1)
    train = tmx.io.NDArrayIter(X, y, batch_size=32, shuffle=True, last_batch_handle="roll_over")
    mod = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    mod.fit(train, optimizer="sgd", optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier(), num_epoch=1)
    arg, _ = mod.get_params()
    for k, v in arg.items():
        assert np.array_equal(ff.arg_params[k].asnumpy(), v.asnumpy()), k
    want = mod.predict(tmx.io.NDArrayIter(X, y, batch_size=32)).asnumpy()
    np.testing.assert_array_equal(ff.predict(X), want)
    assert ff.predict(X, num_batch=2).shape == (64, 2)
    assert ff.score(X) == [v for _, v in mod.score(tmx.io.NDArrayIter(X, np.zeros(128),
                                                                      batch_size=32), "acc")]


def test_feedforward_on_an_untrained_model_and_the_default_context():
    """predict / score before any fit bind a module with the initializer's
    weights (or the given ones); ctx=None is the current context."""
    X, y = _data()
    ff = tmx.model.FeedForward(_net(tmx), numpy_batch_size=32)
    assert ff.ctx == [tmx.cpu()]
    np.random.seed(2)
    assert ff.predict(X[:40]).shape == (40, 2)
    arg = {"fc_weight": tmx.nd.zeros((2, 10)), "fc_bias": tmx.nd.array([0.0, 1.0])}
    ff2 = tmx.model.FeedForward(_net(tmx), ctx=tmx.cpu(), arg_params=arg, numpy_batch_size=32)
    probs = ff2.predict(X)
    np.testing.assert_allclose(probs, np.tile(np.exp([0.0, 1.0]) / np.exp([0.0, 1.0]).sum(),
                                              (128, 1)), rtol=1e-6)
    with pytest.raises(TypeError):
        ff2.predict([1, 2, 3])
