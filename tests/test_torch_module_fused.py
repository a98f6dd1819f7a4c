"""``Module.fit`` on the port's fused mesh path (mirrors
``tests/test_module_fused.py``), on the CPU, held to the JAX package.

Four logical dp ranks on the host with kvstore 'device' route the update
through ``ShardedTrainStep`` and give the single-device executor path's
numbers (rtol 2e-4, atol 2e-5, the reference test's limits) for SGD with
momentum, Adam, RMSProp, NAG and AdaGrad, and the JAX package's fused
numbers at the same limits; a scheduled lr takes effect step by step; a
fit reaches 95% accuracy; and a fused checkpoint with optimizer state
resumes the Adam step count and trains on."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    for k in ("MXTPU_AMP", "MXNET_FIT_MULTISTEP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES"):
        monkeypatch.delenv(k, raising=False)
    with tmx.cpu():
        yield


def _mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _blob_iter(mx, batch_size=32, n=128, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, 8) * 3
    x = np.concatenate([c + rng.randn(n // 4, 8) * 0.3 for c in centers]).astype("f")
    y = np.repeat(np.arange(4), n // 4).astype("f")
    perm = rng.permutation(n)
    return mx.io.NDArrayIter(x[perm], y[perm], batch_size=batch_size)


def _train_params(mx, ctx, kvstore, optimizer, optimizer_params, n_batches=3, lrs=None):
    it = _blob_iter(mx)
    mod = mx.mod.Module(_mlp(mx), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(0)
    np.random.seed(0)
    mod.init_params(mx.init.Uniform(0.1))
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer, optimizer_params=optimizer_params)
    it.reset()
    for i, batch in enumerate(it):
        if i >= n_batches:
            break
        if lrs is not None:
            mod._optimizer.lr = lrs[i]
        mod.forward(batch)
        mod.backward()
        mod.update()
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _four(mx):
    return [mx.cpu(i) for i in range(4)]


def _close(a, b):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 0.1}),
])
def test_fused_matches_single_device_and_jax(optimizer, opt_params):
    mod_f, fused = _train_params(tmx, _four(tmx), "device", optimizer, opt_params)
    assert mod_f._fused_trainer is not None, "fused path not taken"
    mod_s, single = _train_params(tmx, tmx.cpu(), "local", optimizer, opt_params)
    assert mod_s._fused_trainer is None
    _close(fused, single)
    _, jfused = _train_params(jmx, _four(jmx), "device", optimizer, opt_params)
    _close(fused, jfused)


def test_fused_lr_scheduler():
    """FactorScheduler(step=2, factor=0.1) at base 0.5 over 4 steps is the
    lr sequence [0.5, 0.5, 0.05, 0.05] on the fused path."""
    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.1)
    mod_f, fused = _train_params(tmx, _four(tmx), "device", "sgd",
                                 {"learning_rate": 0.5, "lr_scheduler": sched}, n_batches=4)
    assert mod_f._fused_trainer is not None
    _, single = _train_params(tmx, tmx.cpu(), "local", "sgd", {"learning_rate": 0.5},
                              n_batches=4, lrs=[0.5, 0.5, 0.05, 0.05])
    _close(fused, single)


def test_fused_fit_and_score():
    mod = tmx.mod.Module(_mlp(tmx), context=_four(tmx))
    mod.fit(_blob_iter(tmx), optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9}, kvstore="device",
            num_epoch=8)
    assert mod._fused_trainer is not None
    acc = dict(mod.score(_blob_iter(tmx), tmx.metric.Accuracy()))["accuracy"]
    assert acc >= 0.95, acc


def test_fused_checkpoint_roundtrip(tmp_path):
    it = _blob_iter(tmx)
    mod = tmx.mod.Module(_mlp(tmx), context=_four(tmx))
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": 0.01}, kvstore="device",
            num_epoch=2)
    prefix = str(tmp_path / "fused")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    mod2 = tmx.mod.Module.load(prefix, 2, load_optimizer_states=True, context=_four(tmx))
    it.reset()
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.init_optimizer(kvstore="device", optimizer="adam",
                        optimizer_params={"learning_rate": 0.01})
    assert mod2._fused_t == mod._fused_t  # the resumed Adam step count
    batch = next(iter(it))
    before = {k: v.asnumpy().copy() for k, v in mod2.get_params()[0].items()}
    mod2.forward(batch)
    mod2.backward()
    mod2.update()
    after = mod2.get_params()[0]
    assert any(not np.allclose(before[k], after[k].asnumpy()) for k in before)
