"""BatchNorm across the port's two training paths (mirrors
``tests/test_fused_bn.py``), on the CPU, held to the JAX package.

The fused dp-4 path (kvstore 'device', ``ShardedTrainStep``) reduces the
BatchNorm statistics over the global batch: the moving variance is the
global one and equals the single-device run's (rtol 1e-5); the executor
path over two contexts normalizes each slice with its own statistics and
averages the moving statistics, an order of magnitude below the global
variance. Every moving statistic also equals the JAX package's for the
same path (rtol 1e-5). A bf16 graph's inference BatchNorm keeps the
activations bf16."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

B, C = 8, 2
MOM = 0.9


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    for k in ("MXTPU_AMP", "MXNET_FIT_MULTISTEP"):
        monkeypatch.delenv(k, raising=False)
    with tmx.cpu():
        yield


def _bn_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.BatchNorm(data, name="bn", momentum=MOM, fix_gamma=True)
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=1, name="fc")
    return mx.sym.LinearRegressionOutput(net, name="lro")


def _make_data(n_groups):
    """B rows in n_groups blocks with very different means."""
    rng = np.random.RandomState(0)
    offsets = np.linspace(-30, 30, n_groups)
    X = np.concatenate([off + rng.randn(B // n_groups, C, 1, 1) for off in offsets])
    return X.astype(np.float32), rng.randn(B, 1).astype(np.float32)


def _train_one_batch(mx, contexts, kvstore, X, y):
    it = mx.io.NDArrayIter(X, y, batch_size=B, label_name="lro_label")
    mod = mx.mod.Module(_bn_net(mx), label_names=("lro_label",), context=contexts)
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(1)
    mx.random.seed(1)
    mod.init_params(mx.initializer.Uniform(0.01))
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 1e-6})
    batch = next(iter(it))
    mod.forward(batch)
    mod.backward()
    mod.update()
    _, aux = mod.get_params()
    assert (mod._fused_trainer is not None) == (kvstore == "device")
    return {k: v.asnumpy() for k, v in aux.items()}


def test_fused_bn_uses_global_batch_stats():
    X, y = _make_data(n_groups=4)
    fused = _train_one_batch(tmx, [tmx.cpu(i) for i in range(4)], "device", X, y)
    single = _train_one_batch(tmx, [tmx.cpu(0)], None, X, y)
    expect_var = MOM * 1.0 + (1 - MOM) * X.var(axis=(0, 2, 3))
    np.testing.assert_allclose(fused["bn_moving_var"], expect_var, rtol=1e-4)
    np.testing.assert_allclose(fused["bn_moving_var"], single["bn_moving_var"], rtol=1e-5)
    np.testing.assert_allclose(fused["bn_moving_mean"], single["bn_moving_mean"], rtol=1e-5,
                               atol=1e-5)
    jax_fused = _train_one_batch(jmx, [jmx.cpu(i) for i in range(4)], "device", X, y)
    for k in fused:
        np.testing.assert_allclose(fused[k], jax_fused[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_executor_path_uses_per_device_stats():
    X, y = _make_data(n_groups=2)
    aux = _train_one_batch(tmx, [tmx.cpu(0), tmx.cpu(1)], "local", X, y)
    half = B // 2
    per_dev_var = np.stack([X[:half].var(axis=(0, 2, 3)),
                            X[half:].var(axis=(0, 2, 3))]).mean(axis=0)
    np.testing.assert_allclose(aux["bn_moving_var"], MOM + (1 - MOM) * per_dev_var, rtol=1e-4)
    global_expect = MOM * 1.0 + (1 - MOM) * X.var(axis=(0, 2, 3))
    assert np.all(global_expect > 10 * aux["bn_moving_var"])
    jaux = _train_one_batch(jmx, [jmx.cpu(0), jmx.cpu(1)], "local", X, y)
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_bn_inference_preserves_reduced_precision_dtype():
    data = tmx.sym.Variable("data")
    net = tmx.sym.Cast(data, dtype="bfloat16")
    net = tmx.sym.Convolution(net, kernel=(3, 3), num_filter=4, pad=(1, 1), name="c1")
    net = tmx.sym.BatchNorm(net, name="bn1")
    net = tmx.sym.Convolution(net, kernel=(3, 3), num_filter=4, pad=(1, 1), name="c2")
    exe = net.simple_bind(ctx=tmx.cpu(), data=(2, 3, 8, 8))
    exe.arg_dict["data"][:] = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    out = exe.forward(is_train=False)[0]
    assert out._data.dtype == __import__("torch").bfloat16
