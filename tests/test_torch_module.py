"""The PyTorch port's ``Module.fit`` on the executor-group path held
against the JAX package's on the CPU: an MLP and the LeNet (with
BatchNorm) of ``tests/test_train_convergence.py`` fitted on ``cpu(0)``
and with ``kvstore="local"`` on ``[cpu(0), cpu(1)]`` from the same seeds
in both packages (final params within 1e-5 of each tensor's max for the
MLP, 1e-4 for the LeNet; equal metric values). The JAX side's kvstore runs
synchronously (``MXNET_KVSTORE_ASYNC=0``): its asynchronous pushes and
pulls race with the epoch-end ``get_params``, which moves its result.
conv1's bias feeds BatchNorm, so its gradient is zero in exact arithmetic
and its value rounding noise (~1e-8 in both packages): a tensor whose JAX
max is below 1e-6 must stay below 1e-6 in the port. The digits convergence
gates of that file run in the port with its thresholds; and a checkpoint
written by either package loads in the other and scores identically."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import lenet as tlenet
from mxnet_tpu_torch.models import mlp as tmlp


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc2")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _lenet(pkg):
    """tests/test_train_convergence.py's conv / BatchNorm / pool net."""
    data = pkg.sym.Variable("data")
    net = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=16, pad=(1, 1), name="conv1")
    net = pkg.sym.BatchNorm(net, name="bn1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = pkg.sym.Convolution(net, kernel=(3, 3), num_filter=32, pad=(1, 1), name="conv2")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.Flatten(net)
    net = pkg.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data(conv, n=96):
    rng = np.random.RandomState(21)
    centers = rng.randn(10, 64).astype(np.float32)
    y = rng.randint(0, 10, n)
    X = centers[y] + 0.7 * rng.randn(n, 64).astype(np.float32)
    if conv:
        X = X.reshape(n, 1, 8, 8)
    return X.astype(np.float32), y.astype(np.float32)


def _fit(pkg, net, ctxs, kvstore, conv, epochs=3):
    X, y = _data(conv)
    np.random.seed(1)
    pkg.random.seed(1)
    train = pkg.io.NDArrayIter(X, y, batch_size=16, shuffle=True)
    val = pkg.io.NDArrayIter(X[:48], y[:48], batch_size=16)
    mod = pkg.mod.Module(net, context=ctxs)
    metric = pkg.metric.create("acc")
    mod.fit(train, eval_data=val, eval_metric=metric, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
            initializer=pkg.init.Xavier(), num_epoch=epochs)
    arg, aux = mod.get_params()
    params = {k: v.asnumpy() for k, v in {**arg, **aux}.items()}
    return mod, params, metric.get()[1], dict(mod.score(val, "acc"))["accuracy"]


CASES = {
    "mlp-cpu0": (_mlp, False, 1, 1e-5),
    "mlp-cpu01-local": (_mlp, False, 2, 1e-5),
    "lenet-cpu0": (_lenet, True, 1, 1e-4),
    "lenet-cpu01-local": (_lenet, True, 2, 1e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(case, monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    build, conv, ndev, tol = CASES[case]
    jmod, jp, jtrain, jval = _fit(jmx, build(jmx), [jmx.cpu(i) for i in range(ndev)], "local",
                                  conv)
    tmod, tp, ttrain, tval = _fit(tmx, build(tmx), [tmx.cpu(i) for i in range(ndev)], "local",
                                  conv)
    assert tmod._fused_trainer is None and jmod._fused_trainer is None
    assert (tmod._kvstore is None) == (jmod._kvstore is None) == (ndev == 1)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        scale = float(np.abs(jp[n]).max())
        if scale < 1e-6:  # rounding noise of a zero gradient
            assert float(np.abs(tp[n]).max()) < 1e-6, n
            continue
        np.testing.assert_allclose(tp[n] / scale, jp[n] / scale, rtol=0, atol=tol, err_msg=n)
    assert (ttrain, tval) == (jtrain, jval)


def _digits():
    from sklearn.datasets import load_digits

    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    perm = np.random.RandomState(0).permutation(len(X))
    X, y = X[perm], y[perm]
    return (X[:1500], y[:1500]), (X[1500:], y[1500:])


def _fit_digits(net, reshape=None, num_epoch=30, lr=0.1):
    (Xtr, ytr), (Xva, yva) = _digits()
    if reshape:
        Xtr, Xva = Xtr.reshape((-1,) + reshape), Xva.reshape((-1,) + reshape)
    train = tmx.io.NDArrayIter(Xtr, ytr, batch_size=50, shuffle=True)
    val = tmx.io.NDArrayIter(Xva, yva, batch_size=50)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    np.random.seed(1)
    tmx.random.seed(1)
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": 0.9, "wd": 1e-4},
            initializer=tmx.initializer.Xavier(), num_epoch=num_epoch)
    val.reset()
    va = dict(mod.score(val, tmx.metric.Accuracy()))["accuracy"]
    train.reset()
    tr = dict(mod.score(train, tmx.metric.Accuracy()))["accuracy"]
    return tr, va


def test_port_mlp_digits_reaches_97_percent():
    """tests/test_train_convergence.py:52's gate, in the port."""
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    train_acc, val_acc = _fit_digits(net)
    assert train_acc >= 0.99, train_acc
    assert val_acc >= 0.95, val_acc


def test_port_lenet_digits_converges():
    """tests/test_train_convergence.py:90's gate, in the port."""
    train_acc, val_acc = _fit_digits(_lenet(tmx), reshape=(1, 8, 8), num_epoch=20, lr=0.05)
    assert train_acc >= 0.99, train_acc
    assert val_acc >= 0.95, val_acc


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint saved by one package's Module loads with the other's
    ``Module.load`` and scores the same on the same data."""
    src, dst = (tmx, jmx) if writer == "port" else (jmx, tmx)
    X, y = _data(False, 48)
    mod, _, _, _ = _fit(src, _mlp(src), [src.cpu()], "local", False, epochs=1)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 1)
    want = dict(mod.score(src.io.NDArrayIter(X, y, batch_size=16), "acc"))["accuracy"]
    loaded = dst.mod.Module.load(prefix, 1, context=dst.cpu())
    it = dst.io.NDArrayIter(X, y, batch_size=16)
    loaded.bind(it.provide_data, it.provide_label, for_training=False)
    got = dict(loaded.score(it, "acc"))["accuracy"]
    assert got == want
    arg, _ = loaded.get_params()
    want_arg, _ = mod.get_params()
    for n, v in want_arg.items():
        np.testing.assert_array_equal(arg[n].asnumpy(), v.asnumpy())


def test_models_build_the_jax_symbols():
    jmlp = __import__("mxnet_tpu.models.mlp", fromlist=["get_symbol"])
    jlenet = __import__("mxnet_tpu.models.lenet", fromlist=["get_symbol"])
    for tm, jm in ((tmlp, jmlp), (tlenet, jlenet)):
        with jmx.name.NameManager():
            js = jm.get_symbol(num_classes=10)
        with tmx.name.NameManager():
            ts = tm.get_symbol(num_classes=10)
        assert ts.list_arguments() == js.list_arguments()
        shapes = dict(data=(2, 1, 28, 28))
        assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)


def test_predict_and_reshape_match_jax():
    """``predict`` (merged, with the last batch's pad cut), ``iter_predict``
    and a ``reshape`` to a smaller batch give the JAX package's outputs."""
    X, y = _data(False, 40)
    got = {}
    for pkg in (jmx, tmx):
        mod, _, _, _ = _fit(pkg, _mlp(pkg), [pkg.cpu()], "local", False, epochs=1)
        it = pkg.io.NDArrayIter(X, y, batch_size=16)  # 40 rows: the last batch pads 8
        merged = mod.predict(it).asnumpy()
        per_batch = [o[0].asnumpy() for o, _, _ in mod.iter_predict(it)]
        mod.reshape([("data", (8, 64))], [("softmax_label", (8,))])
        small = mod.predict(pkg.io.NDArrayIter(X[:24], y[:24], batch_size=8)).asnumpy()
        got[pkg] = (merged, per_batch, small)
    assert got[tmx][0].shape == (40, 10)
    np.testing.assert_allclose(got[tmx][0], got[jmx][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[tmx][1], got[jmx][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[tmx][2], got[jmx][2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[tmx][2], got[tmx][0][:24], rtol=1e-6, atol=1e-7)


def test_unported_surface_raises():
    # the dist kvstore types and the bucketer are ported: without a
    # launcher the store is a one-worker store, as JAX's is
    kv = tmx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "dist_sync")
    assert tmx.kvstore.GradBucketer(1024).drain() == []
    # FeedForward is ported (tests/test_torch_feedforward.py): it constructs
    # and fits one batch
    X, y = _data(False, n=16)
    ff = tmx.model.FeedForward(_mlp(tmx), ctx=tmx.cpu(), num_epoch=1, numpy_batch_size=16,
                               learning_rate=0.1)
    ff.fit(X, y)
    assert ff.arg_params["fc3_weight"].shape == (10, 16)
    # param_specs are ported (tests/test_torch_tp.py): Module keeps them for
    # its fused step, and ShardedTrainStep takes them with the flat path off
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu(), param_specs={"fc1_weight": ("tp",)})
    assert mod._param_specs == {"fc1_weight": ("tp",)}
    mesh = tmx.parallel.make_mesh(dp=2, devices=[tmx.cpu()] * 2)
    step = tmx.parallel.ShardedTrainStep(_mlp(tmx), mesh)
    assert step.arm_guard() is step and step.guard  # the guard is ported (resilience)
    # zero1 is ported (tests/test_torch_dist.py)
    assert tmx.parallel.ShardedTrainStep(_mlp(tmx), mesh, zero1=True).zero1
    tp_step = tmx.parallel.ShardedTrainStep(_mlp(tmx), mesh, param_specs={"fc1_weight": ("tp",)})
    assert tp_step.param_specs == {"fc1_weight": ("tp",)} and tp_step.flat_mode is None
    # K-step groups are ported for SGD and Adam; other optimizers still raise
    rmsprop = tmx.optimizer.create("rmsprop")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 step 2"):
        tmx.parallel.ShardedTrainStep(_mlp(tmx), mesh, optimizer=rmsprop).compile_multi(4)


def test_unported_fit_options_raise(tmp_path, monkeypatch):
    """``monitor`` is ported (a fit with one records its stats,
    tests/test_torch_monitor.py), and so are checkpoint_dir / resume /
    guardrails (tests/test_torch_resilience.py,
    tests/test_torch_guardrail.py) and the elastic shrink
    (``MXTPU_ELASTIC=1``, tests/test_torch_elastic.py): without a run dir
    and a world above 1 it has nothing to watch, and the fit runs."""
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    it = tmx.io.NDArrayIter(*_data(False, 16), batch_size=16)
    seen = []
    mon = tmx.monitor.Monitor(interval=1)
    toc = mon.toc
    mon.toc = lambda: seen.extend(toc()) or []
    mod.fit(it, num_epoch=1, monitor=mon)
    assert seen and all(step == 1 for step, _, _ in seen)
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    monkeypatch.delenv("MXTPU_RUN_DIR", raising=False)
    mod.fit(it, num_epoch=1, checkpoint_dir=str(tmp_path))
    assert tmx.resilience.list_checkpoints(str(tmp_path))
