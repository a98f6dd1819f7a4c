"""``mxnet_tpu_torch.monitor``, ``visualization`` and the frontend
utilities against the JAX package on the CPU: Monitor records in the same
(step, name) order with stats within 1e-5 relative (on an executor and
through ``fit(monitor=)``), ``print_summary``'s text, the port's
counterparts of ``tests/test_frontend_utils.py``'s four monitor /
``print_summary`` cases and seven scheduler / callback cases, and
``install_monitor`` on ``BucketingModule``."""
import logging
from collections import namedtuple

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

BatchEndParam = namedtuple("BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"])


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.delenv("MXNET_FIT_MULTISTEP", raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")  # the JAX side's pushes synchronous
    with tmx.cpu():
        yield


def _net(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _weights():
    rng = np.random.RandomState(7)
    shapes = {"fc1_weight": (8, 8), "fc1_bias": (8,), "fc2_weight": (4, 8), "fc2_bias": (4,)}
    return {n: rng.uniform(-0.5, 0.5, s).astype(np.float32) for n, s in shapes.items()}


def _stats(records):
    return [(step, name, [float(v) for v in stat.split("\t") if v.strip()])
            for step, name, stat in records]


def _assert_same_records(got, want):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    for (_, name, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("sort", [False, True])
def test_monitor_records_match_jax_on_an_executor(sort):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8).astype("f")
    out = []
    for pkg in (jmx, tmx):
        exe = _net(pkg).simple_bind(ctx=pkg.cpu(0), data=(4, 8), softmax_label=(4,))
        for n, v in _weights().items():
            exe.arg_dict[n][:] = v
        exe.arg_dict["data"][:] = x
        exe.arg_dict["softmax_label"][:] = np.array([0, 1, 2, 3], "f")
        mon = pkg.monitor.Monitor(interval=1, pattern=".*", sort=sort)
        mon.install(exe)
        recs = []
        for _ in range(3):
            mon.tic()
            exe.forward(is_train=False)
            recs += mon.toc()
        out.append(_stats(recs))
    _assert_same_records(out[1], out[0])


def test_executor_manager_install_monitor_matches_jax():
    """``DataParallelExecutorManager.install_monitor`` installs the Monitor
    on each context's executor, as the JAX package's does: the same records
    in the same order, stats within 1e-5."""
    from importlib import import_module

    rng = np.random.RandomState(1)
    x = rng.randn(8, 8).astype("f")
    y = np.array([0, 1, 2, 3] * 2, "f")
    out = []
    for pkg in (jmx, tmx):
        em = import_module(pkg.__name__ + ".executor_manager")
        net = _net(pkg)
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        args = net.list_arguments()
        mgr = em.DataParallelExecutorManager(
            net, [pkg.cpu(0), pkg.cpu(1)], it, args,
            [n for n in args if n not in ("data", "softmax_label")], [])
        mgr.set_params({n: pkg.nd.array(v) for n, v in _weights().items()}, {})
        mon = pkg.monitor.Monitor(interval=1, pattern=".*")
        mgr.install_monitor(mon)
        recs = []
        for batch in it:
            mon.tic()
            mgr.load_data_batch(batch)
            mgr.forward(is_train=False)
            recs += mon.toc()
        out.append(_stats(recs))
    assert out[1] and any("fc1" in name for _, name, _ in out[1])
    _assert_same_records(out[1], out[0])


def test_monitor_through_fit_matches_jax():
    """fit(monitor=) with kvstore 'device' on two contexts: both packages
    decline the fused path and record the same stats in the same order."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    out = []
    for pkg in (jmx, tmx):
        seen = []
        mon = pkg.monitor.Monitor(interval=2, pattern=".*fc.*", sort=True)
        toc = mon.toc

        def capture(toc=toc, seen=seen):
            rec = toc()
            seen.extend(rec)
            return rec

        mon.toc = capture
        mod = pkg.mod.Module(_net(pkg), context=[pkg.cpu(0), pkg.cpu(1)])
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2, optimizer="sgd",
                kvstore="device", optimizer_params={"learning_rate": 0.1}, monitor=mon,
                arg_params={n: pkg.nd.array(v) for n, v in _weights().items()})
        assert mod._fused_trainer is None
        out.append(_stats(seen))
    assert out[1]
    _assert_same_records(out[1], out[0])


def test_print_summary_same_text(capsys):
    texts = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            data = pkg.sym.Variable("data")
            net = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                                      name="conv1")
            net = pkg.sym.BatchNorm(net, name="bn1")
            net = pkg.sym.Activation(net, act_type="relu")
            net = pkg.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
            net = pkg.sym.Flatten(net)
            net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc1")
            net = pkg.sym.SoftmaxOutput(net, name="softmax")
            total = pkg.viz.print_summary(net, shape={"data": (1, 3, 8, 8)})
        texts.append((total, capsys.readouterr().out))
    assert texts[1] == texts[0]


def test_plot_network_raises_without_graphviz():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="graphviz"):
            tmx.viz.plot_network(_net(tmx))
    else:
        dot = tmx.viz.plot_network(_net(tmx), shape={"data": (1, 8)})
        assert "fc1" in dot.source


# -- the port's cases of tests/test_frontend_utils.py -----------------------

def test_monitor_collects_matching_stats():
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu", name="relu1")
    exe = net.simple_bind(ctx=tmx.cpu(0), data=(2, 3))
    rng = np.random.RandomState(0)
    exe.arg_dict["fc1_weight"][:] = rng.randn(4, 3)
    exe.arg_dict["fc1_bias"][:] = 0
    exe.arg_dict["data"][:] = rng.randn(2, 3)
    mon = tmx.monitor.Monitor(interval=1, pattern=".*fc1.*")
    mon.install(exe)
    mon.tic()
    exe.forward(is_train=False)
    names = [name for _step, name, _v in mon.toc()]
    assert any("fc1" in n for n in names)
    assert not any("relu" in n for n in names)
    mon2 = tmx.monitor.Monitor(interval=2, pattern=".*")
    mon2.install(exe)
    mon2.tic()
    assert mon2.activated
    mon2.toc()
    mon2.tic()
    assert not mon2.activated


def test_print_summary_exact_param_counts(capsys):
    data = tmx.sym.Variable("data")
    net = tmx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1), name="conv1")
    net = tmx.sym.BatchNorm(net, name="bn1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.Flatten(net)
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc1")
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    total = tmx.viz.print_summary(net, shape={"data": (1, 3, 8, 8)})
    assert total == 224 + 16 + 5130
    out = capsys.readouterr().out
    assert "conv1(Convolution)" in out and "Total params: 5370" in out


def test_monitor_with_module_fit_device_kvstore():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    it = tmx.io.NDArrayIter(X, y, batch_size=16)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                                       name="fc1"), name="softmax")
    mod = tmx.mod.Module(net, context=[tmx.cpu(0), tmx.cpu(1)])
    seen = []
    mon = tmx.monitor.Monitor(interval=1, pattern=".*fc1.*", sort=True)
    toc = mon.toc

    def capture():
        rec = toc()
        seen.extend(rec)
        return rec

    mon.toc = capture
    mod.fit(it, num_epoch=1, optimizer="sgd", kvstore="device",
            optimizer_params={"learning_rate": 0.1}, monitor=mon)
    assert mod._fused_trainer is None
    assert any("fc1" in name for _s, name, _v in seen), seen[:5]


def test_install_monitor_after_fused_init_errors():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    it = tmx.io.NDArrayIter(X, y, batch_size=16)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                                       name="fc1"), name="softmax")
    mod = tmx.mod.Module(net, context=[tmx.cpu(0), tmx.cpu(1)])
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.init_optimizer(kvstore="device", optimizer="sgd")
    assert mod._fused_trainer is not None
    with pytest.raises(tmx.base.MXNetError):
        mod.install_monitor(tmx.monitor.Monitor(interval=1))


def test_monitor_on_bucketing_module():
    def sym_gen(key):
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc1")
        return tmx.sym.SoftmaxOutput(net, name="softmax"), ("data",), ("softmax_label",)

    class _Keyed(tmx.io.NDArrayIter):
        """Batches of the default bucket."""

        def next(self):
            batch = super().next()
            batch.bucket_key = 8
            batch.provide_data, batch.provide_label = self.provide_data, self.provide_label
            return batch

    rng = np.random.RandomState(0)
    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=8, context=tmx.cpu())
    it = _Keyed(rng.randn(32, 8).astype("f"), rng.randint(0, 4, 32).astype("f"), batch_size=8)
    seen = []
    mon = tmx.monitor.Monitor(interval=1, pattern="fc1.*")
    toc = mon.toc
    mon.toc = lambda: seen.extend(toc()) or []
    mod.fit(it, num_epoch=1, optimizer="sgd", monitor=mon,
            optimizer_params={"learning_rate": 0.1})
    assert {n for _, n, _ in seen} >= {"fc1_weight", "fc1_bias"}
    assert sorted({s for s, _, _ in seen}) == [1, 2, 3, 4]


def test_factor_scheduler_closed_form():
    s = tmx.lr_scheduler.FactorScheduler(step=10, factor=0.5)
    s.base_lr = 1.0
    assert s(1) == 1.0 and s(10) == 1.0 and s(11) == 0.5
    assert s(20) == 0.5 and s(21) == 0.25 and s(11) == 0.5


def test_factor_scheduler_stop_floor():
    s = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.1, stop_factor_lr=1e-3)
    s.base_lr = 1.0
    assert abs(s(2) - 0.1) < 1e-12
    assert s(100) == 1e-3


def test_multi_factor_scheduler():
    s = tmx.lr_scheduler.MultiFactorScheduler(step=[5, 8], factor=0.1)
    s.base_lr = 2.0
    assert s(5) == 2.0
    assert abs(s(6) - 0.2) < 1e-12 and abs(s(8) - 0.2) < 1e-12
    assert abs(s(9) - 0.02) < 1e-12
    with pytest.raises(ValueError):
        tmx.lr_scheduler.MultiFactorScheduler(step=[8, 5])


def test_scheduler_in_optimizer():
    opt = tmx.optimizer.SGD(learning_rate=1.0,
                            lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5))
    assert opt.lr_scheduler.base_lr == 1.0


def test_speedometer_logs_and_resets_metric(caplog):
    from mxnet_tpu_torch import telemetry

    telemetry.enable()
    try:
        metric = tmx.metric.Accuracy()
        metric.update([tmx.nd.array([0.0])], [tmx.nd.array([[0.9, 0.1]])])
        speedo = tmx.callback.Speedometer(batch_size=4, frequent=2)
        with caplog.at_level(logging.INFO):
            speedo(BatchEndParam(0, 0, metric, None))
            speedo(BatchEndParam(0, 1, metric, None))
            speedo(BatchEndParam(0, 2, metric, None))
        assert any("samples/sec" in r.message for r in caplog.records)
        assert metric.num_inst == 0
        assert telemetry.gauge("fit.samples_per_sec").value() > 0
        caplog.clear()
        with caplog.at_level(logging.INFO):
            speedo(BatchEndParam(1, 0, metric, None))
        assert not any("samples/sec" in r.message for r in caplog.records)
    finally:
        telemetry.reset()
        telemetry.disable()


def test_log_train_metric(caplog):
    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array([0.0])], [tmx.nd.array([[0.9, 0.1]])])
    cb = tmx.callback.log_train_metric(2, auto_reset=True)
    with caplog.at_level(logging.INFO):
        cb(BatchEndParam(0, 2, metric, None))
    assert any("Train-accuracy" in r.message for r in caplog.records)
    assert metric.num_inst == 0


def test_do_checkpoint_period(tmp_path):
    fired = []
    cb = tmx.callback.module_checkpoint(
        type("M", (), {"save_checkpoint": staticmethod(lambda p, e, s: fired.append(e))})(),
        str(tmp_path / "x"), period=2)
    for epoch_idx in range(4):
        cb(epoch_idx)
    assert fired == [2, 4]
