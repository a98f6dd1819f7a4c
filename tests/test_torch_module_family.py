"""The PyTorch port's BucketingModule, SequentialModule, PythonModule /
PythonLossModule, MutableModule and executor manager held against the JAX
package's on the CPU, from the same seeds and numpy data.

- ``BucketingModule.fit`` of the bucketing LSTM LM of
  ``tests/test_module.py::test_bucketing_module`` on the fused ``RNN``
  route and on the ``LSTMCell`` stack, under ``kvstore="local"`` on one
  context and ``"device"`` on four host ranks (every bucket on the fused
  path, the owner demoted to the per-parameter update): final parameters
  within 1e-5 of each tensor's max and the same perplexity (the JAX
  kvstore synchronous, ``MXNET_KVSTORE_ASYNC=0``). Buckets share the
  default bucket's parameters; ``MXNET_FIT_MULTISTEP`` groups nothing for
  a BucketingModule, as in JAX.
- ``SequentialModule`` (``::test_sequential_module``) and a Module followed
  by a ``PythonLossModule`` against one Module with ``SoftmaxOutput``.
- ``MutableModule`` over batches of changing size.
- ``_split_input_slice`` and the executor manager's train loop
  (``tests/test_executor_manager.py``).
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models.lstm import BucketingLSTMModel as JBucketing
from mxnet_tpu_torch.models.lstm import BucketingLSTMModel as TBucketing

TOL = 1e-5


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    with tmx.cpu():
        yield


def _close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-6)
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0, atol=tol, err_msg=k)


def _host_params(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def _sentences():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(64):
        length = rng.choice([4, 6])
        start = rng.randint(0, 8)
        out.append([(start + i) % 8 + 1 for i in range(length)])
    return out


def _fit_bucketing(pkg, fused, kvstore, ndev):
    bucketing = TBucketing if pkg is tmx else JBucketing
    random.seed(0)
    np.random.seed(1)
    pkg.random.seed(1)
    it = pkg.rnn.BucketSentenceIter(_sentences(), batch_size=8, buckets=[4, 6],
                                    invalid_label=0)
    sym_gen = bucketing(num_layers=2, input_size=9, num_hidden=8, num_embed=4, num_label=9,
                        fused=fused)
    ctx = [pkg.cpu(i) for i in range(ndev)] if ndev > 1 else pkg.cpu()
    mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=it.default_bucket_key,
                                  context=ctx)
    metric = pkg.metric.Perplexity(ignore_label=0)
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": 0.02},
            initializer=pkg.init.Xavier(factor_type="in", magnitude=2.34),
            eval_metric=metric, num_epoch=2, kvstore=kvstore)
    return mod, _host_params(mod), metric.get()[1]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stack"])
@pytest.mark.parametrize("kvstore,ndev", [("local", 1), ("device", 4)])
def test_bucketing_module_fit_matches_jax(fused, kvstore, ndev):
    jmod, jp, jppl = _fit_bucketing(jmx, fused, kvstore, ndev)
    tmod, tp, tppl = _fit_bucketing(tmx, fused, kvstore, ndev)
    _close(tp, jp)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-5)
    assert set(tmod._buckets) == set(jmod._buckets) == {4, 6}
    assert tmod._buckets[4]._arg_params is tmod._buckets[6]._arg_params
    owner = tmod._buckets[6]
    if kvstore == "device":
        # the fused path, its owner demoted by the borrowing bucket
        assert owner._fused_trainer is not None and owner._fused_trainer.flat_mode is None
        assert tmod._buckets[4]._fused_owner is owner
    else:
        assert owner._fused_trainer is None


def test_bucketing_fit_groups_no_steps_under_multistep(monkeypatch):
    """A BucketingModule has no fused trainer of its own, so fit's
    MXNET_FIT_MULTISTEP grouping never engages: the same result as
    without it, as in JAX."""
    _, want, _ = _fit_bucketing(tmx, True, "device", 4)
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", "2")
    tmod, got, _ = _fit_bucketing(tmx, True, "device", 4)
    _, jgot, _ = _fit_bucketing(jmx, True, "device", 4)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    _close(got, jgot)
    assert all(m._fused_trainer.group_stats() == [] for m in tmod._buckets.values())


def test_bucketing_module_surface():
    sym_gen = TBucketing(num_layers=1, input_size=9, num_hidden=8, num_embed=4, num_label=9)
    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=6, bucket_keys=[6, 2, 4])
    assert mod.bucket_keys == [2, 4, 6]
    assert mod.covering_bucket_key(3) == 4 and mod.covering_bucket_key(6) == 6
    with pytest.raises(ValueError):
        mod.covering_bucket_key(7)
    assert mod.data_names == ("data",)
    assert mod.output_names == ["softmax_output"]
    mod.bind([("data", (2, 6))], [("softmax_label", (2, 6))])
    with pytest.raises(AssertionError):
        mod.bind([("data", (2, 6))], shared_module=mod, force_rebind=True)


def _blobs(n=64, dim=32, classes=4, seed=3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim).astype(np.float32) * 3
    y = rng.randint(0, classes, n)
    X = (centers[y] + rng.randn(n, dim)).astype(np.float32)
    return X, y.astype(np.float32)


def _scores(pkg, hidden=16, classes=4):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=hidden, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    return pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")


def _init_params(pkg, net, shapes, seed=2):
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: pkg.nd.array(rng.uniform(-0.3, 0.3, s).astype(np.float32), ctx=pkg.cpu())
            for n, s in zip(net.list_arguments(), arg_shapes) if n not in shapes}


def _sequential(pkg):
    """tests/test_module.py::test_sequential_module, then two more steps."""
    X, y = _blobs()
    it = pkg.io.NDArrayIter(X, y, batch_size=32)
    net2 = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4, name="fc2")
    net2 = pkg.sym.SoftmaxOutput(net2, name="softmax")
    net1 = pkg.sym.Activation(pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                                     num_hidden=16, name="fc1"),
                              act_type="relu")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net1, label_names=[], context=pkg.cpu()))
    seq.add(pkg.mod.Module(net2, context=pkg.cpu()), take_labels=True, auto_wiring=True)
    seq.bind(it.provide_data, it.provide_label)
    init = _init_params(pkg, _scores(pkg), {"data": (32, 32)})
    seq.init_params(arg_params=init)
    seq.init_optimizer(optimizer_params={"learning_rate": 0.1})
    outs = []
    for _ in range(3):
        it.reset()
        for batch in it:
            seq.forward(batch)
            outs.append(seq.get_outputs()[0].asnumpy())
            seq.backward()
            seq.update()
    return seq, outs, _host_params(seq)


def test_sequential_module_matches_jax():
    jseq, jouts, jp = _sequential(jmx)
    tseq, touts, tp = _sequential(tmx)
    assert touts[0].shape == (32, 4)
    for g, w in zip(touts, jouts):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    _close(tp, jp)
    assert tseq.data_names == ["data"] and tseq.output_names == jseq.output_names
    assert tseq.output_shapes == [("softmax_output", (32, 4))]
    with pytest.raises(ValueError, match="typo"):
        tmx.mod.SequentialModule().add(tseq._modules[0], take_label=True)


def _softmax_grad(pkg, classes=4):
    def grad(scores, labels):
        return pkg.nd.softmax(scores) - pkg.nd.one_hot(labels, depth=classes)
    return grad


def _train(mod, X, y, steps=4, sizes=(32,), before=None):
    lo = 0
    for i in range(steps):
        n = sizes[i % len(sizes)]
        pkg = tmx if isinstance(mod, tmx.mod.BaseModule) else jmx
        b = pkg.io.DataBatch(data=[pkg.nd.array(X[lo:lo + n])], label=[pkg.nd.array(y[lo:lo + n])])
        lo = (lo + n) % (len(X) - max(sizes) + 1)
        if before is not None:
            before(mod, b)
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
    return mod


def _start(pkg, mod, shapes=((("data", (32, 32)),), (("softmax_label", (32,)),))):
    mod.bind(list(shapes[0]), list(shapes[1]))
    mod.init_params(initializer=None, arg_params=_init_params(pkg, _scores(pkg),
                                                               {"data": (32, 32)}))
    mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.1,
                                                          "momentum": 0.9})
    return mod


@pytest.mark.parametrize("pkg", [jmx, tmx], ids=["jax", "port"])
def test_python_loss_module_in_a_sequence_equals_softmax_output(pkg):
    """A Module of scores followed by a PythonLossModule whose gradient is
    SoftmaxOutput's trains as one Module with SoftmaxOutput, in each
    package; the port's equals JAX's."""
    X, y = _blobs(n=128)
    seq = _python_sequence(pkg)
    got = _host_params(_train(_start(pkg, seq), X, y))
    net = pkg.sym.SoftmaxOutput(_scores(pkg), name="softmax")
    want = _host_params(_train(_start(pkg, pkg.mod.Module(net, context=pkg.cpu())), X, y))
    _close(got, want)
    loss = seq._modules[1]
    assert loss.output_shapes == [("pyloss_output", (32, 4))]
    assert loss.get_params() == ({}, {})
    if pkg is tmx:
        _close(got, _host_params(_train(_start(jmx, _python_sequence(jmx)), X, y)))


def _python_sequence(pkg):
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(_scores(pkg), label_names=[], context=pkg.cpu()))
    seq.add(pkg.mod.PythonLossModule(grad_func=_softmax_grad(pkg)), take_labels=True,
            auto_wiring=True)
    return seq


def test_python_module_surface():
    class Doubler(tmx.mod.PythonModule):
        def _compute_output_shapes(self):
            return [("double_output", self._data_shapes[0][1])]

    mod = Doubler(["data"], [], ["double_output"])
    mod.bind([("data", (2, 3))], for_training=False)
    assert mod.binded and mod.output_shapes == [("double_output", (2, 3))]
    assert mod.get_params() == ({}, {})
    mod.init_params()
    mod.init_optimizer()
    mod.update()
    with pytest.raises(TypeError):
        tmx.mod.PythonLossModule(grad_func=3)
    loss = tmx.mod.PythonLossModule()
    loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
    loss.forward(tmx.io.DataBatch([tmx.nd.ones((2, 3))], [tmx.nd.zeros((2,))]))
    with pytest.raises(NotImplementedError):
        loss.backward()


@pytest.mark.parametrize("pkg", [jmx, tmx], ids=["jax", "port"])
def test_mutable_module_over_changing_batch_sizes(pkg):
    """A MutableModule bound at batch 32 trains on batches of 32, 16 and 8
    (one more bound module a new size, sharing the parameters and the
    optimizer) as a Module reshaped before each batch does; the port's
    equals JAX's."""
    X, y = _blobs(n=128)
    net = pkg.sym.SoftmaxOutput(_scores(pkg), name="softmax")
    sizes = (32, 16, 8)
    mm = pkg.mod.MutableModule(net, ["data"], ["softmax_label"], context=pkg.cpu(),
                               max_data_shapes=[("data", (32, 32))],
                               max_label_shapes=[("softmax_label", (32,))])
    got = _host_params(_train(_start(pkg, mm), X, y, steps=7, sizes=sizes))
    assert len(mm._shape_modules) == 3
    assert all(m._arg_params is mm._base_module._arg_params
               for m in mm._shape_modules.values())
    assert mm.output_shapes == [("softmax_output", (32, 4))]

    def reshape(mod, b):
        mod.reshape([("data", b.data[0].shape)], [("softmax_label", b.label[0].shape)])

    ref = pkg.mod.Module(net, context=pkg.cpu())
    want = _host_params(_train(_start(pkg, ref), X, y, steps=7, sizes=sizes, before=reshape))
    _close(got, want)
    if pkg is tmx:
        jnet = jmx.sym.SoftmaxOutput(_scores(jmx), name="softmax")
        jmm = jmx.mod.MutableModule(jnet, ["data"], ["softmax_label"], context=jmx.cpu(),
                                    max_data_shapes=[("data", (32, 32))],
                                    max_label_shapes=[("softmax_label", (32,))])
        _close(got, _host_params(_train(_start(jmx, jmm), X, y, steps=7, sizes=sizes)))


def test_mutable_module_defaults_to_the_current_context():
    net = tmx.sym.SoftmaxOutput(_scores(tmx), name="softmax")
    mm = tmx.mod.MutableModule(net, ["data"], ["softmax_label"])
    assert mm._context == tmx.cpu()


def test_split_input_slice_matches_jax():
    from mxnet_tpu.executor_manager import _split_input_slice as jsplit
    from mxnet_tpu_torch.executor_manager import _split_input_slice as tsplit

    for n, work in ((10, [1, 1]), (9, [2, 1]), (7, [1, 2, 4]), (33, [3, 1])):
        assert tsplit(n, work) == jsplit(n, work), (n, work)
    assert [(s.start, s.stop) for s in tsplit(10, [1, 1])] == [(0, 5), (5, 10)]
    assert [(s.start, s.stop) for s in tsplit(9, [2, 1])] == [(0, 6), (6, 9)]


def _manager_loop(pkg):
    """tests/test_executor_manager.py::test_executor_manager_train_loop."""
    from importlib import import_module

    em = import_module(pkg.__name__ + ".executor_manager")
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 8) * 4
    X = np.concatenate([c + rng.randn(40, 8) * 0.3 for c in centers]).astype(np.float32)
    y = np.repeat(np.arange(3), 40).astype(np.float32)
    p = rng.permutation(120)
    X, y = X[p], y[p]
    it = pkg.io.NDArrayIter(X, y, batch_size=20)
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = pkg.sym.SoftmaxOutput(net, name="softmax")
    arg_names = net.list_arguments()
    param_names = [n for n in arg_names if n not in ("data", "softmax_label")]
    mgr = em.DataParallelExecutorManager(net, [pkg.cpu(0), pkg.cpu(1)], it, arg_names,
                                         param_names, net.list_auxiliary_states())
    assert [(s.start, s.stop) for s in mgr.slices] == [(0, 10), (10, 20)]
    arg_shapes, _, _ = net.infer_shape(data=(20, 8))
    np.random.seed(4)
    init = pkg.init.Xavier()
    arg_params = {}
    for name, shape in zip(arg_names, arg_shapes):
        if name in param_names:
            arr = pkg.nd.zeros(shape)
            init(pkg.init.InitDesc(name), arr)
            arg_params[name] = arr
    mgr.set_params(arg_params, {})
    updater = pkg.optimizer.get_updater(pkg.optimizer.SGD(learning_rate=0.1,
                                                          rescale_grad=1.0 / 20))
    metric = pkg.metric.Accuracy()
    for _ in range(8):
        it.reset()
        metric.reset()
        for batch in it:
            mgr.load_data_batch(batch)
            mgr.forward(is_train=True)
            mgr.backward()
            for idx, (p_list, g_list) in enumerate(zip(mgr.param_arrays, mgr.grad_arrays)):
                gsum = sum(g.asnumpy() for g in g_list)
                warr = pkg.nd.array(p_list[0].asnumpy())
                updater(idx, pkg.nd.array(gsum), warr)
                for p_ in p_list:
                    p_[:] = warr.asnumpy()
            mgr.update_metric(metric, batch.label)
    out = {n: pkg.nd.zeros(a.shape) for n, a in arg_params.items()}
    mgr.copy_to(out, {})
    return metric.get()[1], {k: v.asnumpy() for k, v in out.items()}


def test_executor_manager_train_loop_matches_jax():
    jacc, jp = _manager_loop(jmx)
    tacc, tp = _manager_loop(tmx)
    assert tacc > 0.9 and tacc == jacc
    _close(tp, jp)
