"""The port's custom-operator host (``mxnet_tpu_torch/operator.py``) held
against the JAX package's on the CPU: the five cases of
``tests/test_custom_op.py`` (a standalone and a mid-graph Custom op, the
two-input numpy softmax, shape inference, the NDArrayOp shim) run in both
packages from the same inputs, outputs and gradients within 1e-5; the
forward memo (one user forward per distinct input, through an autograd
replay and a mirrored recompute); the instances per bind; and the capture
refusal of ``MXNET_FIT_MULTISTEP=K`` and of ``refuse_capture``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _register(pkg):
    @pkg.operator.register("scale2")
    class Scale2Prop(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Scale2(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0].asnumpy() * 2.0)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 2.0)

            return Scale2()

    @pkg.operator.register("np_softmax")
    class NpSoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class NpSoftmax(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    y = np.exp(x - x.max(axis=1, keepdims=True))
                    self.assign(out_data[0], req[0], y / y.sum(axis=1, keepdims=True))

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    lab = in_data[1].asnumpy().astype(np.int64)
                    y = out_data[0].asnumpy().copy()
                    y[np.arange(lab.shape[0]), lab] -= 1.0
                    self.assign(in_grad[0], req[0], y)
                    self.assign(in_grad[1], req[1], np.zeros_like(in_data[1].asnumpy()))

            return NpSoftmax()


_register(jmx)
_register(tmx)

CALLS = {"forward": 0}


@tmx.operator.register("counted_noise")
class CountedNoiseProp(tmx.operator.CustomOpProp):
    """Adds fresh noise at each forward and counts the forwards: a second
    forward of one input would change the output and the count."""

    def create_operator(self, ctx, in_shapes, in_dtypes):
        class CountedNoise(tmx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                CALLS["forward"] += 1
                noise = np.random.rand(*in_data[0].shape).astype(np.float32)
                self.assign(out_data[0], req[0], in_data[0].asnumpy() + noise)

            def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 3.0)

        return CountedNoise()


def _both(build, shapes, inputs, head=None):
    """Bind ``build(pkg.sym)`` in each package with ``inputs``; forward in
    training and backward with ``head``: (outputs, grads) of each."""
    res = []
    for pkg in (jmx, tmx):
        out = build(pkg.sym)
        exe = out.simple_bind(pkg.cpu(), **shapes)
        for k, v in inputs.items():
            exe.arg_dict[k][:] = v
        exe.forward(is_train=True)
        outs = [o.asnumpy() for o in exe.outputs]
        exe.backward(None if head is None else pkg.nd.array(head))
        res.append((outs, {k: exe.grad_dict[k].asnumpy() for k in inputs}))
    return res


def _assert_same(res):
    (jo, jg), (to, tg) = res
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=TOL, atol=TOL, err_msg=k)
    return to, tg


def test_custom_forward_backward():
    x = np.random.rand(3, 4).astype(np.float32)
    og = np.random.rand(3, 4).astype(np.float32)
    outs, grads = _assert_same(_both(lambda s: s.Custom(s.Variable("data"), op_type="scale2"),
                                     {"data": (3, 4)}, {"data": x}, og))
    np.testing.assert_allclose(outs[0], 2 * x, rtol=1e-6)
    np.testing.assert_allclose(grads["data"], 2 * og, rtol=1e-6)


def test_custom_mid_graph():
    x = np.random.rand(2, 5).astype(np.float32)

    def build(s):
        return s.Custom(s.Variable("data") * 3.0, op_type="scale2") + 1.0

    outs, grads = _assert_same(_both(build, {"data": (2, 5)}, {"data": x},
                                     np.ones((2, 5), np.float32)))
    np.testing.assert_allclose(outs[0], 6 * x + 1, rtol=1e-6)
    np.testing.assert_allclose(grads["data"], 6.0, rtol=1e-6)


def test_custom_multi_input_softmax():
    x = np.random.rand(4, 6).astype(np.float32)
    lab = np.array([0, 2, 1, 5], np.float32)

    def build(s):
        return s.Custom(s.Variable("data"), s.Variable("label"), op_type="np_softmax", name="sm")

    assert build(tmx.sym).list_arguments() == ["data", "label"]
    _assert_same(_both(build, {"data": (4, 6), "label": (4,)}, {"data": x, "label": lab}))


def test_custom_infer_shape():
    for pkg in (jmx, tmx):
        out = pkg.sym.Custom(pkg.sym.Variable("data"), pkg.sym.Variable("label"),
                             op_type="np_softmax")
        arg_shapes, out_shapes, _ = out.infer_shape(data=(8, 10))
        assert arg_shapes == [(8, 10), (8,)] and out_shapes == [(8, 10)]


def test_ndarray_op_shim():
    def shim(pkg):
        class Scale3(pkg.operator.NDArrayOp):
            def forward(self, in_data, out_data):
                out_data[0][:] = in_data[0].asnumpy() * 3.0

            def backward(self, out_grad, in_data, out_data, in_grad):
                in_grad[0][:] = out_grad[0].asnumpy() * 3.0

            def infer_shape(self, in_shape):
                return in_shape, [in_shape[0]]

        return Scale3()

    x = np.random.rand(2, 3).astype(np.float32)
    ops = {jmx.sym: shim(jmx), tmx.sym: shim(tmx)}
    outs, grads = _assert_same(_both(lambda s: ops[s].get_symbol(s.Variable("data")),
                                     {"data": (2, 3)}, {"data": x}, np.ones((2, 3), np.float32)))
    np.testing.assert_allclose(outs[0], 3 * x, rtol=1e-6)


def test_numpy_op_shim_runs_on_numpy():
    class Plus1(tmx.operator.NumpyOp):
        def forward(self, in_data, out_data):
            assert isinstance(in_data[0], np.ndarray)
            out_data[0][:] = in_data[0] + 1.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0]

    exe = Plus1().get_symbol(tmx.sym.Variable("data")).simple_bind(tmx.cpu(), data=(2, 2))
    exe.forward(is_train=True)
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(), 1.0)


def test_imperative_custom_records_one_forward():
    """mx.nd.Custom under autograd: the backward's replay reads the memo, so
    the noisy forward ran once and the gradient is its own."""
    x = tmx.nd.array(np.random.rand(3, 2).astype(np.float32))
    g = tmx.nd.zeros((3, 2))
    tmx.autograd.mark_variables([x], [g])
    before = CALLS["forward"]
    with tmx.autograd.train_section():
        y = tmx.nd.Custom(x, op_type="counted_noise")
    tmx.autograd.backward([y], [tmx.nd.ones((3, 2))])
    assert CALLS["forward"] - before == 1
    np.testing.assert_allclose(g.asnumpy(), 3.0)
    tmx.autograd._st().marked.clear()


def test_memo_one_forward_per_distinct_input_under_the_mirror(monkeypatch):
    """A mirrored executor recomputes its regions in backward; the Custom
    node's forward still runs once a distinct input, and the output the
    backward sees is the forward's."""
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    data = tmx.sym.Variable("data")
    net = tmx.sym.Activation(tmx.sym.Custom(tmx.sym.exp(data), op_type="counted_noise"),
                             act_type="tanh")
    exe = net.simple_bind(tmx.cpu(), data=(4, 3))
    x = np.random.rand(4, 3).astype(np.float32)
    exe.arg_dict["data"][:] = x
    before = CALLS["forward"]
    exe.forward(is_train=True)
    y = exe.outputs[0].asnumpy()
    exe.backward(tmx.nd.ones((4, 3)))
    assert CALLS["forward"] - before == 1
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(),
                               (1 - y ** 2) * 3.0 * np.exp(x), rtol=1e-5)
    exe.forward(is_train=True)  # the same input: the memo
    assert CALLS["forward"] - before == 1
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(), y)
    exe.arg_dict["data"][:] = x + 1  # a new input: a new forward
    exe.forward(is_train=True)
    assert CALLS["forward"] - before == 2


def test_one_instance_per_bind():
    seen = []

    @tmx.operator.register("instance_probe")
    class ProbeProp(tmx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Probe(tmx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    seen.append(id(self))
                    self.assign(out_data[0], req[0], in_data[0])

            return Probe()

    net = tmx.sym.Custom(tmx.sym.Variable("data"), op_type="instance_probe")
    for _ in range(2):
        exe = net.simple_bind(tmx.cpu(), data=(2,))
        exe.arg_dict["data"][:] = np.arange(2, dtype=np.float32) + len(seen)
        exe.forward()
    assert len(seen) == 2 and seen[0] != seen[1]


def test_capture_refusal_names_the_node():
    """Custom's Python code and ROIPooling's host read of its window size
    cannot be captured: the refusal names each such node."""
    net = tmx.sym.Custom(tmx.sym.Variable("data"), op_type="scale2", name="my_scale")
    assert tmx.operator.uncapturable_nodes(net) == [
        "the Custom node my_scale (op_type scale2), whose Python forward and backward run "
        "on the host at each call"]
    with pytest.raises(MXNetError, match="my_scale"):
        tmx.operator.refuse_capture(net, "the forward of bucket 1")
    roi = tmx.sym.ROIPooling(net, tmx.sym.Variable("rois"), pooled_size=(2, 2),
                             name="roi_pool")
    assert [n.split(",")[0] for n in tmx.operator.uncapturable_nodes(roi)] == [
        "the Custom node my_scale (op_type scale2)", "the ROIPooling node roi_pool"]
    with pytest.raises(MXNetError, match="ROIPooling node roi_pool, whose window size"):
        tmx.operator.refuse_capture(roi * 1.0, "the forward of bucket 2")
    tmx.operator.refuse_capture(tmx.sym.Variable("data") * 2.0, "a graph without Custom")


def _custom_mlp():
    data = tmx.sym.Variable("data")
    h = tmx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = tmx.sym.Custom(h, op_type="scale2", name="scaled")
    h = tmx.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return tmx.sym.SoftmaxOutput(h, name="softmax")


@pytest.mark.parametrize("k", ["2", "auto"])
def test_fit_multistep_refuses_or_keeps_one_step(monkeypatch, k):
    """On the fused path of a dp-4 host mesh: MXNET_FIT_MULTISTEP=2 raises,
    naming the node; =auto trains at one step."""
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", k)
    rng = np.random.RandomState(0)
    X = rng.rand(32, 4).astype(np.float32)
    y = (X.sum(axis=1) > 2).astype(np.float32)
    it = tmx.io.NDArrayIter(X, y, batch_size=8)
    mod = tmx.mod.Module(_custom_mlp(), context=[tmx.cpu(i) for i in range(4)])
    kw = dict(kvstore="device", optimizer="sgd", optimizer_params={"learning_rate": 0.1},
              num_epoch=1)
    if k == "auto":
        mod.fit(it, **kw)
        assert mod._fused_trainer is not None
        assert mod._fused_trainer.group_stats() == []  # no group was compiled
    else:
        with pytest.raises(MXNetError, match="scaled"):
            mod.fit(it, **kw)


def _roi_net():
    pooled = tmx.sym.ROIPooling(tmx.sym.Variable("data"), tmx.sym.Variable("rois"),
                                pooled_size=(2, 2), name="roi_pool")
    h = tmx.sym.FullyConnected(tmx.sym.Flatten(pooled), num_hidden=2, name="fc")
    return tmx.sym.SoftmaxOutput(h, name="softmax")


@pytest.mark.parametrize("k", ["2", "auto"])
def test_fit_multistep_refuses_or_keeps_one_step_for_roi_pooling(monkeypatch, k):
    """ROIPooling reads its window size on the host at each call: on the
    fused path of a dp-4 host mesh MXNET_FIT_MULTISTEP=2 raises, naming the
    node; =auto trains at one step."""
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", k)
    rng = np.random.RandomState(1)
    X = rng.rand(32, 3, 8, 8).astype(np.float32)
    rois = np.zeros((32, 5), np.float32)  # each sample's roi reads image 0 of its shard
    rois[:, 1:3] = rng.randint(0, 4, (32, 2))
    rois[:, 3:5] = rois[:, 1:3] + rng.randint(1, 5, (32, 2))
    y = (X.mean(axis=(1, 2, 3)) > 0.5).astype(np.float32)
    it = tmx.io.NDArrayIter({"data": X, "rois": rois}, y, batch_size=8)
    mod = tmx.mod.Module(_roi_net(), data_names=("data", "rois"),
                         context=[tmx.cpu(i) for i in range(4)])
    kw = dict(kvstore="device", optimizer="sgd", optimizer_params={"learning_rate": 0.1},
              num_epoch=1)
    if k == "auto":
        mod.fit(it, **kw)
        assert mod._fused_trainer is not None
        assert mod._fused_trainer.group_stats() == []  # no group was compiled
    else:
        with pytest.raises(MXNetError, match="ROIPooling node roi_pool"):
            mod.fit(it, **kw)
