"""The port's torch bridge (``mx.th``, also ``mx.torch``;
``mxnet_tpu_torch/th.py``) held against the JAX package's
(``mxnet_tpu/torch.py``) on the CPU: the cases of
``tests/test_torch_interop.py`` on the port, the function namespace's
results equal to JAX's, results that never alias their arguments, and a
torch module wrapped mid-graph whose outputs, MXNet gradients and module
parameter gradients match the JAX bridge's from the same weights (1e-5)."""
import copy

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def test_bridge_is_exported_twice():
    assert tmx.th is tmx.torch
    with pytest.raises(AttributeError):
        tmx.th.no_such_function_here


def test_th_function_namespace():
    x = np.array([[0.0, 1.0], [2.0, 3.0]], np.float32)
    out = tmx.th.exp(tmx.nd.array(x))
    assert isinstance(out, tmx.nd.NDArray)
    np.testing.assert_allclose(out.asnumpy(), jmx.th.exp(jmx.nd.array(x)).asnumpy(), rtol=1e-6)
    mm = tmx.th.mm(tmx.nd.ones((2, 3)), tmx.nd.ones((3, 4)))
    np.testing.assert_allclose(mm.asnumpy(), np.full((2, 4), 3.0))
    vals, idx = tmx.th.sort(tmx.nd.array(np.array([3.0, 1.0, 2.0], np.float32)))
    np.testing.assert_array_equal(vals.asnumpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(idx.asnumpy(), [1, 2, 0])


def test_th_results_do_not_alias_their_arguments():
    a = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(1, 6))
    s = tmx.th.squeeze(a)  # a view in torch
    s[:] = 0.0
    np.testing.assert_array_equal(a.asnumpy()[0], np.arange(6))


def _mlp(mx, build):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = build(h)
    h = mx.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def test_torch_module_mid_graph_matches_jax():
    torch.manual_seed(0)
    tmod = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh())
    jmod = copy.deepcopy(tmod)
    rng = np.random.RandomState(0)
    x = rng.rand(10, 4).astype(np.float32)
    y = (x.sum(axis=1) > 2).astype(np.float32)
    params = {"fc1_weight": rng.randn(8, 4) * 0.3, "fc1_bias": rng.randn(8) * 0.1,
              "fc2_weight": rng.randn(2, 8) * 0.3, "fc2_bias": rng.randn(2) * 0.1}
    res = []
    for mx, mod in ((jmx, jmod), (tmx, tmod)):
        net = _mlp(mx, mx.torch.wrap_module(mod, name="parity_block_%s" % mx.__name__))
        exe = net.simple_bind(mx.cpu(), data=(10, 4), softmax_label=(10,))
        for k, v in params.items():
            exe.arg_dict[k][:] = v.astype(np.float32)
        exe.arg_dict["data"][:] = x
        exe.arg_dict["softmax_label"][:] = y
        exe.forward(is_train=True)
        exe.backward()
        res.append((exe.outputs[0].asnumpy(),
                    {k: exe.grad_dict[k].asnumpy() for k in params},
                    [p.grad.numpy().copy() for p in mod.parameters()]))
    (jo, jg, jp), (to, tg, tp) = res
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_torch_module_mid_graph_training():
    torch.manual_seed(0)
    tmod = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh())
    net = _mlp(tmx, tmx.torch.wrap_module(tmod, name="torch_tanh_block"))
    rng = np.random.RandomState(0)
    X = rng.rand(40, 4).astype(np.float32)
    y = (X.sum(axis=1) > 2).astype(np.float32)
    it = tmx.io.NDArrayIter(X, y, batch_size=10)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.5})
    fc1_before = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
    torch_w_before = [p.detach().clone() for p in tmod.parameters()]
    metric = tmx.metric.Accuracy()
    for _ in range(15):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.update_metric(metric, batch.label)
            mod.backward()
            mod.update()
            with torch.no_grad():  # the module owns its weights: plain SGD on them
                for p in tmod.parameters():
                    if p.grad is not None:
                        p -= 0.05 * p.grad
                        p.grad = None
    assert not np.allclose(mod.get_params()[0]["fc1_weight"].asnumpy(), fc1_before)
    assert any(not torch.allclose(p.detach(), w0)
               for p, w0 in zip(tmod.parameters(), torch_w_before))
    assert metric.get()[1] > 0.8
