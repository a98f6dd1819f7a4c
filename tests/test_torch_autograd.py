"""The PyTorch port's imperative autograd held against the JAX package on
the CPU: tests/test_autograd.py's cases through both packages on the same
inputs (gradients at 1e-5), grad_req write/add/null, retain_graph, the
decorators, and what the port needs of in-place writes: a marked variable
still takes ``x[:] = ...``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

X = np.random.RandomState(3).rand(4).astype(np.float32) + 0.5


@pytest.fixture(autouse=True)
def _host():
    for pkg in (jmx, tmx):
        st = pkg.autograd._st()
        st.marked.clear()
        st.grad_reqs.clear()
        st.tape = []
    with tmx.cpu():
        yield


def _grads(pkg, fn, req="write", init=0.0, out_grads=None):
    """Gradient of fn(x) (an NDArray or a list) at X, written into a buffer
    holding ``init`` by grad_req ``req``."""
    x = pkg.nd.array(X)
    gx = pkg.nd.full(X.shape, init)
    pkg.autograd.mark_variables([x], [gx], grad_reqs=req)
    with pkg.autograd.train_section():
        y = fn(pkg, x)
    ys = y if isinstance(y, list) else [y]
    og = None if out_grads is None else [pkg.nd.array(g) for g in out_grads]
    pkg.autograd.backward(ys, out_grads=og)
    return gx.asnumpy()


CASES = {
    "square": lambda mx, x: x * x,
    "chain": lambda mx, x: mx.nd.exp(x) * x,
    "scalar": lambda mx, x: 3.0 / (x + 1.0) - x ** 2.0,
    "reduce": lambda mx, x: mx.nd.sum(mx.nd.log(x) * mx.nd.sqrt(x)),
    "broadcast": lambda mx, x: mx.nd.broadcast_mul(mx.nd.reshape(x, shape=(4, 1)),
                                                   mx.nd.reshape(x, shape=(1, 4))),
    "two_outputs": lambda mx, x: [mx.nd.tanh(x), mx.nd.sigmoid(x) * 2.0],
    "blockgrad": lambda mx, x: x * mx.nd.BlockGrad(x),
    "constant_input": lambda mx, x: mx.nd.elemwise_add(x, np.array([1.0, 2.0, 3.0, 4.0],
                                                                   np.float32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    fn = CASES[name]
    got, want = _grads(tmx, fn), _grads(jmx, fn)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_simple_backward_and_out_grads():
    np.testing.assert_allclose(_grads(tmx, CASES["square"]), 2 * X, rtol=1e-6)
    og = [np.array([1.0, 2.0, 3.0, 4.0], np.float32)]
    got = _grads(tmx, lambda mx, x: x * 2.0, out_grads=og)
    np.testing.assert_allclose(got, [2.0, 4.0, 6.0, 8.0])
    np.testing.assert_allclose(got, _grads(jmx, lambda mx, x: x * 2.0, out_grads=og))


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    got = _grads(tmx, lambda mx, x: x * 3.0, req=req, init=1.0)
    np.testing.assert_allclose(got, _grads(jmx, lambda mx, x: x * 3.0, req=req, init=1.0))
    np.testing.assert_allclose(got, {"write": 3.0, "add": 4.0, "null": 1.0}[req] * np.ones(4))


def test_retain_graph_and_compute_gradient():
    x = tmx.nd.array(X)
    gx = tmx.nd.zeros(4)
    tmx.autograd.mark_variables([x], [gx], grad_reqs="add")
    with tmx.autograd.train_section():
        y = x * x
    tmx.autograd.backward([y], retain_graph=True)
    tmx.autograd.compute_gradient([y])
    np.testing.assert_allclose(gx.asnumpy(), 4 * X, rtol=1e-6)
    with pytest.raises(tmx.MXNetError, match="grad_req"):
        tmx.autograd.mark_variables([x], [gx], grad_reqs="sometimes")


def test_grad_and_loss_decorators():
    def f(a, b):
        return a * b

    for pkg in (tmx, jmx):
        a = pkg.nd.array(np.array([2.0], np.float32))
        b = pkg.nd.array(np.array([3.0], np.float32))
        grads, loss = pkg.autograd.grad_and_loss(f)(a, b)
        np.testing.assert_allclose(grads[0].asnumpy(), [3.0])
        np.testing.assert_allclose(grads[1].asnumpy(), [2.0])
        np.testing.assert_allclose(loss.asnumpy(), [6.0])
        only_b = pkg.autograd.grad(f, argnum=1)(a, b)
        np.testing.assert_allclose(only_b[0].asnumpy(), [2.0])
    with pytest.raises(tmx.MXNetError):
        tmx.autograd.grad(f)(1.0, 2.0)


def test_marked_variable_takes_inplace_writes():
    """The marked variable's own tensor never requires grad: it takes
    ``x[:] = ...`` and ``+=`` between steps, and the next backward uses the
    new value."""
    x = tmx.nd.array(X)
    gx = tmx.nd.zeros(4)
    tmx.autograd.mark_variables([x], [gx])
    for step in range(2):
        x[:] = X + step
        x += 0.5
        with tmx.autograd.train_section():
            y = x * x
        tmx.autograd.backward([y])
        np.testing.assert_allclose(gx.asnumpy(), 2 * (X + step + 0.5), rtol=1e-6)
    assert not x._data.requires_grad


def test_training_flag():
    assert not tmx.autograd.is_training() and not tmx.autograd.is_recording()
    with tmx.autograd.train_section():
        assert tmx.autograd.is_training() and tmx.autograd.is_recording()
        with tmx.autograd.test_section():
            assert not tmx.autograd.is_training()
    assert not tmx.autograd.is_training()
    assert tmx.autograd.set_is_training(True) is False
    assert tmx.autograd.set_is_training(False) is True
    with pytest.raises(tmx.MXNetError, match="no variables"):
        tmx.autograd.backward([tmx.nd.ones((1,))])
