"""The PyTorch port's NDArray held against the JAX package on the CPU:
tests/test_ndarray.py's assertions run through both packages on the same
numpy inputs, results compared with each other (f32 at 1e-5, integers
exactly), plus what the port adds: in-place writes into the tensor, the
Context stack, bfloat16's asnumpy, and the error without a card."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RNG = np.random.RandomState(0)
X = RNG.rand(3, 4).astype(np.float32) + 0.5
Y = RNG.rand(3, 4).astype(np.float32) + 0.5


@pytest.fixture
def host():
    with tmx.cpu() as ctx:
        yield ctx


def _both(fn):
    """fn(mx) in each package, as numpy: (jax, port)."""
    return [np.asarray(fn(pkg).asnumpy()) for pkg in (jmx, tmx)]


def _same(fn, exact=False):
    want, got = _both(fn)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return got


def test_no_context_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: gpu(0) is the default context there")
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        tmx.nd.zeros((2,))
    with pytest.raises(tmx.MXNetError):
        tmx.current_context()
    with tmx.cpu():
        assert tmx.nd.zeros((2,)).context == tmx.cpu()


def test_context_stack(host):
    assert tmx.current_context() == tmx.cpu(0)
    with tmx.Context("cpu", 1):
        assert tmx.current_context() == tmx.cpu(1)
        assert tmx.nd.ones((1,)).context == tmx.cpu(0)  # the host is one device
    assert tmx.current_context() == tmx.cpu(0)
    assert tmx.gpu(2).device_type == "gpu" and tmx.gpu(2).device_id == 2
    assert tmx.cpu().torch_device == torch.device("cpu")
    assert tmx.Context(torch.device("cuda", 1)) == tmx.gpu(1)
    assert {tmx.cpu(), tmx.cpu(0)} == {tmx.cpu()}
    assert repr(tmx.gpu(3)) == repr(jmx.gpu(3)) == "gpu(3)"
    assert tmx.num_devices("cpu") == 1
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError):
            tmx.gpu(0).torch_device
    from mxnet_tpu_torch.context import resolve_device

    assert resolve_device(None) == resolve_device("cpu") == resolve_device(tmx.cpu())


def test_creation(host):
    for fn in (lambda mx: mx.nd.zeros((3, 4)), lambda mx: mx.nd.ones((2, 2), dtype=np.float64),
               lambda mx: mx.nd.full((2, 2), 7), lambda mx: mx.nd.array([[1, 2], [3, 4]]),
               lambda mx: mx.nd.array(np.arange(6.0)), lambda mx: mx.nd.empty(3),
               lambda mx: mx.nd.arange(2, 9, 1.5, repeat=2),
               lambda mx: mx.nd.arange(5, dtype=np.int32)):
        _same(fn, exact=True)
    a = tmx.nd.zeros((3, 4))
    assert a.shape == (3, 4) and a.dtype == np.float32 and a.size == 12 and a.ndim == 2
    assert tmx.nd.array([[1, 2], [3, 4]]).dtype == jmx.nd.array([[1, 2], [3, 4]]).dtype


def test_elementwise_vs_numpy_and_jax(host):
    for fn in (lambda mx: mx.nd.array(X) + mx.nd.array(Y),
               lambda mx: mx.nd.array(X) - mx.nd.array(Y),
               lambda mx: mx.nd.array(X) * mx.nd.array(Y),
               lambda mx: mx.nd.array(X) / mx.nd.array(Y),
               lambda mx: mx.nd.array(X) ** mx.nd.array(Y),
               lambda mx: mx.nd.array(X) + 2, lambda mx: 2 - mx.nd.array(X),
               lambda mx: 2 / mx.nd.array(X), lambda mx: -mx.nd.array(X),
               lambda mx: 2 ** mx.nd.array(X), lambda mx: mx.nd.array(X) % 0.3,
               lambda mx: 1.7 % mx.nd.array(X), lambda mx: mx.nd.array(X) + X[:1],
               lambda mx: mx.nd.array(X) * mx.nd.array(Y[:1])):
        _same(fn)
    a, b = tmx.nd.array(X), tmx.nd.array(Y)
    np.testing.assert_allclose((a ** b).asnumpy(), X ** Y, rtol=1e-4)
    np.testing.assert_allclose((2 / a).asnumpy(), 2 / X, rtol=1e-5)


def test_inplace_writes_into_the_tensor(host):
    a = tmx.nd.array(np.ones((2, 3), np.float32))
    t = a._data
    a += 2
    a *= 3
    a /= 3
    a -= 1
    assert a._data is t
    np.testing.assert_allclose(a.asnumpy(), np.full((2, 3), 2.0))
    i = tmx.nd.array(np.arange(6, dtype=np.int32).reshape(2, 3))
    i += 1.7  # the scalar takes the array's dtype first, as in jnp
    j = jmx.nd.array(np.arange(6, dtype=np.int32).reshape(2, 3))
    j += 1.7
    np.testing.assert_array_equal(i.asnumpy(), j.asnumpy())
    assert i.dtype == np.int32


def test_comparison(host):
    for fn in (lambda mx: mx.nd.array([1.0, 2.0, 3.0]) == mx.nd.array([3.0, 2.0, 1.0]),
               lambda mx: mx.nd.array([1.0, 2.0, 3.0]) != mx.nd.array([3.0, 2.0, 1.0]),
               lambda mx: mx.nd.array([1.0, 2.0, 3.0]) > mx.nd.array([3.0, 2.0, 1.0]),
               lambda mx: mx.nd.array([1.0, 2.0, 3.0]) >= 2,
               lambda mx: mx.nd.array([1.0, 2.0, 3.0]) < mx.nd.array([3.0, 2.0, 1.0]),
               lambda mx: mx.nd.array([1.0, 2.0, 3.0]) <= 2):
        _same(fn, exact=True)
    a = tmx.nd.array([1.0, 2.0, 3.0])
    assert ((a == tmx.nd.array([3.0, 2.0, 1.0])).asnumpy() == [0, 1, 0]).all()


def test_indexing_and_setitem(host):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)

    def run(mx):
        a = mx.nd.array(x)
        parts = [a[1], a[1:3], a[1, 2:4], a[mx.nd.array([0, 2])], a.slice(1, 3), a.at(2)]
        a[1] = 0.0
        a[2, 1:3] = np.array([7.0, 8.0], np.float32)
        a[3] = mx.nd.array(np.full(6, 9.0, np.float32))
        b = mx.nd.zeros((4, 6))
        b[2:4] = a[0:2]
        c = mx.nd.zeros((4, 6))
        c[:] = 5.0
        d = mx.nd.zeros((2, 6))
        d[:] = x[:1]
        return [p.asnumpy() for p in parts] + [a.asnumpy(), b.asnumpy(), c.asnumpy(), d.asnumpy()]

    for got, want in zip(run(tmx), run(jmx)):
        np.testing.assert_array_equal(got, want)
    a = tmx.nd.array(x)
    t = a._data
    a[:] = 5.0
    assert a._data is t and (a.asnumpy() == 5).all()
    s = a[1:3]
    s[:] = 0.0  # a slice is a copy, as in the JAX package
    assert (a.asnumpy() == 5).all()
    with pytest.raises(tmx.MXNetError, match="step"):
        a[0:4:2]  # noqa: B018


def test_reshape_transpose(host):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for fn in (lambda mx: mx.nd.array(x).reshape((2, 12)), lambda mx: mx.nd.array(x).T,
               lambda mx: mx.nd.Reshape(mx.nd.array(x), shape=(-1, 4)),
               lambda mx: mx.nd.array(x[:1]).broadcast_to((3, 6))):
        _same(fn, exact=True)
    b = tmx.nd.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    assert tmx.nd.Reshape(b, shape=(0, -1)).shape == (2, 12)
    assert tmx.nd.Reshape(b, shape=(-2,)).shape == (2, 3, 4)
    assert tmx.nd.Reshape(b, shape=(-3, 4)).shape == (6, 4)
    assert tmx.nd.Reshape(b, shape=(-4, 1, 2, 0, 0)).shape == (1, 2, 3, 4)
    r = b.reshape((6, 4))
    r[:] = 0.0  # results never alias their input
    assert b.asnumpy().sum() == 276


def test_dot_reduce_broadcast(host):
    x, y = RNG.rand(4, 5).astype(np.float32), RNG.rand(5, 3).astype(np.float32)
    bx, by = RNG.rand(2, 4, 5).astype(np.float32), RNG.rand(2, 5, 3).astype(np.float32)
    z = RNG.rand(2, 3, 4).astype(np.float32)
    np.testing.assert_allclose(
        _same(lambda mx: mx.nd.dot(mx.nd.array(x), mx.nd.array(y))), x @ y, rtol=1e-5)
    np.testing.assert_allclose(
        _same(lambda mx: mx.nd.batch_dot(mx.nd.array(bx), mx.nd.array(by))), bx @ by, rtol=1e-5)
    np.testing.assert_allclose(_same(lambda mx: mx.nd.sum(mx.nd.array(z), axis=(0, 2),
                                                          keepdims=True)),
                               z.sum((0, 2), keepdims=True), rtol=1e-5)
    np.testing.assert_array_equal(_same(lambda mx: mx.nd.argmax(mx.nd.array(z), axis=2)),
                                  z.argmax(2))
    a, b = RNG.rand(2, 1, 4).astype(np.float32), RNG.rand(1, 3, 4).astype(np.float32)
    np.testing.assert_allclose(
        _same(lambda mx: mx.nd.broadcast_add(mx.nd.array(a), mx.nd.array(b))), a + b)
    assert tmx.nd.broadcast_to(tmx.nd.array(a), shape=(2, 5, 4)).shape == (2, 5, 4)


def test_save_load_roundtrip(host, tmp_path):
    fname = str(tmp_path / "nd.bin")
    a = tmx.nd.array(RNG.rand(3, 4).astype(np.float32))
    b = tmx.nd.array(np.arange(5, dtype=np.int32))
    tmx.nd.save(fname, [a, b])
    loaded = tmx.nd.load(fname)
    np.testing.assert_array_equal(loaded[0].asnumpy(), a.asnumpy())
    assert loaded[1].dtype == np.int32 and (loaded[1].asnumpy() == b.asnumpy()).all()
    tmx.nd.save(fname, {"w": a, "b": b})
    loaded = tmx.nd.load(fname)
    assert set(loaded) == {"w", "b"}
    assert tmx.nd.load_buffer(tmx.nd.save_buffer({"w": a}))["w"].shape == (3, 4)
    with pytest.raises(tmx.MXNetError, match="0-d"):
        tmx.nd.save(fname, [tmx.nd.NDArray(torch.tensor(1.0))])


def test_astype_copy_movement(host):
    a = tmx.nd.array(np.arange(4, dtype=np.float32))
    b = a.astype(np.int32)
    assert b.dtype == np.int32
    c = a.copy()
    c += 1
    np.testing.assert_array_equal(a.asnumpy(), np.arange(4))
    assert a.astype("float32")._data is not a._data
    d = tmx.nd.zeros((4,))
    a.copyto(d)
    np.testing.assert_array_equal(d.asnumpy(), np.arange(4))
    assert a.copyto(tmx.cpu()).context == tmx.cpu()
    assert a.as_in_context(tmx.cpu()) is a
    assert a[2].asscalar() == 2.0 and float(a.asnumpy().sum()) == 6.0
    assert np.asarray(a).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        np.asarray(a, copy=False)
    back = pickle.loads(pickle.dumps(a))
    np.testing.assert_array_equal(back.asnumpy(), a.asnumpy())
    assert len(a) == 4 and bool(tmx.nd.ones((1,)))
    with pytest.raises(tmx.MXNetError):
        bool(a)


def test_bfloat16_asnumpy_is_float32(host):
    a = tmx.nd.array(np.array([1.0, 1.00390625, 3.0], np.float32), dtype="bfloat16")
    assert a._data.dtype == torch.bfloat16
    got = a.asnumpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, [1.0, 1.0, 3.0])  # rounded to bf16 on the way in


def test_concatenate_take_onehot(host):
    x, y = RNG.rand(2, 3).astype(np.float32), RNG.rand(4, 3).astype(np.float32)
    np.testing.assert_array_equal(
        _same(lambda mx: mx.nd.concatenate([mx.nd.array(x), mx.nd.array(y)], axis=0)),
        np.concatenate([x, y]))
    w = RNG.rand(10, 4).astype(np.float32)
    idx = np.array([1, 3, 5], np.float32)
    np.testing.assert_array_equal(
        _same(lambda mx: mx.nd.take(mx.nd.array(w), mx.nd.array(idx))), w[[1, 3, 5]])
    oh = _same(lambda mx: mx.nd.one_hot(mx.nd.array(idx), depth=10), exact=True)
    assert oh.shape == (3, 10) and (oh.argmax(1) == [1, 3, 5]).all()
    out = tmx.nd.zeros((3, 10))
    assert tmx.nd.onehot_encode(tmx.nd.array(idx), out) is out
    np.testing.assert_array_equal(out.asnumpy(), oh)
    tmx.nd.waitall()


def test_fused_optimizer_ops_write_back(host):
    w = RNG.rand(5).astype(np.float32)
    g = RNG.rand(5).astype(np.float32)

    def run(mx):
        weight, grad, mom = mx.nd.array(w), mx.nd.array(g), mx.nd.zeros(5)
        mx.nd.sgd_mom_update(weight, grad, mom, out=weight, lr=0.1, momentum=0.9)
        mx.nd.sgd_mom_update(weight, grad, mom, out=weight, lr=0.1, momentum=0.9)
        return weight.asnumpy(), mom.asnumpy()

    (tw, tm), (jw, jm) = run(tmx), run(jmx)
    np.testing.assert_allclose(tw, jw, rtol=1e-6)
    np.testing.assert_allclose(tm, jm, rtol=1e-6)
    weight = tmx.nd.array(w)
    t = weight._data
    tmx.nd.sgd_update(weight, tmx.nd.array(g), out=weight, lr=0.1, wd=0.0)
    assert weight._data is t
    np.testing.assert_allclose(weight.asnumpy(), w - 0.1 * g, rtol=1e-5)
    with pytest.raises(tmx.MXNetError, match="write"):
        tmx.nd.sgd_update(weight, tmx.nd.array(g), out=tmx.nd.zeros(4), lr=0.1)


def test_generated_functions_and_imdecode(host):
    assert tmx.nd.Reshape.__doc__.startswith("Reshape(data")
    assert tmx.nd.ones((2, 3), ctx=tmx.cpu()).T.shape == (3, 2)
    r = tmx.nd.ones((2,), ctx=tmx.cpu()) + tmx.nd.zeros((2,))
    assert repr(r) == "<NDArray 2 @cpu(0)>"
    # ported with the input path: an empty buffer is no image
    with pytest.raises((OSError, tmx.MXNetError)):
        tmx.nd.imdecode(b"")
