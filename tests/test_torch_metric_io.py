"""The PyTorch port's metrics and data iterators held against the JAX
package's on the CPU: each metric gives the same value on the same
predictions and labels; NDArrayIter gives the same batches, pads and
shuffle order (one ``np.random`` seed) in every ``last_batch_handle``
mode across ``reset``; ResizeIter and PrefetchingIter serve the same
batches as the JAX package's."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _preds():
    rng = np.random.RandomState(5)
    logits = rng.randn(12, 4).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    label = rng.randint(0, 4, 12).astype(np.float32)
    return prob.astype(np.float32), label


def _binary():
    rng = np.random.RandomState(6)
    prob = rng.rand(10, 2).astype(np.float32)
    return prob / prob.sum(1, keepdims=True), rng.randint(0, 2, 10).astype(np.float32)


def _regression():
    rng = np.random.RandomState(7)
    return rng.randn(9, 1).astype(np.float32), rng.randn(9).astype(np.float32)


METRICS = [
    ("acc", {}, _preds), ("top_k_accuracy", {"top_k": 2}, _preds), ("f1", {}, _binary),
    ("mae", {}, _regression), ("mse", {}, _regression), ("rmse", {}, _regression),
    ("ce", {}, _preds), ("perplexity", {"ignore_label": 1}, _preds),
    ("composite", {}, _preds), ("custom", {}, _preds),
]


def _metric(pkg, name, kwargs):
    if name == "perplexity":
        return pkg.metric.Perplexity(**kwargs)
    if name == "composite":
        return pkg.metric.create(["acc", "ce"])
    if name == "custom":
        return pkg.metric.np(lambda label, pred: float((pred.argmax(1) == label).mean()),
                             name="argmax_hit")
    return pkg.metric.create(name, **kwargs)


@pytest.mark.parametrize("name,kwargs,data", METRICS, ids=[m[0] for m in METRICS])
def test_metric_matches_jax(name, kwargs, data):
    pred, label = data()
    values = {}
    for pkg in (jmx, tmx):
        m = _metric(pkg, name, kwargs)
        for lo, hi in ((0, 5), (5, len(label))):  # two batches accumulate
            m.update([pkg.nd.array(label[lo:hi])], [pkg.nd.array(pred[lo:hi])])
        values[pkg] = m.get_name_value()
    assert [n for n, _ in values[tmx]] == [n for n, _ in values[jmx]]
    np.testing.assert_allclose([v for _, v in values[tmx]], [v for _, v in values[jmx]],
                               rtol=1e-6)


def _batches(it, epochs):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data], [lb.asnumpy() for lb in b.label], b.pad))
        it.reset()
    return out


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(mode, shuffle):
    rng = np.random.RandomState(8)
    X = rng.randn(23, 3, 2).astype(np.float32)
    y = np.arange(23, dtype=np.float32)
    got = {}
    for pkg in (jmx, tmx):
        np.random.seed(4)
        it = pkg.io.NDArrayIter(X, y, batch_size=5, shuffle=shuffle, last_batch_handle=mode)
        assert [tuple(d) for d in it.provide_data] == [("data", (5, 3, 2))]
        assert [tuple(d) for d in it.provide_label] == [("softmax_label", (5,))]
        got[pkg] = _batches(it, 3)
    assert len(got[tmx]) == len(got[jmx])
    for (td, tl, tp), (jd, jl, jp) in zip(got[tmx], got[jmx]):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)


def test_resize_and_prefetching_iters_match_jax():
    X = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    got = {}
    for pkg in (jmx, tmx):
        resized = pkg.io.ResizeIter(pkg.io.NDArrayIter(X, y, batch_size=6), 7)
        pre = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(X, y, batch_size=4))
        got[pkg] = _batches(resized, 2) + _batches(pre, 2)
    assert len(got[tmx]) == len(got[jmx])
    for (td, tl, tp), (jd, jl, jp) in zip(got[tmx], got[jmx]):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)


def test_unported_iterators_raise():
    """The four iterators that raised NotImplementedError until the input
    path was ported now want their arguments (TypeError), and a
    DeviceFeedIter over an NDArrayIter stages host batches unchanged."""
    for name in ("DeviceFeedIter", "MNISTIter", "CSVIter", "ImageRecordIter"):
        with pytest.raises(TypeError):
            getattr(tmx.io, name)()
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    with tmx.cpu():
        feed = tmx.io.DeviceFeedIter(tmx.io.NDArrayIter(X, np.zeros(6, "f"), batch_size=3))
        np.testing.assert_array_equal(np.concatenate([b.data[0].asnumpy() for b in feed]), X)
