"""The port's one-process kvstore: whatever its type, a stored value
follows the gradients pushed into it onto their device, and the updater
runs there. Imports only the port, so the card's test runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kvstore.py -q
"""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx


class _OnCard(tmx.nd.NDArray):
    """A host tensor that reports ``gpu(0)``: a pushed card gradient as the
    store sees it, without a card."""

    __slots__ = ()

    @property
    def context(self):
        return tmx.gpu(0)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_kvstore_store_follows_pushed_device(kv_type, monkeypatch):
    """Whatever the store type, a value initialised on the host moves to the
    device of the gradient pushed into it, and the updater runs there: the
    gradient is not copied to the host."""
    moved = []

    def as_in_context(self, context):
        moved.append((type(self), context))
        return _OnCard(self._data.clone())

    monkeypatch.setattr(tmx.nd.NDArray, "as_in_context", as_in_context)
    rng = np.random.RandomState(0)
    w, g = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32)
    kv = tmx.kv.create(kv_type)
    kv.init(3, tmx.nd.array(w, ctx=tmx.cpu()))
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.5, rescale_grad=1.0))
    grad = _OnCard(tmx.nd.array(g, ctx=tmx.cpu())._data)
    kv.push(3, grad)
    assert moved == [(tmx.nd.NDArray, tmx.gpu(0))]
    assert type(kv._store[3]) is _OnCard
    out = tmx.nd.zeros((4, 3), ctx=tmx.cpu())
    kv.pull(3, out=out)
    np.testing.assert_allclose(out.asnumpy(), w - 0.5 * g, rtol=1e-6)
    kv.push(3, grad)  # the store is on the pushers' device now: nothing moves
    assert len(moved) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_kvstore_store_follows_pushed_card(kv_type):
    """On the card: a host-initialised 'local' or 'device' store that four
    card gradients are pushed into ends on the card, with its momentum."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    w = rng.randn(64, 32).astype(np.float32)
    gs = [rng.randn(64, 32).astype(np.float32) for _ in range(4)]
    kv = tmx.kv.create(kv_type)
    kv.init(0, tmx.nd.array(w, ctx=tmx.cpu()))
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                          rescale_grad=1.0))
    kv.push(0, [tmx.nd.array(g, ctx=tmx.gpu(0)) for g in gs])
    assert kv._store[0].context == tmx.gpu(0)
    (state,) = [s for s in kv._updater.states.values()]
    assert state.context == tmx.gpu(0)
    out = tmx.nd.zeros((64, 32), ctx=tmx.gpu(0))
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), w - 0.1 * sum(gs), rtol=1e-5, atol=1e-5)
