"""K1's plain version in the PyTorch port (``slab_update_reference``) held
against the JAX package's ``fused_slab_update`` (the Pallas kernel in
interpret mode) and its ``slab_update_reference``, on the same numpy
inputs: sgd / sgd_mom / adam, ragged sizes, clipping on and off, a finite
and a skipped step. Masters and states within rtol 1e-6 / atol 1e-7, the
bf16 weight copy bit for bit, and a skipped step returns its inputs bit
for bit. The wrapper on CPU tensors runs the plain version (its launch
count stays put), also when it writes in place through ``out=``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import kernels

KW = dict(wd=0.0001, rescale_grad=1.0 / 32, momentum=0.9, beta1=0.9, beta2=0.999,
          epsilon=1e-8)
LR, INV_SCALE = 0.05, 1.0 / 128


def _inputs(kind, size):
    rng = np.random.RandomState(size + len(kind))
    w = rng.randn(size).astype(np.float32)
    g = (rng.randn(size) * 4).astype(np.float32)
    states = [rng.randn(size).astype(np.float32) * 0.1
              for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
    return w, g, states


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("size", [131, 1024, 5000])
@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_plain_version_matches_jax(kind, size, clip):
    w, g, states = _inputs(kind, size)
    jw, jg = jnp.asarray(w), jnp.asarray(g, jnp.bfloat16)
    jst = tuple(jnp.asarray(s) for s in states)
    tw = torch.from_numpy(w)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tst = tuple(torch.from_numpy(s) for s in states)
    for finite in (1.0, 0.0):
        args = (LR, INV_SCALE, finite)
        got = kernels.slab_update_reference(kind, tw, tg, tst, *args, clip_gradient=clip, **KW)
        ref = pk.slab_update_reference(kind, jw, jg, jst, *args, clip_gradient=clip, **KW)
        pallas = pk.fused_slab_update(kind, jw, jg, jst, *args, clip_gradient=clip,
                                      interpret=True, **KW)
        for want in (ref, pallas):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6,
                                       atol=1e-7)
            assert len(got[1]) == len(want[1]) == len(states)
            for a, b in zip(got[1], want[1]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(got[2].float().numpy(),
                                          np.asarray(want[2].astype(jnp.float32)))
        if finite == 0.0:
            np.testing.assert_array_equal(got[0].numpy(), w)
            for a, s in zip(got[1], states):
                np.testing.assert_array_equal(a.numpy(), s)
            np.testing.assert_array_equal(_bits(got[2]), _bits(tw.to(torch.bfloat16)))


@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_wrapper_on_cpu_tensors_runs_the_plain_version(kind):
    w, g, states = _inputs(kind, 300)
    tw, tg = torch.from_numpy(w), torch.from_numpy(g).to(torch.bfloat16)
    tst = tuple(torch.from_numpy(s) for s in states)
    before = kernels.fused_slab_update.launches
    args = (kind, tw, tg, tst, torch.tensor(LR), torch.tensor(INV_SCALE), torch.tensor(1.0))
    got = kernels.fused_slab_update(*args, clip_gradient=None, **KW)
    want = kernels.slab_update_reference(*args, clip_gradient=None, **KW)
    for a, b in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # in place through out=: master and states overwritten, w16 written
    mw, mst = tw.clone(), tuple(s.clone() for s in tst)
    w16 = torch.empty(300, dtype=torch.bfloat16)
    out = kernels.fused_slab_update(kind, mw, tg, mst, LR, INV_SCALE, 1.0, clip_gradient=None,
                                    out=(mw, mst, w16), **KW)
    assert out[0] is mw and out[2] is w16
    for a, b in zip((mw, *mst, w16), (want[0], *want[1], want[2])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert kernels.fused_slab_update.launches == before
