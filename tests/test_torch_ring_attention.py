"""The port's ring attention (``mxnet_tpu_torch.parallel.ring_attention``)
held against the JAX package's on the CPU: ``sequence_parallel_attention``
over sp = 2 and 4 blocks, causal and not, forward and gradients against
``shard_map`` over the virtual host devices (the shapes and tolerances of
``tests/test_parallel.py``); a ``q_offset`` of whole blocks; the raises;
the plain online-softmax loop against the ring; and the two models that
take an sp mesh, the transformer LM and the LSTM attention LM, against
JAX's with ``make_mesh(sp=2)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu.parallel.ring_attention import (
    sequence_parallel_attention as jspa)
from mxnet_tpu_torch.models import common as tcommon
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.parallel.mesh import make_mesh
from mxnet_tpu_torch.parallel.ring_attention import (
    live_pairs, ring_attention, ring_attention_reference, sequence_parallel_attention)

SHAPE = (2, 16, 2, 8)  # B, T, H, D of tests/test_parallel.py:31
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)


def _qkv(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _port(*xs, grad=False):
    return [torch.from_numpy(x.copy()).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(sp, causal):
    q, k, v = _qkv(0)
    mesh = jmake_mesh(sp=sp)
    want = jax.jit(lambda q, k, v: jspa(q, k, v, mesh, causal=causal))(q, k, v)
    got = sequence_parallel_attention(*_port(q, k, v), make_mesh(sp=sp, devices=["cpu"] * sp),
                                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(sp, causal):
    """dq, dk, dv of sum(out * cot) against jax.grad through shard_map."""
    q, k, v = _qkv(1)
    cot = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    mesh = jmake_mesh(sp=sp)

    def loss(q, k, v):
        return jnp.sum(jspa(q, k, v, mesh, causal=causal) * cot)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = _port(q, k, v, grad=True)
    out = sequence_parallel_attention(tq, tk, tv, {"sp": sp}, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg="d" + name, **GRAD)


@pytest.mark.parametrize("blocks", [1, 2])
def test_whole_block_q_offset_matches_jax(blocks):
    """Queries shifted by whole blocks (the chunked-prefill hook): forward
    and dq against JAX's."""
    sp, tb = 2, SHAPE[1] // 2
    q, k, v = _qkv(3)
    mesh = jmake_mesh(sp=sp)

    def out_sum(q):
        return jnp.sum(jspa(q, jnp.asarray(k), jnp.asarray(v), mesh, causal=True,
                            q_offset=blocks * tb))

    want = jax.jit(lambda q: jspa(q, jnp.asarray(k), jnp.asarray(v), mesh, causal=True,
                                  q_offset=blocks * tb))(q)
    want_dq = jax.jit(jax.grad(out_sum))(q)
    tq, tk, tv = _port(q, k, v)
    tq.requires_grad_()
    got = ring_attention(tq, tk, tv, sp, causal=True, q_offset=blocks * tb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    (dq,) = torch.autograd.grad(got.sum(), (tq,))
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), **GRAD)


def test_raises_where_the_ring_cannot_run():
    q, k, v = _port(*_qkv(4))
    with pytest.raises(NotImplementedError, match="whole blocks"):
        ring_attention(q, k, v, 2, causal=True, q_offset=3)
    with pytest.raises(NotImplementedError, match="whole blocks"):
        ring_attention(q, k, v, 2, causal=True, q_offset=-8)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, k, v, 3, causal=True)
    with pytest.raises(ValueError, match="divisible"):
        kernels.attention(q, k, v, causal=True, mesh={"sp": 5})


@pytest.mark.parametrize("sp,causal,offset", [(2, False, 0), (4, True, 0), (4, True, 8),
                                              (4, False, 4)])
def test_plain_loop_matches_the_ring(sp, causal, offset):
    """ring_attention_reference (JAX's online-softmax loop, every block pair
    computed) against the ring (live pairs only, merged by logsumexp), and
    the ring's pair count."""
    q, k, v = _port(*_qkv(5))
    want = ring_attention_reference(q, k, v, sp, causal=causal, q_offset=offset)
    got = ring_attention(q, k, v, sp, causal=causal, q_offset=offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
    n = len(live_pairs(sp, causal, offset // (SHAPE[1] // sp)))
    if not causal:
        assert n == sp * sp
    elif offset == 0:
        assert n == sp * (sp + 1) // 2


def test_transformer_sp_mesh_matches_jax():
    """The dense LM's apply_fn with an sp = 2 mesh against JAX's apply_fn(...,
    mesh=make_mesh(sp=2)) in f32: logits 1e-5, the gradients of the mean
    NLL 1e-4 of each one's max."""
    from mxnet_tpu.models import transformer as jtfm
    from mxnet_tpu_torch.models import transformer as ttfm

    dims = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32)
    tokens = np.random.RandomState(6).randint(0, dims["vocab"], (2, 13))
    j_init, j_apply = jtfm.transformer_lm(dtype=jnp.float32, **dims)
    tree = j_init(0)
    mesh = jmake_mesh(sp=2)

    def jloss(p):
        logits = j_apply(p, jnp.asarray(tokens[:, :-1]), mesh=mesh)
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(tokens[:, 1:])[..., None], -1))
        return nll, logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    _, t_apply = ttfm.transformer_lm(dtype=torch.float32, **dims)
    params = ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32).requires_grad_()
    logits = t_apply(params, torch.from_numpy(tokens[:, :-1]),
                     mesh=make_mesh(sp=2, devices=["cpu"] * 2))
    lp = torch.log_softmax(logits, -1)
    loss = -lp.gather(-1, torch.from_numpy(tokens[:, 1:])[..., None]).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = ttfm.grads_to_jax(params)
    for key, sub in jax.tree_util.tree_map(np.asarray, jgrads).items():
        for name, w in (sub.items() if isinstance(sub, dict) else [(None, sub)]):
            g = got[key][name] if name else got[key]
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g / scale, w / scale, rtol=1e-4, atol=1e-4,
                                       err_msg="%s/%s" % (key, name))


def test_lstm_attention_lm_sp_mesh_matches_jax():
    """The LSTM attention LM with mesh={"sp": 2} against JAX's with
    make_mesh(sp=2): logits and every gradient of a cross-entropy loss,
    atol 1e-5 (test_torch_rnn.py's tolerances)."""
    from mxnet_tpu.models.lstm import lstm_attention_lm as jlm
    from mxnet_tpu_torch.models.lstm import lstm_attention_lm as tlm

    dims = dict(vocab=40, num_hidden=16, num_embed=12, n_heads=2)
    jinit, japply = jlm(**dims)
    _, tapply = tlm(**dims)
    host = jinit(3)
    tokens = np.random.RandomState(6).randint(0, 40, (2, 8))
    tgt = np.random.RandomState(7).randint(0, 40, (2, 8))
    mesh = jmake_mesh(sp=2)

    def jloss(params):
        logits = japply(params, jnp.asarray(tokens), mesh=mesh)
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(lp, jnp.asarray(tgt)[..., None], -1).mean(), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(host)
    params, _ = tcommon.params_from_numpy(host, {}, device="cpu")
    for p in params.values():
        p.requires_grad_()
    logits = tapply(params, torch.from_numpy(tokens), mesh={"sp": 2})
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 40),
                                             torch.from_numpy(tgt).reshape(-1))
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]), rtol=0, atol=1e-5,
                                   err_msg=n)
