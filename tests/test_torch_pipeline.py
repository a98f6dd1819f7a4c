"""The port's GPipe pipeline (``mxnet_tpu_torch.parallel.pipeline``) held
against the JAX package's on the CPU: ``pipelined_loss`` over 4 logical pp
ranks against JAX's over ``make_mesh(dp=1, pp=4)`` of the virtual host
devices, with ``tests/test_moe_pipeline.py``'s problem (loss within 1e-5
relative, gradients within 1e-4), against the port's own sequential loop,
and the port of ``test_pipeline_trains``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.pipeline import pipelined_loss as jpipelined_loss
from mxnet_tpu_torch.parallel.mesh import make_mesh
from mxnet_tpu_torch.parallel.pipeline import pipeline_stages, pipelined_loss


def _stage_fn(p, act):
    return torch.relu(act @ p["w"] + p["b"])


def _jstage_fn(p, act):
    return jax.nn.relu(act @ p["w"] + p["b"])


def _loss_fn(outs, y):
    return torch.mean((outs - y) ** 2)


def _problem(n_stages=4, n_micro=8, mb=4, d=16, seed=5):
    """test_moe_pipeline.py's _make_pipeline_problem, as numpy arrays."""
    r = np.random.RandomState(seed)
    params = {"w": (r.randn(n_stages, d, d) * 0.3).astype(np.float32),
              "b": (r.randn(n_stages, d) * 0.1).astype(np.float32)}
    x = r.randn(n_micro, mb, d).astype(np.float32)
    y = r.randn(n_micro, mb, d).astype(np.float32)
    return params, x, y


def _torch(params, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in params.items()}


def _sequential_loss(params, x, y):
    act = x
    for s in range(params["w"].shape[0]):
        act = _stage_fn({"w": params["w"][s], "b": params["b"][s]}, act)
    return _loss_fn(act, y)


@pytest.mark.parametrize("seed", [5, 9])
def test_pipelined_loss_matches_jax(seed):
    params, x, y = _problem(seed=seed)
    mesh = jmake_mesh(dp=1, pp=4, devices=jax.devices()[:4])
    jloss = jpipelined_loss(_jstage_fn, lambda o, t: jnp.mean((o - t) ** 2), mesh)
    with mesh:
        want, want_g = jax.jit(jax.value_and_grad(jloss))(params, x, y)
    tp = _torch(params, grad=True)
    loss = pipelined_loss(_stage_fn, _loss_fn, make_mesh(dp=1, pp=4, devices=["cpu"] * 4))(
        tp, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_g[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_pipeline_matches_the_sequential_loop():
    """Outputs of every microbatch, the loss and the gradients against the
    stages run one after another on the whole batch."""
    params, x, y = _problem()
    tp, tq = _torch(params, grad=True), _torch(params, grad=True)
    outs = pipeline_stages(_stage_fn, tp, torch.from_numpy(x), 4)
    act = torch.from_numpy(x)
    for s in range(4):
        act = _stage_fn({"w": tq["w"][s], "b": tq["b"][s]}, act)
    assert outs.shape == (8, 4, 16)
    torch.testing.assert_close(outs, act, rtol=1e-6, atol=1e-6)
    _loss_fn(outs, torch.from_numpy(y)).backward()
    _sequential_loss(tq, torch.from_numpy(x), torch.from_numpy(y)).backward()
    for k in params:
        torch.testing.assert_close(tp[k].grad, tq[k].grad, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="stages"):
        pipelined_loss(_stage_fn, _loss_fn, {"pp": 3})(tp, torch.from_numpy(x),
                                                       torch.from_numpy(y))


def test_pipeline_trains():
    """A few SGD steps through the pipelined loss reduce it."""
    params, x, _ = _problem(seed=6)
    tp = _torch(params, grad=True)
    x = torch.from_numpy(x)
    y = torch.zeros_like(x)  # learnable target (zero output is reachable)
    loss_p = pipelined_loss(_stage_fn, _loss_fn, {"pp": 4})
    l0 = None
    for _ in range(25):
        loss = loss_p(tp, x, y)
        l0 = loss.item() if l0 is None else l0
        loss.backward()
        with torch.no_grad():
            for p in tp.values():
                p -= 0.1 * p.grad
                p.grad = None
    with torch.no_grad():
        l1 = loss_p(tp, x, y).item()
    assert l1 < l0 * 0.5, (l0, l1)
