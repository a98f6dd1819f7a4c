"""The port's Switch-MoE (``mxnet_tpu_torch.parallel.moe``, the MoE layers
of ``models.transformer`` and the ``SwitchMoE`` contrib operator) held
against the JAX package on the CPU: the parameters bit for bit, the
routing, outputs, aux loss and gradients of ``switch_moe``, the ports of
``tests/test_moe_pipeline.py``'s MoE cases, the MoE transformer LM (with
and without an sp mesh) and the operator through ``Module.fit``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.parallel import moe as jmoe
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.parallel import moe as tmoe
from mxnet_tpu_torch.parallel.mesh import make_mesh

DIMS = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32)  # test_torch_serving.py's
MOE = dict(d_model=16, d_hidden=32, num_experts=8)  # test_moe_pipeline.py's sharded cases


def _jax_params(seed=0, **dims):
    return {k: np.asarray(v) for k, v in jmoe.init_moe_params(seed, **(dims or MOE)).items()}


def _port_params(host, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in host.items()}


def _x(seed, tokens=64, d=16):
    return np.random.RandomState(seed).randn(tokens, d).astype(np.float32)


def _jax_routing(params, x):
    return np.asarray(jnp.argmax(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(params["gate_w"]), axis=-1), axis=-1))


def _port_routing(params, x):
    return torch.argmax(torch.softmax(torch.from_numpy(x) @ params["gate_w"].detach(), -1),
                        -1).numpy()


@pytest.mark.parametrize("seed", [0, 7])
def test_init_moe_params_bitwise_jax(seed):
    want = _jax_params(seed)
    got = tmoe.init_moe_params(seed, device="cpu", **MOE)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert {k: tuple(v) for k, v in jmoe.moe_partition_specs().items()} == \
        tmoe.moe_partition_specs()


@pytest.mark.parametrize("capacity_factor", [2.0, 1.25, 0.5])
def test_switch_moe_matches_jax(capacity_factor):
    """The routing first (a near tie flipping an argmax would show as
    itself), then y and aux within 2e-5."""
    host, x = _jax_params(0), _x(3)
    params = _port_params(host)
    np.testing.assert_array_equal(_port_routing(params, x), _jax_routing(host, x))
    jy, jaux = jax.jit(lambda p, x: jmoe.switch_moe(p, x, capacity_factor))(host, x)
    y, aux = tmoe.switch_moe(params, torch.from_numpy(x), capacity_factor)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=2e-5)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_switch_moe_grads_match_jax(capacity_factor):
    """Gradients of mean(y^2) + 0.01 aux (test_moe_pipeline.py's loss) in
    x and every weight, within 5e-5."""
    host, x = _jax_params(0), _x(4)

    def jloss(p, x):
        y, aux = jmoe.switch_moe(p, x, capacity_factor)
        return jnp.mean(y * y) + 0.01 * aux

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(host, x)
    params = _port_params(host, grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    np.testing.assert_array_equal(_port_routing(params, x), _jax_routing(host, x))
    y, aux = tmoe.switch_moe(params, tx, capacity_factor)
    (torch.mean(y * y) + 0.01 * aux).backward()
    for k in host:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(want[0][k]),
                                   rtol=5e-5, atol=5e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]), rtol=5e-5, atol=5e-5)


def test_switch_moe_routes_and_balances():
    params = tmoe.init_moe_params(0, d_model=8, d_hidden=16, num_experts=4, device="cpu")
    x = torch.from_numpy(_x(1, 32, 8))
    y, aux = tmoe.switch_moe(params, x, capacity_factor=2.0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    # aux loss is 1.0 under perfectly uniform routing; finite and > 0 always
    assert 0.0 < aux.item() < 4.0
    # with generous capacity, every token got routed: output nonzero rows
    assert (y.abs().sum(1) > 0).float().mean().item() > 0.9


def test_switch_moe_capacity_drops_tokens():
    params = tmoe.init_moe_params(0, d_model=8, d_hidden=16, num_experts=2, device="cpu")
    x = _x(2, 16, 8)
    capacity = 4  # tokens * 0.5 / experts
    y, _ = tmoe.switch_moe(params, torch.from_numpy(x), capacity_factor=0.5)
    routed = np.argmax(x @ params["gate_w"].numpy(), axis=1)
    expected = sum(min(int((routed == e).sum()), capacity) for e in (0, 1))
    assert int((y.abs().sum(1) > 1e-9).sum()) == expected
    assert expected < 16  # the setup actually exercises dropping


def test_logical_ep_mesh_equals_one_rank():
    """The trainer on a logical ep 4 mesh (experts whole on the one device)
    gives ep 1's losses bit for bit; experts that do not divide by ep
    raise, as JAX's device_put of P("ep", ...) does."""
    from mxnet_tpu_torch.examples import train_transformer_lm as trainer

    small = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, seq_len=8,
                 batch_size=2, steps=3, moe_experts=4, device="cpu", log=lambda *a: None)
    assert trainer.train(ep=4, **small) == trainer.train(ep=1, **small)
    with pytest.raises(ValueError, match="shard"):
        trainer.train(ep=3, **small)
    with pytest.raises(ValueError):
        jax.device_put(jnp.zeros((4, 16, 32)), jax.sharding.NamedSharding(
            jmake_mesh(dp=2, ep=3, devices=jax.devices()[:6]),
            jax.sharding.PartitionSpec("ep", None, None)))


def test_moe_transformer_init_and_round_trip():
    """init_fn(0) bit for bit JAX's (the per-layer RandomState seed drawn
    from the model's stream, no w1/w2 on MoE layers);
    params_from_jax / params_to_jax round-trip it."""
    want = jtfm.transformer_lm(moe_experts=4, **DIMS)[0](0)
    got = ttfm.transformer_lm(moe_experts=4, **DIMS)[0](0)
    assert sorted(got) == sorted(want) and sorted(got["l1"]) == sorted(want["l1"])
    assert "w1" not in got["l1"] and sorted(got["l1"]["moe"]) == ["gate_w", "w_down", "w_up"]
    for leaf_w, leaf_g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(leaf_g, leaf_w)
    params = ttfm.params_from_jax(got, device="cpu", dtype=torch.bfloat16)
    assert params.layers[1].moe["gate_w"].dtype == torch.float32
    assert params.layers[1].moe["w_up"].dtype == torch.bfloat16
    params = ttfm.params_from_jax(got, device="cpu", dtype=torch.float32)
    back = ttfm.params_to_jax(params)
    for leaf_w, leaf_g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(leaf_g, leaf_w)


@pytest.mark.parametrize("sp", [1, 2])
def test_moe_transformer_matches_jax(sp):
    """(logits, aux) within 1e-5 and the gradients of nll + 0.01 aux (the
    example trainer's loss) within 1e-4 of each one's max, f32, without a
    mesh and with an sp 2 mesh (JAX's make_mesh(sp=2))."""
    tokens = np.random.RandomState(6).randint(0, DIMS["vocab"], (2, 13))
    j_init, j_apply = jtfm.transformer_lm(dtype=jnp.float32, moe_experts=4, **DIMS)
    tree = j_init(0)
    jmesh = jmake_mesh(sp=sp) if sp > 1 else None

    def jloss(p):
        logits, aux = j_apply(p, jnp.asarray(tokens[:, :-1]), mesh=jmesh)
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(tokens[:, 1:])[..., None], -1))
        return nll + 0.01 * aux, (logits, aux)

    (jl, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    _, t_apply = ttfm.transformer_lm(dtype=torch.float32, moe_experts=4, **DIMS)
    params = ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32).requires_grad_()
    mesh = make_mesh(sp=sp, devices=["cpu"] * sp) if sp > 1 else None
    logits, aux = t_apply(params, torch.from_numpy(tokens[:, :-1]), mesh=mesh)
    lp = torch.log_softmax(logits, -1)
    nll = -lp.gather(-1, torch.from_numpy(tokens[:, 1:])[..., None]).mean()
    loss = nll + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = ttfm.grads_to_jax(params)
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_transformer_trains():
    """The LM with MoE FFN layers: loss (incl. load-balance aux) falls
    under SGD, and expert weights receive gradients."""
    init_fn, apply_fn = ttfm.transformer_lm(
        vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
        dtype=torch.float32, moe_experts=4, moe_every=2)
    params = ttfm.params_from_jax(init_fn(0), device="cpu", dtype=torch.float32)
    params.requires_grad_()
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (4, 16)))

    def loss_of():
        logits, aux = apply_fn(params, tokens)
        lp = torch.log_softmax(logits[:, :-1], -1)
        nll = -lp.gather(-1, tokens[:, 1:, None]).mean()
        return nll + 0.01 * aux

    l0 = None
    for _ in range(10):
        loss = loss_of()
        l0 = loss.item() if l0 is None else l0
        loss.backward()
        grads = {k: v.grad.clone() for k, v in params.layers[1].moe.items()}
        with torch.no_grad():
            for p in params.parameters():
                p -= 0.5 * p.grad
                p.grad = None
    with torch.no_grad():
        l1 = loss_of().item()
    assert l1 < l0, (l0, l1)
    assert grads["w_up"].abs().sum().item() > 0
    assert grads["gate_w"].abs().sum().item() > 0


# -- the SwitchMoE contrib operator --------------------------------------------
def _op_pair():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    return jreg.get("_contrib_SwitchMoE"), treg.get("_contrib_SwitchMoE")


def test_switch_moe_op_infer_shape_matches_jax():
    """The same shapes, and the same ValueErrors (wrong rank, no width),
    with JAX's registry metadata."""
    from mxnet_tpu.base import MXNetError as JMXNetError
    from mxnet_tpu_torch.base import MXNetError

    jop, top = _op_pair()
    assert top.aliases == jop.aliases == ["SwitchMoE"]
    assert top.defaults == jop.defaults
    assert top.list_arguments() == jop.list_arguments()
    assert top.list_outputs() == jop.list_outputs()
    attrs = {"num_experts": "4", "num_hidden": "32", "capacity_factor": "2.0"}
    shapes = [(32, 16), None, None, None]
    assert top.infer_shape(top.canon_attrs(attrs), shapes) == \
        jop.infer_shape(jop.canon_attrs(attrs), shapes)
    for bad_attrs, bad_shapes in ((attrs, [(2, 16, 16), None, None, None]),
                                  ({"num_experts": "4"}, shapes)):
        errs = []
        for op in (jop, top):
            with pytest.raises(ValueError) as exc:
                op.infer_shape(op.canon_attrs(bad_attrs), bad_shapes)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]
    with pytest.raises(JMXNetError):
        jop.infer_shape(jop.canon_attrs(attrs), [None] * 4)
    with pytest.raises(MXNetError):
        top.infer_shape(top.canon_attrs(attrs), [None] * 4)


def test_switch_moe_op_forward_matches_jax():
    jop, top = _op_pair()
    host, x = _jax_params(0), _x(5)
    attrs = {"num_experts": "8", "num_hidden": "32", "capacity_factor": "1.25"}
    ins = [x, host["gate_w"], host["w_up"], host["w_down"]]
    want = jop.fcompute(jop.canon_attrs(attrs), [jnp.asarray(a) for a in ins], True)
    got = top.fcompute(top.canon_attrs(attrs), [torch.from_numpy(np.array(a)) for a in ins], True)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want] == [(64, 16), (1,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_switch_moe_symbol_op_module_fit():
    """MoE through the reference-style API: a Module whose hidden layer is
    the SwitchMoE symbol op, trained with Module.fit on the host."""
    import mxnet_tpu_torch as mx

    E, D, H = 4, 16, 32
    with mx.cpu():
        data = mx.sym.Variable("data")
        moe = mx.contrib.symbol.SwitchMoE(
            data, mx.sym.Variable("gate_weight"),
            mx.sym.Variable("up_weight"), mx.sym.Variable("down_weight"),
            num_experts=E, num_hidden=H, capacity_factor=2.0, name="moe")
        fc = mx.sym.FullyConnected(moe[0], num_hidden=2, name="fc")
        net = mx.sym.SoftmaxOutput(fc, name="softmax")
        args, outs, _ = net.infer_shape(data=(32, D), softmax_label=(32,))
        assert outs == [(32, 2)]
        d = dict(zip(net.list_arguments(), args))
        assert d["up_weight"] == (E, D, H) and d["down_weight"] == (E, H, D)
        r = np.random.RandomState(0)
        X = r.randn(128, D).astype(np.float32)
        yl = (X[:, 0] > 0).astype(np.float32)
        it = mx.io.NDArrayIter(X, yl, batch_size=32)
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=20, optimizer="sgd", initializer=mx.init.Uniform(0.3),
                optimizer_params={"learning_rate": 0.5})
        assert dict(mod.score(it, mx.metric.Accuracy()))["accuracy"] > 0.9
    assert hasattr(mx.sym, "SwitchMoE") and hasattr(mx.nd, "_contrib_SwitchMoE")
    assert not hasattr(mx.contrib.symbol, "MultiBoxPrior")  # not registered yet
