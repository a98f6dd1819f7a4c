"""Tensor parallelism and the model axes of the port in one process, held
against the JAX package on the CPU (f32):

- the mesh's rank order is JAX's ``make_mesh`` reshape of the process-major
  device list, on logical ranks split over two (pretend) processes, and the
  axis layout of every dp x tp split;
- ``partition_spec`` is the JAX trainer's ``spec_for``; ``shard_params`` /
  ``gather_params`` cut and rebuild the tree;
- the transformer LM over a tp 2 mesh (logical ranks: each runs its heads
  and FFN columns, the partials summed on the device) against JAX's
  ``apply_fn`` with ``spec_for``-sharded params on a dp 2 x tp 2 x ep 2
  mesh of the virtual host devices: logits and every gradient within 1e-5
  of max, dense and with Switch-MoE experts over ep 2;
- ``ShardedTrainStep(param_specs=...)`` and ``Module(mesh=,
  param_specs=).fit`` on a dp 4 x tp 2 mesh: parameters after 3 steps
  within 1e-6 of JAX's (the per-parameter update, as in JAX: the flat path
  and AMP are off);
- a mesh over several devices of one process still raises.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu.parallel.moe import moe_partition_specs as jmoe_specs
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.parallel import mesh as tmesh

DIMS = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64)
STEPS = 3
B = 16


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in ("MXTPU_AMP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES", "MXNET_FIT_MULTISTEP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    with tmx.cpu():
        yield


def _of_max(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= tol * scale, "%s: max err %.3g > %g of max %.3g" % (what, err, tol, scale)


@pytest.mark.parametrize("dp,tp,procs", [(1, 2, 2), (2, 2, 2), (2, 4, 2), (4, 2, 4), (2, 2, 4)])
def test_rank_order_is_jax_make_mesh(dp, tp, procs):
    """JAX reshapes the process-major device list to (dp, tp, pp, sp, ep):
    the port's ranks of each (pretend) process sit at the same coordinates,
    and each axis group holds the processes of one line along the axis."""
    n = dp * tp
    jm = jmake_mesh(dp=dp, tp=tp, devices=jax.devices()[:n])
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    ids = [d.id for d in jax.devices()[:n]]
    per = n // procs
    for p in range(procs):
        m = tmesh.Mesh(["cpu"] * per, {"dp": dp, "tp": tp, "pp": 1, "sp": 1, "ep": 1},
                       processes=procs, process_rank=p)
        for i in range(per):
            assert tuple(m.coords(i).values()) == where[ids[p * per + i]]
        for axis in ("dp", "tp"):
            layout = tmesh._axis_layout(m, axis)
            pos = layout[p][1]
            assert list(pos) == m.positions(axis)
            peers = [q for q in range(procs) if layout[q][0] == layout[p][0]]
            held = sorted(x for q in peers for x in layout[q][1])
            assert held == list(range(m.shape[axis])), (axis, p, peers)


def test_dp_rows_and_one_process_groups():
    m = tmesh.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    g = tmesh.axis_group(m, "tp")
    assert (g.positions, g.ranks, g.size, g.group) == ([0, 1], [0], 1, None)
    assert tmesh.dp_rows(m, 8) == slice(0, 8)
    x = torch.ones(3)
    assert tmesh.allreduce_sum(x, axis=g) is x and tmesh.all_gather(x, axis="tp", mesh=m) is x
    assert tmesh.axis_group(m, "tp") is g  # kept with the mesh


def test_partition_spec_is_the_jax_trainers():
    """examples/train_transformer_lm.py:86-101's spec_for, leaf by leaf."""
    moe = jmoe_specs()

    def spec_for(path_key):
        if "moe" in path_key:
            return tuple(moe[path_key.split("/")[-1]])
        leaf = path_key.split("/")[-1]
        if leaf in ("wq", "wk", "wv", "w1"):
            return (None, "tp")
        if leaf in ("wo", "w2"):
            return ("tp", None)
        return ()

    tree = jtfm.transformer_lm(dtype=jnp.float32, moe_experts=4, **DIMS)[0](0)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) > 10
    for path, _ in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        assert ttfm.partition_spec(key) == spec_for(key), key


def test_shard_and_gather_params_round_trip():
    init_fn, _ = ttfm.transformer_lm(dtype=torch.float32, moe_experts=4, **DIMS)
    params = ttfm.params_from_jax(init_fn(0), device="cpu", dtype=torch.float32)
    m = tmesh.make_mesh(tp=2, ep=2, devices=["cpu"] * 4)
    sharded = ttfm.shard_params(params, m)
    back = ttfm.params_to_jax(ttfm.gather_params(sharded, m))
    want = ttfm.params_to_jax(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    # one process holds every position: nothing is cut
    assert sharded.layers[0].wq.shape == params.layers[0].wq.shape
    rep = ttfm.replicated_names(params)
    assert "embed" in rep and "layers.0.ln1" in rep and "layers.1.moe.gate_w" in rep
    assert not any(n.endswith(("wq", "wo", "w1", "w2", "w_up", "w_down")) for n in rep)


def _jax_sharded(tree, mesh):
    """JAX's trainer placement: every leaf device_put with spec_for."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, v in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        leaves.append(jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(
            *ttfm.partition_spec(key)))))
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("moe", [0, 4])
def test_tp_transformer_matches_jax_sharded(moe):
    """Logits and the gradients of the trainer's loss over a tp 2 mesh (and
    ep 2 with experts), logical ranks, against JAX's GSPMD run of the same
    params sharded by spec_for on a dp 2 x tp 2 x ep 2 mesh: 1e-5 of max."""
    tokens = np.random.RandomState(5).randint(0, DIMS["vocab"], (2, 17))
    j_init, j_apply = jtfm.transformer_lm(dtype=jnp.float32, moe_experts=moe, **DIMS)
    tree = j_init(0)
    jmesh = jmake_mesh(dp=2, tp=2, ep=2)

    def jloss(p):
        out = j_apply(p, jnp.asarray(tokens[:, :-1]))
        logits, aux = out if moe else (out, 0.0)
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(tokens[:, 1:])[..., None], -1))
        return nll + 0.01 * aux, logits

    with jmesh:
        (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            _jax_sharded(tree, jmesh))
    _, t_apply = ttfm.transformer_lm(dtype=torch.float32, moe_experts=moe, **DIMS)
    mesh = tmesh.make_mesh(tp=2, ep=2, devices=["cpu"] * 4)
    params = ttfm.shard_params(ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32),
                               mesh).requires_grad_()
    out = t_apply(params, torch.from_numpy(tokens[:, :-1]), mesh=mesh)
    logits, aux = out if moe else (out, 0.0)
    lp = torch.log_softmax(logits, -1)
    loss = -lp.gather(-1, torch.from_numpy(tokens[:, 1:])[..., None]).mean() + 0.01 * aux
    loss.backward()
    _of_max(logits.detach().numpy(), np.asarray(jlogits), 1e-5, "logits")
    got = ttfm.grads_to_jax(params)  # one process holds every shard whole
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        _of_max(g, w, 1e-5, jax.tree_util.keystr(path))


def test_tp_ranks_each_run_their_heads(monkeypatch):
    """On logical tp ranks each rank calls attention on its H / tp heads."""
    seen = []
    real = ttfm._kernels.attention

    def spy(q, k, v, **kw):
        seen.append(q.shape[2])
        return real(q, k, v, **kw)

    monkeypatch.setattr(ttfm._kernels, "attention", spy)
    init_fn, apply_fn = ttfm.transformer_lm(dtype=torch.float32, **DIMS)
    params = ttfm.params_from_jax(init_fn(0), device="cpu", dtype=torch.float32)
    apply_fn(params, torch.zeros((1, 8), dtype=torch.long),
             mesh=tmesh.make_mesh(tp=2, devices=["cpu"] * 2))
    assert seen == [DIMS["n_heads"] // 2] * (2 * DIMS["n_layers"])


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


#: Megatron's MLP: fc1 column-parallel (its rows and bias), fc2 row-parallel
SPECS = {"fc1_weight": ("tp", None), "fc1_bias": ("tp",), "fc2_weight": (None, "tp")}


def _blob():
    rng = np.random.RandomState(11)
    arg = {"fc1_weight": rng.uniform(-0.3, 0.3, (32, 8)), "fc1_bias": rng.uniform(-0.1, 0.1, 32),
           "fc2_weight": rng.uniform(-0.3, 0.3, (4, 32)), "fc2_bias": np.zeros(4)}
    arg = {k: v.astype(np.float32) for k, v in arg.items()}
    X = rng.randn(STEPS, B, 8).astype(np.float32)
    y = rng.randint(0, 4, (STEPS, B)).astype(np.float32)
    return arg, X, y


def _jax_step_run(arg, X, y, jmesh):
    opt = jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / B)
    step = jmx.parallel.ShardedTrainStep(_mlp(jmx), jmesh, optimizer=opt,
                                         param_specs={k: P(*v) for k, v in SPECS.items()})
    step.compile()
    params, aux = step.place_params(arg, {})
    state = step.make_state(params)
    for t in range(STEPS):
        batch = {"data": jax.device_put(X[t], step.batch_sharding()),
                 "softmax_label": jax.device_put(y[t], step.batch_sharding())}
        params, aux, state, _ = step(params, aux, state, batch, t=t + 1)
    return step, {k: np.asarray(v) for k, v in params.items()}, state


def test_sharded_train_step_param_specs_matches_jax(caplog, monkeypatch):
    """dp 4 x tp 2 with Megatron specs: three SGD-momentum steps within 1e-6
    of JAX's, the momentum too; the flat path and AMP off (JAX's warning)."""
    arg, X, y = _blob()
    jstep, want, jstate = _jax_step_run(arg, X, y, jmake_mesh(dp=4, tp=2))
    assert jstep.flat_mode is None
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    mesh = tmx.parallel.make_mesh(dp=4, tp=2, devices=[tmx.cpu()] * 8)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / B)
    with caplog.at_level(logging.WARNING):
        step = tmx.parallel.ShardedTrainStep(_mlp(tmx), mesh, optimizer=opt, param_specs=SPECS)
    assert "MXTPU_AMP=bf16 ignored" in caplog.text
    assert step.flat_mode is None and not step.amp and not step.state_sharded
    params, aux = step.place_params(arg, {})
    state = step.make_state(params)
    for t in range(STEPS):
        batch = {"data": torch.from_numpy(X[t]), "softmax_label": torch.from_numpy(y[t])}
        params, aux, state, _ = step(params, aux, state, batch, t=t + 1)
    for k in want:
        assert not np.array_equal(want[k], arg[k])
        _of_max(params[k].numpy(), want[k], 1e-6, k)
        _of_max(state[k].numpy(), np.asarray(jstate[k]), 1e-6, "momentum " + k)


def _fit(pkg, mesh):
    arg, X, y = _blob()
    np.random.seed(0)
    it = pkg.io.NDArrayIter(X.reshape(-1, 8), y.reshape(-1), batch_size=B)
    specs = {k: (P(*v) if pkg is jmx else v) for k, v in SPECS.items()}
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu(), mesh=mesh, param_specs=specs)
    mod.fit(it, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()}, num_epoch=1)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_param_specs_matches_jax(tmp_path):
    """Module(mesh=, param_specs=).fit through the fused step, three batches:
    within 1e-6 of JAX's; the checkpoint's .params load in JAX."""
    jmod, want = _fit(jmx, jmake_mesh(dp=4, tp=2))
    mod, got = _fit(tmx, tmx.parallel.make_mesh(dp=4, tp=2, devices=[tmx.cpu()] * 8))
    tr = mod._fused_trainer
    assert tr is not None and tr.param_specs == SPECS and tr.flat_mode is None
    for k in want:
        _of_max(got[k], want[k], 1e-6, k)
    mod.save_checkpoint(str(tmp_path / "tp"), 1)
    loaded = jmx.nd.load(str(tmp_path / "tp-0001.params"))
    for k in want:
        np.testing.assert_array_equal(loaded["arg:" + k].asnumpy(), got[k])


def test_multi_device_mesh_still_raises():
    with pytest.raises(NotImplementedError, match="multi-card half"):
        tmesh.make_mesh(dp=1, tp=2, devices=[torch.device("cpu"), torch.device("meta")])
