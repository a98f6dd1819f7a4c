"""``MXNET_FIT_MULTISTEP=K`` in the PyTorch port (``Module.update_multi``,
``ShardedTrainStep.call_multi``) on the CPU, where the K micro-steps of a
group run uncaptured on the group's static buffers, reading the same
per-step lr table a captured group reads on the card.

Each case of ``tests/test_fit_multistep.py`` runs in both packages on a
dp-4 fused Module (the JAX side on four of the virtual host devices, its
kvstore synchronous), from the same numpy-made weights: the port's
K-grouped fit equals its eager fit bit for bit and agrees with the JAX
package's K-grouped fit within that file's tolerance (rtol 2e-4, atol
2e-5). Also: the same bitwise equality on the bf16 AMP path (K1's plain
version) for SGD-momentum and Adam in both flat modes with an inf-poisoned
batch inside a group, and on the per-parameter path; an optimizer the
port does not group, and ``=auto``, raise; the grouped body makes no host
read (``Tensor.item``, ``__bool__``, ``__float__``, ``__int__``,
``tolist``, ``numpy`` patched to raise): the CPU's stand-in for "nothing in
the step waits for the device", which a CUDA graph capture needs; each
micro-step reads its own row of the lr table; and the fused update
operators give the same bits with ``lr`` a number or a 0-d f32 tensor."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

_ENV = ("MXTPU_AMP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES", "MXNET_FIT_MULTISTEP",
        "MXTPU_FUSED_UPDATE_KERNEL", "MXTPU_LOSS_SCALE", "MXTPU_LOSS_SCALE_WINDOW")


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")  # the JAX side's pushes synchronous
    with tmx.cpu():
        yield


def _mlp(pkg, dropout=False, hidden=16):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    if dropout:
        net = pkg.sym.Dropout(net, p=0.3)
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _blobs(n=128, seed=0, poison=None):
    """tests/test_fit_multistep.py's four blobs in 8 dimensions; ``poison``
    puts an inf into that sample."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, 8) * 3
    x = np.concatenate([c + rng.randn(n // 4, 8) * 0.3 for c in centers]).astype("f")
    y = np.repeat(np.arange(4), n // 4).astype("f")
    perm = rng.permutation(n)
    x, y = x[perm], y[perm]
    if poison is not None:
        x[poison, 0] = np.inf
    return x, y


def _weights(hidden=16):
    """Numpy-made weights both packages start from."""
    rng = np.random.RandomState(3)
    shapes = {"fc1_weight": (hidden, 8), "fc1_bias": (hidden,), "fc2_weight": (4, hidden),
              "fc2_bias": (4,)}
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32) for n, s in shapes.items()}


def _fit(pkg, k, monkeypatch, num_epoch=2, callbacks=None, sched=None, optimizer="sgd",
         dropout=False, poison=None):
    if k > 1:
        monkeypatch.setenv("MXNET_FIT_MULTISTEP", str(k))
    else:
        monkeypatch.delenv("MXNET_FIT_MULTISTEP", raising=False)
    hidden = 32 if dropout else 16
    it = pkg.io.NDArrayIter(*_blobs(poison=poison), batch_size=32)
    mod = pkg.mod.Module(_mlp(pkg, dropout, hidden), context=[pkg.cpu(i) for i in range(4)])
    pkg.random.seed(0)
    np.random.seed(0)
    if optimizer == "sgd":
        opt_params = {"learning_rate": 0.2 if dropout else 0.1, "momentum": 0.9}
    else:
        opt_params = {"learning_rate": 0.01}
    if sched is not None:
        opt_params["lr_scheduler"] = sched
    arg_params = None if dropout else {n: pkg.nd.array(v) for n, v in _weights(hidden).items()}
    mod.fit(it, optimizer=optimizer, optimizer_params=opt_params, kvstore="device",
            num_epoch=num_epoch, initializer=pkg.init.Uniform(0.1), arg_params=arg_params,
            batch_end_callback=callbacks)
    assert mod._fused_trainer is not None
    return mod, {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def _groups(mod):
    """Groups the port's trainer ran, over every batch signature."""
    return sum(g["groups"] for g in mod._fused_trainer.group_stats())


def _fused_state(mod):
    """Every state tensor of a port module's fused path, as numpy bits."""
    owner = mod._fused_owner
    out = {}
    for kind, tree in (("param", owner._fused_params), ("aux", owner._fused_aux),
                       ("opt", owner._fused_opt)):
        for name, v in tree.items():
            for j, t in enumerate(v if isinstance(v, tuple) else (v,)):
                if t is not None:
                    t = t.detach()
                    out["%s:%s.%d" % (kind, name, j)] = (
                        t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _assert_close(got, want):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=2e-4, atol=2e-5, err_msg=n)


@pytest.mark.parametrize("k", [2, 4])
def test_multistep_matches_single(monkeypatch, k):
    """K-grouped fit == plain fit bit for bit in the port (4 batches an
    epoch: k = 4 is one group an epoch, k = 2 two), and the JAX package's
    K-grouped fit within its own tolerance."""
    base_mod, base = _fit(tmx, 1, monkeypatch)
    mod, multi = _fit(tmx, k, monkeypatch)
    assert _groups(mod) == 8 // k and _groups(base_mod) == 0
    _assert_bitwise(_fused_state(mod), _fused_state(base_mod))
    _assert_bitwise(multi, base)
    _, jax_multi = _fit(jmx, k, monkeypatch)
    _assert_close(multi, jax_multi)
    assert mod._optimizer.num_update == base_mod._optimizer.num_update == 8
    assert mod._fused_owner._fused_t == 8


def test_multistep_partial_group(monkeypatch):
    """4 batches an epoch with K = 3: a group and a single-step tail."""
    base_mod, base = _fit(tmx, 1, monkeypatch)
    mod, multi = _fit(tmx, 3, monkeypatch)
    assert _groups(mod) == 2
    _assert_bitwise(_fused_state(mod), _fused_state(base_mod))
    _, jax_multi = _fit(jmx, 3, monkeypatch)
    _assert_close(multi, jax_multi)


def test_multistep_callbacks_per_batch(monkeypatch):
    """batch_end_callback fires once a batch with its true nbatch and the
    single-step path's locals; the metric it sees is the eager fit's,
    batch by batch (the JAX package's callbacks see the same sequence)."""
    seen = {}
    for name, pkg, k in (("eager", tmx, 1), ("port", tmx, 2), ("jax", jmx, 2)):
        calls = seen[name] = []

        def cb(param, calls=calls):
            assert param.locals["data_batch"] is not None and param.locals["self"] is not None
            calls.append((param.epoch, param.nbatch,
                          dict(param.eval_metric.get_name_value())["accuracy"]))

        _fit(pkg, k, monkeypatch, callbacks=cb)
    order = [(e, n) for e in range(2) for n in range(4)]
    for calls in seen.values():
        assert [(e, n) for e, n, _ in calls] == order
        assert all(0.0 <= m <= 1.0 for _, _, m in calls)
    assert seen["port"] == seen["eager"]


def test_multistep_lr_schedule_advances_per_step(monkeypatch):
    """The schedule advances per micro-step: FactorScheduler(step=2) at
    K = 4 gives the plain fit's lrs [0.1, 0.1, 0.01, 0.01]."""
    runs = {}
    for name, pkg, k in (("eager", tmx, 1), ("port", tmx, 4), ("jax", jmx, 4)):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.1)
        runs[name] = _fit(pkg, k, monkeypatch, num_epoch=1, sched=sched)
    _assert_bitwise(_fused_state(runs["port"][0]), _fused_state(runs["eager"][0]))
    _assert_close(runs["port"][1], runs["jax"][1])
    opt = runs["port"][0]._optimizer
    assert opt.num_update == 4
    assert opt.lr_scheduler(opt.num_update) == pytest.approx(0.01)


def test_multistep_rng_net_trains(monkeypatch):
    """A Dropout net under K = 2: each micro-step draws its own masks from
    the port's generator, in the eager fit's order (so, on the CPU, the
    eager fit's bits), and training converges on the blob problem."""
    base_mod, base = _fit(tmx, 1, monkeypatch, num_epoch=8, dropout=True)
    mod, multi = _fit(tmx, 2, monkeypatch, num_epoch=8, dropout=True)
    assert mod._fused_trainer._needs_rng and _groups(mod) == 16
    _assert_bitwise(multi, base)
    val = tmx.io.NDArrayIter(*_blobs(), batch_size=32)
    assert dict(mod.score(val, tmx.metric.Accuracy()))["accuracy"] >= 0.9


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("shard", ["1", "0"])
@pytest.mark.parametrize("k", [2, 4])
def test_amp_multistep_is_bitwise(monkeypatch, optimizer, shard, k):
    """bf16 AMP (K1's plain version, both flat modes): the K-grouped fit
    keeps every bit of the eager fit (working params, masters, states, the
    loss scale and good count), an inf in batch 1 skipping its step inside
    a group."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_SHARD_UPDATE", shard)
    mods = {kk: _fit(tmx, kk, monkeypatch, optimizer=optimizer, poison=40)[0] for kk in (1, k)}
    tr = mods[k]._fused_trainer
    assert tr.amp and tr.flat_mode == ("shard" if shard == "1" else "replicated")
    assert _groups(mods[k]) == 8 // k
    state = _fused_state(mods[k])
    _assert_bitwise(state, _fused_state(mods[1]))
    scale = state["opt:%s.0" % tr.AMP_SCALE_KEY]
    assert scale == tr.amp_scale_init / 4  # batch 1 of each epoch skipped


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_per_param_multistep_is_bitwise(monkeypatch, optimizer):
    """A zero bucket cap (the per-parameter update): grouped == eager bit
    for bit, and JAX's grouped fit within tolerance."""
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "0")
    base_mod, _ = _fit(tmx, 1, monkeypatch, optimizer=optimizer)
    mod, multi = _fit(tmx, 2, monkeypatch, optimizer=optimizer)
    assert mod._fused_trainer.flat_mode is None and _groups(mod) == 4
    _assert_bitwise(_fused_state(mod), _fused_state(base_mod))
    _, jax_multi = _fit(jmx, 2, monkeypatch, optimizer=optimizer)
    _assert_close(multi, jax_multi)


def test_ungrouped_optimizer_and_auto_raise(monkeypatch):
    """An optimizer whose update the port does not group raises, naming
    itself and the ROADMAP entry; ``auto`` raises naming its queue."""
    with pytest.raises(NotImplementedError, match="RMSProp.*Queue 1 step 2"):
        _fit(tmx, 2, monkeypatch, optimizer="rmsprop")
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", "auto")
    mod = tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(i) for i in range(4)])
    with pytest.raises(NotImplementedError, match="Queue 1 step 10"):
        mod.fit(tmx.io.NDArrayIter(*_blobs(), batch_size=32), kvstore="device", num_epoch=1)


def test_update_multi_hands_back_copies(monkeypatch):
    """update_multi returns K lists of outputs that the next group does not
    overwrite, advances the update count K times and leaves the last
    step's outputs in get_outputs."""
    mod, _ = _fit(tmx, 2, monkeypatch, num_epoch=1)
    x, y = _blobs()
    batches = [tmx.io.DataBatch([tmx.nd.array(x[i:i + 32])], [tmx.nd.array(y[i:i + 32])])
               for i in (0, 32)]
    t = mod._fused_owner._fused_t
    steps = mod.update_multi(batches)
    assert len(steps) == 2 and mod._fused_owner._fused_t == t + 2
    kept = [o.clone() for o in steps[0]]
    assert torch.equal(mod.get_outputs()[0]._data, steps[1][0])
    mod.update_multi(batches)
    assert all(torch.equal(a, b) for a, b in zip(kept, steps[0]))


def _raise_host_read(*args, **kwargs):
    raise AssertionError("a host read inside the grouped step")


@pytest.mark.parametrize("case", ["f32_flat", "per_param_adam", "amp_sgd_mom", "amp_adam",
                                  "dropout"])
def test_grouped_step_makes_no_host_read(monkeypatch, case):
    """The grouped step body, run with Tensor.item, __bool__, __float__,
    __int__, tolist and numpy patched to raise, finishes: nothing in it
    reads a tensor on the host, which a CUDA graph capture cannot."""
    optimizer = "adam" if "adam" in case else "sgd"
    if case == "per_param_adam":
        monkeypatch.setenv("MXTPU_BUCKET_BYTES", "0")
    if case.startswith("amp"):
        monkeypatch.setenv("MXTPU_AMP", "bf16")
    mod, _ = _fit(tmx, 2, monkeypatch, num_epoch=1, optimizer=optimizer,
                  dropout=case == "dropout")
    owner = mod._fused_owner
    x, y = _blobs()
    batches = {"data": [torch.from_numpy(x[i:i + 32]) for i in (0, 32)],
               "softmax_label": [torch.from_numpy(y[i:i + 32]) for i in (0, 32)]}
    for name in ("item", "__bool__", "__float__", "__int__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, _raise_host_read)
    out = mod._fused_trainer.call_multi(owner._fused_params, owner._fused_aux, owner._fused_opt,
                                        batches, [0.1, 0.1], [5, 6])
    monkeypatch.undo()
    assert [tuple(o.shape) for o in out[3]] == [(2, 32, 4)]


@pytest.mark.parametrize("clip", [None, 0.05])
def test_update_ops_take_a_device_lr(clip):
    """sgd_update, sgd_mom_update and adam_update give the same bits with
    lr a number and a 0-d f32 tensor holding f32(lr), f32 weights, with
    clipping on and off."""
    rng = np.random.RandomState(4)
    w, g, m, v = (tmx.nd.array(rng.randn(257).astype(np.float32)) for _ in range(4))
    v = tmx.nd.abs(v)
    kw = dict(wd=1e-4, rescale_grad=1.0 / 32, clip_gradient=-1.0 if clip is None else clip)
    for lr in (0.1, 0.037, 1e-3 * 0.9 ** 7):
        lrs = (lr, torch.tensor(np.float32(lr)))
        outs = []
        for x in lrs:
            m1, v1 = m.copy(), v.copy()
            outs.append([tmx.nd.sgd_update(w, g, lr=x, **kw),
                         tmx.nd.sgd_mom_update(w, g, m1, lr=x, momentum=0.9, **kw), m1,
                         tmx.nd.adam_update(w, g, m1.copy(), v1, lr=x, **kw), v1])
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def _clone_state(state):
    return [{n: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                 else None if v is None else v.clone()) for n, v in d.items()} for d in state]


@pytest.mark.parametrize("optimizer", [None, "sgd", "adam"])
def test_grouped_micro_steps_read_their_lr_rows(monkeypatch, optimizer):
    """call_multi with a different lr for each micro-step gives the bits of
    single steps at those lrs (per-parameter path; with no optimizer the
    plain ``w -= lr * g``), and leaves the optimizer unpatched."""
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "0")
    net = _mlp(tmx)
    opt = None if optimizer is None else tmx.optimizer.create(
        optimizer, learning_rate=0.1, rescale_grad=1.0 / 32,
        **({"momentum": 0.9} if optimizer == "sgd" else {}))
    tr = tmx.parallel.ShardedTrainStep(
        net, tmx.parallel.make_mesh(dp=4, devices=[tmx.cpu()] * 4), optimizer=opt).compile()
    arg_shapes, _, _ = net.infer_shape(data=(32, 8), softmax_label=(32,))
    np.random.seed(0)
    state = tr.init(dict(zip(net.list_arguments(), arg_shapes)), tmx.init.Uniform(0.1))
    x, y = _blobs()
    batches = {"data": [torch.from_numpy(x[i:i + 32]) for i in (0, 32, 64)],
               "softmax_label": [torch.from_numpy(y[i:i + 32]) for i in (0, 32, 64)]}
    lrs, ts = [0.1, 0.03, 0.0071], [4, 5, 6]
    want = _clone_state(state)
    for i, (lr, t) in enumerate(zip(lrs, ts)):
        *want, _ = tr(*want, {n: v[i] for n, v in batches.items()}, lr=lr, t=t)
    got = tr.call_multi(*_clone_state(state), batches, lrs, ts)[:3]
    for g, w in zip(got, want):
        for n in w:
            for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (g[n], w[n]))):
                assert (a is None and b is None) or torch.equal(a, b), n
    if opt is not None:
        assert "_op_lr" not in vars(opt) and "_update_count" not in vars(opt)
