"""Memory mirroring in the PyTorch port (``MXNET_BACKWARD_DO_MIRROR`` and
``__force_mirroring__``), the cases of tests/test_mirror.py held on the
port and against the JAX package on the CPU.

The JAX tests grep a jaxpr for "remat"; here the evidence is the
dispatcher: a counting ``TorchDispatchMode`` over one training step shows
the saved operations (convolutions, matrix products) run as often with the
mirror as without, while the recomputed ones (ReLU, BatchNorm's
arithmetic, the Dropout draw) run again in backward. Gradients: mirrored
against plain at rtol 1e-5 / atol 5e-5, port against JAX mirrored the
same; a graph with Dropout bit for bit, eagerly (the generator set back
for the recompute) and as under a CUDA graph capture (the draws kept)."""
import collections
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import name as jname
from mxnet_tpu_torch import executor as texecutor
from mxnet_tpu_torch import name as tname


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    monkeypatch.delenv("MXNET_MIRROR_SAVE", raising=False)
    with tmx.cpu():
        yield


def _mirror(on):
    if on:
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    else:
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)


def _conv_bn_net(S, n_layers=3, pool=False, dropout=0.0):
    net = S.Variable("data")
    for i in range(n_layers):
        net = S.Convolution(net, kernel=(3, 3), num_filter=8, pad=(1, 1), name="conv%d" % i)
        net = S.BatchNorm(net, name="bn%d" % i)
        net = S.Activation(net, act_type="relu")
        if pool:
            net = S.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    if dropout:
        net = S.Dropout(net, p=dropout)
    net = S.Flatten(net)
    net = S.FullyConnected(net, num_hidden=5, name="fc")
    return S.SoftmaxOutput(net, name="softmax")


def _bind_and_step(pkg, net, seed=0, dshape=(4, 3, 16, 16)):
    exe = net.simple_bind(ctx=pkg.cpu(0), data=dshape, softmax_label=(dshape[0],))
    rng = np.random.RandomState(seed)
    for n, a in exe.arg_dict.items():
        if n not in ("data", "softmax_label"):
            a[:] = rng.randn(*a.shape) * 0.05
    exe.arg_dict["data"][:] = rng.rand(*dshape)
    exe.arg_dict["softmax_label"][:] = rng.randint(0, 5, (dshape[0],))
    if pkg is tmx:
        tmx.random.seed(3)
    exe.forward(is_train=True)
    exe.backward()
    return exe


def _run(pkg, mirror, **kw):
    _mirror(mirror)
    try:
        with (jname if pkg is jmx else tname).NameManager():
            net = _conv_bn_net(pkg.sym, **kw)
        exe = _bind_and_step(pkg, net)
    finally:
        _mirror(False)
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items() if g is not None}
    return grads, {n: a.asnumpy() for n, a in exe.aux_dict.items()}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("against", ["port_plain", "jax_mirrored"])
def test_mirror_gradients_match(against):
    got, got_aux = _run(tmx, True)
    want, want_aux = _run(tmx, False) if against == "port_plain" else _run(jmx, True)
    assert sorted(got) == sorted(want)
    for name in want:
        # atol: conv biases feeding BatchNorm have an exactly-zero gradient
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=5e-5, err_msg=name)
    for name in want_aux:  # the moving stats written once, from the first forward
        np.testing.assert_allclose(got_aux[name], want_aux[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_mirror_keeps_saved_ops_and_recomputes_the_rest():
    """The dispatch count that replaces JAX's jaxpr grep: with the mirror
    the step runs as many convolutions and matrix products as without, and
    more of the recomputed elementwise and BatchNorm ops."""
    counts = {}
    for on in (False, True):
        with _Count() as c:
            _run(tmx, on)
        counts[on] = c.ops
    off, on = counts[False], counts[True]
    assert off["convolution"] == on["convolution"] == 3
    assert off["mm"] == on["mm"]
    for op in ("relu", "rsqrt", "clamp_min"):  # ReLU and BatchNorm's statistics
        assert on[op] == 2 * off[op], (op, off[op], on[op])


@pytest.mark.parametrize("save", ["", "reduce_window_max", "reduce_window_max,concatenate"])
def test_mirror_save_names_the_kept_ops(monkeypatch, save):
    """``MXNET_MIRROR_SAVE`` in JAX's primitive names: the pooling outputs
    are recomputed unless ``reduce_window_max`` is named."""
    if save:
        monkeypatch.setenv("MXNET_MIRROR_SAVE", "dot_general,conv_general_dilated," + save)
    counts = {}
    for on in (False, True):
        with _Count() as c:
            got, _ = _run(tmx, on, pool=True)
        counts[on] = (c.ops, got)
    (off, plain), (on, mirrored) = counts[False], counts[True]
    pools = "max_pool2d_with_indices"
    assert on[pools] == (off[pools] if save else 2 * off[pools]), (off[pools], on[pools])
    assert off["convolution"] == on["convolution"]
    for name in plain:
        np.testing.assert_allclose(mirrored[name], plain[name], rtol=1e-5, atol=5e-5,
                                   err_msg=name)


def test_unknown_mirror_save_name_raises(monkeypatch):
    monkeypatch.setenv("MXNET_MIRROR_SAVE", "dot_general,reduce_window")
    with pytest.raises(tmx.base.MXNetError, match="'reduce_window'"):
        _run(tmx, True)


@pytest.mark.parametrize("capture_like", [False, True])
def test_dropout_gradients_bit_for_bit(monkeypatch, capture_like):
    """A mirrored Dropout graph gives the unmirrored graph's gradients bit
    for bit: eagerly the generator is set back for the recompute (the draw
    runs twice), as under a capture the draw is kept (it runs once)."""
    if capture_like:
        monkeypatch.setattr(texecutor, "_capturing", lambda: True)
    plain, plain_aux = _run(tmx, False, dropout=0.5)
    with _Count() as c:
        got, got_aux = _run(tmx, True, dropout=0.5)
    assert c.ops["rand"] == (1 if capture_like else 2)
    for name in plain:
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)
    for name in plain_aux:
        np.testing.assert_array_equal(got_aux[name], plain_aux[name], err_msg=name)


def test_dropout_recompute_needs_the_generator_set_back(monkeypatch):
    """Without the snapshot the recomputed mask differs (the checkpoint's
    preserve_rng_state does not reach an explicit generator), and the
    gradients with it: the snapshot is what makes the case above hold."""
    plain, _ = _run(tmx, False, dropout=0.5)
    real = texecutor._mirrored

    def without_snapshot(fn, generators, save_ops):
        return real(fn, [], save_ops)

    monkeypatch.setattr(texecutor, "_mirrored", without_snapshot)
    got, _ = _run(tmx, True, dropout=0.5)
    assert any(not np.array_equal(got[n], plain[n]) for n in plain)


def _force_mirror_net(pkg, dropout=False):
    data = pkg.sym.Variable("data")
    with pkg.AttrScope(__force_mirroring__="True"):
        h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = pkg.sym.Activation(h, act_type="relu")
        if dropout:
            h = pkg.sym.Dropout(h, p=0.5)
    h = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _fc_step(pkg, net, whole=False):
    _mirror(whole)
    try:
        exe = net.simple_bind(ctx=pkg.cpu(0), data=(4, 6), softmax_label=(4,))
    finally:
        _mirror(False)
    rng = np.random.RandomState(1)
    for n, a in exe.arg_dict.items():
        if n != "softmax_label":
            a[:] = rng.randn(*a.shape) * 0.5
    exe.arg_dict["softmax_label"][:] = rng.randint(0, 3, (4,))
    if pkg is tmx:
        tmx.random.seed(3)
    exe.forward(is_train=True)
    exe.backward()
    return {n: g.asnumpy() for n, g in exe.grad_dict.items() if g is not None}


@pytest.mark.parametrize("whole", [False, True])
def test_force_mirroring_attr(whole):
    """``__force_mirroring__`` mirrors its nodes without the env flag (the
    reference's need_mirror reads the attr first): the ReLU runs again in
    backward; the gradients equal the plain graph's and JAX's. Inside a
    whole-graph mirror a forced product is recomputed too."""
    with tname.NameManager():
        forced = _force_mirror_net(tmx)
    with tname.NameManager():
        plain = tmx.sym.FullyConnected(
            tmx.sym.Activation(tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=8,
                                                      name="fc1"), act_type="relu"),
            num_hidden=3, name="fc2")
        plain = tmx.sym.SoftmaxOutput(plain, name="softmax")
    with _Count() as c_forced:
        got = _fc_step(tmx, forced, whole)
    with _Count() as c_plain:
        want = _fc_step(tmx, plain)
    assert c_forced.ops["relu"] == 2 * c_plain.ops["relu"]
    # a node's own region recomputes that node from its inputs; in a
    # whole-graph region fc1's product is recomputed for the ReLU's input
    assert c_forced.ops["mm"] == c_plain.ops["mm"] + (1 if whole else 0)
    with jname.NameManager():
        jwant = _fc_step(jmx, _force_mirror_net(jmx), whole)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(got[name], jwant[name], rtol=1e-5, atol=5e-5, err_msg=name)


def test_force_mirrored_dropout_bit_for_bit():
    with tname.NameManager():
        net = _force_mirror_net(tmx, dropout=True)
    with tname.NameManager():
        data = tmx.sym.Variable("data")
        h = tmx.sym.Activation(tmx.sym.FullyConnected(data, num_hidden=8, name="fc1"),
                               act_type="relu")
        h = tmx.sym.Dropout(h, p=0.5)
        h = tmx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        plain = tmx.sym.SoftmaxOutput(h, name="softmax")
    got, want = _fc_step(tmx, net), _fc_step(tmx, plain)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# the fused step (ShardedTrainStep) under the flag
# ---------------------------------------------------------------------------
def _fused_params(pkg, mirror, mode, dropout=0.0, steps=3, multi=False):
    """Three SGD steps of the conv-BN net through ``ShardedTrainStep``:
    ``mode`` "per_param" (dp 1), "flat" (dp 2, f32 slabs) or "amp" (dp 2,
    bf16 AMP, K1's plain version)."""
    _mirror(mirror)
    amp = os.environ.pop("MXTPU_AMP", None)
    if mode == "amp":
        os.environ["MXTPU_AMP"] = "bf16"
    try:
        with (jname if pkg is jmx else tname).NameManager():
            net = _conv_bn_net(pkg.sym, n_layers=1, dropout=dropout)
        dp = 1 if mode == "per_param" else 2
        if pkg is jmx:
            mesh = jmx.parallel.make_mesh(dp=dp, tp=1)
        else:
            mesh = tmx.parallel.make_mesh(dp=dp, devices=[tmx.cpu()] * dp)
        opt = pkg.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0 / 8)
        step = pkg.parallel.ShardedTrainStep(net, mesh, optimizer=opt).compile()
        if pkg is tmx:
            assert step.mirror == mirror
        shapes = {"data": (8, 3, 16, 16), "softmax_label": (8,)}
        arg_shapes, _, _ = net.infer_shape(**shapes)
        np.random.seed(0)
        params, aux, st = step.init(dict(zip(net.list_arguments(), arg_shapes)),
                                    pkg.initializer.Uniform(0.05))
        rng = np.random.RandomState(1)
        data = rng.rand(8, 3, 16, 16).astype(np.float32)
        label = rng.randint(0, 5, (8,)).astype(np.float32)
        if pkg is jmx:
            import jax

            batch = {"data": jax.device_put(data, step.batch_sharding()),
                     "softmax_label": jax.device_put(label, step.batch_sharding())}
        else:
            tmx.random.seed(3)
            batch = {"data": torch.from_numpy(data), "softmax_label": torch.from_numpy(label)}
        if multi:
            params, aux, st, _ = step.call_multi(
                params, aux, st, {k: [v] * steps for k, v in batch.items()},
                [0.1] * steps, list(range(1, steps + 1)))
        else:
            for t in range(steps):
                params, aux, st, _ = step(params, aux, st, batch, t=t + 1)
    finally:
        _mirror(False)
        os.environ.pop("MXTPU_AMP", None)
        if amp is not None:
            os.environ["MXTPU_AMP"] = amp
    return {k: (v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
            for k, v in params.items()}


@pytest.mark.parametrize("mode", ["per_param", "flat", "amp"])
def test_fused_step_honors_mirror(mode):
    """3 SGD steps: mirrored against plain in the port at rtol 1e-5 / atol
    1e-7 (bit for bit in fact: the kept products are the plain ones), and
    against the JAX package's mirrored step at 1e-4 of each tensor's max in
    f32 (the repo's limit for a conv-BN training step across the packages).
    The two packages' bf16 AMP steps differ by bf16 rounding (2.8e-2 of max
    on conv0_weight, mirror or not), so there the check is that the mirror
    moves neither: port minus JAX is the same array mirrored and plain."""
    got = _fused_params(tmx, True, mode)
    plain = _fused_params(tmx, False, mode)
    jwant = _fused_params(jmx, True, mode)
    jplain = _fused_params(jmx, False, mode)
    for k in plain:
        np.testing.assert_allclose(got[k], plain[k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(got[k] - jwant[k], plain[k] - jplain[k], err_msg=k)
        if mode != "amp":
            scale = max(float(np.abs(jwant[k]).max()), 1.0)
            np.testing.assert_allclose(got[k], jwant[k], rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["flat", "amp"])
def test_fused_multistep_under_mirror(mode):
    """``call_multi`` (``compile_multi``'s K steps, uncaptured on the CPU)
    mirrored equals the eager mirrored steps bit for bit, Dropout in the
    graph."""
    got = _fused_params(tmx, True, mode, dropout=0.5, multi=True)
    want = _fused_params(tmx, True, mode, dropout=0.5)
    plain = _fused_params(tmx, False, mode, dropout=0.5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_module_fit_under_mirror(kvstore):
    """``Module.fit`` on the executor path (one context) and the fused path
    (four host ranks, ``kvstore="device"``) with the flag: the parameters
    after two epochs equal the plain fit's (rtol 1e-5)."""
    rng = np.random.RandomState(0)
    X = rng.rand(32, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 5, (32,)).astype(np.float32)

    def fit(on):
        _mirror(on)
        try:
            with tname.NameManager():
                net = _conv_bn_net(tmx.sym, n_layers=2, pool=True)
            ctx = tmx.cpu() if kvstore == "local" else [tmx.cpu(i) for i in range(4)]
            mod = tmx.mod.Module(net, context=ctx)
            np.random.seed(0)
            tmx.random.seed(0)
            it = tmx.io.NDArrayIter(X, y, batch_size=8)
            mod.fit(it, num_epoch=2, kvstore=kvstore, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                    initializer=tmx.init.Xavier())
            if kvstore == "device":
                assert mod._fused_trainer is not None and mod._fused_trainer.mirror == on
            else:
                assert mod._exec_group.execs[0]._mirror == on
            return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        finally:
            _mirror(False)

    got, want = fit(True), fit(False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_mirror_inception_tool_on_the_host(capsys):
    """``tools/mirror_inception --cpu`` at inception-v3's smallest side: one
    JSON line a variant, each bound under its own env, the env left clean."""
    import json

    from mxnet_tpu_torch.tools import mirror_inception

    rows = mirror_inception.main(["--cpu", "--batch", "1", "--side", "75", "--steps", "1",
                                  "--variants", "plain,mirror_pool"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in printed] == [r["variant"] for r in rows] == [
        "plain", "mirror_pool"]
    assert [r["mirror"] for r in rows] == [False, True]
    assert rows[1]["save"].endswith("reduce_window_max,reduce_window_sum")
    assert all(r["step_ms"] > 0 and r["card"] is None for r in rows)
    assert "MXNET_BACKWARD_DO_MIRROR" not in os.environ
    assert "MXNET_MIRROR_SAVE" not in os.environ


def test_mirror_lowers_the_backward_peak_of_live_tensors():
    """What the mirror is for, seen on the host: over a training step of
    eight conv-BN-ReLU layers, the peak bytes of the tensors alive at once
    (sampled after every op of the forward and the backward) stays under
    0.75 of the plain graph's. The graph runs as regions, each ending at a
    kept convolution, so a backward recomputes one region at a time; one
    region over the whole graph would recompute everything at the first
    backward op and reach the plain peak."""
    import gc
    import weakref

    class Peak(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.refs, self.peak = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if torch.is_tensor(t) and t.numel() >= 4096:
                    self.refs.append(weakref.ref(t))
            live = {}
            for r in self.refs:
                t = r()
                if t is not None:
                    live[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            self.peak = max(self.peak, sum(live.values()))
            return out

    def peak_bytes(on):
        _mirror(on)
        try:
            with tname.NameManager():
                net = tmx.sym.Variable("data")
                for i in range(8):
                    net = tmx.sym.Convolution(net, kernel=(3, 3), num_filter=16, pad=(1, 1),
                                              no_bias=True, name="conv%d" % i)
                    net = tmx.sym.Activation(tmx.sym.BatchNorm(net, name="bn%d" % i),
                                             act_type="relu")
                net = tmx.sym.FullyConnected(tmx.sym.Flatten(net), num_hidden=5, name="fc")
                net = tmx.sym.SoftmaxOutput(net, name="softmax")
            exe = net.simple_bind(ctx=tmx.cpu(0), data=(8, 16, 32, 32), softmax_label=(8,))
        finally:
            _mirror(False)
        rng = np.random.RandomState(0)
        for name, arr in exe.arg_dict.items():
            arr[:] = rng.rand(*arr.shape) * 0.1
        gc.collect()
        with Peak() as peak:
            exe.forward(is_train=True)
            exe.backward()
        return peak.peak

    plain, mirrored = peak_bytes(False), peak_bytes(True)
    assert mirrored < 0.75 * plain, (mirrored, plain)
