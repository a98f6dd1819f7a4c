"""Model-parallel placement in the PyTorch port (``ctx_group`` +
``group2ctx``), the cases of tests/test_model_parallel.py held on the port
and against the JAX package on the CPU.

The JAX package places on eight virtual CPU devices, so its tests read
each array's committed device. The port's ``cpu(i)`` are logical contexts
of the one host device (an NDArray's context reads ``cpu(0)``), so the
placement is held through the executor: the placed program's segments
(context and node names) against JAX's ``_placed.segments``, and the
context each argument was allocated for; the numbers against JAX's placed
executor and the port's unplaced one within 1e-5."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import name as jname
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.examples import model_parallel_lstm as tlstm


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _two_stage_symbol(pkg):
    with pkg.AttrScope(ctx_group="stage1"):
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act1 = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    with pkg.AttrScope(ctx_group="stage2"):
        fc2 = pkg.sym.FullyConnected(act1, num_hidden=3, name="fc2")
        net = pkg.sym.SoftmaxOutput(fc2, name="softmax")
    return net


def _segments(exe, pkg):
    """(context, node names) of each placed segment; JAX's devices as the
    contexts they stand for."""
    out = []
    for dev, nodes in exe._placed.segments:
        ctx = "cpu(%d)" % dev.id if pkg is jmx else str(dev)
        out.append((ctx, [n.name for n in nodes]))
    return out


def _bind(pkg, net, group2ctx, shapes, seed=0, grad_req="write"):
    g2c = {k: getattr(pkg, t)(i) for k, (t, i) in group2ctx.items()} if group2ctx else None
    exe = net.simple_bind(ctx=pkg.cpu(0), group2ctx=g2c, grad_req=grad_req, **shapes)
    rng = np.random.RandomState(seed)
    for name, arr in exe.arg_dict.items():
        if name == "softmax_label":
            arr[:] = rng.randint(0, 3, arr.shape)
        else:
            arr[:] = rng.randn(*arr.shape) * (1.0 if name == "data" else 0.1)
    return exe


def _grads(exe):
    return {n: g.asnumpy() for n, g in exe.grad_dict.items() if g is not None}


def _close(got, want, tol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


STAGES = {"stage1": ("cpu", 1), "stage2": ("cpu", 2)}
SHAPES = dict(data=(8, 6), softmax_label=(8,))


def test_group2ctx_bind_and_train():
    """Placed bind: arguments allocated for their stage's context, two
    segments whose contexts and nodes are JAX's, and the outputs and every
    gradient equal to JAX's placed executor and to the port's unplaced
    bind within 1e-5; ``_placed`` is None without groups."""
    with jname.NameManager():
        jnet = _two_stage_symbol(jmx)
    with tname.NameManager():
        tnet = _two_stage_symbol(tmx)
    jexe = _bind(jmx, jnet, STAGES, SHAPES)
    texe = _bind(tmx, tnet, STAGES, SHAPES)
    tsp = _bind(tmx, tnet, None, SHAPES)
    for name, ctx in [("fc1_weight", tmx.cpu(1)), ("fc1_bias", tmx.cpu(1)),
                      ("fc2_weight", tmx.cpu(2)), ("fc2_bias", tmx.cpu(2)),
                      ("data", tmx.cpu(1)), ("softmax_label", tmx.cpu(2))]:
        assert texe._arg_contexts[name] == ctx, (name, texe._arg_contexts[name])
    assert tsp._placed is None
    assert _segments(texe, tmx) == _segments(jexe, jmx) == [
        ("cpu(1)", ["fc1", "relu1"]), ("cpu(2)", ["fc2", "softmax"])]
    for exe in (jexe, texe, tsp):
        exe.forward(is_train=True)
        exe.backward()
    assert texe._placed.boundary_copies == 0  # cpu(1) and cpu(2): one host device
    np.testing.assert_allclose(texe.outputs[0].asnumpy(), jexe.outputs[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    _close(_grads(texe), _grads(jexe))
    _close(_grads(texe), _grads(tsp))


def _blobs(n=120, d=6, k=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 4
    X = np.concatenate([c + rng.randn(n // k, d) * 0.3 for c in centers])
    y = np.repeat(np.arange(k), n // k).astype(np.float32)
    p = rng.permutation(n)
    return X[p].astype(np.float32), y[p]


def _train(pkg, epochs=8):
    X, y = _blobs()
    with (jname if pkg is jmx else tname).NameManager():
        net = _two_stage_symbol(pkg)
    exe = net.simple_bind(ctx=pkg.cpu(0), group2ctx={"stage1": pkg.cpu(1),
                                                      "stage2": pkg.cpu(2)},
                          data=(30, 6), softmax_label=(30,))
    assert exe._placed is not None
    rng = np.random.RandomState(1)
    for name, arr in exe.arg_dict.items():
        if name not in ("data", "softmax_label"):
            arr[:] = rng.randn(*arr.shape) * 0.1
    losses = []
    for _ in range(epochs):
        for i in range(0, 120, 30):
            exe.arg_dict["data"][:] = X[i:i + 30]
            exe.arg_dict["softmax_label"][:] = y[i:i + 30]
            exe.forward(is_train=True)
            exe.backward()
            probs = exe.outputs[0].asnumpy()
            losses.append(-np.mean(np.log(probs[np.arange(30), y[i:i + 30].astype(int)]
                                          + 1e-8)))
            for name, grad in exe.grad_dict.items():
                if grad is not None and name not in ("data", "softmax_label"):
                    exe.arg_dict[name][:] = (exe.arg_dict[name].asnumpy()
                                             - 0.1 * grad.asnumpy() / 30)
    return losses


def test_group2ctx_training_converges():
    """Training through the placed executor (the reference example drives
    bound executors directly): the loss falls below a fifth of its first
    value, each step's loss within 1e-4 of JAX's placed run."""
    got, want = _train(tmx), _train(jmx)
    assert got[-1] < 0.2 * got[0], (got[0], got[-1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_group2ctx_attrs_round_trip_json():
    """The ctx_group attrs survive JSON, and cross to the JAX package."""
    with tname.NameManager():
        net = _two_stage_symbol(tmx)
    for load in (tmx.sym.load_json, jmx.sym.load_json):
        loaded = load(net.tojson())
        args = loaded.list_arguments()
        assert "fc1_weight" in args and "fc2_weight" in args
        assert loaded.attr_dict()["fc1"]["ctx_group"] == "stage1"
        assert loaded.attr_dict()["fc2"]["ctx_group"] == "stage2"


def test_bf16_training_converges():
    """test_dtype.py's bf16 middle with an f32 head, through Module.fit."""
    X, y = _blobs(n=150, d=8)
    it = tmx.io.NDArrayIter(X, y, batch_size=30)
    data = tmx.sym.Variable("data")
    h = tmx.sym.Cast(data, dtype="bfloat16")
    h = tmx.sym.FullyConnected(h, num_hidden=16, name="fc1")
    h = tmx.sym.Activation(h, act_type="relu")
    h = tmx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    h = tmx.sym.Cast(h, dtype="float32")
    net = tmx.sym.SoftmaxOutput(h, name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.1}, num_epoch=6)
    assert dict(mod.score(it, tmx.metric.Accuracy()))["accuracy"] > 0.95
    arg_types, out_types, _ = net.infer_type(data="float32")
    by_name = dict(zip(net.list_arguments(), arg_types))
    assert str(np.dtype(by_name["fc1_weight"])) == "bfloat16"
    assert str(np.dtype(out_types[0])) == "float32"
    jarg_types, _, _ = jmx.sym.load_json(net.tojson()).infer_type(data="float32")
    assert [str(np.dtype(t)) for t in jarg_types] == [str(np.dtype(t)) for t in arg_types]


def test_grad_req_add_across_a_boundary():
    """grad_req="add" over two backward passes of the placed graph: twice
    the write gradients, as JAX's placed executor accumulates them."""
    with jname.NameManager():
        jnet = _two_stage_symbol(jmx)
    with tname.NameManager():
        tnet = _two_stage_symbol(tmx)
    req = {"fc1_weight": "add", "fc1_bias": "add", "fc2_weight": "add", "fc2_bias": "write"}
    jexe = _bind(jmx, jnet, STAGES, SHAPES, grad_req=req)
    texe = _bind(tmx, tnet, STAGES, SHAPES, grad_req=req)
    once = _bind(tmx, tnet, STAGES, SHAPES)
    once.forward(is_train=True)
    once.backward()
    for exe in (jexe, texe):
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward()
    got, want = _grads(texe), _grads(jexe)
    _close(got, want)
    single = _grads(once)
    for k in req:
        np.testing.assert_allclose(got[k], single[k] * (2 if req[k] == "add" else 1),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_reshape_keeps_group2ctx():
    """reshape to another batch keeps the placement: the same segments, the
    parameters shared, new data allocated for its stage, gradients equal to
    JAX's reshaped placed executor."""
    with jname.NameManager():
        jnet = _two_stage_symbol(jmx)
    with tname.NameManager():
        tnet = _two_stage_symbol(tmx)
    jexe = _bind(jmx, jnet, STAGES, SHAPES).reshape(data=(4, 6), softmax_label=(4,))
    base = _bind(tmx, tnet, STAGES, SHAPES)
    texe = base.reshape(data=(4, 6), softmax_label=(4,))
    assert texe._placed is not None and _segments(texe, tmx) == _segments(base, tmx)
    assert texe.arg_dict["fc1_weight"] is base.arg_dict["fc1_weight"]
    assert texe._arg_contexts["data"] == tmx.cpu(1)
    assert texe.arg_dict["data"].shape == (4, 6)
    rng = np.random.RandomState(3)
    x, y = rng.randn(4, 6).astype(np.float32), rng.randint(0, 3, (4,)).astype(np.float32)
    for exe in (jexe, texe):
        exe.arg_dict["data"][:] = x
        exe.arg_dict["softmax_label"][:] = y
        exe.forward(is_train=True)
        exe.backward()
    _close(_grads(texe), _grads(jexe))


def test_variable_only_group():
    """A group that only a variable carries (fc1's weight): that argument
    goes to its context, the executor is placed with one segment on the
    bind context, and the gradients equal JAX's and the unplaced bind's."""
    def build(pkg):
        data = pkg.sym.Variable("data")
        w = pkg.sym.Variable("fc1_weight", attr={"ctx_group": "params"})
        h = pkg.sym.FullyConnected(data, weight=w, num_hidden=16, name="fc1")
        h = pkg.sym.Activation(h, act_type="relu", name="relu1")
        h = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(h, name="softmax")

    with jname.NameManager():
        jnet = build(jmx)
    with tname.NameManager():
        tnet = build(tmx)
    group = {"params": ("cpu", 3)}
    jexe = _bind(jmx, jnet, group, SHAPES)
    texe = _bind(tmx, tnet, group, SHAPES)
    tsp = _bind(tmx, tnet, None, SHAPES)
    assert texe._arg_contexts["fc1_weight"] == tmx.cpu(3)
    assert texe._arg_contexts["fc1_bias"] == tmx.cpu(0)
    assert _segments(texe, tmx) == _segments(jexe, jmx) == [
        ("cpu(0)", ["fc1", "relu1", "fc2", "softmax"])]
    for exe in (jexe, texe, tsp):
        exe.forward(is_train=True)
        exe.backward()
    _close(_grads(texe), _grads(jexe))
    _close(_grads(texe), _grads(tsp))


def test_model_parallel_lstm_example():
    """The example's ``build`` placed over three contexts, as JAX places
    the same graph (its JSON loaded there): the same segments, the loss
    gradients within 1e-5 of JAX's and of the unplaced bind; and the
    example's training loop on the host lowers the perplexity."""
    net = tlstm.build(seq_len=5, vocab=20, num_hidden=8, num_layers=3)
    jnet = jmx.sym.load_json(net.tojson())
    plan = {"embed": ("cpu", 0), "decode": ("cpu", 0), "layer0": ("cpu", 0),
            "layer1": ("cpu", 1), "layer2": ("cpu", 2)}
    shapes = dict(data=(4, 5), softmax_label=(4, 5))

    def bind(pkg, sym, group2ctx):
        g2c = {k: getattr(pkg, t)(i) for k, (t, i) in group2ctx.items()} if group2ctx else None
        exe = sym.simple_bind(ctx=pkg.cpu(0), group2ctx=g2c, **shapes)
        rng = np.random.RandomState(0)
        for name, arr in exe.arg_dict.items():
            if name in ("data", "softmax_label"):
                arr[:] = rng.randint(0, 20, arr.shape)
            else:
                arr[:] = rng.randn(*arr.shape) * 0.3
        exe.forward(is_train=True)
        exe.backward()
        return exe

    texe, jexe, tsp = bind(tmx, net, plan), bind(jmx, jnet, plan), bind(tmx, net, None)
    assert [c for c, _ in _segments(texe, tmx)] == ["cpu(0)", "cpu(1)", "cpu(2)", "cpu(0)"]
    assert _segments(texe, tmx) == _segments(jexe, jmx)
    _close(_grads(texe), _grads(jexe))
    _close(_grads(texe), _grads(tsp))
    exe, (name, ppl) = tlstm.main(["--ctx", "cpu", "--num-epochs", "2", "--seq-len", "6",
                                   "--vocab", "12", "--num-hidden", "16"])
    assert exe._placed is not None and name == "Perplexity" and ppl < 12


def test_placed_graph_under_the_mirror(monkeypatch):
    """Placement and the mirror together: the two-stage bind with
    MXNET_BACKWARD_DO_MIRROR, its regions running across the stages, gives
    the plain unplaced gradients bit for bit."""
    with tname.NameManager():
        tnet = _two_stage_symbol(tmx)
    want = _bind(tmx, tnet, None, SHAPES)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    got = _bind(tmx, tnet, STAGES, SHAPES)
    assert got._mirror and got._placed is not None
    for exe in (got, want):
        exe.forward(is_train=True)
        exe.backward()
    for name, g in _grads(want).items():
        np.testing.assert_array_equal(_grads(got)[name], g, err_msg=name)
