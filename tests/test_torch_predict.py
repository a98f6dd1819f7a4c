"""The PyTorch port's predict.py (Predictor, bundles) held against the JAX
package's on the CPU: the same bundle through both Predictors for an MLP,
LeNet and the cifar ResNet-8 (outputs at 1e-5 in f32); predict_batch rows
equal to predict() of the same bucket bit for bit; bundles crossing both
ways, the port's export_bundle writing the JAX package's bytes, v1
bundles; every CRC failure naming the same section or tensor in both
packages; the LRU executor pool; the raises (params_from_checkpoint, the
default context without a card); and tests/test_predict.py's two cases."""
import importlib
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import name as jname
from mxnet_tpu import predict as jpredict
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch.base import MXNetError


def _model(pkg, model):
    mod = importlib.import_module("%s.models.%s" % (pkg.__name__, model))
    manager = (jname if pkg is jmx else tname).NameManager()
    with manager:
        if model == "resnet":
            return mod.get_symbol(num_classes=10, num_layers=8, image_shape="3,28,28")
        if model == "mlp":
            return mod.get_symbol(num_classes=10, hidden=(32,))
        return mod.get_symbol(num_classes=10)


MODELS = {"mlp": (16,), "lenet": (1, 28, 28), "resnet": (3, 28, 28)}


def _params(sym, feature, seed=0):
    """Name -> f32 numpy params (arg and aux) of ``sym`` from a seed:
    weights N(0, 0.1²)..., gammas near 1, moving variances positive."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + feature)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        v = rng.randn(*s).astype(np.float32)
        args[n] = (1.0 + 0.1 * v) if n.endswith("gamma") else 0.2 * v
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        v = rng.rand(*s).astype(np.float32)
        aux[n] = (0.5 + v) if n.endswith("var") else 0.1 * (v - 0.5)
    return args, aux


def _nd(pkg, arrays):
    if pkg is tmx:
        with tmx.cpu():
            return {n: tmx.nd.array(v) for n, v in arrays.items()}
    return {n: jmx.nd.array(v) for n, v in arrays.items()}


def _bundle(tmp_path, model, pkg=jmx):
    sym = _model(pkg, model)
    args, aux = _params(sym, MODELS[model])
    path = str(tmp_path / ("%s_%s.pred" % (model, pkg.__name__)))
    (jpredict if pkg is jmx else tpredict).export_bundle(path, sym, _nd(pkg, args),
                                                         _nd(pkg, aux))
    return path, args, aux


@pytest.mark.parametrize("model", sorted(MODELS))
def test_predictor_matches_jax_on_one_bundle(tmp_path, model):
    path, _, _ = _bundle(tmp_path, model)
    feature = MODELS[model]
    rng = np.random.RandomState(1)
    jp = jpredict.load_bundle(path, {"data": (1,) + feature})
    tp = tpredict.load_bundle(path, {"data": (1,) + feature}, ctx=tmx.cpu())
    for b in (1, 3, 4):
        x = rng.randn(b, *feature).astype(np.float32)
        want = jp.predict_batch(data=x)
        got = tp.predict_batch(data=x)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
        jp.reshape({"data": x.shape})
        tp.reshape({"data": x.shape})
        np.testing.assert_allclose(tp.predict(data=x)[0], jp.predict(data=x)[0],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_predict_batch_rows_equal_predict_of_the_same_bucket(tmp_path, model):
    path, _, _ = _bundle(tmp_path, model, tmx)
    feature = MODELS[model]
    tp = tpredict.load_bundle(path, {"data": (4,) + feature}, ctx=tmx.cpu())
    tp.compile()
    rng = np.random.RandomState(2)
    for _ in range(2):
        x = rng.randn(4, *feature).astype(np.float32)
        got = tp.predict_batch(data=x)[0]
        want = tp.predict(data=x)[0]
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_export_bundle_bytes_equal_jax(tmp_path, model):
    j_path, _, _ = _bundle(tmp_path, model, jmx)
    t_path, _, _ = _bundle(tmp_path, model, tmx)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()


def test_bundles_cross_both_ways(tmp_path):
    feature = MODELS["lenet"]
    x = np.random.RandomState(3).randn(2, *feature).astype(np.float32)
    j_path, _, _ = _bundle(tmp_path, "lenet", jmx)
    t_path, _, _ = _bundle(tmp_path, "lenet", tmx)
    shapes = {"data": (2,) + feature}
    want = jpredict.load_bundle(j_path, shapes).predict(data=x)[0]
    got_jax_reads_port = jpredict.load_bundle(t_path, shapes).predict(data=x)[0]
    got_port_reads_jax = tpredict.load_bundle(j_path, shapes, ctx=tmx.cpu()).predict(data=x)[0]
    np.testing.assert_array_equal(got_jax_reads_port, want)
    np.testing.assert_allclose(got_port_reads_jax, want, rtol=1e-5, atol=1e-5)


def test_v1_bundles_load(tmp_path):
    sym = _model(jmx, "mlp")
    args, _ = _params(sym, MODELS["mlp"])
    js = sym.tojson().encode()
    param_bytes = jmx.nd.save_buffer({"arg:" + n: v for n, v in _nd(jmx, args).items()})
    path = str(tmp_path / "v1.pred")
    with open(path, "wb") as f:
        f.write(b"MXTPUPRED1")
        f.write(struct.pack("<qq", len(js), len(param_bytes)))
        f.write(js)
        f.write(param_bytes)
    x = np.random.RandomState(4).randn(1, 16).astype(np.float32)
    want = jpredict.load_bundle(path, {"data": (1, 16)}).predict_batch(data=x)[0]
    got = tpredict.load_bundle(path, {"data": (1, 16)}, ctx=tmx.cpu()).predict_batch(data=x)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def _corrupt(blob, kind, args):
    """tests/test_serving.py's corruptions and the header's."""
    blob = bytearray(blob)
    if kind == "tensor":
        off = bytes(blob).find(np.ascontiguousarray(args["fc1_weight"]).tobytes())
        assert off > 0
        blob[off + 8] ^= 0xFF
    elif kind == "symbol":
        blob[bytes(blob).find(b'"nodes"')] ^= 0xFF
    elif kind == "manifest":
        blob[10 + 24] ^= 0xFF  # the manifest's opening brace
    elif kind == "magic":
        blob[0] ^= 0xFF
    return bytes(blob)


@pytest.mark.parametrize("kind,needle", [
    ("tensor", "arg:fc1_weight"), ("symbol", "symbol section"),
    ("manifest", "manifest section"), ("magic", "not a predictor bundle")])
def test_crc_failures_name_the_same_section_or_tensor(tmp_path, kind, needle):
    path, args, _ = _bundle(tmp_path, "mlp", jmx)
    bad = str(tmp_path / "bad.pred")
    open(bad, "wb").write(_corrupt(open(path, "rb").read(), kind, args))
    with pytest.raises(JMXNetError) as je:
        jpredict.load_bundle(bad, {"data": (1, 16)})
    with pytest.raises(MXNetError) as te:
        tpredict.load_bundle(bad, {"data": (1, 16)}, ctx=tmx.cpu())
    assert str(te.value) == str(je.value)
    assert needle in str(te.value) and "bad.pred" in str(te.value)


def _mlp_predictor(**kw):
    sym = _model(tmx, "mlp")
    args, _ = _params(sym, MODELS["mlp"])
    return tpredict.Predictor(sym.tojson(), {"arg:" + n: v for n, v in _nd(tmx, args).items()},
                              {"data": (1, 16)}, **kw)


def test_reshape_reuses_lru_executor():
    p = _mlp_predictor(ctx=tmx.cpu())
    first = p._exec
    p.reshape({"data": (4, 16)})
    second = p._exec
    assert second is not first
    p.reshape({"data": (1, 16)})
    assert p._exec is first  # LRU hit: no rebind, same executor object
    assert len(p.cached_shape_keys) == 2
    # every executor reads the first bind's parameter tensors
    for name in ("fc1_weight", "fc2_bias"):
        assert second.arg_dict[name]._data is first.arg_dict[name]._data


def test_exec_cache_eviction_drops_the_bucket(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_EXEC_CACHE", "2")
    p = _mlp_predictor(ctx=tmx.cpu())
    p.compile([{"data": (2, 16)}])
    assert len(p._serve_cache) == 1
    for b in (3, 4):
        p.reshape({"data": (b, 16)})
    assert len(p.cached_shape_keys) == 2  # capped, oldest evicted
    assert p._serve_cache == {}  # the evicted bucket's forward went with it


def test_params_from_checkpoint_raises():
    """A directory that is no verified checkpoint raises the resilience
    package's CheckpointError (the reading itself is held in
    tests/test_torch_resilience.py)."""
    from mxnet_tpu_torch.resilience import CheckpointError

    with pytest.raises(CheckpointError, match="unreadable manifest"):
        tpredict.params_from_checkpoint("ckpt-1")


def test_default_context_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no such CUDA device"):
        _mlp_predictor()
    with pytest.raises(MXNetError, match="no such CUDA device"):
        _mlp_predictor(ctx=tmx.gpu(0))


def test_unnamed_params_and_bad_quant_raise():
    sym = _model(tmx, "mlp")
    with pytest.raises(MXNetError, match="NAMED"):
        tpredict.Predictor(sym.tojson(), [], {"data": (1, 16)}, ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="only int8"):
        _mlp_predictor(ctx=tmx.cpu(), quant="int4")
    p = _mlp_predictor(ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="does not match compiled bucket"):
        p.compile()._serve_cache[(("data", (1, 16)),)]({"data": np.zeros((2, 16))})
    with pytest.raises(MXNetError, match="unknown input"):
        p.predict_batch(label=np.zeros((1, 16)))


# ---------------------------------------------------------------------------
# tests/test_predict.py's two cases, in the port
# ---------------------------------------------------------------------------

def _trained_net():
    rng = np.random.RandomState(0)
    X = rng.rand(100, 6).astype(np.float32)
    y = (X.sum(axis=1) > 3).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=20)
        net = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(net, num_hidden=8, name="fc1")
        net = tmx.sym.Activation(net, act_type="relu")
        net = tmx.sym.FullyConnected(net, num_hidden=2, name="fc2")
        net = tmx.sym.SoftmaxOutput(net, name="softmax")
        mod = tmx.mod.Module(net, context=tmx.cpu())
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, num_epoch=2)
    arg_params, aux_params = mod.get_params()
    return net, arg_params, aux_params, mod, X


def _module_predict(mod, X, n):
    """The module's prediction of the first ``n`` rows, in one batch of
    ``n`` (smaller than the bound 20)."""
    with tmx.cpu():
        return mod.predict(tmx.io.NDArrayIter(X[:n], None, batch_size=n)).asnumpy()


@pytest.mark.parametrize("rows,batch", [(4, 4), (24, 8), (26, 20)])
def test_module_predict_over_smaller_batches_matches_jax(rows, batch):
    """Module bound at (20, 6), predicting over batches of other sizes
    (smaller than the bound one, and a padded last batch): the JAX package
    returns every row, and the port returns the same rows."""
    net, arg_params, aux_params, mod, X = _trained_net()
    jnet = jmx.sym.load_json(net.tojson())
    jmod = jmx.mod.Module(jnet, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (20, 6))], label_shapes=[("softmax_label", (20,))],
              for_training=False)
    jmod.set_params({k: jmx.nd.array(v.asnumpy()) for k, v in arg_params.items()},
                    {k: jmx.nd.array(v.asnumpy()) for k, v in aux_params.items()})
    want = jmod.predict(jmx.io.NDArrayIter(X[:rows], None, batch_size=batch)).asnumpy()
    with tmx.cpu():
        got = mod.predict(tmx.io.NDArrayIter(X[:rows], None, batch_size=batch)).asnumpy()
        again = mod.predict(tmx.io.NDArrayIter(X[:20], None, batch_size=20)).asnumpy()
    assert got.shape == np.asarray(want).shape == (rows, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    # the bound batch still runs after a smaller one rebound the inputs
    np.testing.assert_allclose(again[:min(rows, 20)], got[:min(rows, 20)], rtol=1e-5,
                               atol=1e-6)


def test_predictor_matches_module(tmp_path):
    net, arg_params, aux_params, mod, X = _trained_net()
    # via checkpoint bytes — exactly what MXPredCreate consumes
    tmx.model.save_checkpoint(str(tmp_path / "m"), 0, net, arg_params, aux_params)
    param_bytes = (tmp_path / "m-0000.params").read_bytes()
    sym_json = (tmp_path / "m-symbol.json").read_text()

    pred = tpredict.Predictor(sym_json, param_bytes, {"data": (4, 6)}, ctx=tmx.cpu())
    pred.set_input("data", X[:4])
    pred.forward()
    out = pred.get_output(0)
    ref = _module_predict(mod, X, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)

    # reshape keeps weights, handles a new batch size
    pred.reshape({"data": (2, 6)})
    out2 = pred.predict(data=X[:2])[0]
    np.testing.assert_allclose(out2, ref[:2], rtol=1e-5, atol=1e-6)


def test_bundle_roundtrip(tmp_path):
    net, arg_params, aux_params, mod, X = _trained_net()
    path = str(tmp_path / "model.bundle")
    tpredict.export_bundle(path, net, arg_params, aux_params)
    pred = tpredict.load_bundle(path, {"data": (4, 6)}, ctx=tmx.cpu())
    out = pred.predict(data=X[:4])[0]
    ref = _module_predict(mod, X, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert out.shape == (4, 2)
