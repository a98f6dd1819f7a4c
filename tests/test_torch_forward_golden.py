"""Pinned inference numerics of the port (mirrors
``tests/test_forward_golden.py``) on the committed fixture
``tests/fixtures/golden_convnet*`` (a conv + BatchNorm + pooling net in
the dmlc checkpoint format, with nontrivial moving statistics).

The checkpoint loads, binds and forwards through ``Executor``,
``Module.predict`` and ``predict.Predictor`` on the CPU to the stored
probabilities (rtol 1e-4, atol 1e-5, the reference test's limits), the
three paths agree with the JAX package's forward (rtol 1e-5), and the
``.params`` bytes survive a read / write round trip unchanged."""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PREFIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "golden_convnet")


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _load_io():
    io = np.load(PREFIX + "_io.npz")
    return io["data"], io["probs"]


def _jax_probs():
    sym, arg_params, aux_params = jmx.model.load_checkpoint(PREFIX, 1)
    data, _ = _load_io()
    exe = sym.simple_bind(ctx=jmx.cpu(), grad_req="null", data=data.shape)
    for n, v in arg_params.items():
        v.copyto(exe.arg_dict[n])
    for n, v in aux_params.items():
        v.copyto(exe.aux_dict[n])
    exe.arg_dict["data"][:] = data
    return exe.forward(is_train=False)[0].asnumpy()


def _check(probs):
    _, golden = _load_io()
    np.testing.assert_allclose(probs, golden, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(probs, _jax_probs(), rtol=1e-5, atol=1e-7)


def test_checkpoint_forward_matches_golden():
    sym, arg_params, aux_params = tmx.model.load_checkpoint(PREFIX, 1)
    data, _ = _load_io()
    exe = sym.simple_bind(ctx=tmx.cpu(), grad_req="null", data=data.shape)
    for n, v in arg_params.items():
        v.copyto(exe.arg_dict[n])
    for n, v in aux_params.items():
        v.copyto(exe.aux_dict[n])
    exe.arg_dict["data"][:] = data
    _check(exe.forward(is_train=False)[0].asnumpy())


def test_module_predict_matches_golden():
    sym, arg_params, aux_params = tmx.model.load_checkpoint(PREFIX, 1)
    data, _ = _load_io()
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("softmax_label", (data.shape[0],))], for_training=False)
    mod.set_params(arg_params, aux_params, allow_missing=True)
    it = tmx.io.NDArrayIter(data, np.zeros(data.shape[0], np.float32),
                            batch_size=data.shape[0])
    _check(mod.predict(it).asnumpy())


def test_predictor_matches_golden():
    from mxnet_tpu_torch import predict

    data, _ = _load_io()
    with open(PREFIX + "-symbol.json") as f:
        sym_json = f.read()
    with open(PREFIX + "-0001.params", "rb") as f:
        raw = f.read()
    pred = predict.Predictor(sym_json, raw, {"data": data.shape}, ctx=tmx.cpu())
    (probs,) = pred.predict(data=data)
    _check(probs)
    (batched,) = pred.predict_batch(data=data)
    np.testing.assert_array_equal(batched, probs)


def test_params_bytes_stable(tmp_path):
    with open(PREFIX + "-0001.params", "rb") as f:
        blob = f.read()
    tmp = str(tmp_path / "roundtrip.params")
    tmx.nd.save(tmp, tmx.nd.load(PREFIX + "-0001.params"))
    with open(tmp, "rb") as f:
        assert f.read() == blob
