"""The port's counterpart of ``tests/test_dtype_consistency.py``: in a
reduced-precision graph each layer's runtime dtype is the dtype type
inference declares, bfloat16 after a ``Cast``, in train and inference
mode, through ``simple_bind`` on the host; and the outputs of the
deterministic layers agree with the JAX package's on the same inputs
within bf16's rounding."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _layers(mx):
    return {
        "conv": lambda x: mx.sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                                             name="op"),
        "deconv": lambda x: mx.sym.Deconvolution(x, kernel=(2, 2), stride=(2, 2), num_filter=4,
                                                 name="op"),
        "pool_max": lambda x: mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max"),
        "pool_avg": lambda x: mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="avg"),
        "bn": lambda x: mx.sym.BatchNorm(x, name="op"),
        "lrn": lambda x: mx.sym.LRN(x, nsize=3),
        "act": lambda x: mx.sym.Activation(x, act_type="relu"),
        "leaky": lambda x: mx.sym.LeakyReLU(x, act_type="leaky"),
        "dropout": lambda x: mx.sym.Dropout(x, p=0.3),
        "fc": lambda x: mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=6, name="op"),
        "concat_self": lambda x: mx.sym.Concat(x, x),
        "elemwise": lambda x: x + x * 0.5,
        "softmax_act": lambda x: mx.sym.SoftmaxActivation(mx.sym.Flatten(x)),
    }


NAMES = list(_layers(tmx))


def _run(mx, name, is_train):
    data = mx.sym.Variable("data")
    net = _layers(mx)[name](mx.sym.Cast(data, dtype="bfloat16"))
    declared = net.infer_type(data="float32")[1][0]
    exe = net.simple_bind(ctx=mx.cpu(), data=(2, 3, 8, 8), grad_req="null")
    rng = np.random.RandomState(0)
    for k in sorted(exe.arg_dict):
        a = exe.arg_dict[k]
        if k != "data":
            a[:] = rng.rand(*a.shape).astype(np.float32) - 0.5
    exe.arg_dict["data"][:] = rng.rand(2, 3, 8, 8).astype(np.float32)
    return declared, exe.forward(is_train=is_train)[0]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "infer"])
def test_layer_preserves_bf16(name, is_train):
    with tmx.cpu():
        declared, out = _run(tmx, name, is_train)
        assert np.dtype(declared).name == "bfloat16", (name, declared)
        assert out._data.dtype == torch.bfloat16, (name, out._data.dtype)
        if name == "dropout" and is_train:
            return  # its mask comes from each package's own generator
        got = out._data.float().numpy()
    _, want = _run(jmx, name, is_train)
    want = np.asarray(want.asnumpy(), np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale, err_msg=name)
