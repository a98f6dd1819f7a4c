"""The PyTorch port's Executor held against the JAX package's on the CPU:
an MLP and the cifar ResNet-8 bound by ``simple_bind`` in both packages
with the same parameters and batch; forward outputs at 1e-5 and gradients
at 1e-4 (of each tensor's max where that is above 1), with grad_req
write, add and null; ``reshape`` and ``copy_params_from``; the aux states
a training forward writes; tests/test_executor.py's own cases; and the
ResNet symbol's space-to-depth stem and bfloat16 variant, now that
Reshape / transpose / Pad / Cast are ported (graph JSON and a forward)."""
import importlib
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import name as jname
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.models import resnet as tresnet

jresnet = importlib.import_module("mxnet_tpu.models.resnet")


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _mlp(S):
    data = S.Variable("data")
    x = S.FullyConnected(data, num_hidden=16, name="fc1")
    x = S.Activation(x, act_type="relu", name="relu1")
    x = S.FullyConnected(x, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(x, name="softmax")


def _resnet8(S):
    mod = tresnet if S is tmx.sym else jresnet
    return mod.get_symbol(num_classes=10, num_layers=8, image_shape="3,28,28")


MODELS = {"mlp": (_mlp, (8, 20), 10), "resnet8": (_resnet8, (4, 3, 28, 28), 10)}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _bind_both(model, grad_req="write", batch=None):
    build, dshape, classes = MODELS[model]
    dshape = (batch or dshape[0],) + tuple(dshape[1:])
    with jname.NameManager():
        js = build(jmx.sym)
    with tname.NameManager():
        ts = build(tmx.sym)
    shapes = dict(data=dshape, softmax_label=(dshape[0],))
    jexe = js.simple_bind(jmx.cpu(), grad_req=grad_req, **shapes)
    texe = ts.simple_bind(tmx.cpu(), grad_req=grad_req, **shapes)
    rng = np.random.RandomState(0)
    for name, arr in jexe.arg_dict.items():
        if name == "softmax_label":
            v = rng.randint(0, classes, arr.shape).astype(np.float32)
        elif name.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*arr.shape).astype(np.float32)
        else:
            v = rng.randn(*arr.shape).astype(np.float32) * 0.3
        arr[:] = v
        texe.arg_dict[name][:] = v
    for name, arr in jexe.aux_dict.items():
        v = (np.ones if name.endswith("var") else np.zeros)(arr.shape, np.float32)
        arr[:] = v
        texe.aux_dict[name][:] = v
    return jexe, texe


def _compare(jexe, texe, what, grads=True):
    for i, (t, j) in enumerate(zip(texe.outputs, jexe.outputs)):
        _close(t.asnumpy(), j.asnumpy(), 1e-5, "%s output %d" % (what, i))
    for name, t in texe.aux_dict.items():
        _close(t.asnumpy(), jexe.aux_dict[name].asnumpy(), 1e-5, "%s aux %s" % (what, name))
    if grads:
        for name, t in texe.grad_dict.items():
            j = jexe.grad_dict[name]
            assert (t is None) == (j is None), name
            if t is not None:
                _close(t.asnumpy(), j.asnumpy(), 1e-4, "%s grad %s" % (what, name))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_backward_matches_jax(model):
    jexe, texe = _bind_both(model)
    assert texe.arg_dict.keys() == jexe.arg_dict.keys()
    assert texe.aux_dict.keys() == jexe.aux_dict.keys()
    assert texe.output_dict.keys() == jexe.output_dict.keys()
    for exe in (jexe, texe):
        exe.forward(is_train=True)
        exe.backward()
    _compare(jexe, texe, model)
    for exe in (jexe, texe):  # inference uses the moving stats just written
        exe.forward(is_train=False)
    _compare(jexe, texe, model + " eval", grads=False)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_grad_req_add_and_null_match_jax(model):
    req = {name: ("null" if name in ("data", "softmax_label") or name.endswith("bias")
                  else "add") for name in MODELS[model][0](jmx.sym).list_arguments()}
    jexe, texe = _bind_both(model, grad_req=req)
    for exe in (jexe, texe):
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward()
    _compare(jexe, texe, model + " add")
    assert texe.grad_dict["data"] is None
    name = [n for n in texe.grad_dict if n.endswith("weight")][0]
    assert texe.grad_dict[name] is not None


def test_reshape_and_copy_params_from_match_jax():
    jexe, texe = _bind_both("resnet8")
    for exe in (jexe, texe):
        exe.forward(is_train=True)
        exe.backward()
    j2, t2 = (exe.reshape(data=(2, 3, 28, 28), softmax_label=(2,)) for exe in (jexe, texe))
    assert t2.arg_dict["data"].shape == (2, 3, 28, 28)
    assert t2.arg_dict["conv0_weight"] is texe.arg_dict["conv0_weight"]
    x = np.random.RandomState(1).rand(2, 3, 28, 28).astype(np.float32)
    for exe, pkg in ((j2, jmx), (t2, tmx)):
        exe.forward(is_train=False, data=pkg.nd.array(x))
    _close(t2.outputs[0].asnumpy(), j2.outputs[0].asnumpy(), 1e-5, "reshaped forward")
    _, fresh = _bind_both("resnet8")
    params = {n: a for n, a in texe.arg_dict.items() if n not in ("data",)}
    fresh.copy_params_from(params, texe.aux_dict)
    fresh.forward(is_train=False)
    texe.forward(is_train=False)
    np.testing.assert_array_equal(fresh.outputs[0].asnumpy(), texe.outputs[0].asnumpy())
    with pytest.raises(tmx.MXNetError, match="not in executor"):
        fresh.copy_params_from({"nope": texe.arg_dict["data"]})


def test_bind_forward_backward():
    a, b = tmx.sym.Variable("a"), tmx.sym.Variable("b")
    x = np.random.rand(3, 3).astype(np.float32)
    y = np.random.rand(3, 3).astype(np.float32)
    ga, gb = tmx.nd.zeros((3, 3)), tmx.nd.zeros((3, 3))
    exe = (a * b).bind(tmx.cpu(), {"a": tmx.nd.array(x), "b": tmx.nd.array(y)},
                       args_grad={"a": ga, "b": gb})
    exe.forward(is_train=True)
    np.testing.assert_allclose(exe.outputs[0].asnumpy(), x * y)
    og = np.random.rand(3, 3).astype(np.float32)
    exe.backward(tmx.nd.array(og))
    np.testing.assert_allclose(ga.asnumpy(), og * y, rtol=1e-6)
    np.testing.assert_allclose(gb.asnumpy(), og * x, rtol=1e-6)
    ga2 = tmx.nd.ones((3, 3))
    exe = (a * 2.0).bind(tmx.cpu(), {"a": tmx.nd.array(x)}, args_grad={"a": ga2},
                         grad_req="add")
    exe.forward(is_train=True)
    exe.backward(tmx.nd.ones((3, 3)))
    np.testing.assert_allclose(ga2.asnumpy(), 3 * np.ones((3, 3)))
    gn = tmx.nd.zeros((2,))
    exe = (a + b).bind(tmx.cpu(), {"a": tmx.nd.ones((2,)), "b": tmx.nd.ones((2,))},
                       args_grad={"a": gn}, grad_req={"a": "write", "b": "null"})
    exe.backward(tmx.nd.ones((2,)))  # with no forward first, one is run
    np.testing.assert_allclose(gn.asnumpy(), np.ones(2))


def test_simple_bind_eval_outputs_and_monitor():
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=6, name="fc")
    exe = net.simple_bind(tmx.cpu(), data=(4, 10))
    assert exe.arg_dict["fc_weight"].shape == (6, 10)
    assert exe.grad_dict["fc_weight"].shape == (6, 10)
    exe.arg_dict["fc_weight"][:] = np.random.rand(6, 10).astype(np.float32)
    exe.forward(is_train=True, data=np.random.rand(4, 10).astype(np.float32))
    before = exe.outputs[0].asnumpy().copy()
    exe.backward(tmx.nd.ones((4, 6)))
    np.testing.assert_array_equal(before, exe.outputs[0].asnumpy())
    seen = []
    exe.set_monitor_callback(lambda name, arr: seen.append(name))
    exe.forward()
    assert seen == ["fc_output"] and "FullyConnected fc" in exe.debug_str()
    out = (data * 3.0).eval(tmx.cpu(), data=tmx.nd.ones((2,)))
    np.testing.assert_allclose(out[0].asnumpy(), [3.0, 3.0])
    a = tmx.sym.Variable("a")
    exe = tmx.sym.Group([a * 2.0, a + 1.0]).bind(
        tmx.cpu(), {"a": tmx.nd.ones((2,))}, args_grad={"a": tmx.nd.zeros((2,))})
    exe.forward(is_train=True)
    exe.backward([tmx.nd.ones((2,)), tmx.nd.ones((2,))])
    np.testing.assert_allclose(exe.grad_dict["a"].asnumpy(), 3 * np.ones(2))
    typed = net.simple_bind(tmx.cpu(), type_dict={"data": "float64"}, data=(4, 10))
    assert typed.arg_dict["fc_weight"].dtype == np.float64


def test_creation_op_shape_resolved_at_bind():
    """A ``_zeros`` whose shape has an unknown (0) dim takes it from graph
    inference at bind, as begin-state zeros do in the JAX package."""
    x = np.random.RandomState(4).rand(2, 3).astype(np.float32)
    outs = []
    for pkg in (jmx, tmx):
        net = pkg.sym.Variable("data") + pkg.sym._ones(shape=(0, 3))
        exe = net.simple_bind(pkg.cpu(), data=(2, 3))
        outs.append(exe.forward(data=pkg.nd.array(x))[0].asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], x + 1)


@pytest.mark.parametrize("variant", [dict(stem_s2d=True), dict(dtype="bfloat16")],
                         ids=["stem_s2d", "bfloat16"])
def test_resnet_variants_match_jax(variant):
    """The space-to-depth stem and the bf16 symbol: graph JSON equal to the
    JAX package's, and a forward of ResNet-18 at 1 x 3 x 64 x 64 from the
    same weights within 1e-4 (f32) or 3e-2 of max (bf16)."""
    kwargs = dict(num_classes=10, num_layers=18, image_shape="3,64,64", **variant)
    with jname.NameManager():
        js = jresnet.get_symbol(**kwargs)
    with tname.NameManager():
        ts = tresnet.get_symbol(**kwargs)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    shapes = dict(data=(1, 3, 64, 64), softmax_label=(1,))
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    jt, tt = js.infer_type(data="float32"), ts.infer_type(data="float32")
    assert [np.dtype(t) for t in tt[0]] == [np.dtype(t) for t in jt[0]]
    jexe = js.simple_bind(jmx.cpu(), grad_req="null", type_dict={"data": "float32"}, **shapes)
    texe = ts.simple_bind(tmx.cpu(), grad_req="null", type_dict={"data": "float32"}, **shapes)
    rng = np.random.RandomState(2)
    for name, arr in jexe.arg_dict.items():
        v = rng.rand(*arr.shape).astype(np.float32) if name != "softmax_label" else \
            np.zeros(arr.shape, np.float32)
        if name.endswith("weight"):
            v = (v - 0.5) * 0.2
        arr[:] = v
        texe.arg_dict[name][:] = v
    for name, arr in jexe.aux_dict.items():
        v = (np.ones if name.endswith("var") else np.zeros)(arr.shape, np.float32)
        arr[:] = v
        texe.aux_dict[name][:] = v
    want = jexe.forward(is_train=False)[0].asnumpy()
    got = texe.forward(is_train=False)[0].asnumpy()
    tol = 1e-4 if "dtype" not in variant else 3e-2
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
