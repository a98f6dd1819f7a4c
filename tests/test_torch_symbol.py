"""The PyTorch port's Symbol layer held against the JAX package: the
listings, shape and type inference and graph JSON of ResNet-50 and a cifar
ResNet-20 built by both packages, JSON carried across in both directions,
automatic names, the attribute helpers and scopes, and the refusals of
what is not ported yet (other operators, placement over several devices,
mirroring)."""
import importlib
import json

import numpy as np
import pytest

from mxnet_tpu import attribute as jattribute
from mxnet_tpu import base as jbase
from mxnet_tpu import name as jname
from mxnet_tpu import symbol as jsym
from mxnet_tpu_torch import attribute as tattribute
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import context as tcontext
from mxnet_tpu_torch import executor as texecutor
from mxnet_tpu_torch import ndarray as tndarray
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.models import resnet as tresnet

jresnet = importlib.import_module("mxnet_tpu.models.resnet")

MODELS = {
    "resnet50": (dict(num_layers=50, num_classes=1000, image_shape="3,224,224"),
                 (2, 3, 224, 224)),
    "cifar-resnet20": (dict(num_layers=20, num_classes=10, image_shape="3,28,28"),
                       (4, 3, 28, 28)),
}


def _both(model):
    kwargs, shape = MODELS[model]
    with jname.NameManager():
        js = jresnet.get_symbol(**kwargs)
    with tname.NameManager():
        ts = tresnet.get_symbol(**kwargs)
    return js, ts, shape


def _listing(s):
    return s.list_arguments(), s.list_auxiliary_states(), s.list_outputs()


def _shapes(s, shape):
    return s.infer_shape(data=shape, softmax_label=(shape[0],))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_resnet_listing_and_shapes_match_jax(model):
    js, ts, shape = _both(model)
    assert _listing(ts) == _listing(js)
    assert _shapes(ts, shape) == _shapes(js, shape)
    partial = dict(data=(0,) + shape[1:])
    assert ts.infer_shape_partial(**partial) == js.infer_shape_partial(**partial)
    jt = js.infer_type(data="float32")
    tt = ts.infer_type(data="float32")
    assert [np.dtype(t) for t in tt[0]] == [np.dtype(t) for t in jt[0]]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_resnet_json_matches_jax(model):
    js, ts, _ = _both(model)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_json_crosses_packages_both_ways(model):
    js, ts, shape = _both(model)
    from_jax = tsym.load_json(js.tojson())
    assert _listing(from_jax) == _listing(js)
    assert _shapes(from_jax, shape) == _shapes(js, shape)
    assert json.loads(from_jax.tojson()) == json.loads(js.tojson())
    from_port = jsym.load_json(ts.tojson())
    assert _listing(from_port) == _listing(ts)
    assert _shapes(from_port, shape) == _shapes(ts, shape)


def _small_graph(S):
    data = S.Variable("data")
    x = S.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1))
    x = S.BatchNorm(x)
    x = S.Activation(x, act_type="relu")
    y = S.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    z = S.Pooling(x, global_pool=True, pool_type="avg")
    x = S.Flatten(y) + S.Flatten(S.Pooling(y, kernel=(4, 4), pool_type="avg"))
    x = S.FullyConnected(x, num_hidden=5)
    return S.Group([S.SoftmaxOutput(x), S.Flatten(z)])


def test_automatic_names_match_jax():
    with jname.NameManager():
        js = _small_graph(jsym)
    with tname.NameManager():
        ts = _small_graph(tsym)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    assert _listing(ts) == _listing(js)
    assert "pooling0_output" not in ts.list_outputs()
    names = [n["name"] for n in json.loads(ts.tojson())["nodes"]]
    for want in ("convolution0", "batchnorm0", "activation0", "pooling0", "pooling2",
                 "flatten0", "elemwise_add0", "fullyconnected0", "softmaxoutput0"):
        assert want in names, names
    with tname.Prefix("net_"), jname.Prefix("net_"):
        assert tsym.Flatten(tsym.Variable("a")).name == jsym.Flatten(jsym.Variable("a")).name


def test_attr_helpers_and_scopes_match_jax():
    for v in ("(2,2)", "True", "false", "None", "0.9", "relu", "(100,)", 3, (1, 2)):
        assert tbase.parse_attr_value(v) == jbase.parse_attr_value(v)
    for v in (True, None, (1, 2), [3], 0.5, "avg"):
        assert tbase.attr_repr(v) == jbase.attr_repr(v)
    for d in ("float32", "float16", "int32", 0, 4, np.int64):
        assert tbase.np_dtype(d) == jbase.np_dtype(d)
        assert tbase.dtype_name(d) == jbase.dtype_name(d)
    with tattribute.AttrScope(ctx_group="dev1"), jattribute.AttrScope(ctx_group="dev1"):
        ts = tsym.Activation(tsym.Variable("x"), name="a")
        js = jsym.Activation(jsym.Variable("x"), name="a")
    assert ts.attr_dict() == js.attr_dict() and ts.attr("ctx_group") == "dev1"
    assert tattribute.AttrScope.current().get(None) == {}


def test_composition_and_arithmetic():
    with tname.NameManager():
        a, b = tsym.Variable("a"), tsym.Variable("b")
        net = tsym.Activation(tsym.Variable("x"), name="act")
        composed = net(x=a + b)
    assert composed.list_arguments() == ["a", "b"]
    assert composed.infer_shape(a=(2, 3), b=(2, 3))[1] == [(2, 3)]
    assert list(composed.get_internals().list_outputs()) == [
        "a", "b", "elemwise_add0_output", "act_output"]


def test_what_is_not_ported_raises(monkeypatch):
    a = tsym.Variable("a")
    with pytest.raises(tbase.MXNetError, match="not ported"):
        tsym.load_json(jsym.BilinearSampler(jsym.Variable("a"), jsym.Variable("g")).tojson())
    with pytest.raises(AttributeError, match="mxnet_tpu/ops/"):
        tsym.BilinearSampler  # noqa: B018
    net = (a * 2).__copy__()
    net._set_attr(ctx_group="dev1")
    with pytest.raises(NotImplementedError, match="_PlacedProgram"):
        net.bind(tcontext.cpu(), {"a": tndarray.ones((2,), ctx=tcontext.cpu())},
                 group2ctx={"dev1": tcontext.gpu(1)})
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    with pytest.raises(NotImplementedError, match="_mirror_policy"):
        net.simple_bind(tcontext.cpu(), a=(2,))
    with pytest.raises(tbase.MXNetError, match="missing input"):
        texecutor._GraphProgram(tsym.Activation(a))({}, {}, None, True)
