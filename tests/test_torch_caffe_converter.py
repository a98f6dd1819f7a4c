"""The port's Caffe converter (``mxnet_tpu_torch.tools.caffe_converter``)
against ``tests/test_caffe_converter.py``'s cases and against the JAX
package's converter (``tools/caffe_converter.py``).

The .caffemodel bytes come from that test's own protobuf writer (varints,
length-delimited messages, packed floats: the wire spec, independent of
both readers), torch's functional ops are the numerical oracle, and for the
same prototxt and caffemodel both converters must give the same graph
(arguments, attributes, inferred shapes), the same params bit for bit and
forward outputs within 1e-5.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.tools import caffe_converter as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sys.path.insert(0, os.path.join(REPO, "tools"))
W = _load("_caffe_wire_writer", os.path.join(REPO, "tests", "test_caffe_converter.py"))
jcc = W.cc  # the JAX package's converter, as its test imports it


@pytest.fixture
def tiny_model(tmp_path):
    """test_caffe_converter.py's tiny_model: conv, relu, ceil-mode pool, BN
    with its Scale, inner product, softmax."""
    rng = np.random.RandomState(0)
    w_conv = rng.randn(4, 3, 3, 3).astype(np.float32) * 0.3
    b_conv = rng.randn(4).astype(np.float32) * 0.1
    bn_mean = rng.randn(4).astype(np.float32) * 0.2
    bn_var = (rng.rand(4).astype(np.float32) + 0.5)
    bn_scale = np.asarray([2.0], np.float32)  # caffe stores mean*factor
    gamma = rng.rand(4).astype(np.float32) + 0.5
    beta = rng.randn(4).astype(np.float32) * 0.1
    w_fc = rng.randn(5, 4 * 4 * 4).astype(np.float32) * 0.1
    b_fc = rng.randn(5).astype(np.float32) * 0.1
    net = (W._s(1, "tiny")
           + W._layer("conv1", "Convolution", [w_conv, b_conv])
           + W._layer("bn1", "BatchNorm", [bn_mean * bn_scale[0], bn_var * bn_scale[0],
                                           bn_scale])
           + W._layer("scale1", "Scale", [gamma, beta])
           + W._layer("fc1", "InnerProduct", [w_fc, b_fc]))
    prototxt = tmp_path / "tiny.prototxt"
    prototxt.write_text(W.PROTOTXT)
    caffemodel = tmp_path / "tiny.caffemodel"
    caffemodel.write_bytes(net)
    weights = dict(w_conv=w_conv, b_conv=b_conv, bn_mean=bn_mean, bn_var=bn_var, gamma=gamma,
                   beta=beta, w_fc=w_fc, b_fc=b_fc)
    return str(prototxt), str(caffemodel), weights


def _x():
    return np.random.RandomState(7).randn(2, 3, 8, 8).astype(np.float32)


def test_convert_model_matches_torch_oracle(tiny_model, tmp_path):
    prototxt, caffemodel, w = tiny_model
    prefix = str(tmp_path / "converted")
    sym, args, auxs = cc.convert_model(prototxt, caffemodel, prefix)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0000.params")
    np.testing.assert_allclose(args["bn1_gamma"].asnumpy(), w["gamma"])
    np.testing.assert_allclose(auxs["bn1_moving_mean"].asnumpy(), w["bn_mean"], rtol=1e-6)
    exe = sym.simple_bind(ctx=tmx.cpu(), data=(2, 3, 8, 8))
    for k, v in args.items():
        exe.arg_dict[k][:] = v.asnumpy()
    for k, v in auxs.items():
        exe.aux_dict[k][:] = v.asnumpy()
    exe.arg_dict["data"][:] = _x()
    got = exe.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, W._torch_forward(_x(), w), rtol=1e-4, atol=1e-5)


def test_converted_checkpoint_loads_as_module(tiny_model, tmp_path):
    prototxt, caffemodel, w = tiny_model
    prefix = str(tmp_path / "ckpt")
    cc.convert_model(prototxt, caffemodel, prefix)
    with tmx.cpu():
        sym, args, auxs = tmx.model.load_checkpoint(prefix, 0)
        mod = tmx.mod.Module(sym, label_names=[], context=tmx.cpu())
        mod.bind(data_shapes=[("data", (2, 3, 8, 8))], for_training=False)
        mod.set_params(args, auxs)
        mod.forward(tmx.io.DataBatch([tmx.nd.array(_x())], []))
        out = mod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(out, W._torch_forward(_x(), w), rtol=1e-4, atol=1e-5)


def test_v1_binary_layers_normalize(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    v1_layer = W._s(4, "conv1") + W._tag(5, 0) + W._varint(4) + W._ld(6, W._blob(w))
    p = tmp_path / "old.caffemodel"
    p.write_bytes(W._s(1, "old") + W._ld(2, v1_layer))
    layers = cc.parse_caffemodel(str(p))
    assert [(lay.name, lay.type) for lay in layers] == [("conv1", "Convolution")]
    np.testing.assert_array_equal(layers[0].blobs[0], w)


def test_v1_prototxt_normalizes():
    proto = cc.parse_prototxt("""
    name: "old"
    input: "data" input_dim: 1 input_dim: 3 input_dim: 4 input_dim: 4
    layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
      convolution_param { num_output: 2 kernel_size: 3 } }
    layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
    layers { name: "loss" type: SOFTMAX_LOSS bottom: "conv1" top: "loss" }
    """)
    assert [lay["type"][-1] for lay in cc._proto_layers(proto)] == [
        "Convolution", "ReLU", "SoftmaxWithLoss"]


def test_convert_mean_roundtrip(tmp_path):
    mean = np.random.RandomState(0).rand(3, 4, 4).astype(np.float32)
    p = tmp_path / "mean.binaryproto"
    p.write_bytes(W._blob(mean))
    nd = cc.convert_mean(str(p), str(tmp_path / "mean.nd"))
    assert nd.context == tmx.cpu()
    np.testing.assert_allclose(nd.asnumpy(), mean)
    with tmx.cpu():
        loaded = tmx.nd.load(str(tmp_path / "mean.nd"))["mean_image"]
    np.testing.assert_allclose(loaded.asnumpy(), mean)
    # the JAX package reads the port's file
    np.testing.assert_array_equal(jmx.nd.load(str(tmp_path / "mean.nd"))["mean_image"].asnumpy(),
                                  mean)


def test_prototxt_parser_roundtrips_structure():
    proto = cc.parse_prototxt(W.PROTOTXT)
    assert proto["name"][-1] == "tiny"
    assert [int(d) for d in proto["input_dim"]] == [2, 3, 8, 8]
    layers = proto["layer"]
    assert [lay["type"][-1] for lay in layers] == [
        "Convolution", "ReLU", "Pooling", "BatchNorm", "Scale", "InnerProduct", "Softmax"]
    assert layers[0]["convolution_param"][-1]["num_output"][-1] == 4


def test_repeated_per_axis_params():
    proto = cc.parse_prototxt("""
    layer { name: "c" type: "Convolution" bottom: "data" top: "c"
      convolution_param { num_output: 2
        kernel_size: 3 kernel_size: 2
        stride: 2 stride: 1
        pad: 1 pad: 0 } }
    """)
    p = proto["layer"][0]["convolution_param"][-1]
    assert cc._xy(p, "kernel_size", "kernel_h", "kernel_w", None) == (3, 2)
    assert cc._xy(p, "stride", "stride_h", "stride_w", (1, 1)) == (2, 1)
    assert cc._xy(p, "pad", "pad_h", "pad_w", (0, 0)) == (1, 0)
    p2 = cc.parse_prototxt('p { kernel_size: 3 kernel_h: 5 kernel_w: 4 }')["p"][-1]
    assert cc._xy(p2, "kernel_size", "kernel_h", "kernel_w", None) == (5, 4)


def test_one_sided_hw_params():
    assert cc._xy({"pad_h": ["2"]}, "pad", "pad_h", "pad_w", (0, 0)) == (2, 0)
    assert cc._xy({"stride_w": ["3"]}, "stride", "stride_h", "stride_w", (1, 1)) == (1, 3)
    assert cc._xy({"kernel_size": ["7"], "kernel_h": ["5"]},
                  "kernel_size", "kernel_h", "kernel_w", None) == (5, 7)
    assert cc._xy({"kernel_w": ["3"]}, "kernel_size", "kernel_h", "kernel_w", None) == (3, 3)


def test_scale_pairs_by_topology_not_file_order(tmp_path):
    prototxt = tmp_path / "two_bn.prototxt"
    prototxt.write_text("""
    name: "twobn"
    input: "data" input_dim: 1 input_dim: 2 input_dim: 4 input_dim: 4
    layer { name: "bn_a" type: "BatchNorm" bottom: "data" top: "a"
      batch_norm_param { use_global_stats: true } }
    layer { name: "bn_b" type: "BatchNorm" bottom: "a" top: "b"
      batch_norm_param { use_global_stats: true } }
    layer { name: "sc" type: "Scale" bottom: "a" top: "a2"
      scale_param { bias_term: true } }
    """)
    gamma = np.asarray([2.0, 3.0], np.float32)
    beta = np.asarray([0.5, -0.5], np.float32)
    zeros2, ones2, one = np.zeros(2, np.float32), np.ones(2, np.float32), np.ones(1, np.float32)
    net = (W._s(1, "twobn") + W._layer("bn_a", "BatchNorm", [zeros2, ones2, one])
           + W._layer("bn_b", "BatchNorm", [zeros2, ones2, one])
           + W._layer("sc", "Scale", [gamma, beta]))
    caffemodel = tmp_path / "two_bn.caffemodel"
    caffemodel.write_bytes(net)
    _, args, _ = cc.convert_model(str(prototxt), str(caffemodel))
    np.testing.assert_allclose(args["bn_a_gamma"].asnumpy(), gamma)
    np.testing.assert_allclose(args["bn_a_beta"].asnumpy(), beta)
    np.testing.assert_allclose(args["bn_b_gamma"].asnumpy(), ones2)


def _graph(sym):
    """(arguments, aux states, outputs, each node's op / name / attributes,
    inferred shapes) of a converted symbol."""
    nodes = [(n["op"], n["name"], n.get("attrs", n.get("attr", {})))
             for n in json.loads(sym.tojson())["nodes"]]
    shapes = sym.infer_shape(data=(2, 3, 8, 8))
    return (sym.list_arguments(), sym.list_auxiliary_states(), sym.list_outputs(), nodes,
            [[tuple(s) for s in group] for group in shapes])


def test_same_conversion_as_the_jax_converter(tiny_model, tmp_path):
    """Both converters on one prototxt and caffemodel: the same graph, the
    same params bit for bit, forwards within 1e-5, and the port's files
    load in the JAX package with equal arrays."""
    prototxt, caffemodel, _ = tiny_model
    # auto-named nodes count up per process: each converter in a fresh NameManager
    with tmx.name.NameManager():
        tsym, targs, tauxs = cc.convert_model(prototxt, caffemodel, str(tmp_path / "t"))
    with jmx.name.NameManager():
        jsym, jargs, jauxs = jcc.convert_model(prototxt, caffemodel, str(tmp_path / "j"),
                                               mx=jmx)
    assert _graph(tsym) == _graph(jsym)
    for mine, theirs in ((targs, jargs), (tauxs, jauxs)):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k].asnumpy(), theirs[k].asnumpy(), err_msg=k)
    outs = []
    for mx, sym, args, auxs in ((tmx, tsym, targs, tauxs), (jmx, jsym, jargs, jauxs)):
        exe = sym.simple_bind(ctx=mx.cpu(), data=(2, 3, 8, 8))
        for k, v in list(args.items()) + list(auxs.items()):
            (exe.arg_dict if k in exe.arg_dict else exe.aux_dict)[k][:] = v.asnumpy()
        exe.arg_dict["data"][:] = _x()
        outs.append(exe.forward(is_train=False)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    loaded = jmx.nd.load(str(tmp_path / "t-0000.params"))
    assert sorted(loaded) == sorted(["arg:" + k for k in targs] + ["aux:" + k for k in tauxs])
    for k, v in loaded.items():
        src = targs if k.startswith("arg:") else tauxs
        np.testing.assert_array_equal(v.asnumpy(), src[k[4:]].asnumpy(), err_msg=k)


def test_main_writes_the_ports_checkpoint(tiny_model, tmp_path, capsys):
    prototxt, caffemodel, w = tiny_model
    prefix = str(tmp_path / "cli")
    assert cc.main([prototxt, caffemodel, prefix]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info == {"symbol": prefix + "-symbol.json", "params": prefix + "-0000.params",
                    "args": 6, "auxs": 2}
    assert cc.main([prototxt]) == 1
