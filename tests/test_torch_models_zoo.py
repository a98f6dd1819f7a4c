"""The port's image-classification zoo held against the JAX package on the
CPU: alexnet, vgg-16, googlenet, inception-bn, inception-v3,
inception-resnet-v2 and resnext-50. At each model's published batch and
image size: the argument and aux names and every inferred shape equal
JAX's, and so does the decision of every convolution's gradient path
(``conv_bwd_plan``, f32 and bf16), whose counts are pinned. At each model's
smallest input (batch 2): the forward, every parameter gradient and the new
aux states through ``params_from_numpy`` against JAX's ``_GraphProgram`` on
the same numpy parameters, within 1e-4 of each tensor's max, with Dropout's
p set to 0 through the symbol JSON in both packages. The JAX side takes
XLA's convolution gradients (its Pallas pair is held to the port's plain
K2/K3 in ``test_torch_conv_kernels.py``), the port its plain K2/K3.
``tools.model_sweep --cpu --smoke`` runs."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import name as jname
from mxnet_tpu import symbol as jsym
from mxnet_tpu.executor import _GraphProgram as JProgram
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.executor import _GraphProgram as TProgram
from mxnet_tpu_torch.models import common
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.tools import model_sweep

# name -> (module, get_symbol kwargs, published batch, published side, smallest
# side, convolutions, in the K2/K3 envelope in f32, in bf16)
ZOO = {
    "alexnet": ("alexnet", {}, 512, 224, 67, 5, 4, 4),
    "vgg-16": ("vgg", {"num_layers": 16}, 32, 224, 32, 13, 7, 10),
    "googlenet": ("googlenet", {}, 32, 224, 64, 57, 56, 56),
    "inception-bn": ("inception_bn", {}, 32, 224, 64, 69, 64, 64),
    "inception-v3": ("inception_v3", {}, 32, 299, 75, 94, 89, 89),
    "inception-resnet-v2": ("inception_resnet_v2", {}, 32, 299, 75, 244, 237, 237),
    "resnext-50": ("resnext", {"num_layers": 50}, 32, 224, 64, 53, 33, 33),
}


def _model_modules(module):
    return (importlib.import_module("mxnet_tpu.models." + module),
            importlib.import_module("mxnet_tpu_torch.models." + module))


def _symbols(name, side, num_classes=1000):
    """The model in both packages, each built in a fresh NameManager (auto
    names count per process)."""
    module, kwargs = ZOO[name][:2]
    jmod, tmod = _model_modules(module)
    if "image_shape" in tmod.get_symbol.__code__.co_varnames:
        kwargs = dict(kwargs, image_shape="3,%d,%d" % (side, side))
    with jname.NameManager():
        js = jmod.get_symbol(num_classes=num_classes, **kwargs)
    with tname.NameManager():
        ts = tmod.get_symbol(num_classes=num_classes, **kwargs)
    return js, ts


def _jax_conv_layers(symbol, data_shape):
    known = symbol._infer_shape_impl(
        False, data=data_shape, softmax_label=(data_shape[0],))[3]
    out = []
    for node in symbol._nodes():
        if node.is_variable or node.op.name != "Convolution":
            continue
        attrs = node.canon_attrs()
        pad = tuple(attrs.get("pad") or (0, 0))
        stride = tuple(attrs.get("stride") or (1, 1))
        dilate = tuple(attrs.get("dilate") or (1, 1))
        (d, di), (w, wi) = node.inputs[0], node.inputs[1]
        out.append((node.name, tuple(known[(id(d), di)]), tuple(known[(id(w), wi)]), stride,
                    pad, dilate))
    return out


@pytest.mark.parametrize("name", sorted(ZOO))
def test_names_and_shapes_match_jax_at_the_published_size(name):
    _, _, batch, side = ZOO[name][:4]
    js, ts = _symbols(name, side)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    shapes = dict(data=(batch, 3, side, side), softmax_label=(batch,))
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_every_convolution_takes_the_gradient_path_jax_takes(name):
    """Per convolution at the published size, f32 and bf16: the port's
    ``conv_bwd_plan`` decides as JAX's does, and the counts are the ones
    K2/K3's launches a step are held to on the card."""
    _, _, batch, side, _, n_convs, n_f32, n_bf16 = ZOO[name]
    js, ts = _symbols(name, side)
    shape = (batch, 3, side, side)
    jlayers = _jax_conv_layers(js, shape)
    tlayers = common.conv_layers(ts, shape)
    assert len(jlayers) == len(tlayers) == n_convs
    for dtype, count in (("float32", n_f32), ("bfloat16", n_bf16)):
        jin, tin = [], []
        for (lname, d, w, s, p, dl), layer in zip(jlayers, tlayers):
            assert (lname, d, w, s, p, dl) == (
                layer["name"], layer["data"], layer["weight"], layer["stride"], layer["pad"],
                layer["dilate"])
            if pk.conv_bwd_plan(d, w, s, p, dl, dtype) is not None:
                jin.append(lname)
            if kernels.conv_bwd_plan(d, w, s, p, dl, dtype):
                tin.append(lname)
        assert jin == tin and len(tin) == count, (dtype, len(jin), len(tin))
        assert model_sweep.in_envelope_convs(ts, shape, dtype) == count


def _steady(symbol, package):
    """``symbol`` with every Dropout's p set to 0 and every BatchNorm on its
    moving statistics (``use_global_stats``), through its JSON."""
    graph = json.loads(symbol.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node.setdefault("attr", {})["p"] = "0"
        if node["op"] == "BatchNorm":
            node.setdefault("attr", {})["use_global_stats"] = "True"
    return package.load_json(json.dumps(graph))


def _rel(got, want):
    """max|got - want| / max|want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(np.abs(got).max())


def _jax_step(js, names):
    """JAX's forward and gradients of the summed SoftmaxOutput, jitted:
    (data, label, aux, *params) -> (grads, (output, new aux))."""

    def loss(data, label, aux, *vals):
        args = dict(zip(names, vals), data=data, softmax_label=label)
        outs, new_aux = JProgram(js)(args, aux, jax.random.PRNGKey(0), True)
        return jnp.sum(outs[0]), (outs[0], new_aux)

    return jax.jit(jax.grad(loss, argnums=tuple(range(3, 3 + len(names))), has_aux=True))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_forward_and_gradients_match_jax_at_the_smallest_size(name):
    """Batch 2 at the model's smallest side, in training mode: the softmax
    output and every parameter gradient within 1e-4 of its max. Dropout
    (alexnet, vgg, inception-resnet-v2) is the identity at p = 0 in both
    packages, and BatchNorm normalizes with its moving statistics: with
    batch statistics over the 2 to 8 values a channel that the last stages
    hold at this size, the gradients are chaotic, JAX's own moving by more
    than 1e-4 of their max for most tensors when the data moves by one f32
    ulp, so no two f32 implementations agree there. Training-mode
    BatchNorm is held to JAX op by op (``test_torch_resnet.py``) and
    through the ResNet step. A ReLU or max-pool input that f32 rounding
    leaves on either side of a tie is a kink of the gradient: JAX runs at
    the data and at the data moved by one ulp, and the port's output and
    gradients must all be within 1e-4 of one of the two runs."""
    side = ZOO[name][4]
    js, ts = _symbols(name, side, num_classes=10)
    js, ts = _steady(js, jsym), _steady(ts, tsym)
    shape = (2, 3, side, side)
    arg_np, aux_np = common.init_params(ts, shape, seed=0)
    data = np.random.RandomState(1).rand(*shape).astype(np.float32)
    label = np.array([3, 7], np.float32)
    names = list(arg_np)
    jstep = _jax_step(js, names)
    jaux = {n: jnp.asarray(v) for n, v in aux_np.items()}

    def jax_run(x):
        grads, (out, _) = jstep(jnp.asarray(x), jnp.asarray(label), jaux,
                                *[jnp.asarray(arg_np[n]) for n in names])
        return [out] + list(grads)

    params, aux = common.params_from_numpy(arg_np, aux_np, "cpu")
    for p in params.values():
        p.requires_grad_()
    args = dict(params, data=torch.from_numpy(data), softmax_label=torch.from_numpy(label))
    touts, _ = TProgram(ts)(args, aux, torch.Generator().manual_seed(0), True)
    tgrads = torch.autograd.grad(touts[0].sum(), [params[n] for n in names], allow_unused=True)
    got = [touts[0].detach()] + [torch.zeros_like(params[n]) if g is None else g
                                 for n, g in zip(names, tgrads)]
    keys = ["output"] + ["grad " + n for n in names]
    worst = []
    for x in (data, np.nextafter(data, np.float32(2.0))):
        errs = [_rel(t.numpy(), j) for t, j in zip(got, jax_run(x))]
        worst.append(max(zip(errs, keys)))
        if worst[-1][0] <= 1e-4:
            return
    raise AssertionError("worst error of max against JAX at the data and one ulp on: %s"
                         % worst)


def test_model_sweep_smoke_runs_on_the_host(capsys):
    """``python -m mxnet_tpu_torch.tools.model_sweep --cpu --smoke``: the
    sweep's first model, inception-bn, at batch 2 and 64 x 64 in f32 and
    bf16, each with a finite loss."""
    assert model_sweep.main(["--cpu", "--smoke", "--steps", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r["model"], r["dtype"], r["batch"]) for r in res["rows"]] == [
        ("inception-bn", "float32", 2), ("inception-bn", "bfloat16", 2)]
    for row in res["rows"]:
        assert np.isfinite([row["first_loss"], row["last_loss"]]).all()
        assert row["in_envelope_convs"] == 64


def test_model_sweep_table_is_the_jax_sweeps():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "model_sweep.py")
    spec = importlib.util.spec_from_file_location("jax_model_sweep", path)
    jsweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsweep)
    assert model_sweep.MODELS == jsweep.MODELS
