"""The PyTorch port's ResNet path held against the JAX package on the CPU:
every ported operator forward and backward (through each package's own
registry), residual units through both graph programs, and the ResNet-50
bench step of ``bench.py`` (``_build_resnet50_step``) ported both ways and
run on a cifar ResNet-8 for three SGD-momentum steps in f32, and one step
in bf16. The JAX side runs its Pallas conv-backward pair in interpret mode
(``MXTPU_CONV_KERNEL=pallas``), the port the plain versions of K2/K3."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import name as jname
from mxnet_tpu import symbol as jsym
from mxnet_tpu.executor import _GraphProgram as JProgram
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.executor import _GraphProgram as TProgram
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.tools import resnet_bench

jresnet = importlib.import_module("mxnet_tpu.models.resnet")


@pytest.fixture(autouse=True)
def _pallas_on(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_KERNEL", "pallas")
    pk._conv_plan_cache.clear()
    yield
    pk._conv_plan_cache.clear()


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _run_op(name, attrs, inputs, n_diff, is_train=True, seed=0):
    """All outputs, and the gradients of the differentiable inputs (the first
    ``n_diff``) against one random cotangent of output 0, of op ``name`` in
    each package. Returns ((jax outs, jax grads), (port outs, port grads))."""
    jop, top = jreg.get(name), treg.get(name)
    jattrs, tattrs = jop.canon_attrs(attrs), top.canon_attrs(attrs)
    jin = [jnp.asarray(x) for x in inputs]

    def first(*diff):
        return jop.fcompute(jattrs, list(diff) + jin[n_diff:], is_train)[0]

    jouts = jop.fcompute(jattrs, jin, is_train)
    cot = np.random.RandomState(seed + 1).randn(*jouts[0].shape).astype(np.float32)
    _, vjp = jax.vjp(first, *jin[:n_diff])
    jgrads = vjp(jnp.asarray(cot, jouts[0].dtype))
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs[:n_diff]]
    rest = [torch.from_numpy(np.array(x)) for x in inputs[n_diff:]]
    touts = top.fcompute(tattrs, leaves + rest, is_train)
    tgrads = torch.autograd.grad(touts[0], leaves, torch.from_numpy(cot), allow_unused=True)
    tgrads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, tgrads)]
    return ((jouts, jgrads), ([o.detach().numpy() for o in touts],
                              [g.numpy() for g in tgrads]))


def _check_op(name, attrs, inputs, n_diff, tol=1e-5, **kw):
    (jouts, jgrads), (touts, tgrads) = _run_op(name, attrs, inputs, n_diff, **kw)
    assert len(jouts) == len(touts), (len(jouts), len(touts))
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, tol, "%s output %d" % (name, i))
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _close(t, j, tol, "%s grad of input %d" % (name, i))


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu", "softsign"])
def test_activation_matches_jax(act):
    _check_op("Activation", {"act_type": act}, [_randn(2, 3, 4, 5)], 1)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_matches_jax(no_bias):
    ins = [_randn(4, 3, 2, 2, seed=1), _randn(6, 12, seed=2)]
    if not no_bias:
        ins.append(_randn(6, seed=3))
    _check_op("FullyConnected", {"num_hidden": 6, "no_bias": no_bias}, ins, len(ins))


def test_elemwise_add_and_flatten_match_jax():
    _check_op("elemwise_add", {}, [_randn(2, 3, 4), _randn(2, 3, 4, seed=1)], 2)
    _check_op("_plus", {}, [_randn(2, 3), _randn(2, 3, seed=1)], 2)
    _check_op("Flatten", {}, [_randn(2, 3, 4, 5)], 1)


@pytest.mark.parametrize("attrs,dshape", [
    ({"kernel": (3, 3), "pad": (1, 1), "num_filter": 16, "no_bias": True}, (2, 8, 9, 9)),
    ({"kernel": (1, 1), "num_filter": 8}, (2, 16, 7, 5)),
    ({"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3), "num_filter": 8, "no_bias": True},
     (2, 3, 16, 16)),
    ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 8}, (2, 8, 9, 9)),
])
def test_convolution_matches_jax(attrs, dshape):
    """In-envelope shapes (the first two) run the conv-backward pair in both
    packages; the strided ones autograd's / XLA's own gradient."""
    kh, kw = attrs["kernel"]
    o = attrs["num_filter"]
    ins = [_randn(*dshape, seed=4), _randn(o, dshape[1], kh, kw, seed=5, scale=0.1)]
    if not attrs.get("no_bias"):
        ins.append(_randn(o, seed=6))
    _check_op("Convolution", attrs, ins, len(ins))


@pytest.mark.parametrize("attrs,dshape", [
    ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"}, (2, 4, 9, 9)),
    ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg"}, (2, 4, 9, 8)),
    ({"global_pool": True, "kernel": (7, 7), "pool_type": "avg"}, (2, 4, 5, 6)),
    ({"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
      "pooling_convention": "full"}, (2, 4, 8, 8)),
    ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
      "pooling_convention": "full"}, (2, 4, 8, 10)),
    ({"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum"}, (1, 2, 6, 6)),
])
def test_pooling_matches_jax(attrs, dshape):
    _check_op("Pooling", attrs, [_randn(*dshape, seed=7)], 1)


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batch_norm_matches_jax(is_train, fix_gamma):
    """Output, batch mean and var, and the new moving stats; gradients of
    data, gamma (zero under fix_gamma) and beta. Moving stats that are not
    0 and 1, and an input with a mean, so each term shows."""
    c = 6
    ins = [_randn(4, c, 5, 3, seed=8) * 2.0 + 0.5,
           1.0 + _randn(c, seed=9, scale=0.2), _randn(c, seed=10, scale=0.3),
           _randn(c, seed=11, scale=0.1), 1.0 + np.abs(_randn(c, seed=12, scale=0.3))]
    attrs = {"fix_gamma": fix_gamma, "eps": 2e-5, "momentum": 0.9}
    _check_op("BatchNorm", attrs, ins, 3, is_train=is_train)


@pytest.mark.parametrize("attrs", [
    {},
    {"grad_scale": 0.5, "normalization": "batch"},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
])
def test_softmax_output_gradient_matches_jax(attrs):
    """The backward ignores the cotangent: softmax − onehot(int(label))."""
    label = np.array([0, 2, 4, 2, 1], np.float32)
    _check_op("SoftmaxOutput", attrs, [_randn(5, 5, seed=13), label], 1)


def _unit(S, stride, bottle_neck):
    mod = tresnet if S is tsym else jresnet
    data = S.Variable("data")
    return mod.residual_unit(data, 32, (stride, stride), False, "u",
                             bottle_neck=bottle_neck)


def _random_params(symbol, data_shape, seed):
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n.endswith("_gamma"):
            args[n] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            args[n] = (rng.randn(*s) * (0.2 if n.endswith("_weight") else 1.0)).astype(
                np.float32)
    aux = {n: (0.1 * rng.randn(*s) if n.endswith("mean") else 1.0 + np.abs(rng.randn(*s)))
           .astype(np.float32) for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("bottle_neck", [True, False])
def test_residual_unit_matches_jax(stride, bottle_neck):
    data_shape = (2, 16, 16, 16)
    with jname.NameManager():
        js = _unit(jsym, stride, bottle_neck)
    with tname.NameManager():
        ts = _unit(tsym, stride, bottle_neck)
    assert ts.list_arguments() == js.list_arguments()
    args, aux = _random_params(ts, data_shape, seed=14)
    out_shape = ts.infer_shape(data=data_shape)[1][0]
    cot = _randn(*out_shape, seed=15)
    names = list(args)

    def jf(*vals):
        outs, new_aux = JProgram(js)(dict(zip(names, vals)),
                                     {n: jnp.asarray(v) for n, v in aux.items()}, None, True)
        return outs[0], new_aux

    jargs = [jnp.asarray(args[n]) for n in names]
    jout, jaux = jf(*jargs)
    _, vjp = jax.vjp(lambda *v: jf(*v)[0], *jargs)
    jgrads = vjp(jnp.asarray(cot))
    leaves = {n: torch.from_numpy(v).requires_grad_() for n, v in args.items()}
    touts, taux = TProgram(ts)(leaves, {n: torch.from_numpy(v) for n, v in aux.items()},
                               None, True)
    tgrads = torch.autograd.grad(touts[0], [leaves[n] for n in names], torch.from_numpy(cot))
    _close(touts[0].detach().numpy(), jout, 1e-4, "output")
    for n in aux:
        _close(taux[n].detach().numpy(), jaux[n], 1e-4, n)
    for n, t, j in zip(names, tgrads, jgrads):
        _close(t.numpy(), j, 1e-4, "grad " + n)


def _jax_bench_step(program, batch, bf16):
    """bench.py:836-857, the JAX bench's train_step."""
    lr, momentum, wd = 0.1, 0.9, 1e-4
    rescale = 1.0 / batch

    def train_step(params, moms, aux, data, label):
        def loss_fn(ps):
            if bf16:
                ps = {n: v.astype(jnp.bfloat16) for n, v in ps.items()}
            args = dict(ps)
            args["data"] = data.astype(jnp.bfloat16) if bf16 else data
            args["softmax_label"] = label
            outs, new_aux = program(args, aux, None, True)
            return jnp.sum(outs[0].astype(jnp.float32)), new_aux

        grads, new_aux = jax.grad(loss_fn, has_aux=True)(params)
        new_params, new_moms = {}, {}
        for n in params:
            g = grads[n] * rescale + wd * params[n]
            m = momentum * moms[n] - lr * g
            new_params[n] = params[n] + m
            new_moms[n] = m
        return new_params, new_moms, new_aux

    return jax.jit(train_step)


STEP_THREADS = 8


@pytest.fixture
def _steady_threads():
    """The step tests hold cancelling gradient sums (bn_data_beta's) to
    1e-4 after three steps. Both packages' CPU convolutions split their
    sums over the OpenMP threads that ``torch.set_num_threads`` sets for
    the whole process, JAX's included, so the last bits, and after three
    steps the whole comparison, depend on that count. Pin it for these
    tests, and restore it after."""
    before = torch.get_num_threads()
    torch.set_num_threads(STEP_THREADS)
    yield
    torch.set_num_threads(before)


def _both_steps(bf16, steps):
    """The cifar ResNet-8 bench step in both packages from the same weights
    and batch: (jax state, port state) after ``steps`` steps."""
    batch, shape = 4, (3, 28, 28)
    kwargs = dict(num_layers=8, num_classes=10, image_shape="3,28,28")
    with jname.NameManager():
        js = jresnet.get_symbol(**kwargs)
    step, (params, moms, aux), data, label, ts = resnet_bench.build_step(
        batch, bf16, "cpu", num_layers=8, num_classes=10, image_shape=shape)
    assert ts.list_arguments() == js.list_arguments()
    jstep = _jax_bench_step(JProgram(js), batch, bf16)
    jstate = tuple({n: jnp.asarray(v.detach().numpy()) for n, v in d.items()}
                   for d in (params, moms, aux))
    jdata, jlabel = jnp.asarray(data.numpy()), jnp.asarray(label.numpy())
    for _ in range(steps):
        jstate = jstep(*jstate, jdata, jlabel)
        aux, _ = step(params, moms, aux, data, label)
    return jstate, (params, moms, aux)


def test_bench_step_matches_jax_for_three_steps_f32(_steady_threads):
    (jp, jm, ja), (tp, tm, ta) = _both_steps(False, 3)
    assert set(tp) == set(jp) and set(ta) == set(ja)
    for group, tgroup, jgroup in (("param", tp, jp), ("momentum", tm, jm), ("aux", ta, ja)):
        for n in tgroup:
            _close(tgroup[n].detach().numpy(), jgroup[n], 1e-4, "%s %s" % (group, n))


def _ulp(x):
    """One bf16 ulp at the largest magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(x).max()), 1e-30))) - 7)


def test_bench_step_bf16_matches_jax_within_bf16_rounding(_steady_threads):
    """One step of the bf16 recipe. The forward's softmax output agrees
    within two bf16 ulps of its max. The momenta (lr times the step's
    gradient) and the new aux cannot agree to an ulp of their max: at
    random init the gradients are sums with heavy cancellation, so bf16
    rounding moves them by 10-25% of their max in either package (measured
    against the f32 step). Each is held within twice the distance of JAX's
    own bf16 step from its f32 step, plus one ulp; and the port's bf16 step
    must differ from its f32 step (the casts took effect)."""
    (_, jm, ja), (_, tm, ta) = _both_steps(True, 1)
    (_, fm, fa), (_, pm, _) = _both_steps(False, 1)
    for group, tgroup, jgroup, fgroup in (("momentum", tm, jm, fm), ("aux", ta, ja, fa)):
        for n in tgroup:
            got = tgroup[n].detach().float().numpy()
            want = np.asarray(jgroup[n], np.float32)
            noise = np.abs(want - np.asarray(fgroup[n], np.float32)).max()
            bound = 2.0 * noise + _ulp(want)
            assert np.abs(got - want).max() <= bound, (group, n, np.abs(got - want).max(), bound)
    assert any(not torch.equal(tm[n], pm[n]) for n in tm)


def test_bench_forward_bf16_matches_jax_within_two_ulps():
    batch, kwargs = 4, dict(num_layers=8, num_classes=10, image_shape="3,28,28")
    with jname.NameManager():
        js = jresnet.get_symbol(**kwargs)
    _, (params, _, aux), data, label, ts = resnet_bench.build_step(
        batch, True, "cpu", num_layers=8, num_classes=10, image_shape=(3, 28, 28))
    args = {n: p.detach().to(torch.bfloat16) for n, p in params.items()}
    args.update(data=data.to(torch.bfloat16), softmax_label=label)
    got = TProgram(ts)(args, aux, None, True)[0][0].float().numpy()
    jargs = {n: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for n, v in args.items()
             if n != "softmax_label"}
    jargs["softmax_label"] = jnp.asarray(label.numpy())
    want = np.asarray(JProgram(js)(jargs, {n: jnp.asarray(v.numpy()) for n, v in aux.items()},
                                   None, True)[0][0], np.float32)
    assert np.abs(got - want).max() <= 2 * _ulp(want), (np.abs(got - want).max(), _ulp(want))


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::conv_wgrad_kernel<__nv_bfloat16>(...)", "conv_bwd_filter"),
    ("void (anonymous namespace)::conv_dgrad_kernel<float>(...)", "conv_bwd_input"),
    ("void sm90::(anonymous namespace)::conv_dgrad_sm90<128>(CUtensorMap_st, ...)",
     "conv_bwd_input"),
    ("sm90::(anonymous namespace)::transpose_bf16(unsigned short const*, ...)", "conv_layout"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, ...>", "cudnn_conv_fwd"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cudnn_conv_bwd"),
    ("void sm90::(anonymous namespace)::conv_wgrad_sm90<128, 1>(CUtensorMap_st, ...)",
     "conv_bwd_filter"),
    ("(anonymous namespace)::conv_wgrad_reduce_kernel(float const*, float*, int, int, long long)",
     "conv_bwd_filter"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cudnn_conv_bwd"),
])
def test_bench_kernel_families(name, fam):
    """The ResNet trace's kernel families, on kernel names an H100 run
    reports: the Hopper kernels of K2 and K3 count as K2 and K3, their
    layout transposes (shared since the backward hands one channels-last
    gradient to both) as a family of their own, cuDNN's as cuDNN's."""
    assert resnet_bench.family(name) == fam
