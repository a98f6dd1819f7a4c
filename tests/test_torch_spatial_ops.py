"""The spatial operators of the port's ``ops/spatial.py`` held against the
JAX package's on the CPU: GridGenerator (affine and warp),
BilinearSampler (inside the map, across its border, wholly outside),
SpatialTransformer, Correlation (multiply and subtract, strides, padding,
kernel sizes) and IdentityAttachKLSparseReg (its output, its moving
average written back as an aux state, and its gradient term, which reads
the updated average). Each case feeds the same numpy inputs to each
package's ``fcompute``: outputs within 1e-5 of their max and the gradients
of every input against one random cotangent within 1e-4. The cases of
``tests/test_spatial_ops.py`` run on the port's ``mx.nd`` / ``mx.sym``."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.test_utils import check_numeric_gradient
from test_torch_nn_ops import _close, _run_op

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


_R = np.random.RandomState(11)
THETA = np.array([[0.8, 0.1, 0.05, -0.1, 0.9, -0.05],
                  [1.1, 0.0, 0.2, 0.0, 0.7, 0.1]], np.float32)
CASES = {
    "grid_affine": ("GridGenerator", {"target_shape": (4, 5)}, [THETA], 1),
    "grid_affine_1col": ("GridGenerator", {"target_shape": (3, 1)}, [THETA], 1),
    "grid_warp": ("GridGenerator", {"transform_type": "warp"},
                  [_R.randn(2, 2, 3, 4).astype(np.float32)], 1),
    "sampler_inside": ("BilinearSampler", {}, [_R.randn(2, 3, 6, 5).astype(np.float32),
                                               _R.uniform(-0.9, 0.9, (2, 2, 4, 3))
                                               .astype(np.float32)], 2),
    # corners across the border read 0, each on its own
    "sampler_border": ("BilinearSampler", {}, [_R.randn(1, 2, 5, 5).astype(np.float32),
                                               _R.uniform(-1.4, 1.4, (1, 2, 6, 6))
                                               .astype(np.float32)], 2),
    "sampler_outside": ("BilinearSampler", {}, [_R.randn(1, 1, 4, 4).astype(np.float32),
                                                np.full((1, 2, 2, 2), 3.0, np.float32)], 2),
    "transformer": ("SpatialTransformer", {"target_shape": (5, 6)},
                    [_R.randn(2, 3, 8, 8).astype(np.float32), THETA], 2),
    "correlation": ("Correlation", {"kernel_size": 1, "max_displacement": 2, "pad_size": 2},
                    [_R.randn(1, 4, 7, 7).astype(np.float32),
                     _R.randn(1, 4, 7, 7).astype(np.float32)], 2),
    "correlation_k3": ("Correlation", {"kernel_size": 3, "max_displacement": 1,
                                       "pad_size": 1},
                       [_R.randn(2, 2, 6, 6).astype(np.float32),
                        _R.randn(2, 2, 6, 6).astype(np.float32)], 2),
    "correlation_strides": ("Correlation", {"kernel_size": 3, "max_displacement": 4,
                                            "stride1": 2, "stride2": 2, "pad_size": 4},
                            [_R.randn(1, 3, 9, 10).astype(np.float32),
                             _R.randn(1, 3, 9, 10).astype(np.float32)], 2),
    "correlation_subtract": ("Correlation", {"kernel_size": 1, "max_displacement": 1,
                                             "is_multiply": False},
                             [_R.randn(1, 2, 6, 6).astype(np.float32),
                              _R.randn(1, 2, 6, 6).astype(np.float32)], 2),
    "kl_sparse": ("IdentityAttachKLSparseReg",
                  {"sparseness_target": 0.2, "penalty": 0.01, "momentum": 0.9},
                  [_R.rand(4, 5).astype(np.float32), _R.uniform(0.05, 0.3, 5)
                   .astype(np.float32)], 1),
    "kl_sparse_4d": ("IdentityAttachKLSparseReg", {},
                     [_R.rand(2, 3, 4, 4).astype(np.float32), np.full(3, 0.1, np.float32)], 1),
}


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("cid", sorted(CASES))
def test_forward_and_gradients_match_jax(cid, is_train):
    op, attrs, inputs, n_diff = CASES[cid]
    (jouts, jgrads), (touts, tgrads) = _run_op(op, attrs, inputs, n_diff, is_train)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, FWD_TOL, "%s output %d" % (cid, i))
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _close(t, j, GRAD_TOL, "%s grad of input %d" % (cid, i))


@pytest.mark.parametrize("cid", sorted(CASES))
def test_shape_inference_and_metadata_match_jax(cid):
    op, attrs, inputs, _ = CASES[cid]
    j, t = jreg.get(op), treg.get(op)
    shapes = [x.shape for x in inputs[:len(j.list_arguments())]]
    assert t.infer_shape(t.canon_attrs(attrs), shapes) == j.infer_shape(j.canon_attrs(attrs),
                                                                         shapes)
    assert t.defaults == j.defaults and t.list_auxiliary_states() == j.list_auxiliary_states()


# -- the cases of tests/test_spatial_ops.py on the port --------------------
def _identity_theta(batch):
    return np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (batch, 1))


def test_grid_generator_affine_identity():
    grid = tmx.nd.GridGenerator(tmx.nd.array(_identity_theta(2)), transform_type="affine",
                                target_shape=(4, 5)).asnumpy()
    assert grid.shape == (2, 2, 4, 5)
    np.testing.assert_allclose(grid[0, 0], np.tile(np.linspace(-1, 1, 5), (4, 1)), atol=1e-5)
    np.testing.assert_allclose(grid[0, 1], np.tile(np.linspace(-1, 1, 4)[:, None], (1, 5)),
                               atol=1e-5)


def test_grid_generator_warp_zero_flow():
    grid = tmx.nd.GridGenerator(tmx.nd.zeros((1, 2, 3, 4)), transform_type="warp").asnumpy()
    np.testing.assert_allclose(grid[0, 0], np.tile(np.linspace(-1, 1, 4), (3, 1)), atol=1e-5)


def test_bilinear_sampler_identity_and_grad():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    grid = tmx.nd.GridGenerator(tmx.nd.array(_identity_theta(2)), transform_type="affine",
                                target_shape=(6, 6))
    np.testing.assert_allclose(tmx.nd.BilinearSampler(tmx.nd.array(x), grid).asnumpy(), x,
                               atol=1e-5)
    s = sym.BilinearSampler(sym.Variable("data"), sym.Variable("grid"))
    check_numeric_gradient(s, [rng.randn(1, 2, 5, 5), rng.rand(1, 2, 4, 4) * 1.6 - 0.8],
                           numeric_eps=1e-3, rtol=5e-2, atol=5e-3)


def test_bilinear_sampler_out_of_bounds_zero():
    grid = tmx.nd.array(np.full((1, 2, 2, 2), 3.0, np.float32))
    out = tmx.nd.BilinearSampler(tmx.nd.ones((1, 1, 4, 4)), grid).asnumpy()
    np.testing.assert_allclose(out, np.zeros_like(out))


def test_spatial_transformer_matches_gridgen_plus_sampler():
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    data, theta = tmx.nd.array(x), tmx.nd.array(THETA)
    st = tmx.nd.SpatialTransformer(data, theta, transform_type="affine",
                                   sampler_type="bilinear", target_shape=(5, 6)).asnumpy()
    grid = tmx.nd.GridGenerator(theta, transform_type="affine", target_shape=(5, 6))
    np.testing.assert_allclose(st, tmx.nd.BilinearSampler(data, grid).asnumpy(), atol=1e-5)
    assert st.shape == (2, 3, 5, 6)


def test_spatial_transformer_grad():
    rng = np.random.RandomState(2)
    s = sym.SpatialTransformer(sym.Variable("data"), sym.Variable("loc"), target_shape=(4, 4))
    check_numeric_gradient(s, [rng.randn(1, 2, 5, 5),
                               np.array([[0.9, 0.05, 0.02, -0.03, 0.8, 0.01]])],
                           numeric_eps=1e-3, rtol=5e-2, atol=5e-3)


def test_correlation_forward_and_grad():
    rng = np.random.RandomState(3)
    d1 = rng.randn(1, 4, 10, 10).astype(np.float32)
    a = tmx.nd.array(d1)
    out = tmx.nd.Correlation(a, a, kernel_size=1, max_displacement=2, stride1=1, stride2=1,
                             pad_size=2).asnumpy()
    assert out.shape == (1, 25, 10, 10)
    np.testing.assert_allclose(out[0, 12], (d1[0] ** 2).mean(axis=0), rtol=1e-4, atol=1e-5)
    c = sym.Correlation(sym.Variable("a"), sym.Variable("b"), kernel_size=3, max_displacement=1,
                        stride1=1, stride2=1, pad_size=1)
    check_numeric_gradient(c, [rng.randn(1, 2, 6, 6), rng.randn(1, 2, 6, 6)],
                           numeric_eps=1e-3, rtol=5e-2, atol=5e-3)


def test_correlation_subtract_mode():
    a = tmx.nd.array(np.random.RandomState(4).randn(1, 2, 6, 6).astype(np.float32))
    out = tmx.nd.Correlation(a, a, kernel_size=1, max_displacement=0, is_multiply=False)
    np.testing.assert_allclose(out.asnumpy(), 0.0, atol=1e-6)


def test_identity_attach_kl_sparse_reg():
    """Through an executor: the moving average lands in the aux array and
    the gradient reads the updated average."""
    rng = np.random.RandomState(5)
    y = sym.IdentityAttachKLSparseReg(sym.Variable("x"), sparseness_target=0.2, penalty=0.01,
                                      momentum=0.9)
    ex = y.simple_bind(tmx.cpu(), x=(4, 5), grad_req="write")
    xin = rng.rand(4, 5).astype(np.float32)
    ex.arg_dict["x"][:] = xin
    ex.forward(is_train=True)
    np.testing.assert_allclose(ex.outputs[0].asnumpy(), xin, atol=1e-6)
    avg = ex.aux_dict[y.list_auxiliary_states()[0]].asnumpy()
    np.testing.assert_allclose(avg, 0.1 * xin.mean(axis=0), rtol=1e-5)
    ex.backward(tmx.nd.ones((4, 5)))
    rho, rho_hat = 0.2, 0.1 * xin.mean(axis=0)
    expect = 1.0 + 0.01 * (-rho / (rho_hat + 1e-8) + (1 - rho) / (1 - rho_hat + 1e-8))
    np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), np.tile(expect, (4, 1)), rtol=1e-4)
