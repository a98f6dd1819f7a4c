"""The port's convolution examples (``mxnet_tpu_torch/examples/``:
stochastic_depth, cnn_text_classification, train_mnist) and
dec_clustering against their JAX twins under ``examples/`` on the CPU: the
same symbols and the first three steps on the same batches from the same
parameters within 1e-5 (f32 losses, relative); the deterministic runs'
outcomes in the ``slow`` tier.
Where the framework's generator enters (stochastic depth's gates,
dropout), the steps are held with it out of play (p_survive 1, dropout 0)
and the run itself by repeat from one seed and by its own outcome."""
import argparse

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import cnn_text_classification, common, dec_clustering
from mxnet_tpu_torch.examples import stochastic_depth, train_mnist
from torch_example_parity import one_thread  # noqa: F401 (autouse)
from torch_example_parity import (assert_same_symbol, batches, ce, fresh, jax_example, mean_out,
                                  mse, run_port, train_steps)

STEPS = 3


def _digit_images():
    d = common.load_digits()
    return (d.images / 16.0).astype(np.float32).reshape(-1, 1, 8, 8), d.target.astype(np.float32)


def test_stochastic_depth_matches_jax():
    j = jax_example("stochastic_depth")
    for stochastic in (True, False):
        assert_same_symbol(fresh(tmx, stochastic_depth.build, 3, 0.75, stochastic),
                           fresh(jmx, j.build, 3, 0.75, stochastic),
                           data=(100, 1, 8, 8), softmax_label=(100,))
    # p_survive 1: every gate is 1 whatever the generator draws
    X, y = _digit_images()
    train_steps(fresh(tmx, stochastic_depth.build, 3, 1.0, True), fresh(jmx, j.build, 3, 1.0, True),
                {"data": batches(X, STEPS, 100)}, {"softmax_label": batches(y, STEPS, 100)},
                "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                jmx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2), ce)


def test_stochastic_depth_repeats_from_one_seed():
    argv = ["--num-epochs", "1", "--min-acc", "0"]
    a, b = run_port(stochastic_depth, argv), run_port(stochastic_depth, argv)
    assert a["accuracy"] == b["accuracy"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


def test_cnn_text_classification_matches_jax_and_learns_ngrams():
    j = jax_example("cnn_text_classification")
    assert_same_symbol(fresh(tmx, cnn_text_classification.build_sym, 16, 32, 0.25),
                       fresh(jmx, j.build_sym, 16, 32, 0.25), data=(100, 20), softmax_label=(100,))
    X, y = cnn_text_classification.make_data(4000, 1)
    jX, jy = j.make_data(4000, 1)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    train_steps(fresh(tmx, cnn_text_classification.build_sym, 16, 32, 0.0),
                fresh(jmx, j.build_sym, 16, 32, 0.0), {"data": batches(X, STEPS, 100)},
                {"softmax_label": batches(y, STEPS, 100)}, "adam", {"learning_rate": 0.05},
                jmx.init.Xavier(), ce)
    res = run_port(cnn_text_classification, ["--num-epochs", "4", "--min-acc", "0.75"])
    assert res["accuracy"] >= 0.75


def test_train_mnist_matches_jax():
    j = jax_example("train_mnist")
    X, y = train_mnist.synthetic_mnist()
    jX, jy = j.synthetic_mnist()
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    for net, shape in (("mlp", (-1, 784)), ("lenet", (-1, 1, 28, 28))):
        args = argparse.Namespace(network=net)
        tsym, jsym = fresh(tmx, train_mnist.get_symbol, args), fresh(jmx, j.get_symbol, args)
        xs = X.reshape(shape)
        assert_same_symbol(tsym, jsym, data=(64,) + xs.shape[1:], softmax_label=(64,))
        train_steps(tsym, jsym, {"data": batches(xs, STEPS, 64)},
                    {"softmax_label": batches(y, STEPS, 64)}, "sgd",
                    {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
                    jmx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2), ce)


def test_dec_clustering_matches_jax():
    j = jax_example("dec_clustering")
    n, k = 100, dec_clustering.K
    assert_same_symbol(fresh(tmx, dec_clustering.build_ae), fresh(jmx, j.build_ae), data=(n, 64),
                       recon_label=(n, 64))
    assert_same_symbol(fresh(tmx, dec_clustering.build_dec), fresh(jmx, j.build_dec), data=(n, 64),
                       p_label=(n, k))
    X, _ = _digit_images()
    X = X.reshape(-1, 64)
    train_steps(fresh(tmx, dec_clustering.build_ae), fresh(jmx, j.build_ae),
                {"data": batches(X, STEPS, n)}, {"recon_label": batches(X, STEPS, n)}, "adam",
                {"learning_rate": 0.02}, jmx.init.Xavier(), mse)
    P = np.random.RandomState(1).dirichlet(np.ones(k), STEPS * n).astype(np.float32)
    train_steps(fresh(tmx, dec_clustering.build_dec), fresh(jmx, j.build_dec),
                {"data": batches(X, STEPS, n)}, {"p_label": batches(P, STEPS, n)}, "adam",
                {"learning_rate": 0.01, "rescale_grad": 1.0}, jmx.init.Xavier(), mean_out)


@pytest.mark.slow
def test_deterministic_examples_outcomes():
    """train_mnist's and dec_clustering's runs (deterministic from their
    seeds; the steps above hold them to JAX's)."""
    assert run_port(train_mnist, ["--num-epochs", "1"])["accuracy"] >= 0.9
    res = run_port(dec_clustering, ["--num-epochs", "15", "--refine-rounds", "3", "--lr",
                                    "0.001"])
    assert res["refined_acc"] >= max(0.6, res["init_acc"] - 0.02)
