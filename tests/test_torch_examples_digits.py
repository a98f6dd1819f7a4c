"""The port's digits examples (``mxnet_tpu_torch/examples/``: svm_digits,
autoencoder, multi_task, numpy_ops, adversary_fgsm) against their JAX twins
under ``examples/`` on the CPU: the same symbol (arguments, inferred
shapes), the first three steps on the same batches from the same
parameters within 1e-5 (f32 losses, relative); each example's own
asserted outcome at the settings of its smoke in
``tests/test_examples_smoke.py`` in the ``slow`` tier (the runs are
deterministic from their seeds, and ``chip_smoke.py --only examples`` runs
them on the card).
Also the committed digits file against scikit-learn's bundled copy."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import adversary_fgsm, autoencoder, common, multi_task, numpy_ops
from mxnet_tpu_torch.examples import svm_digits
from torch_example_parity import one_thread  # noqa: F401 (autouse)
from torch_example_parity import (assert_same_symbol, batches, ce, fresh, jax_example, mse,
                                  run_port, train_steps)

STEPS, B = 3, 100


def hinge(outs, labels):
    """SVMOutput's squared hinge loss (margin 1) of the scores it passes on."""
    s = outs[0].astype(np.float64)
    y = labels[0].astype(np.int64)
    viol = np.maximum(0.0, 1.0 - (s[np.arange(len(y)), y][:, None] - s))
    viol[np.arange(len(y)), y] = 0.0
    return float((viol ** 2).sum(1).mean())


def _digits(flat=True):
    d = common.load_digits()
    X = (d.images / 16.0).astype(np.float32)
    return (X.reshape(-1, 64) if flat else X.reshape(-1, 1, 8, 8)), d.target.astype(np.float32)


def test_digits_file_is_sklearns():
    datasets = pytest.importorskip("sklearn.datasets")
    want, got = datasets.load_digits(), common.load_digits()
    for k in ("images", "data", "target"):
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("use_linear", [False, True])
def test_svm_digits_matches_jax(use_linear):
    j = jax_example("svm_digits")
    jsym = fresh(jmx, lambda: j_svm(j, use_linear))
    tsym = fresh(tmx, svm_digits.build_net, use_linear)
    assert_same_symbol(tsym, jsym, data=(B, 64), svm_label=(B,))
    X, y = _digits()
    train_steps(tsym, jsym, {"data": batches(X, STEPS, B)}, {"svm_label": batches(y, STEPS, B)},
                "sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                jmx.init.Xavier(), hinge)


def j_svm(j, use_linear):
    """The JAX twin builds its net inside main(): the same lines."""
    mx = j.mx
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SVMOutput(net, mx.sym.Variable("svm_label"), margin=1.0,
                            regularization_coefficient=1.0, use_linear=use_linear, name="svm")


def test_autoencoder_matches_jax():
    j = jax_example("autoencoder")
    jsym, tsym = fresh(jmx, j.build_ae), fresh(tmx, autoencoder.build_ae)
    assert_same_symbol(tsym, jsym, data=(B, 64), recon_label=(B, 64))
    X, _ = _digits()
    train_steps(tsym, jsym, {"data": batches(X, STEPS, B)}, {"recon_label": batches(X, STEPS, B)},
                "adam", {"learning_rate": 0.02}, jmx.init.Xavier(), mse)


def test_multi_task_matches_jax():
    j = jax_example("multi_task")
    jsym, tsym = fresh(jmx, j.build_sym), fresh(tmx, multi_task.build_sym)
    assert_same_symbol(tsym, jsym, data=(50, 64), digit_label=(50,), parity_label=(50,))
    X, y = _digits()
    train_steps(tsym, jsym, {"data": batches(X, STEPS, 50)},
                {"digit_label": batches(y, STEPS, 50), "parity_label": batches(y % 2, STEPS, 50)},
                "sgd", {"learning_rate": 0.1, "momentum": 0.9}, jmx.init.Xavier(), ce)


def test_numpy_ops_custom_softmax_matches_jax():
    j = jax_example("numpy_ops")
    mx = j.mx
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        jsym = mx.sym.Custom(net, mx.sym.Variable("softmax_label"),
                             op_type="numpy_softmax_example", name="softmax")
    tsym = fresh(tmx, numpy_ops.build_net)
    assert_same_symbol(tsym, jsym, data=(B, 64), softmax_label=(B,))
    X, y = _digits()
    train_steps(tsym, jsym, {"data": batches(X, STEPS, B)},
                {"softmax_label": batches(y, STEPS, B)}, "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, jmx.init.Xavier(), ce)


def test_adversary_fgsm_matches_jax():
    j = jax_example("adversary_fgsm")
    jsym, tsym = fresh(jmx, j.build_net), fresh(tmx, adversary_fgsm.build_net)
    assert_same_symbol(tsym, jsym, data=(B, 1, 8, 8), softmax_label=(B,))
    X, y = _digits(flat=False)
    train_steps(tsym, jsym, {"data": batches(X, STEPS, B)},
                {"softmax_label": batches(y, STEPS, B)}, "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, jmx.init.Xavier(), ce)


@pytest.mark.slow
def test_digits_examples_outcomes():
    """Each example's own check at its smoke's settings (deterministic from
    the seeds: the steps above hold them to JAX's)."""
    assert run_port(svm_digits, [])["accuracy"] >= 0.9
    res = run_port(autoencoder, ["--num-epochs", "3"])
    assert res["mse"] < 0.5 * res["variance"]
    res = run_port(multi_task, ["--num-epochs", "8"])
    assert res["digit"] >= 0.85 and res["parity"] >= 0.85
    assert run_port(numpy_ops, [])["accuracy"] >= 0.9
    res = run_port(adversary_fgsm, ["--num-epochs", "4"])
    assert res["adversarial"] < res["clean"]
