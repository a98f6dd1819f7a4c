"""The port's sequence and embedding examples (``mxnet_tpu_torch/
examples/``: char_lstm, bi_lstm_sort, nce_loss, matrix_factorization)
against their JAX twins under ``examples/`` on the CPU: the same symbols
(arguments, inferred shapes), the first three steps on the same batches
from the same parameters within 1e-5 (f32 losses, relative); each
example's own outcome at the settings of its smoke in
``tests/test_examples_smoke.py`` in the ``slow`` tier (deterministic from
the seeds; ``chip_smoke.py --only examples`` runs them on the card)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import bi_lstm_sort, char_lstm, matrix_factorization, nce_loss
from torch_example_parity import one_thread  # noqa: F401 (autouse)
from torch_example_parity import (assert_same_symbol, batches, ce, fresh, jax_example, mse,
                                  run_port, train_steps)

STEPS = 3


def bce(outs, labels):
    """LogisticRegressionOutput's loss: binary cross entropy of its sigmoid."""
    p = np.clip(outs[0].astype(np.float64), 1e-12, 1 - 1e-12)
    y = labels[0]
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def test_char_lstm_matches_jax():
    j = jax_example("char_lstm")
    text, vocab, c2i = char_lstm.corpus()
    assert (text, vocab) == j.corpus()[:2]
    V, seq = len(vocab), 32
    tsym = fresh(tmx, char_lstm.train_sym, V, seq, 128, 32)
    jsym = fresh(jmx, j.train_sym, V, seq, 128, 32)
    assert_same_symbol(tsym, jsym, data=(8, seq), softmax_label=(8, seq))
    assert_same_symbol(fresh(tmx, char_lstm.infer_sym, V, 128, 32), fresh(jmx, j.infer_sym, V, 128, 32),
                       data=(1, 1), init_h=(1, 128), init_c=(1, 128))
    ids = np.asarray([c2i[c] for c in text], np.float32)
    n = (len(ids) - 1) // seq
    X, Y = ids[:n * seq].reshape(n, seq), ids[1:n * seq + 1].reshape(n, seq)
    train_steps(tsym, jsym, {"data": batches(X, STEPS, 8)},
                {"softmax_label": batches(Y, STEPS, 8)}, "adam", {"learning_rate": 0.02},
                jmx.init.Xavier(), ce)


def test_bi_lstm_sort_matches_jax():
    j = jax_example("bi_lstm_sort")
    tsym, jsym = fresh(tmx, bi_lstm_sort.build_sym, 6, 64, 16), fresh(jmx, j.build_sym, 6, 64, 16)
    assert_same_symbol(tsym, jsym, data=(100, 6), softmax_label=(100, 6))
    X, Y = bi_lstm_sort.make_data(4000, 6, 1)
    np.testing.assert_array_equal(X, j.make_data(4000, 6, 1)[0])
    train_steps(tsym, jsym, {"data": batches(X, STEPS, 100)},
                {"softmax_label": batches(Y, STEPS, 100)}, "adam", {"learning_rate": 0.01},
                jmx.init.Xavier(), ce)


def test_nce_loss_matches_jax():
    j = jax_example("nce_loss")
    tsym, jsym = fresh(tmx, nce_loss.build_sym, 16), fresh(jmx, j.build_sym, 16)
    k = nce_loss.K_NOISE + 1
    assert_same_symbol(tsym, jsym, center=(500,), cand=(500, k), nce_label=(500, k))
    data, label = nce_loss.make_data(20000)
    np.testing.assert_array_equal(data["center"], j.make_corpus(20000, 1)[0])
    train_steps(tsym, jsym, {n: batches(data[n], STEPS, 500) for n in ("center", "cand")},
                {"nce_label": batches(label["nce_label"], STEPS, 500)}, "adam",
                {"learning_rate": 0.3, "rescale_grad": 1.0}, jmx.init.Normal(0.1), bce)


def test_matrix_factorization_matches_jax():
    j = jax_example("matrix_factorization")
    tsym = fresh(tmx, matrix_factorization.build_sym, 300, 200, 8)
    jsym = fresh(jmx, j.build_sym, 300, 200, 8)
    assert_same_symbol(tsym, jsym, user=(500,), item=(500,), score_label=(500,))
    args = matrix_factorization.parse_args([])
    data, r = matrix_factorization.make_data(args)
    train_steps(tsym, jsym, {n: batches(data[n], STEPS, 500) for n in ("user", "item")},
                {"score_label": batches(r.astype(np.float32), STEPS, 500)}, "adam",
                {"learning_rate": 0.05}, jmx.init.Normal(0.1), mse)


@pytest.mark.slow
def test_sequence_examples_outcomes():
    """Each example's own check at its smoke's settings (deterministic from
    the seeds: the steps above hold them to JAX's)."""
    vocab = char_lstm.corpus()[1]
    res = run_port(char_lstm, ["--num-epochs", "2", "--sample-chars", "25", "--num-hidden",
                               "64"])
    assert len(res["sampled"]) == 26 and set(res["sampled"]) <= set(vocab)
    res = run_port(bi_lstm_sort, ["--num-epochs", "3", "--num-samples", "1500", "--min-acc",
                                  "0.3"])
    assert res["accuracy"] >= 0.3
    res = run_port(nce_loss, ["--num-epochs", "6"])
    assert res["same_group"] >= 0.6 > res["chance"]
    res = run_port(matrix_factorization, ["--num-epochs", "8"])
    assert res["mse"] < 0.2 * res["variance"]
