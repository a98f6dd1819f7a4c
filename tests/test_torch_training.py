"""The PyTorch port's transformer-LM training path held against the JAX
package on the CPU: the loss and every parameter gradient of the port's LM
against ``jax.value_and_grad`` of ``examples/train_transformer_lm.py``'s
loss with the Pallas flash kernels (interpret mode), five SGD steps of the
port's trainer against the JAX loop, the trainer's corpus against the
example's, parameter trees carried both ways, the trainer's refusals, and
the training bench's FLOP count and host smoke run."""
import argparse
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import train_transformer_lm as trainer
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.tools import transformer_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32)  # test_torch_serving.py's
BATCH, SEQ_LEN, STEPS, LR = 2, 12, 5, 3e-2


def _jax_loss_fn(apply_fn):
    """The loss of examples/train_transformer_lm.py:114-119 (dense, no
    mesh: the MoE aux term is 0)."""
    def loss_fn(p, tokens, targets):
        logits = apply_fn(p, tokens)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(lp, targets[..., None], -1))
    return loss_fn


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's f32 training loop (:121-127) for STEPS steps with
    the Pallas flash kernels forced on: per-step losses, the first step's
    gradients, and the final parameters."""
    was = os.environ.get("MXNET_TPU_FORCE_FLASH")
    os.environ["MXNET_TPU_FORCE_FLASH"] = "1"
    try:
        init_fn, apply_fn = jtfm.transformer_lm(dtype=jnp.float32, **DIMS)
        seq = trainer.corpus(DIMS["vocab"], BATCH, SEQ_LEN)
        tokens, targets = jnp.asarray(seq[:, :-1]), jnp.asarray(seq[:, 1:])
        params = jax.tree_util.tree_map(jnp.asarray, init_fn(0))
        step = jax.jit(jax.value_and_grad(_jax_loss_fn(apply_fn)))
        losses, first_grads = [], None
        for _ in range(STEPS):
            loss, grads = step(params, tokens, targets)
            losses.append(float(loss))
            if first_grads is None:
                first_grads = jax.tree_util.tree_map(np.asarray, grads)
            params = jax.tree_util.tree_map(
                lambda p, g: p - LR * g.astype(p.dtype), params, grads)
    finally:
        if was is None:
            os.environ.pop("MXNET_TPU_FORCE_FLASH")
        else:
            os.environ["MXNET_TPU_FORCE_FLASH"] = was
    return {"losses": losses, "grads": first_grads,
            "params": jax.tree_util.tree_map(np.asarray, params)}


def _assert_trees_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_close(got[key], want[key], rtol, atol)
        else:
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=key)


def _port_params():
    init_fn, apply_fn = ttfm.transformer_lm(dtype=torch.float32, **DIMS)
    params = ttfm.params_from_jax(init_fn(0), device="cpu", dtype=torch.float32)
    return params.requires_grad_(), apply_fn


@pytest.mark.timeout(300)
def test_loss_and_grads_match_jax(jax_run):
    """f32: the loss at 1e-5 and every gradient, carried back to the JAX
    layout by grads_to_jax (projections transposed to [in, out]), at 1e-4:
    XLA and ATen sum the matmuls in different orders."""
    params, apply_fn = _port_params()
    seq = torch.from_numpy(trainer.corpus(DIMS["vocab"], BATCH, SEQ_LEN).astype(np.int64))
    loss = trainer.lm_loss(apply_fn(params, seq[:, :-1]), seq[:, 1:])
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["losses"][0], rtol=1e-5, atol=1e-5)
    _assert_trees_close(ttfm.grads_to_jax(params), jax_run["grads"], rtol=1e-4, atol=1e-4)


@pytest.mark.timeout(300)
def test_sgd_steps_match_jax(jax_run):
    """Five SGD steps of the port's trainer from init_fn(0) on the corpus:
    per-step losses and the final parameters at 1e-4 of the JAX loop's."""
    final = {}
    losses = trainer.train(seq_len=SEQ_LEN, batch_size=BATCH, steps=STEPS, lr=LR,
                           device="cpu", log=lambda *a: None,
                           on_step=lambda i, loss, p: final.update(p=p), **DIMS)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0]
    _assert_trees_close(ttfm.params_to_jax(final["p"]), jax_run["params"],
                        rtol=1e-4, atol=1e-4)


def _example_corpus(vocab, batch_size, seq_len):
    """Run the corpus statements of examples/train_transformer_lm.py's
    main() (from ``rng = ...`` to ``targets = ...``) as written."""
    with open(os.path.join(REPO, "examples", "train_transformer_lm.py")) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = [getattr(s.targets[0], "id", None) if isinstance(s, ast.Assign) else None
             for s in main.body]
    body = main.body[names.index("rng"):names.index("targets") + 1]
    env = {"np": np, "jnp": jnp, "args": argparse.Namespace(
        vocab=vocab, batch_size=batch_size, seq_len=seq_len)}
    exec(compile(ast.Module(body=body, type_ignores=[]), "example", "exec"), env)
    return np.asarray(env["tokens"]), np.asarray(env["targets"])


@pytest.mark.parametrize("vocab,batch_size,seq_len", [(256, 8, 256), (32, 2, 12), (32000, 3, 50)])
def test_corpus_matches_example(vocab, batch_size, seq_len):
    tokens, targets = _example_corpus(vocab, batch_size, seq_len)
    seq = trainer.corpus(vocab, batch_size, seq_len)
    assert seq.dtype == np.int32 and seq.shape == (batch_size, seq_len + 1)
    np.testing.assert_array_equal(seq[:, :-1], tokens)
    np.testing.assert_array_equal(seq[:, 1:], targets)


def test_params_round_trip_to_jax_layout():
    """params_to_jax inverts params_from_jax exactly; grads_to_jax needs a
    backward first."""
    tree = jtfm.transformer_lm(**DIMS)[0](0)
    params = ttfm.params_from_jax(tree, device="cpu", dtype=torch.float32)
    _assert_trees_close(ttfm.params_to_jax(params), tree, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ttfm.grads_to_jax(params)


def test_trainer_refuses_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        trainer.train(steps=1, log=lambda *a: None, **DIMS)
    with pytest.raises(MXNetError):
        trainer.main(["--steps", "1", "--vocab", "32", "--d-model", "16", "--n-heads", "2"])
    assert transformer_bench.main([]) == 1


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"]])
def test_trainer_raises_on_unported_parallelism(flags, capsys):
    """--dp and --tp are ported (across processes in tests/test_torch_dist.py
    and tests/test_torch_axes_dist.py): in one process the two ranks share
    the batch (dp) or each runs its half of the heads and FFN columns (tp),
    which trains as one rank does; heads that do not divide by tp raise."""
    small = ["--cpu", "--steps", "1", "--vocab", "32", "--d-model", "16", "--n-heads", "2",
             "--n-layers", "1", "--d-ff", "32", "--seq-len", "8", "--batch-size", "2"]
    assert trainer.main(small) == 0
    one = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert trainer.main(small + flags) == 0
    two = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert [ln.split()[:4] for ln in two] == [ln.split()[:4] for ln in one]
    if flags[0] == "--tp":
        with pytest.raises(ValueError, match="n-heads"):
            trainer.main(small + ["--tp", "4", "--n-heads", "2"])


@pytest.mark.parametrize("flags", [["--sp", "2"], ["--moe-experts", "4"],
                                   ["--moe-experts", "4", "--ep", "2"],
                                   ["--sp", "2", "--moe-experts", "4", "--ep", "2"]])
def test_trainer_runs_sp_and_moe_on_cpu(flags, capsys):
    """The mesh and MoE flags run on the host at small width: a mesh line
    when sp or ep > 1, finite losses that fall; experts or a sequence that
    do not divide by ep or sp raise."""
    small = ["--cpu", "--steps", "6", "--vocab", "32", "--d-model", "16", "--n-heads", "2",
             "--n-layers", "2", "--d-ff", "32", "--seq-len", "8", "--batch-size", "2"]
    assert trainer.main(small + flags) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu"
    sp = int(flags[flags.index("--sp") + 1]) if "--sp" in flags else 1
    ep = int(flags[flags.index("--ep") + 1]) if "--ep" in flags else 1
    if sp * ep > 1:
        assert out[1] == "mesh: %s" % {"dp": 1, "tp": 1, "pp": 1, "sp": sp, "ep": ep}
    losses = [float(line.split()[3]) for line in out if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0], losses
    with pytest.raises(ValueError):
        trainer.main(small + flags + ["--seq-len", "7", "--sp", "2", "--moe-experts", "3"])


def test_trainer_main_runs_on_cpu(capsys):
    assert trainer.main(["--cpu", "--steps", "3", "--vocab", "32", "--d-model", "16",
                         "--n-heads", "2", "--n-layers", "1", "--d-ff", "32",
                         "--seq-len", "8", "--batch-size", "2", "--dtype", "bfloat16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu"
    assert [line.split()[:2] for line in out[1:3]] == [["step", "0"], ["step", "2"]]
    assert out[-1].startswith("done: final loss ")


def test_bench_flop_count():
    """step_flops at the full-width config, counted by hand: per layer
    2·N·(4·d² + 2·d·d_ff) + 2·B·d·T(T+1), plus the head 2·N·d·vocab, all x3."""
    b, t, d, layers, d_ff, vocab = 8, 2047, 1024, 12, 4096, 32000
    n = b * t
    per_layer = 2 * n * (4 * d * d + 2 * d * d_ff) + 2 * b * d * t * (t + 1)
    want = 3 * (layers * per_layer + 2 * n * d * vocab)
    assert transformer_bench.step_flops(b, t, d, layers, d_ff, vocab) == want
    assert 20.4e12 < want < 20.6e12


def test_bench_smoke_on_cpu(monkeypatch, capsys, tmp_path):
    for key, val in dict(TLM_SMOKE="1", TLM_LAYERS="1", TLM_SEQ="17", TLM_DMODEL="64",
                         TLM_SCAN_K="2", TLM_REPS="1").items():
        monkeypatch.setenv(key, val)
    out_file = tmp_path / "r.json"
    assert transformer_bench.main(["--cpu", "--out", str(out_file)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == json.loads(out_file.read_text())
    assert res["device"] == "cpu" and res["peak_share"] is None and res["T"] == 16
    assert np.isfinite(res["first_loss"]) and res["step_ms"] > 0
    with pytest.raises(SystemExit):
        transformer_bench.main(["--cpu", "--trace", str(tmp_path / "t.json")])


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::flash_dkv_kernel<__nv_bfloat16, 64>(...)", "flash_attn_bwd_dkv"),
    ("void (anonymous namespace)::flash_dq_kernel<__nv_bfloat16, 64>(...)", "flash_attn_bwd_dq"),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64>(...)", "flash_attn_fwd"),
    ("void sm90::(anonymous namespace)::flash_fwd_sm90<64>(CUtensorMap_st, ...)", "flash_attn_fwd"),
    ("void sm90::(anonymous namespace)::flash_dq_sm90<64>(CUtensorMap_st, ...)",
     "flash_attn_bwd_dq"),
    ("void sm90::(anonymous namespace)::flash_dkv_sm90<64>(CUtensorMap_st, ...)",
     "flash_attn_bwd_dkv"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(...)", "gemm_f32"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3", "gemm_f32"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
])
def test_bench_kernel_families(name, fam):
    """The trace's kernel families, on kernel names an H100 run reports."""
    assert transformer_bench.family(name) == fam
