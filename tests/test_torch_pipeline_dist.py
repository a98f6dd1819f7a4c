"""The port's GPipe pipeline over a pp axis that spans processes, on the
CPU: ``tools/dist_check.py`` launched on 2 and on 4 processes over gloo
(``make_mesh(dp=1, pp=P, processes=P)``, one stage a process; for the
pipeline problem also pp 4 over 2 processes, two stages a process), held to
the JAX package and to the port's one-process pipeline.

- ``--checks pp``: the pp axis's rank order and neighbours, ``ppermute``
  over it (a shift and a ring, f32 and bf16) and its autograd pair (the
  gradient is the reverse permute);
- ``--pp-problem``: ``pipelined_loss`` on ``tests/test_moe_pipeline.py``'s
  problem (stage ``relu(a @ w + b)``) against JAX's ``pipelined_loss`` over
  ``make_mesh(dp=1, pp=P)`` of the virtual host devices (loss within 1e-6
  relative, every stage gradient within 1e-5 of its max) and against the
  port's one-process pipeline (1e-6; bit for bit on this host);
- ``--pp-test``: the transformer LM's blocks as the stages (embedding before
  the pipeline, final norm and tied head in the loss), 3 SGD steps, against
  the one-process pipeline (losses and the first step's gradients) and
  against JAX's ``transformer_lm`` trained densely (losses within 1e-5
  relative, stage gradients within 1e-5 of max).

One launch a process count serves every case (a module fixture).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.pipeline import pipelined_loss as jpipelined_loss
from mxnet_tpu_torch.examples import train_transformer_lm as trainer
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import pipelined_loss
from mxnet_tpu_torch.tools import dist_check
from torch_example_parity import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_DIMS = (32, 16, 2, 4, 32, 8, 4)  # vocab, d_model, n_heads, n_layers, d_ff, seq_len, batch
LM_STEPS, MICRO, LR = 3, dist_check.PP_MICRO, 3e-2
SIZES = (2, 4)
#: (processes, stages) of the pipeline problem
PROBLEMS = [pytest.param(2, 2, id="2"), pytest.param(4, 4, id="4"),
            pytest.param(2, 4, id="4-over-2")]


def _problem(n_stages, n_micro=8, mb=4, d=16, seed=5):
    """test_moe_pipeline.py's _make_pipeline_problem, as numpy arrays."""
    r = np.random.RandomState(seed)
    return {"w": (r.randn(n_stages, d, d) * 0.3).astype(np.float32),
            "b": (r.randn(n_stages, d) * 0.1).astype(np.float32),
            "x": r.randn(n_micro, mb, d).astype(np.float32),
            "y": r.randn(n_micro, mb, d).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    env = dict(os.environ)
    for k in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR", "MXTPU_AMP", "MXTPU_RUN_DIR",
              "MXTPU_FAULT_INJECT", "DMLC_RANK", "DMLC_NUM_WORKER",
              "MXTPU_COORDINATOR_ADDRESS"):
        env.pop(k, None)
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    out = {}
    for s in (2, 4):
        np.savez(root / ("prob%d.npz" % s), **_problem(s))
    for n in SIZES:
        probs = ",".join(str(root / ("prob%d.npz" % s)) for s in (2, 4) if s % n == 0)
        d = root / ("out%d" % n)
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n), "python",
               "-m", "mxnet_tpu_torch.tools.dist_check", "--out", str(d), "--device", "cpu",
               "--checks", "pp", "--pp-problem", probs, "--pp-test",
               "--lm-dims", ",".join(map(str, LM_DIMS)), "--lm-steps", str(LM_STEPS)]
        r = subprocess.run(cmd, cwd=ROOT, env=env, timeout=180, capture_output=True, text=True)
        assert r.returncode == 0, "launch -n %d rc=%d\n%s\n%s" % (
            n, r.returncode, r.stdout[-3000:], r.stderr[-5000:])
        out[n] = {"dir": d, "res": [json.loads((d / ("rank%d.json" % i)).read_text())
                                    for i in range(n)]}
    return out


def _of_max(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= tol * scale, "%s: max err %.3g > %g of max %.3g" % (what, err, tol, scale)


@pytest.mark.parametrize("n", SIZES)
def test_pp_axis_and_ppermute(runs, n):
    for rank, res in enumerate(runs[n]["res"]):
        pp = res["pp"]
        assert pp["coords"]["pp"] == rank and pp["pp_ranks"] == list(range(n))
        assert pp["neighbours"] == {"prev": rank - 1 if rank else None,
                                    "next": rank + 1 if rank + 1 < n else None}
        # the shift's value came from the stage before (zeros on stage 0), the
        # ring's too, in both dtypes
        for dtype in ("torch.float32", "torch.bfloat16"):
            assert pp["got"][dtype] == [float(rank), float((rank - 1) % n + 1)]
        assert pp["grad"] == [float(i + 10 * ((rank + 1) % n)) for i in range(4)]
        assert pp["stats"]["ppermute@pp"]["calls"] == 6  # every rank is on every pair


def _pipeline_grads(runs, n, stages):
    """The stage gradients as the processes computed them: each stage's rows
    from the process that holds it (the others' rows are zeros there)."""
    got = [dict(np.load(runs[n]["dir"] / ("pp_problem%d_rank%d.npz" % (stages, r))))
           for r in range(n)]
    per = stages // n
    for r, (g, res) in enumerate(zip(got, runs[n]["res"])):
        mine = list(range(r * per, (r + 1) * per))
        assert res["pp_problem"][str(stages)]["stages_held"] == mine
        others = [s for s in range(stages) if s not in mine]
        assert not np.any(g["w"][others]) and not np.any(g["b"][others])
    return got, {k: np.stack([got[s // per][k][s] for s in range(stages)]) for k in ("w", "b")}


@pytest.mark.parametrize("n,stages", PROBLEMS)
def test_pipeline_across_processes_matches_jax(runs, n, stages):
    prob = _problem(stages)
    mesh = jmake_mesh(dp=1, pp=stages, devices=jax.devices()[:stages])
    jloss = jpipelined_loss(lambda p, a: jax.nn.relu(a @ p["w"] + p["b"]),
                            lambda o, t: jnp.mean((o - t) ** 2), mesh)
    params = {k: prob[k] for k in ("w", "b")}
    with mesh:
        want, want_g = jax.jit(jax.value_and_grad(jloss))(params, prob["x"], prob["y"])
    got, grads = _pipeline_grads(runs, n, stages)
    for g in got:  # every process returns the last stage's loss
        assert float(g["loss"]) == pytest.approx(float(want), rel=1e-6)
    for k in params:
        for s in range(stages):
            _of_max(grads[k][s], np.asarray(want_g[k])[s], 1e-5, "%s stage %d" % (k, s))


@pytest.mark.parametrize("n,stages", PROBLEMS)
def test_pipeline_across_processes_matches_one_process(runs, n, stages):
    prob = _problem(stages)
    params = {k: torch.from_numpy(prob[k].copy()).requires_grad_() for k in ("w", "b")}
    loss = pipelined_loss(dist_check.relu_stage, dist_check.mse_loss, {"pp": stages})(
        params, torch.from_numpy(prob["x"]), torch.from_numpy(prob["y"]))
    loss.backward()
    got, grads = _pipeline_grads(runs, n, stages)
    bitwise = all(float(g["loss"]) == loss.item() for g in got) and all(
        np.array_equal(grads[k], params[k].grad.numpy()) for k in params)
    print("pp %d over %d processes, bit for bit the one-process pipeline: %s"
          % (stages, n, bitwise))
    assert float(got[0]["loss"]) == pytest.approx(loss.item(), rel=1e-6)
    for k in params:
        _of_max(grads[k], params[k].grad.numpy(), 1e-6, k)


def _one_process_lm(n):
    """The one-process pipeline over logical pp ranks: losses of LM_STEPS
    steps and the first step's gradients."""
    with tmx.cpu():
        lm = dist_check.pp_lm(LM_DIMS, "float32", torch.device("cpu"), n)
        loss_fn = lm.loss_for({"pp": n})
        losses, grads = [], None
        for i in range(LM_STEPS):
            loss = loss_fn()
            loss.backward()
            if i == 0:
                grads = {k: v.grad.numpy().copy() for k, v in lm.stages.items()}
                grads.update(embed=lm.embed.grad.numpy().copy(),
                             ln_f=lm.ln_f.grad.numpy().copy())
            dist_check.pp_sgd(lm.leaves, LR)
            losses.append(loss.item())
    return losses, grads


def _process_lm_grads(runs, n):
    """The first step's gradients the processes wrote, each stage's rows from
    its own process."""
    z = [dict(np.load(runs[n]["dir"] / ("pp_lm_rank%d.npz" % r))) for r in range(n)]
    out = {k: np.concatenate([z[r]["grad:" + k] for r in range(n)])
           for k in dist_check.PP_NAMES}
    out.update(embed=z[0]["grad:embed"], ln_f=z[0]["grad:ln_f"])
    return out


@pytest.mark.parametrize("n", SIZES)
def test_lm_pipeline_matches_one_process(runs, n):
    ranks = [r["pp_lm"] for r in runs[n]["res"]]
    for r in ranks:  # every process's loss is the last stage's
        assert r["losses"] == ranks[0]["losses"]
        assert r["blocks_a_stage"] == LM_DIMS[3] // n
        # one send and one receive a microbatch each way, on the inner stages
        assert r["permute_calls_per_step"] in (2 * MICRO, 4 * MICRO)
    want, grads = _one_process_lm(n)
    got = _process_lm_grads(runs, n)
    per = LM_DIMS[3] // n
    bitwise = ranks[0]["losses"] == want and all(
        np.array_equal(got[k], grads[k].reshape(got[k].shape)) for k in got)
    print("LM over pp %d processes, bit for bit the one-process pipeline: %s" % (n, bitwise))
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-6, atol=0)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    for k, v in got.items():
        w = grads[k] if k in ("embed", "ln_f") else grads[k].reshape((n * per,) + v.shape[2:])
        _of_max(v.reshape(w.shape), w, 1e-6, k)


def test_lm_pipeline_matches_jax_dense():
    """The pipelined LM (pp 2, in one process) trains as JAX's
    ``transformer_lm`` does densely: losses within 1e-5 relative and the
    first step's block gradients within 1e-5 of max (the processes' runs
    equal the one-process pipeline, above)."""
    vocab, d_model, n_heads, n_layers, d_ff, seq_len, batch = LM_DIMS
    init_fn, apply_fn = jtfm.transformer_lm(vocab=vocab, d_model=d_model, n_heads=n_heads,
                                            n_layers=n_layers, d_ff=d_ff, dtype=jnp.float32)
    seq = trainer.corpus(vocab, batch, seq_len)
    tokens, targets = jnp.asarray(seq[:, :-1]), jnp.asarray(seq[:, 1:])

    def loss_fn(p):
        lp = jax.nn.log_softmax(apply_fn(p, tokens).astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(lp, targets[..., None], -1))

    step = jax.jit(jax.value_and_grad(loss_fn))
    params = jax.tree_util.tree_map(jnp.asarray, init_fn(0))
    want, first = [], None
    for _ in range(LM_STEPS):
        loss, g = step(params)
        want.append(float(loss))
        first = first or jax.tree_util.tree_map(np.asarray, g)
        params = jax.tree_util.tree_map(lambda p, gr: p - LR * gr, params, g)
    got, grads = _one_process_lm(2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    per = n_layers // 2
    for name in dist_check.PP_NAMES:
        for i in range(n_layers):
            w = first["l%d" % i][name]
            g = grads[name][i // per, i % per]
            _of_max(g.T if g.ndim == 2 else g, w, 1e-5, "l%d %s" % (i, name))
    _of_max(grads["embed"], first["embed"], 1e-5, "embed")


def test_ppermute_in_one_process():
    """Over logical ranks of one process ``ppermute`` is a local permutation
    of the stacked entries (JAX's global view), and its gradient the reverse
    one."""
    m = tmesh.make_mesh(dp=1, pp=4, devices=["cpu"] * 4)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3).requires_grad_()
    ring = [(i, (i + 1) % 4) for i in range(4)]
    y = tmesh.ppermute(x, ring, axis="pp", mesh=m)
    assert torch.equal(y, torch.roll(x.detach(), 1, 0))
    shift = tmesh.ppermute(x.detach(), ring[:3], axis="pp", mesh=m)
    assert torch.equal(shift[0], torch.zeros(3)) and torch.equal(shift[1:], x.detach()[:3])
    w = torch.randn(4, 3)
    (y * w).sum().backward()
    assert torch.equal(x.grad, torch.roll(w, -1, 0))
    with pytest.raises(tmx.base.MXNetError, match="permutation"):
        tmesh.ppermute(x, [(0, 1), (2, 1)], axis="pp", mesh=m)
    with pytest.raises(tmx.base.MXNetError, match="position"):
        tmesh.ppermute(x[:2], ring, axis="pp", mesh=m)
