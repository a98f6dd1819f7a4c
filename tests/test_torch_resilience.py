"""The resilience slice of the PyTorch port (``mxnet_tpu_torch/resilience``
and its wiring into ``Module.fit``, the iterators, the kvstore, ``predict``
and ``tools/serve.py``) on the CPU, held to the JAX package.

Every case of ``tests/test_resilience.py`` that this slice covers runs on
the port: atomic files, the checkpoint round trip, retention, a duplicate
step, a torn newest checkpoint, ENOSPC, a transient write, a failing
``save_async``; the fault spec unset / malformed / budgeted and the four
retry cases; ``NDArrayIter.skip`` in the three ``last_batch_handle``
modes; SIGTERM preemption with an exact resume and the async interval
snapshots of a dp-4 fused MLP fit (four logical ranks on the host); and
the SIGKILL crash-resume subprocess case at ``fit_k`` 1 and 2, bit for
bit, with a torn newest checkpoint at ``fit_k`` 1. The recordio and
DeviceFeedIter cases live in ``tests/test_torch_recordio.py`` and
``tests/test_torch_io_iters.py``; the heartbeat cases wait for the
multi-process mesh (ROADMAP Queue 1 step 8).

Across the packages: the same state written by both managers gives the
same bytes in every member (the MANIFEST's ``time`` aside); a checkpoint
written by JAX's ``fit(checkpoint_dir=)`` verifies, loads (params and
fused optimizer state equal to JAX's own ``load_state``) and resumes in
the port, and one written by the port does the same in JAX
(``load_state``, ``params_from_checkpoint``, ``fit(resume="auto")``);
continued training agrees with the other package's uninterrupted run
within the fit-parity tolerance (rtol 2e-4, atol 2e-5); JAX's
executor-path updater pickle is refused by name. Also: the kvstore's
injected push/pull faults are absorbed by the retry, the legacy savers
write atomically, ``params_from_checkpoint`` and ``tools/serve.py
--checkpoint`` serve a checkpoint, the port's ``ckpt_inspect`` reads a
JAX checkpoint, and importing the port loads neither ``jax`` nor
``mxnet_tpu``."""
import errno
import json
import logging
import os
import pickle
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.resilience import checkpoint as jck
from mxnet_tpu.resilience import fault as jfault
from mxnet_tpu_torch import resilience
from mxnet_tpu_torch.resilience import checkpoint as ck
from mxnet_tpu_torch.resilience import fault, retry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV = ("MXTPU_AMP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES", "MXNET_FIT_MULTISTEP",
        "MXTPU_FAULT_INJECT", "MXTPU_CKPT_INTERVAL", "MXTPU_CKPT_KEEP", "MXTPU_ELASTIC",
        "MXTPU_RUN_DIR")


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")  # the JAX side's pushes synchronous
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# checkpoint primitives
# ---------------------------------------------------------------------------

def _state(step=10, w=None):
    return {
        "module": {
            "arg": {"w": np.arange(12, dtype=np.float32).reshape(3, 4) if w is None else w},
            "aux": {"m": np.ones(3, dtype=np.float64)},
            "opt": {"kind": "none"},
        },
        "epoch": 1, "nbatch": 2, "global_step": step,
        "metric": None,
        "rng": {"numpy": np.random.get_state(), "mx": None,
                "torch": tmx.random.get_states()},
    }


def test_atomic_file_success(tmp_path):
    target = tmp_path / "out.bin"
    with ck.atomic_file(str(target)) as f:
        f.write(b"payload")
    assert target.read_bytes() == b"payload"
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]


def test_atomic_file_failure_leaves_previous_intact(tmp_path):
    target = tmp_path / "out.bin"
    target.write_bytes(b"old")
    with pytest.raises(RuntimeError):
        with ck.atomic_file(str(target)) as f:
            f.write(b"half-written new conten")
            raise RuntimeError("boom")
    assert target.read_bytes() == b"old"
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]


def test_checkpoint_roundtrip(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    path = mgr.save(_state(step=7), 7)
    assert os.path.isdir(path)
    ck.verify_checkpoint(path, deep=True)
    state = ck.load_state(path)
    np.testing.assert_array_equal(state["module"]["arg"]["w"],
                                  np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(state["module"]["aux"]["m"], np.ones(3, dtype=np.float64))
    assert state["module"]["aux"]["m"].dtype == np.float64
    assert state["epoch"] == 1 and state["nbatch"] == 2
    assert state["global_step"] == 7
    assert state["module"]["opt"] == {"kind": "none"}


def test_checkpoint_payload_is_host_values_from_device_tensors(tmp_path):
    """Tensors in the state (the fused path's clones) reach the files as
    numpy: the pickles hold no torch.Tensor."""
    import torch

    state = _state(step=3)
    state["module"]["arg"]["w"] = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    state["module"]["opt"] = {"kind": "fused", "t": 3,
                              "state": {"w": torch.ones(3, 4)},
                              "amp": {"scale": torch.tensor(2.0 ** 15), "good": torch.tensor(1.0)}}
    path = ck.CheckpointManager(str(tmp_path)).save(state, 3)
    raw = open(os.path.join(path, ck.OPT_FILE), "rb").read()
    assert b"torch" not in raw
    opt = pickle.loads(raw)
    assert isinstance(opt["state"]["w"], np.ndarray)
    assert isinstance(opt["amp"]["scale"], np.ndarray) and opt["amp"]["scale"].shape == ()
    np.testing.assert_array_equal(ck.load_state(path)["module"]["arg"]["w"],
                                  np.arange(12, dtype=np.float32).reshape(3, 4))


def test_checkpoint_retention_keeps_last_n(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(_state(step=step), step)
    assert ck.list_checkpoints(str(tmp_path)) == [2, 3]


def test_checkpoint_duplicate_step_is_noop(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    first = mgr.save(_state(), 5)
    again = mgr.save(_state(), 5)
    assert first == again
    ck.verify_checkpoint(first, deep=True)


def test_latest_valid_skips_truncated_newest(tmp_path, caplog):
    mgr = ck.CheckpointManager(str(tmp_path), keep=5)
    mgr.save(_state(step=10), 10)
    mgr.save(_state(step=20), 20)
    torn = os.path.join(ck.step_dir(str(tmp_path), 20), ck.PARAMS_FILE)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    with pytest.raises(ck.CheckpointError):
        ck.verify_checkpoint(ck.step_dir(str(tmp_path), 20))
    with caplog.at_level(logging.WARNING):
        assert mgr.latest_valid() == ck.step_dir(str(tmp_path), 10)
    assert any("skipping corrupt checkpoint" in r.message for r in caplog.records)
    assert mgr.load()["global_step"] == 10


def test_latest_valid_none_when_all_torn(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=5)
    mgr.save(_state(step=3), 3)
    os.unlink(os.path.join(ck.step_dir(str(tmp_path), 3), ck.MANIFEST))
    assert mgr.latest_valid() is None
    assert mgr.load() is None


def test_deep_verify_names_the_corrupt_tensor(tmp_path):
    path = ck.CheckpointManager(str(tmp_path)).save(_state(step=2), 2)
    manifest = ck.read_manifest(path)
    manifest["tensors"]["arg:w"] ^= 1  # a tensor whose bytes disagree with its CRC
    with open(os.path.join(path, ck.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ck.CheckpointError, match="tensor arg:w fails CRC32"):
        ck.verify_checkpoint(path, deep=True)


def test_enospc_aborts_without_partial_checkpoint(tmp_path, monkeypatch):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(_state(step=1), 1)
    # the second member write (optimizer.state) of the next save hits ENOSPC
    monkeypatch.setenv(fault.ENV, "enospc_at_ckpt_write=2")
    with pytest.raises(OSError) as exc:
        mgr.save(_state(step=2), 2)
    assert exc.value.errno == errno.ENOSPC
    monkeypatch.delenv(fault.ENV)
    assert ck.list_checkpoints(str(tmp_path)) == [1]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    ck.verify_checkpoint(ck.step_dir(str(tmp_path), 1), deep=True)


def test_transient_ckpt_write_absorbed_by_retry(tmp_path, monkeypatch):
    monkeypatch.setenv(fault.ENV, "fail_ckpt_write=2")
    path = ck.CheckpointManager(str(tmp_path), keep=3).save(_state(step=4), 4)
    ck.verify_checkpoint(path, deep=True)


def test_save_async_failure_is_contained(tmp_path, monkeypatch):
    monkeypatch.setenv(fault.ENV, "enospc_at_ckpt_write=1")
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    mgr.save_async(_state(step=9), 9)
    mgr.wait()  # must not raise; the failure is logged and kept
    assert ck.list_checkpoints(str(tmp_path)) == []
    assert isinstance(mgr._last_error, OSError)


def test_truncate_ckpt_fault_tears_the_published_params(tmp_path, monkeypatch):
    monkeypatch.setenv(fault.ENV, "truncate_ckpt=1,unit=%d" % os.getpid())
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(_state(step=1), 1)
    mgr.save(_state(step=2), 2)
    assert mgr.latest_valid() == ck.step_dir(str(tmp_path), 2)
    with pytest.raises(ck.CheckpointError, match="torn write"):
        ck.verify_checkpoint(ck.step_dir(str(tmp_path), 1))


# ---------------------------------------------------------------------------
# fault spec + retry policy
# ---------------------------------------------------------------------------

def test_fault_unset_is_noop(monkeypatch):
    monkeypatch.delenv(fault.ENV, raising=False)
    assert not fault.configured()
    fault.fire("step", step=1)


def test_fault_malformed_directives_ignored(monkeypatch):
    monkeypatch.setenv(fault.ENV, "nonsense,foo=bar,kill_at_step=xyz, ,=3")
    assert fault.configured()
    fault.fire("step", step=1)
    fault.fire("ckpt_write", path="p")


def test_fault_budget_is_consumed_once(monkeypatch):
    monkeypatch.setenv(fault.ENV, "fail_kv_push=1,unit=%d" % os.getpid())
    with pytest.raises(OSError) as exc:
        fault.fire("kv_push", key="3")
    assert exc.value.errno == errno.EIO
    fault.fire("kv_push", key="3")  # budget spent: a no-op


def test_fault_spec_parses_as_the_jax_package_does(monkeypatch):
    raw = ("kill_at_step=7,enospc_at_ckpt_write=1,replica_lost=2@9,heartbeat_stall=1@x,"
           "bad, =4,nan_grad_at_step=3")
    monkeypatch.setenv(fault.ENV, raw)
    assert fault._spec() == jfault._spec()
    assert fault._spec()[1]["replica_lost"] == (2, 9)


def test_fault_inert_directives_do_nothing(tmp_path, monkeypatch):
    """The step point's directives whose sites are elsewhere (recordio,
    decode, collectives) do nothing there; ``replica_lost`` and
    ``heartbeat_stall`` are live since the multi-process slice and write
    the JAX package's tombstone files, no others."""
    spec = ("replica_lost=0@1,heartbeat_stall=1@1,fail_recordio_read=1,bad_record=1,"
            "delay_collective_ms=1,unit=%d" % os.getpid())
    got = {}
    for name, mod in (("port", fault), ("jax", jfault)):
        run = tmp_path / name
        run.mkdir()
        monkeypatch.setenv("MXTPU_RUN_DIR", str(run))
        monkeypatch.setenv(fault.ENV, spec)
        mod.fire("step", step=1)
        got[name] = sorted(os.listdir(run))
    assert got["port"] == got["jax"] == ["hb_0", "lost_0", "prog_1", "stall_1"]


def test_batch_poison_fires_once_per_directive(monkeypatch):
    monkeypatch.setenv(fault.ENV, "nan_grad_at_step=3,loss_spike_at_step=5,u=%d" % os.getpid())
    assert fault.batch_poison(2) is None
    assert fault.batch_poison(3) == "nan"
    assert fault.batch_poison(3) is None
    assert fault.batch_poison(5) == "spike"


def test_retry_backoff_then_success():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "transient")
        return "ok"

    assert retry.call(flaky, max_attempts=5, base_delay=0.05, jitter=0.0,
                      sleep=sleeps.append) == "ok"
    assert calls["n"] == 3
    assert sleeps == [0.05, 0.1]


def test_retry_gives_up_after_max_attempts():
    def always():
        raise retry.TransientError("still down")

    with pytest.raises(retry.TransientError):
        retry.call(always, max_attempts=3, sleep=lambda s: None)


def test_retry_does_not_catch_permanent_errors():
    calls = {"n": 0}

    def permanent():
        calls["n"] += 1
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        retry.call(permanent, max_attempts=5, sleep=lambda s: None)
    assert calls["n"] == 1


def test_retry_classification():
    assert retry.is_retryable(OSError(errno.EIO, "io"))
    assert retry.is_retryable(OSError(errno.ETIMEDOUT, "t"))
    assert retry.is_retryable(retry.TransientError("x"))
    assert not retry.is_retryable(OSError(errno.ENOSPC, "full"))
    assert not retry.is_retryable(ValueError("x"))


def test_kvstore_push_pull_faults_absorbed_by_retry(monkeypatch):
    monkeypatch.setenv("MXTPU_RETRY_MAX", "3")
    monkeypatch.setenv(fault.ENV, "fail_kv_push=2,fail_kv_pull=2,u=%d" % os.getpid())
    kv = tmx.kv.create("local")
    kv.init(3, tmx.nd.zeros((2, 2)))
    kv.push(3, [tmx.nd.ones((2, 2)), tmx.nd.ones((2, 2))])
    out = tmx.nd.zeros((2, 2))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 2.0, np.float32))


def test_kvstore_push_gives_up_past_the_retry_budget(monkeypatch):
    monkeypatch.setenv("MXTPU_RETRY_MAX", "2")
    monkeypatch.setenv(fault.ENV, "fail_kv_push=5,u=%d" % os.getpid())
    kv = tmx.kv.create("local")
    kv.init(0, tmx.nd.zeros((2,)))
    with pytest.raises(OSError):
        kv.push(0, tmx.nd.ones((2,)))


# ---------------------------------------------------------------------------
# iterator skip
# ---------------------------------------------------------------------------

def test_ndarrayiter_skip_is_cursor_math():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    it = tmx.io.NDArrayIter(x, np.zeros(10, np.float32), batch_size=2)
    it.reset()
    it.skip(3)
    np.testing.assert_array_equal(it.next().data[0].asnumpy(), x[6:8])


@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
def test_ndarrayiter_skip_matches_sequential_all_modes(mode):
    """skip(k) leaves the iterator where k next() calls would: cursor, the
    rest of the stream, and the next epoch after reset(); and where the
    JAX package's skip leaves it."""
    x = np.arange(40, dtype=np.float32).reshape(10, 4)

    def make(pkg=tmx):
        it = pkg.io.NDArrayIter(x, np.zeros(10, np.float32), batch_size=3,
                                last_batch_handle=mode)
        it.reset()
        return it

    def drain(it):
        out = []
        while it.iter_next():
            out.append(np.asarray(it.getdata()[0].asnumpy()))
        return out

    for k in range(0, 8):
        skipped, walked, jax_skipped = make(), make(), make(jmx)
        skipped.skip(k)
        jax_skipped.skip(k)
        for _ in range(k):
            if not walked.iter_next():
                break
        assert skipped.cursor == walked.cursor == jax_skipped.cursor, (mode, k)
        rest_s, rest_w = drain(skipped), drain(walked)
        assert len(rest_s) == len(rest_w), (mode, k)
        for a, b in zip(rest_s, rest_w):
            np.testing.assert_array_equal(a, b)
        skipped.reset()
        walked.reset()
        assert skipped.cursor == walked.cursor, (mode, k)
        for a, b in zip(drain(skipped), drain(walked)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wrap", ["resize", "prefetch"])
def test_generic_skip_consumes_batches(wrap):
    x = np.arange(64, dtype=np.float32).reshape(16, 4)

    def make():
        inner = tmx.io.NDArrayIter(x, np.zeros(16, np.float32), batch_size=2)
        return (tmx.io.ResizeIter(inner, 6) if wrap == "resize"
                else tmx.io.PrefetchingIter(inner))

    skipped, walked = make(), make()
    skipped.skip(3)
    for _ in range(3):
        walked.next()
    np.testing.assert_array_equal(skipped.next().data[0].asnumpy(),
                                  walked.next().data[0].asnumpy())
    np.testing.assert_array_equal(walked.current_batch.data[0].asnumpy(), x[6:8])
    skipped.skip(100)  # past the end: stops at StopIteration
    with pytest.raises(StopIteration):
        skipped.next()


# ---------------------------------------------------------------------------
# preemption (in process) and crash resume (subprocess) on the fused path
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _blob_iter(pkg, batch_size=8, n=64):
    rng = np.random.RandomState(42)
    x = rng.randn(n, 8).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    return pkg.io.NDArrayIter(x, y, batch_size=batch_size)


def _weights():
    """Numpy-made weights both packages start from."""
    rng = np.random.RandomState(3)
    shapes = {"fc1_weight": (16, 8), "fc1_bias": (16,), "fc2_weight": (4, 16), "fc2_bias": (4,)}
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32) for n, s in shapes.items()}


def _fused_fit(pkg, ckpt_dir, metric, resume=None, num_epoch=1, context=None):
    np.random.seed(0)
    pkg.random.seed(0)
    context = context or [pkg.cpu(i) for i in range(4)]
    mod = pkg.mod.Module(_mlp(pkg), context=context)
    mod.fit(_blob_iter(pkg), eval_metric=metric,
            kvstore="device" if isinstance(context, list) else "local", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=pkg.init.Uniform(0.1),
            arg_params={n: pkg.nd.array(v) for n, v in _weights().items()},
            num_epoch=num_epoch, checkpoint_dir=ckpt_dir, resume=resume)
    if isinstance(context, list):
        assert mod._fused_trainer is not None
    return mod


def _params_of(mod):
    arg, aux = mod.get_params()
    out = {k: np.asarray(v.asnumpy()) for k, v in arg.items()}
    out.update({"aux:" + k: np.asarray(v.asnumpy()) for k, v in aux.items()})
    return out


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg="%s differs" % key)


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("amp", ["", "bf16"])
def test_sigterm_preempts_with_final_checkpoint_and_exact_resume(tmp_path, monkeypatch, amp):
    if amp:
        monkeypatch.setenv("MXTPU_AMP", amp)
    monkeypatch.setenv(ck.ENV_INTERVAL, "2")
    ref_metric = tmx.metric.create("acc")
    ref = _params_of(_fused_fit(tmx, str(tmp_path / "ref"), ref_metric))

    pre_dir = str(tmp_path / "pre")
    monkeypatch.setenv(fault.ENV, "preempt_at_step=5,amp=%s" % amp)
    with pytest.raises(SystemExit) as exc:
        _fused_fit(tmx, pre_dir, tmx.metric.create("acc"))
    assert exc.value.code == resilience.EXIT_PREEMPTED == 75
    monkeypatch.delenv(fault.ENV)
    assert 5 in ck.list_checkpoints(pre_dir)  # the drain's final checkpoint

    res_metric = tmx.metric.create("acc")
    res = _params_of(_fused_fit(tmx, pre_dir, res_metric, resume="auto"))
    _assert_bitwise(res, ref)
    assert res_metric.get() == ref_metric.get()


def test_async_interval_snapshots_are_the_state_of_their_step(tmp_path, monkeypatch):
    """One snapshot a step, each verifying deep, and each the state of its
    own step (a clone taken before the next step overwrote it): step s's
    params equal those of a fit that stopped after s steps."""
    monkeypatch.setenv(ck.ENV_INTERVAL, "1")
    mgr = ck.CheckpointManager(str(tmp_path / "all"), keep=100)
    _fused_fit(tmx, mgr, tmx.metric.create("acc"))
    assert mgr._last_error is None
    steps = ck.list_checkpoints(mgr.directory)
    assert steps == list(range(1, 9))
    for step in steps:
        ck.verify_checkpoint(ck.step_dir(mgr.directory, step), deep=True)
    monkeypatch.setenv(fault.ENV, "preempt_at_step=3,snap=1")
    with pytest.raises(SystemExit):
        _fused_fit(tmx, str(tmp_path / "three"), tmx.metric.create("acc"))
    got = ck.load_state(ck.step_dir(mgr.directory, 3))
    want = ck.load_state(ck.step_dir(str(tmp_path / "three"), 3))
    for kind in ("arg", "aux"):
        _assert_bitwise(got["module"][kind], want["module"][kind])
    _assert_bitwise(got["module"]["opt"]["state"], want["module"]["opt"]["state"])


def test_resume_without_checkpoint_dir_and_bad_values_raise(tmp_path):
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _fused_fit(tmx, None, "acc", resume="auto")
    with pytest.raises(ValueError, match="resume must be"):
        _fused_fit(tmx, str(tmp_path), "acc", resume="latest")


def test_elastic_shrink_is_not_ported(tmp_path, monkeypatch):
    """The elastic shrink is ported since the multi-process slice
    (tests/test_torch_elastic.py): without a run dir it watches nothing, and
    the fused fit runs to its end as without MXTPU_ELASTIC."""
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    monkeypatch.delenv("MXTPU_RUN_DIR", raising=False)
    mod = _fused_fit(tmx, str(tmp_path), "acc")
    assert mod._fused_trainer is not None
    assert ck.list_checkpoints(str(tmp_path))


def test_executor_path_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """One context (no kvstore): the updater's pickled states ride in the
    checkpoint and a resume gives the uninterrupted bits."""
    monkeypatch.setenv(ck.ENV_INTERVAL, "3")
    ref = _params_of(_fused_fit(tmx, str(tmp_path / "ref"), "acc", context=tmx.cpu()))
    monkeypatch.setenv(fault.ENV, "preempt_at_step=4,exec=1")
    with pytest.raises(SystemExit):
        _fused_fit(tmx, str(tmp_path / "pre"), "acc", context=tmx.cpu())
    monkeypatch.delenv(fault.ENV)
    state = ck.load_state(ck.step_dir(str(tmp_path / "pre"), 4))
    assert state["module"]["opt"]["kind"] == "updater"
    res = _params_of(_fused_fit(tmx, str(tmp_path / "pre"), "acc", resume="auto",
                                context=tmx.cpu()))
    _assert_bitwise(res, ref)


TRAIN_SCRIPT = textwrap.dedent("""\
    import os, sys
    sys.path.insert(0, %(repo)r)
    import logging
    logging.basicConfig(level=logging.INFO)
    import numpy as np
    import mxnet_tpu_torch as mx

    ckpt_dir, out = sys.argv[1], sys.argv[2]
    np.random.seed(0)
    mx.random.seed(0)
    with mx.cpu():
        rng = np.random.RandomState(42)
        X = rng.randn(128, 8).astype(np.float32)
        y = rng.randint(0, 4, 128).astype(np.float32)
        it = mx.io.NDArrayIter(X, y, batch_size=16)  # 8 batches an epoch

        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")

        mod = mx.mod.Module(net, context=[mx.cpu(i) for i in range(4)])
        metric = mx.metric.create("acc")
        mod.fit(it, eval_metric=metric, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Uniform(0.1), num_epoch=2,
                checkpoint_dir=ckpt_dir, resume="auto")
        assert mod._fused_trainer is not None
        arg, aux = mod.get_params()
    blob = {k: v.asnumpy() for k, v in arg.items()}
    blob.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    blob["__metric__"] = np.asarray([metric.get()[1]], dtype=np.float64)
    np.savez(out, **blob)
    print("TRAIN-DONE", flush=True)
""") % {"repo": REPO}


def _port_env(extra):
    env = os.environ.copy()
    for k in _ENV + ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run_train(script_dir, ckpt_dir, out, extra_env, timeout=240):
    script = os.path.join(script_dir, "train_ckpt.py")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(TRAIN_SCRIPT)
    return subprocess.run([sys.executable, script, ckpt_dir, out], capture_output=True,
                          text=True, timeout=timeout, env=_port_env(extra_env))


def _load_blob(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("fit_k", ["1", "2"])
def test_sigkill_crash_resume_bitwise_parity(tmp_path, fit_k):
    base_env = {"MXNET_FIT_MULTISTEP": fit_k, ck.ENV_INTERVAL: "3"}
    ref_out = str(tmp_path / "ref.npz")
    proc = _run_train(str(tmp_path), str(tmp_path / "ref_ck"), ref_out, base_env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAIN-DONE" in proc.stdout

    # SIGKILL at step 15 of 16: interval and epoch-end checkpoints exist
    crash_dir = str(tmp_path / "crash_ck")
    proc = _run_train(str(tmp_path), crash_dir, str(tmp_path / "unused.npz"),
                      dict(base_env, **{fault.ENV: "kill_at_step=15"}))
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]
    assert ck.list_checkpoints(crash_dir), "no checkpoint survived the kill"

    if fit_k == "1":
        # tear the newest checkpoint: resume falls back to the one before
        mgr = ck.CheckpointManager(crash_dir)
        newest = ck.step_dir(crash_dir, ck.list_checkpoints(crash_dir)[-1])
        params = os.path.join(newest, ck.PARAMS_FILE)
        with open(params, "r+b") as f:
            f.truncate(os.path.getsize(params) // 2)
        fallback = mgr.latest_valid()
        assert fallback is not None and fallback != newest

    res_out = str(tmp_path / "res.npz")
    proc = _run_train(str(tmp_path), crash_dir, res_out, base_env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resume: restored step" in proc.stderr
    if fit_k == "1":
        assert "skipping corrupt checkpoint" in proc.stderr
    _assert_bitwise(_load_blob(res_out), _load_blob(ref_out))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _shared_state():
    rng = np.random.RandomState(5)
    return {
        "module": {
            "arg": {"fc_weight": rng.randn(4, 3).astype(np.float32),
                    "fc_bias": rng.randn(4).astype(np.float32)},
            "aux": {"bn_moving_var": rng.rand(4).astype(np.float32),
                    "m64": rng.rand(2, 2)},
            "opt": {"kind": "fused", "t": 12,
                    "state": {"fc_weight": rng.randn(4, 3).astype(np.float32),
                              "fc_bias": (rng.randn(4).astype(np.float32),
                                          rng.rand(4).astype(np.float32)),
                              "x": None},
                    "amp": {"scale": np.asarray(32768.0, np.float32),
                            "good": np.asarray(3.0, np.float32)}},
        },
        "epoch": 2, "nbatch": 5, "global_step": 12, "sample_position": 40,
        "metric": None,
        "rng": {"numpy": np.random.RandomState(1).get_state(), "mx": None},
        "topology": {"dp": 4, "mesh": {"dp": 4}, "global_batch": 8, "per_replica_batch": 2},
        "health": {"clean": True, "step": 12, "last_clean_step": 12, "trips": 0, "skips": 0},
    }


def test_same_state_gives_the_same_bytes_in_both_packages(tmp_path):
    jpath = jck.CheckpointManager(str(tmp_path / "j")).save(_shared_state(), 12)
    tpath = ck.CheckpointManager(str(tmp_path / "t")).save(_shared_state(), 12)
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath))
    for name in (ck.PARAMS_FILE, ck.OPT_FILE, ck.TRAIN_FILE):
        assert open(os.path.join(jpath, name), "rb").read() == \
            open(os.path.join(tpath, name), "rb").read(), name
    jm, tm = jck.read_manifest(jpath), ck.read_manifest(tpath)
    jm.pop("time")
    tm.pop("time")
    assert jm == tm
    # and each package verifies (deep) and loads the other's
    ck.verify_checkpoint(jpath, deep=True)
    jck.verify_checkpoint(tpath, deep=True)
    mine, theirs = ck.load_state(jpath), jck.load_state(tpath)
    for kind in ("arg", "aux"):
        _assert_bitwise(mine["module"][kind], theirs["module"][kind])
        assert {k: v.dtype for k, v in mine["module"][kind].items()} == \
            {k: v.dtype for k, v in theirs["module"][kind].items()}


def _jax_fit(ckpt_dir, metric, resume=None, num_epoch=1):
    return _fused_fit(jmx, ckpt_dir, metric, resume=resume, num_epoch=num_epoch)


def _opt_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _opt_tree_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _opt_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_jax_checkpoint_verifies_loads_and_resumes_in_the_port(tmp_path, monkeypatch):
    """JAX's fit preempted at step 5 (mid-epoch: its metric pickle and
    iterator cursor ride along); the port verifies it deep, loads the same
    params and fused optimizer state JAX loads, and resumes to JAX's
    uninterrupted two-epoch result within the fit-parity tolerance."""
    monkeypatch.setenv(ck.ENV_INTERVAL, "2")
    jref = _params_of(_jax_fit(str(tmp_path / "jref"), "acc", num_epoch=2))
    jdir = str(tmp_path / "j")
    monkeypatch.setenv(fault.ENV, "preempt_at_step=5,jax=1")
    with pytest.raises(SystemExit) as exc:
        _jax_fit(jdir, jmx.metric.create("acc"), num_epoch=2)
    assert exc.value.code == 75
    monkeypatch.delenv(fault.ENV)
    path = ck.step_dir(jdir, 5)
    manifest = ck.verify_checkpoint(path, deep=True)
    assert manifest["topology"]["dp"] == 4
    mine, theirs = ck.load_state(path), jck.load_state(path)
    for kind in ("arg", "aux"):
        _assert_bitwise(mine["module"][kind], theirs["module"][kind])
    assert mine["module"]["opt"]["kind"] == "fused"
    _opt_tree_equal(mine["module"]["opt"], theirs["module"]["opt"])
    assert mine["nbatch"] == 5 and mine["global_step"] == 5
    assert mine["rng"]["mx"] is not None and "torch" not in mine["rng"]

    metric = tmx.metric.create("acc")
    res = _params_of(_fused_fit(tmx, jdir, metric, resume="auto", num_epoch=2))
    _assert_close(res, jref)
    assert 0.0 <= metric.get()[1] <= 1.0


def test_port_checkpoint_verifies_loads_and_resumes_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(ck.ENV_INTERVAL, "2")
    tref = _params_of(_fused_fit(tmx, str(tmp_path / "tref"), "acc", num_epoch=2))
    tdir = str(tmp_path / "t")
    monkeypatch.setenv(fault.ENV, "preempt_at_step=5,port=1")
    with pytest.raises(SystemExit):
        _fused_fit(tmx, tdir, tmx.metric.create("acc"), num_epoch=2)
    monkeypatch.delenv(fault.ENV)
    path = ck.step_dir(tdir, 5)
    jck.verify_checkpoint(path, deep=True)
    theirs = jck.load_state(path)
    assert theirs["rng"]["mx"] is None and theirs["rng"]["torch"] is not None
    mine = ck.load_state(path)
    for kind in ("arg", "aux"):
        _assert_bitwise(theirs["module"][kind], mine["module"][kind])
    _opt_tree_equal(theirs["module"]["opt"], mine["module"]["opt"])
    # JAX's params_from_checkpoint and the port's give the same arrays
    from mxnet_tpu import predict as jpredict

    jp = jpredict.params_from_checkpoint(path)
    tp = tmx.predict.params_from_checkpoint(path)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k].asnumpy()), tp[k].asnumpy())
    res = _params_of(_jax_fit(tdir, jmx.metric.create("acc"), resume="auto", num_epoch=2))
    _assert_close(res, tref)


def test_jax_executor_path_updater_is_refused_by_name(tmp_path, monkeypatch):
    monkeypatch.setenv(ck.ENV_INTERVAL, "4")
    jdir = str(tmp_path / "j")
    _fused_fit(jmx, jdir, "acc", context=jmx.cpu())
    state = ck.load_state(ck.CheckpointManager(jdir).latest_valid())
    assert state["module"]["opt"]["kind"] == "updater"
    with pytest.raises(ck.CheckpointError,
                       match=r"optimizer\.state: holds an object of class "
                             r"mxnet_tpu\.ndarray\.NDArray"):
        _fused_fit(tmx, jdir, "acc", resume="auto", context=tmx.cpu())


# ---------------------------------------------------------------------------
# legacy savers, serving from a checkpoint, the inspector, the imports
# ---------------------------------------------------------------------------

def test_legacy_savers_write_atomically_and_load_in_jax(tmp_path):
    mod = _fused_fit(tmx, None, "acc")
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    tmx.model.save_checkpoint(prefix + "b", 1, mod.symbol, *mod.get_params())
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    _sym, args, auxs = jmx.model.load_checkpoint(prefix, 1)
    arg, _ = mod.get_params()
    for k, v in arg.items():
        np.testing.assert_array_equal(np.asarray(args[k].asnumpy()), v.asnumpy())
    assert open(prefix + "-0001.params", "rb").read() == \
        open(prefix + "b-0001.params", "rb").read()


def test_params_from_checkpoint_serves_what_module_predicts(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    mod = _fused_fit(tmx, mgr, "acc")
    path = ck.step_dir(mgr.directory, 8)
    params = tmx.predict.params_from_checkpoint(path)
    assert all(v.dtype == np.float32 for v in params.values())
    arg, _ = mod.get_params()  # the f32 masters
    for k, v in arg.items():
        np.testing.assert_array_equal(params["arg:" + k].asnumpy(), v.asnumpy())
    x = _blob_iter(tmx).data[0][1][:8]
    pred = tmx.predict.Predictor(mod.symbol.tojson(), params, {"data": (8, 8)}, ctx=tmx.cpu())
    pred.set_input("data", x)
    pred.forward()
    want = mod.predict(tmx.io.NDArrayIter(x, None, batch_size=8)).asnumpy()
    np.testing.assert_allclose(pred.get_output(0), want, rtol=1e-5, atol=1e-6)
    # a corrupt tensor is named
    manifest = ck.read_manifest(path)
    manifest["tensors"]["arg:fc1_bias"] ^= 1
    with open(os.path.join(path, ck.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ck.CheckpointError, match="arg:fc1_bias"):
        tmx.predict.params_from_checkpoint(path)


@pytest.mark.timeout(180)
def test_serve_checkpoint_answers_a_request(tmp_path):
    """``tools/serve.py --checkpoint DIR --symbol F --cpu`` as a subprocess:
    it serves the checkpoint's weights over its socket, one request gives
    the predictor's row, SIGTERM drains and exits 0."""
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    mod = _fused_fit(tmx, mgr, "acc")
    sym_file = str(tmp_path / "mlp.json")
    mod.symbol.save(sym_file)
    path = ck.step_dir(mgr.directory, 8)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve", "--checkpoint", path,
         "--symbol", sym_file, "--input", "data=8", "--port", "0", "--cpu", "--max-batch", "2"],
        cwd=REPO, env=_port_env({"PYTHONPATH": REPO}), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on "), (line, proc.stderr.read() if proc.poll() else "")
        port = int(line.split()[2].split(":")[1])
        x = _blob_iter(tmx).data[0][1][:1]
        with socket.create_connection(("127.0.0.1", port), 30) as s:
            f = s.makefile("rwb")
            f.write((json.dumps({"inputs": {"data": x[0].tolist()}}) + "\n").encode())
            f.flush()
            reply = json.loads(f.readline().decode())
        want = mod.predict(tmx.io.NDArrayIter(np.repeat(x, 8, 0), None,
                                              batch_size=8)).asnumpy()[0]
        np.testing.assert_allclose(np.asarray(reply["outputs"][0], np.float32), want,
                                   rtol=1e-5, atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_port_ckpt_inspect_reads_a_jax_checkpoint(tmp_path, capsys):
    from mxnet_tpu_torch.tools import ckpt_inspect

    jdir = str(tmp_path / "j")
    jck.CheckpointManager(jdir).save(_shared_state(), 12)
    assert ckpt_inspect.main([jdir, "--verify"]) == 0
    assert "OK (deep)" in capsys.readouterr().out
    assert ckpt_inspect.main([jdir, "--state", "latest"]) == 0
    out = capsys.readouterr().out
    assert "global_step: 12" in out and "arg:fc_weight" in out and "optimizer  : fused" in out
    assert ckpt_inspect._self_test() == 0


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.resilience, "
            "mxnet_tpu_torch.tools.ckpt_inspect, mxnet_tpu_torch.tools.serve; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, env=_port_env({"PYTHONPATH": REPO}), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
