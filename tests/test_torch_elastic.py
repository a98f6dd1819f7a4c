"""Liveness, supervision and the elastic shrink in the port, against the
JAX package and the repo's tools:

- heartbeat files cross both ways: the port's writers and ``mark_lost``
  are read by JAX's ``dead_nodes`` / ``stalled_nodes`` / ``lost_nodes`` /
  ``tombstoned``, and JAX's by the port's (one file format);
- the port's ``tools/watchdog.py`` ``decide`` equals the repo's over a grid
  of (rc, lost, restarts, world, elastic), and its self-test passes;
- ``launch.worker_env`` and the mpi / sge / yarn / ssh builders, and the
  local launcher's process-group kill (a rank that fails leaves no peer
  waiting);
- the fault points ``replica_lost`` / ``heartbeat_stall`` /
  ``delay_collective_ms`` against JAX's;
- the non-slow cases of ``tests/test_elastic.py`` and
  ``tests/test_failure_recovery.py`` and the heartbeat cases of
  ``tests/test_resilience.py``, on the port;
- the two-process shrink (a lost peer, exit 76, the watchdog's relaunch at
  one worker, the resume), marked slow as the JAX side's relaunch tests are.
"""
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import heartbeat as jhb
from mxnet_tpu.resilience import fault as jfault
from mxnet_tpu_torch import resilience
from mxnet_tpu_torch.parallel import heartbeat as hb
from mxnet_tpu_torch.resilience import checkpoint as ck
from mxnet_tpu_torch.resilience import fault
from mxnet_tpu_torch.tools import launch, watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _repo_tool(name):
    spec = importlib.util.spec_from_file_location("repo_" + name,
                                                  os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jwatchdog = _repo_tool("watchdog")
jlaunch = _repo_tool("launch")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in (fault.ENV, "MXTPU_RUN_DIR", "MXTPU_ELASTIC", "MXTPU_WORLD_SIZE",
              "MXTPU_ELASTIC_POLL", "DMLC_RANK", "DMLC_NUM_WORKER", "MXTPU_CKPT_INTERVAL"):
        monkeypatch.delenv(k, raising=False)
    with tmx.cpu():
        yield


# -- heartbeat files, both ways ---------------------------------------------------
@pytest.mark.parametrize("writer,reader", [(hb, jhb), (jhb, hb)],
                         ids=["port-to-jax", "jax-to-port"])
def test_heartbeat_files_cross_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    w0 = writer.HeartbeatWriter(d, 0, interval=0.05).start()
    w1 = writer.HeartbeatWriter(d, 1, interval=0.05).start()
    try:
        time.sleep(0.15)
        assert reader.dead_nodes(d, 3, timeout=5.0) == [2]  # never started
        assert reader.lost_nodes(d, 3, timeout=5.0) == []  # not a shrink vote
        writer.mark_lost(d, 1)
        assert reader.tombstoned(d) == {1}
        assert reader.lost_nodes(d, 3, timeout=5.0) == [1]
        time.sleep(0.15)  # the lost writer must not resurrect its back-dated file
        assert reader.dead_nodes(d, 3, timeout=5.0) == [1, 2]
        writer.mark_lost(d, 0, stall_only=True)
        assert reader.stalled_nodes(d, 1, timeout=5.0) == [0]
    finally:
        w0.stop()
        w1.stop()
    assert sorted(os.listdir(d)) == sorted(
        f for f in os.listdir(d) if f.split("_")[0] in ("hb", "prog", "lost", "stall", "clock"))


def test_run_dir_and_progress_credit(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_RUN_DIR", str(tmp_path))
    assert hb.run_dir() == jhb.run_dir() == str(tmp_path)
    w = hb.HeartbeatWriter(str(tmp_path), 0, interval=60.0)
    w.progress()
    time.sleep(0.5)
    w.progress(ticks=4)  # a 4-step dispatch banks future credit (about 1.5 s)
    assert os.path.getmtime(os.path.join(str(tmp_path), "prog_0")) > time.time()


# -- the watchdog ---------------------------------------------------------------
def test_watchdog_decide_equals_jax():
    rcs = (0, 1, 7, 75, 76, 78, -9)
    losts = ([], [0], [3], [1, 2], [3, 3], list(range(4)))
    for rc, lost, restarts, world, elastic in itertools.product(
            rcs, losts, (0, 1, 2), (1, 2, 4, 8), (False, True)):
        got = watchdog.decide(rc, lost, restarts, 2, world, elastic)
        assert got == jwatchdog.decide(rc, lost, restarts, 2, world, elastic), \
            (rc, lost, restarts, world, elastic)


def test_watchdog_self_test_and_checkpoint_finder(tmp_path):
    assert watchdog._self_test() == 0
    prefix = str(tmp_path / "model")
    assert watchdog.find_latest_checkpoint(prefix) is None
    for e in (1, 2, 10):
        open("%s-%04d.params" % (prefix, e), "w").close()
    assert watchdog.find_latest_checkpoint(prefix) == jwatchdog.find_latest_checkpoint(prefix)


# -- the launcher ---------------------------------------------------------------------
def test_worker_env_names(tmp_path):
    got = launch.worker_env(1, 4, "10.0.0.1:1234", str(tmp_path), base={})
    want = jlaunch.worker_env(1, 4, "10.0.0.1:1234", str(tmp_path))
    dmlc = {k: v for k, v in want.items() if k.startswith("DMLC_")}
    assert {k: got[k] for k in dmlc} == dmlc
    assert got["MXTPU_RUN_DIR"] == want["MXTPU_RUN_DIR"] == str(tmp_path)
    assert got["MXTPU_COORDINATOR_ADDRESS"] == "10.0.0.1:1234"
    assert (got["DMLC_PS_ROOT_URI"], got["DMLC_PS_ROOT_PORT"]) == ("10.0.0.1", "1234")


def test_job_script_builders(tmp_path, monkeypatch):
    shim = launch.rank_shim(3, "h0:29500", ["python", "train.py", "--kv-store", "dist sync"])
    jshim = jlaunch._RANK_SHIM % {"n": 3, "coord": "h0:29500",
                                  "cmd": "python train.py --kv-store 'dist sync'"}
    # the scheduler's rank variables and the reference's names are JAX's
    for line in jshim.splitlines():
        if line.startswith(("RANK=", "if [", "export DMLC_", "exec ")):
            assert line in shim.splitlines(), line
    assert 'export MXTPU_COORDINATOR_ADDRESS="h0:29500"' in shim
    assert launch.mpi_command(3, "s.sh")[1:] == ["-np", "3", "s.sh"]
    assert launch.sge_command(3, "s.sh", queue="q") == [
        "qsub", "-terse", "-cwd", "-V", "-b", "y", "-t", "1-3", "-q", "q", "s.sh"]
    yarn = launch.yarn_command(3, "s.sh")
    assert yarn[-2] == "-shell_command" and "OMPI_COMM_WORLD_RANK=$((ORD - 2))" in yarn[-1]
    cmds = launch.ssh_commands(["a", "b"], 3, ["python", "t.py"], 29501, cwd="/w")
    assert [c[3] for c in cmds] == ["a", "b", "a"]
    assert "DMLC_RANK=2" in cmds[2][4] and "MXTPU_COORDINATOR_ADDRESS=a:29501" in cmds[2][4]
    monkeypatch.chdir(tmp_path)
    assert launch.main(["-n", "2", "--launcher", "mpi", "--dry-run", "python", "t.py"]) == 0
    assert launch.main(["-n", "2", "--launcher", "sge", "--dry-run", "python", "t.py"]) == 0


def test_local_launcher_kills_the_peer_of_a_failed_rank(tmp_path):
    """Rank 1 fails at once while rank 0 would wait a minute (as in a
    collective): the launcher returns rank 1's code within seconds and
    leaves no worker behind."""
    code = ("import os, sys, time\n"
            "r = int(os.environ['DMLC_RANK'])\n"
            "open(os.path.join(%r, 'pid%%d' %% r), 'w').write(str(os.getpid()))\n"
            "time.sleep(60) if r == 0 else (time.sleep(0.5), sys.exit(3))\n" % str(tmp_path))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
                        sys.executable, "-c", code], cwd=ROOT, timeout=60,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 3
    assert time.time() - t0 < 30
    pid0 = int((tmp_path / "pid0").read_text())
    time.sleep(0.2)
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)


def test_local_launcher_world_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_WORLD_SIZE", "3")
    code = "import os; open(os.path.join(%r, os.environ['DMLC_RANK']), 'w').close()" % str(
        tmp_path)
    assert launch.main([sys.executable, "-c", code]) == 0
    assert sorted(os.listdir(tmp_path)) == ["0", "1", "2"]


# -- fault points -------------------------------------------------------------------
def test_fault_spec_parses_rank_at_step(monkeypatch):
    raw = "replica_lost=3@5,heartbeat_stall=1@7,kill_at_step=9,bogus=x@y,junk=zz,uniq=%d" % \
        os.getpid()
    monkeypatch.setenv(fault.ENV, raw)
    assert fault._spec()[1] == jfault._spec()[1]
    assert fault._spec()[1]["replica_lost"] == (3, 5)


def test_replica_lost_tombstones_and_silences_heartbeat(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv(hb.RUN_DIR_ENV, d)
    monkeypatch.setenv(fault.ENV, "replica_lost=2@4,uniq=%d" % os.getpid())
    victim = hb.HeartbeatWriter(d, 2, interval=0.05).start()
    survivor = hb.HeartbeatWriter(d, 0, interval=0.05).start()
    try:
        for step in range(1, 4):
            fault.fire("step", step=step)
        assert hb.tombstoned(d) == set()
        fault.fire("step", step=4)
        assert hb.tombstoned(d) == jhb.tombstoned(d) == {2}
        time.sleep(0.25)
        assert hb.lost_nodes(d, 4, timeout=60.0) == jhb.lost_nodes(d, 4, timeout=60.0) == [2]
    finally:
        victim.stop()
        survivor.stop()


def test_heartbeat_stall_freezes_progress_only(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv(hb.RUN_DIR_ENV, d)
    monkeypatch.setenv(fault.ENV, "heartbeat_stall=1@2,uniq=%d" % os.getpid())
    w = hb.HeartbeatWriter(d, 1, interval=0.05).start()
    try:
        fault.fire("step", step=1)
        fault.fire("step", step=2)
        time.sleep(0.25)
        w.progress()  # swallowed by the stall tombstone
        assert hb.stalled_nodes(d, 2, timeout=0.2) == [1]
        assert jhb.stalled_nodes(d, 2, timeout=0.2) == [1]
        assert hb.lost_nodes(d, 2, timeout=60.0) == []
    finally:
        w.stop()


def test_collective_point_delays_and_the_lost_rank_stops(tmp_path, monkeypatch):
    monkeypatch.setenv(fault.ENV, "delay_collective_ms=150,uniq=%d" % os.getpid())
    t0 = time.perf_counter()
    fault.fire("collective")
    assert time.perf_counter() - t0 >= 0.14
    # the lost rank stops in its next collective (not in a local reduce)
    code = ("import importlib.util as u\n"
            "s = u.spec_from_file_location('fault', %r)\n"
            "fault = u.module_from_spec(s); s.loader.exec_module(fault)\n"
            "fault.fire('step', step=1)\nfault.fire('collective', local=True)\n"
            "print('local ok', flush=True)\nfault.fire('collective')\nprint('not reached')\n"
            % fault.__file__)
    env = dict(os.environ, MXTPU_FAULT_INJECT="replica_lost=1@1", DMLC_RANK="1",
               MXTPU_RUN_DIR=str(tmp_path))
    p = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                         text=True)
    try:
        assert p.stdout.readline() == "local ok\n"
        with pytest.raises(subprocess.TimeoutExpired):
            p.wait(timeout=1.5)
    finally:
        p.kill()
    assert p.stdout.read() == ""
    assert sorted(os.listdir(tmp_path)) == ["hb_1", "lost_1"]


# -- tests/test_failure_recovery.py and tests/test_resilience.py ------------------
def test_heartbeat_dead_node_detection(tmp_path):
    d = str(tmp_path)
    w0 = hb.HeartbeatWriter(d, 0, interval=0.2).start()
    w1 = hb.HeartbeatWriter(d, 1, interval=0.2).start()
    try:
        time.sleep(0.3)
        assert hb.dead_nodes(d, 3, timeout=5.0) == [2]
        w1.stop()
        old = time.time() - 120
        os.utime(os.path.join(d, "hb_1"), (old, old))
        assert hb.dead_nodes(d, 3, timeout=30.0) == [1, 2]
        assert hb.dead_nodes(d, 1, timeout=30.0) == []
    finally:
        w0.stop()
        w1.stop()


def test_kvstore_reports_dead_nodes(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv(hb.RUN_DIR_ENV, d)
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    kv = tmx.kvstore.create("local")
    assert kv.num_workers == 3
    hb.HeartbeatWriter(d, 0).start().stop()
    hb.HeartbeatWriter(d, 1).start().stop()
    assert kv.get_num_dead_node(0, timeout=60) == 1
    old = time.time() - 120
    for r in (0, 1):
        os.utime(os.path.join(d, "hb_%d" % r), (old, old))
    assert kv.get_num_dead_node(0, timeout=60) == 3


def test_heartbeat_stop_start_single_beater(tmp_path):
    w = hb.HeartbeatWriter(str(tmp_path), rank=0, interval=0.05)
    w.start()
    first = w._thread
    w.start()
    assert w._thread is first
    w.stop()
    w.start()
    assert w._thread is not None and w._thread.is_alive()
    assert len([t for t in threading.enumerate()
                if t.name == "mxtpu-heartbeat" and t.is_alive()]) == 1
    w.stop()


def test_heartbeat_stop_timeout_keeps_handle_then_reaps(tmp_path):
    w = hb.HeartbeatWriter(str(tmp_path), rank=1, interval=0.05)

    class _Winding:
        def __init__(self):
            self.alive, self.joined_blocking = True, False

        def is_alive(self):
            return self.alive

        def join(self, timeout=None):
            if timeout is None:
                self.joined_blocking, self.alive = True, False

    stuck = _Winding()
    w._thread = stuck
    w.stop()
    assert w._thread is stuck
    w.start()
    assert stuck.joined_blocking and w._thread is not stuck and w._thread.is_alive()
    w.stop()


# -- tests/test_elastic.py: the lost peer in fit ---------------------------------
def _mlp():
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _blob_iter(batch_size=8, n=64):
    rng = np.random.RandomState(42)
    x = rng.randn(n, 8).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    return tmx.io.NDArrayIter(x, y, batch_size=batch_size)


def test_fit_elastic_guard_exits_reshape_on_lost_peer(tmp_path, monkeypatch):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    monkeypatch.setenv(hb.RUN_DIR_ENV, str(run_dir))
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    monkeypatch.setenv("MXTPU_WORLD_SIZE", "4")
    monkeypatch.setenv("MXTPU_ELASTIC_POLL", "0")
    monkeypatch.setenv(fault.ENV, "replica_lost=3@5,uniq=%d" % os.getpid())
    np.random.seed(0)
    tmx.random.seed(0)
    mod = tmx.mod.Module(_mlp(), context=[tmx.cpu(i) for i in range(4)])
    ckpt_dir = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as exc:
        mod.fit(_blob_iter(), eval_metric=tmx.metric.create("acc"), kvstore="device",
                optimizer="sgd", optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=tmx.init.Uniform(0.1), num_epoch=1, checkpoint_dir=ckpt_dir)
    assert exc.value.code == resilience.EXIT_RESHAPE == 76
    assert 5 in ck.list_checkpoints(ckpt_dir)
    assert hb.tombstoned(str(run_dir)) == {3}
    # fit kept rank 0's heartbeat files and ticked its progress
    assert {"hb_0", "prog_0"} <= set(os.listdir(run_dir))


def test_fit_writes_heartbeat_progress_under_a_run_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(hb.RUN_DIR_ENV, str(tmp_path))
    mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
    mod.fit(_blob_iter(), num_epoch=1, optimizer="sgd")
    assert {"hb_0", "prog_0"} <= set(os.listdir(tmp_path))
    assert not [t for t in threading.enumerate()
                if t.name == "mxtpu-heartbeat" and t.is_alive()]


def test_preempting_one_rank_of_a_sharded_fit_checkpoints_the_whole_state(tmp_path):
    """SIGTERM reaches rank 1 alone (``preempt_at_step=3`` in its
    environment only) of a two-process fused fit in "shard" mode, whose
    optimizer state each process holds 1/2 of: the ranks agree on the
    signal at the same boundary, gather the state together, rank 0 writes
    the step-3 checkpoint with every parameter's whole momentum, and the
    job exits 75 (no collective left unmatched, no hang)."""
    ckpt = tmp_path / "ck"
    rank1_only = ('if [ "$DMLC_RANK" = 1 ]; then export MXTPU_FAULT_INJECT=preempt_at_step=3; '
                  'fi; exec "$@"')
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2", "sh", "-c",
           rank1_only, "sh", sys.executable, "-m", "mxnet_tpu_torch.tools.dist_check",
           "--out", str(tmp_path / "out"), "--device", "cpu", "--checks", "none",
           "--fit", "dist_device_sync", "--model", "mlp-bn", "--steps", "6", "--batch", "16",
           "--ckpt", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
               MXTPU_SHARD_UPDATE="1", MXTPU_BUCKET_BYTES="1024", MXTPU_DIST_TIMEOUT="60")
    for k in ("XLA_FLAGS", fault.ENV, "MXTPU_AMP", "MXTPU_CKPT_INTERVAL", "MXTPU_RUN_DIR"):
        env.pop(k, None)
    r = subprocess.run(cmd, cwd=ROOT, env=env, timeout=120, capture_output=True, text=True)
    assert r.returncode == resilience.EXIT_PREEMPTED == 75, r.stdout[-3000:] + r.stderr[-5000:]
    assert r.stderr.count("preempted: checkpoint at step 3 written") == 2, r.stderr[-5000:]
    assert ck.list_checkpoints(str(ckpt)) == [3]
    state = ck.CheckpointManager(str(ckpt)).load()
    assert state["global_step"] == 3
    module = state["module"]
    assert module["opt"]["kind"] == "fused"
    for name, w in module["arg"].items():
        assert np.asarray(module["opt"]["state"][name]).shape == np.asarray(w).shape, name


@pytest.mark.slow
def test_watchdog_elastic_shrink_two_processes(tmp_path):
    """Two workers of a dist_sync fit under the port's watchdog: rank 1 is
    declared lost at step 3, rank 0 sees it through the heartbeat files,
    checkpoints and exits 76; the watchdog relaunches the job at one
    worker, which resumes from the checkpoint and finishes."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.watchdog", "--elastic", "--world", "2",
           "--max-restarts", "0", "--", sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
           sys.executable, "-m", "mxnet_tpu_torch.tools.dist_check", "--out", str(out),
           "--device", "cpu", "--checks", "none", "--fit", "dist_sync", "--model", "mlp-bn",
           "--steps", "6", "--batch", "16", "--ckpt", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               MXTPU_FAULT_INJECT="replica_lost=1@3", MXTPU_ELASTIC_POLL="0",
               MXTPU_CKPT_INTERVAL="2")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(cmd, cwd=ROOT, env=env, timeout=300, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    assert "elastic shrink" in r.stdout and "world 1" in r.stdout, r.stdout
    assert "exiting 76" in r.stderr and "resume: restored step 3" in r.stderr
    res = json.loads((out / "rank0.json").read_text())
    assert res["size"] == 1 and res["fits"]["dist_sync"]["steps"] == 3
    assert 3 in ck.list_checkpoints(str(tmp_path / "ck"))
