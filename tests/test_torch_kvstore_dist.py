"""The port's dist kvstore types and GradBucketer in one process, against
the JAX package (``mxnet_tpu/kvstore.py``).

- ``GradBucketer.drain`` builds the JAX package's buckets from the same
  pushes (priority then push order, same-dtype, the byte cap);
- the cases of ``tests/test_kvstore.py`` on the one-worker ``dist_*`` types
  (no launcher: a one-worker store, as JAX's is), with the same numbers as
  JAX's store;
- the cases of ``tests/test_kvstore_overlap.py`` that apply to a store that
  runs its pushes on the caller's thread: the bucketer's deferral, drain
  order, byte cap, legacy per-key shape, dtype split, the pull's flush and
  its telemetry, on a store flipped onto the dist path (``type`` and
  ``_size``; its collectives pass values through in one process);
- the kvstore-server cases of ``tests/test_executor_manager.py``.
The cross-process sums run in ``tests/test_torch_dist.py``.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import kvstore as jkvs
from mxnet_tpu_torch import kvstore as tkvs
from mxnet_tpu_torch.parallel import mesh as tmesh

SHAPE = (4, 4)
DIST = ("dist_sync", "dist_device_sync", "dist_async", "dist")


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in ("DMLC_NUM_WORKER", "DMLC_RANK", "MXTPU_BUCKET_BYTES", "MXTPU_RUN_DIR",
              "MXTPU_BUCKET_TWO_PHASE", "MXTPU_BUCKET_REDUCE_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    with tmx.cpu():
        yield


# -- GradBucketer.drain against JAX's ------------------------------------------
_PUSHES = {
    "fifo_under_cap": (1024, [(0, "a", (4,), "float32"), (0, "b", (8,), "float32"),
                              (0, "c", (2,), "float32")]),
    "priority_first": (1024, [(-2, 2, (4,), "float32"), (-1, 1, (4,), "float32"),
                              (0, 0, (4,), "float32"), (-1, 3, (4,), "float32")]),
    "byte_cap": (32, [(0, 0, (6,), "float32"), (-1, 1, (6,), "float32"),
                      (-2, 2, (2,), "float32"), (-3, 3, (2,), "float32")]),
    "dtype_split": (4096, [(-5, "a", (4,), "float64"), (0, "b", (4,), "float32"),
                           (-1, "c", (3,), "float32"), (-6, "d", (1,), "float64")]),
    "zero_cap": (0, [(0, 0, (2,), "float32"), (-1, 1, (2,), "float32")]),
    "resnet_like": (4 << 20, [(-i, i, s, "float32") for i, s in enumerate(
        [(64, 3, 7, 7), (64,), (64,), (256, 64, 1, 1), (2048, 512, 3, 3), (1000, 2048),
         (1000,)])]),
}


@pytest.mark.parametrize("case", sorted(_PUSHES))
def test_bucketer_drain_matches_jax(case):
    cap, pushes = _PUSHES[case]
    got, want = tkvs.GradBucketer(cap), jkvs.GradBucketer(cap)
    flush_got, flush_want = [], []
    for prio, key, shape, dtype in pushes:
        flush_got.append(got.add(prio, key, key, {}, torch.zeros(shape, dtype=getattr(
            torch, dtype)), None))
        flush_want.append(want.add(prio, key, key, {}, np.zeros(shape, dtype), None))
    assert flush_got == flush_want
    assert got.pending_bytes == want.pending_bytes
    assert [[e.key for e in b] for b in got.drain()] == \
        [[e.key for e in b] for b in want.drain()]
    assert got.pending == [] and got.pending_bytes == 0


def test_bucketer_counts_bf16_at_its_itemsize():
    b = tkvs.GradBucketer(16)
    assert not b.add(0, 0, 0, {}, torch.zeros(4, dtype=torch.bfloat16), None)  # 8 bytes
    assert b.add(0, 1, 1, {}, torch.zeros(4, dtype=torch.bfloat16), None)  # 16
    assert [[e.key for e in bk] for bk in b.drain()] == [[0, 1]]


# -- test_kvstore.py on the one-worker dist types --------------------------------
def _both(kv_type):
    out = []
    for pkg in (jmx, tmx):
        kv = pkg.kvstore.create(kv_type)
        kv.init(3, pkg.nd.zeros(SHAPE))
        kv.init([5, 7, 11], [pkg.nd.zeros(SHAPE)] * 3)
        out.append((pkg, kv))
    return out


@pytest.mark.parametrize("kv_type", DIST)
def test_one_worker_dist_store_matches_jax(kv_type):
    got = {}
    for pkg, kv in _both(kv_type):
        assert (kv.rank, kv.num_workers, kv.type) == (0, 1, kv_type)
        assert kv.get_num_dead_node(0) == 0
        vals = [pkg.nd.ones(SHAPE) * (i + 1) for i in range(4)]
        kv.push(3, vals)  # the aggregator: the per-device sum
        agg = pkg.nd.zeros(SHAPE)
        kv.pull(3, out=agg)
        kv._set_updater(lambda key, recv, stored: stored.__iadd__(recv * 2))
        kv.push([5, 7], [[pkg.nd.ones(SHAPE)] * 3, [pkg.nd.ones(SHAPE) * 2]])
        outs = [pkg.nd.zeros(SHAPE) for _ in range(2)]
        kv.pull([5, 7], out=outs)
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9))
        kv.push(11, pkg.nd.ones(SHAPE))
        kv.push(11, pkg.nd.ones(SHAPE))
        w = pkg.nd.zeros(SHAPE)
        kv.pull(11, out=w)
        kv._barrier()
        got[pkg] = [agg.asnumpy()] + [o.asnumpy() for o in outs] + [w.asnumpy()]
    np.testing.assert_array_equal(got[tmx][0], 10 * np.ones(SHAPE))
    for a, b in zip(got[tmx], got[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_all_accepted_types_route():
    for t in ("local", "local_allreduce_cpu", "local_allreduce_device", "device") + DIST:
        kv = tmx.kvstore.create(t)
        kv.init(7, tmx.nd.ones((3,)))
        out = tmx.nd.zeros((3,))
        kv.push(7, [tmx.nd.ones((3,)) * 2, tmx.nd.ones((3,))])
        kv.pull(7, out=out)
        np.testing.assert_allclose(out.asnumpy(), 3.0 * np.ones(3))
        assert kv.type == t and kv.num_workers == 1
    with pytest.raises(tmx.base.MXNetError):
        tmx.kvstore.create("definitely_not_a_store")


def test_launcher_env_without_a_group_refuses(monkeypatch):
    """A launcher's environment that promises two workers but no rendezvous:
    the store refuses to train unsynchronized, as JAX's does."""
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.delenv("MXTPU_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    with pytest.raises(tmx.base.MXNetError, match="coordinator"):
        tmx.kvstore.create("dist_sync")


# -- test_kvstore_overlap.py's bucketer cases --------------------------------
def _fake_dist_kv(monkeypatch, bucket_bytes=None):
    """A store on the dist push path in one process; records each flushed
    bucket's keys and each collective's size."""
    kv = tmx.kv.create("local")
    kv.type = "dist_sync"
    kv._size = 2
    if bucket_bytes is not None:
        kv._bucketer.bucket_bytes = bucket_bytes
    log = {"buckets": [], "sizes": []}
    drain = kv._bucketer.drain

    def recording_drain():
        out = drain()
        log["buckets"] += [[e.key for e in b] for b in out]
        return out

    kv._bucketer.drain = recording_drain
    allreduce = tmesh.allreduce_sum
    monkeypatch.setattr(tmesh, "allreduce_sum",
                        lambda v: log["sizes"].append(int(v.numel())) or allreduce(v))
    return kv, log


def test_bucketer_coalesces_and_defers(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch)
    for k in range(3):
        kv.init(k, tmx.nd.zeros((4,)))
    for k in range(3):
        kv.push(k, tmx.nd.ones((4,)) * (k + 1), priority=-k)
    assert len(kv._bucketer.pending) == 3 and log["sizes"] == []  # deferred
    kv._flush_buckets()
    assert not kv._bucketer.pending
    assert log["buckets"] == [[0, 1, 2]] and log["sizes"] == [12]  # one collective
    for k in range(3):
        out = tmx.nd.zeros((4,))
        kv.pull(k, out=out)
        np.testing.assert_allclose(out.asnumpy(), (k + 1) * np.ones(4))


def test_bucketer_priority_orders_drain(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch)
    for k in range(3):
        kv.init(k, tmx.nd.zeros((4,)))
    for k in reversed(range(3)):
        kv.push(k, tmx.nd.ones((4,)), priority=-k)
    kv._flush_buckets()
    assert log["buckets"] == [[0, 1, 2]]  # not 2, 1, 0


def test_bucketer_byte_cap_triggers_flush(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch, bucket_bytes=32)
    for k in range(2):
        kv.init(k, tmx.nd.zeros((6,)))
    kv.push(0, tmx.nd.ones((6,)), priority=0)
    assert len(kv._bucketer.pending) == 1  # 24 < 32
    kv.push(1, tmx.nd.ones((6,)) * 2, priority=-1)
    assert not kv._bucketer.pending  # 48 >= 32: flushed
    assert log["buckets"] == [[0], [1]]
    out = tmx.nd.zeros((6,))
    kv.pull(1, out=out)
    np.testing.assert_allclose(out.asnumpy(), 2 * np.ones(6))


def test_bucket_bytes_zero_legacy_per_key(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch, bucket_bytes=0)
    for k in range(3):
        kv.init(k, tmx.nd.zeros((2,)))
    for k in range(3):
        kv.push(k, tmx.nd.ones((2,)), priority=-k)
        assert not kv._bucketer.pending
    assert log["buckets"] == [[0], [1], [2]]


def test_bucketer_dtype_split(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch)
    kv.init("a", tmx.nd.zeros((4,), dtype="float64"))
    kv.init("b", tmx.nd.zeros((4,)))
    kv.push("a", tmx.nd.ones((4,), dtype="float64"), priority=-5)
    kv.push("b", tmx.nd.ones((4,)), priority=0)
    kv._flush_buckets()
    assert log["buckets"] == [["b"], ["a"]]


def test_pull_flushes_pending_bucket(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch)
    kv.init(0, tmx.nd.zeros((4,)))
    kv.push(0, tmx.nd.ones((4,)) * 7)
    assert kv._bucketer.pending
    out = tmx.nd.zeros((4,))
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), 7 * np.ones(4))


def test_snapshot_immune_to_grad_overwrite(monkeypatch):
    """A deferred push keeps the values pushed, though the trainer
    overwrites its gradient before the flush."""
    kv, _ = _fake_dist_kv(monkeypatch)
    kv.init(0, tmx.nd.zeros((4,)))
    g = tmx.nd.ones((4,))
    kv.push(0, g)
    g[:] = 777.0
    out = tmx.nd.zeros((4,))
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.ones(4))


def test_updater_change_flushes_first(monkeypatch):
    kv, log = _fake_dist_kv(monkeypatch)
    kv.init(0, tmx.nd.zeros((4,)))
    kv.push(0, tmx.nd.ones((4,)))
    kv.set_updater(lambda key, recv, stored: stored.__iadd__(recv * 10))
    assert log["buckets"] == [[0]]  # the pending push used the old (no) updater
    kv.push(0, tmx.nd.ones((4,)))
    out = tmx.nd.zeros((4,))
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), 11 * np.ones(4))


@pytest.mark.parametrize("knob", ["MXTPU_BUCKET_TWO_PHASE", "MXTPU_BUCKET_REDUCE_DTYPE"])
def test_bucket_knobs_keep_values_and_dtypes(monkeypatch, knob):
    monkeypatch.setenv(knob, "1" if knob.endswith("PHASE") else "float32")
    kv, _ = _fake_dist_kv(monkeypatch)
    kv.init(0, tmx.nd.zeros((5,), dtype="bfloat16"))
    kv.init(1, tmx.nd.zeros((3,), dtype="bfloat16"))
    kv.push(0, tmx.nd.ones((5,), dtype="bfloat16") * 3)
    kv.push(1, tmx.nd.ones((3,), dtype="bfloat16") * 2)
    for k, n, v in ((0, 5, 3), (1, 3, 2)):
        out = tmx.nd.zeros((n,), dtype="bfloat16")
        kv.pull(k, out=out)
        assert out._data.dtype == torch.bfloat16
        np.testing.assert_array_equal(out._data.float().numpy(), v * np.ones(n))


def test_bucket_flush_observes_telemetry(monkeypatch):
    from mxnet_tpu_torch import telemetry as tm

    was = tm.enabled()
    tm.enable()
    try:
        kv, _ = _fake_dist_kv(monkeypatch)
        for k in range(2):
            kv.init(k, tmx.nd.zeros((4,)))
        flushes = tkvs.bucket_stats["flushes"]
        for k in range(2):
            kv.push(k, tmx.nd.ones((4,)), priority=-k)
        kv._flush_buckets()
        snap = tm.snapshot()["kvstore.bucket_bytes"]
        dist = [s for s in snap["streams"] if s["labels"].get("path") == "dist"]
        assert dist and any(s["sum"] >= 32.0 for s in dist)
        assert tkvs.bucket_stats["flushes"] == flushes + 1
    finally:
        if not was:
            tm.disable()


# -- the kvstore server ---------------------------------------------------------
def test_kvstore_server_command_protocol():
    got = {}
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("local")
        kv.init(3, pkg.nd.ones((2, 2)))
        server = pkg.kvstore_server.KVStoreServer(kv)
        server.run([(0, pickle.dumps(pkg.optimizer.SGD(learning_rate=0.5)))])
        kv.push(3, pkg.nd.ones((2, 2)))
        out = pkg.nd.zeros((2, 2))
        kv.pull(3, out)
        got[pkg] = out.asnumpy()
    np.testing.assert_allclose(got[tmx], np.full((2, 2), 0.5), rtol=1e-5)
    np.testing.assert_array_equal(got[tmx], got[jmx])


@pytest.mark.parametrize("role", ["server", "scheduler", "worker"])
def test_server_role_import_is_noop(monkeypatch, role):
    from mxnet_tpu.kvstore_server import _init_kvstore_server_module as jinit
    from mxnet_tpu_torch.kvstore_server import _init_kvstore_server_module as tinit

    monkeypatch.setenv("DMLC_ROLE", role)
    assert tinit() == jinit() == role


def test_set_optimizer_pickles_on_a_multi_worker_store(monkeypatch):
    """A store of several workers ships the optimizer through pickle (the
    reference's command 0), its bound symbol left behind."""
    kv, _ = _fake_dist_kv(monkeypatch)
    opt = tmx.optimizer.create("sgd", learning_rate=0.25, sym=tmx.sym.Variable("x"))
    kv.set_optimizer(opt)
    assert kv._optimizer is not opt and kv._optimizer.sym is None and opt.sym is not None
    assert kv._optimizer.lr == 0.25


def test_restored_updater_state_follows_its_weight(monkeypatch):
    """An updater's states unpickled from a checkpoint lie on the host; at
    their first update they move to the weight's device (a resumed
    ``dist_sync`` fit on the card)."""

    class _OnCard(tmx.nd.NDArray):
        __slots__ = ()

        @property
        def context(self):
            return tmx.gpu(0)

    moved = []

    def as_in_context(self, context):
        moved.append(context)
        return _OnCard(self._data.clone())

    upd = tmx.optimizer.get_updater(tmx.optimizer.create("sgd", learning_rate=0.5,
                                                         momentum=0.9))
    w = _OnCard(torch.ones(3))
    upd.states = {0: tmx.nd.zeros((3,))}
    upd.set_states(upd.get_states())  # as a resume restores them: on the host
    assert type(upd.states[0]) is tmx.nd.NDArray
    monkeypatch.setattr(tmx.nd.NDArray, "as_in_context", as_in_context)
    upd(0, _OnCard(torch.ones(3)), w)
    assert moved == [tmx.gpu(0)] and type(upd.states[0]) is _OnCard
    upd(0, _OnCard(torch.ones(3)), w)
    assert len(moved) == 1
