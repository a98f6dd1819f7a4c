"""The port's streaming input pipeline (``mxnet_tpu_torch/io_pipeline.py``)
on the CPU, held to the JAX package (``mxnet_tpu/io_pipeline.py``).

Every case of ``tests/test_input_pipeline.py`` runs on the port: chunks
that cover every record, disjoint and complete host shards, thread and
worker parity of ``ImageRecordIter``, a worker-count-independent stream
with random augmenters, the shuffle buffer, ``skip`` / ``seek_sample``,
a SIGKILL mid-epoch resumed at the reported cursor, the manifest's
``sample_position``, the device-feed handoff with its telemetry, and
relaxed mode covering an epoch. Across the packages: the port's stream
(inline and with a 2-process pool) gives the JAX package's batches bit
for bit for one seed (shuffle buffer, rand_crop, rand_mirror, mean,
scale, two epochs, a host shard). Also: the quarantine JSONL and
``MXTPU_BAD_RECORD_BUDGET`` under ``bad_record``, ``seek_epoch``, a
reset with chunks in flight, and decode children that see no card and
import neither ``jax`` nor ``mxnet_tpu``. Every spawned pool is closed in
teardown; pool tests carry their own timeout."""
import json
import os
import signal
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu import io_pipeline as jiop
from mxnet_tpu_torch import io_pipeline, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import fault

pytest.importorskip("PIL")

SIZE = 32
SHAPE = (3, SIZE, SIZE)


@pytest.fixture(autouse=True)
def _host_and_reap(monkeypatch):
    for k in ("MXTPU_INPUT_WORKERS", "MXTPU_SHUFFLE_BUFFER", "MXTPU_INPUT_STRICT_ORDER",
              "MXTPU_FAULT_INJECT", "MXTPU_QUARANTINE_FILE", "MXTPU_RUN_DIR",
              "MXTPU_BAD_RECORD_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    with tmx.cpu():
        yield
    io_pipeline.shutdown_all()
    jiop.shutdown_all()


def _pack(tmp_path, n, seed=0, name="data", size=SIZE):
    rng = np.random.RandomState(seed)
    rec, idx = str(tmp_path / ("%s.rec" % name)), str(tmp_path / ("%s.idx" % name))
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0), img,
                                         img_fmt=".png"))
    w.close()
    return rec, idx


def _collect(it, n=None):
    out = []
    while n is None or len(out) < n:
        try:
            b = it.next()
        except StopIteration:
            break
        out.append((np.asarray(b.data[0].asnumpy()), np.asarray(b.label[0].asnumpy()),
                    b.pad or 0))
    return out


def _assert_batches_equal(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for i, ((da, la, pa), (db, lb, pb)) in enumerate(zip(a, b)):
        assert pa == pb, ("pad", i, pa, pb)
        np.testing.assert_array_equal(la, lb, err_msg="label batch %d" % i)
        np.testing.assert_array_equal(da, db, err_msg="data batch %d" % i)


def _labels(batches):
    return [int(l) for d, lab, p in batches for l in lab[:len(lab) - p]]


# ---------------------------------------------------------------------------
# chunking and sharding
# ---------------------------------------------------------------------------

def test_build_chunks_cover_every_record(tmp_path):
    rec, idx = _pack(tmp_path, 23)
    chunks = recordio.build_chunks(rec, idx, chunk_bytes=4096)
    assert len(chunks) > 1 and sum(c.n_records for c in chunks) == 23
    seen = []
    with open(rec, "rb") as f:
        for c in chunks:
            for j, s in enumerate(recordio.read_chunk(f, c, uri=rec)):
                seen.append((c.ordinal + j, float(recordio.unpack(s)[0].label)))
    assert [o for o, _ in seen] == list(range(23))
    assert [int(l) for _, l in seen] == list(range(23))
    assert recordio.build_chunks(rec, None, chunk_bytes=4096) == chunks


def test_host_shards_are_disjoint_and_complete(tmp_path):
    rec, _ = _pack(tmp_path, 30)
    labels = {}
    for rank in range(3):
        it = io_pipeline.StreamingImageRecordIter(5, SHAPE, rec, shuffle=False, workers=0,
                                                  host_rank=rank, num_hosts=3)
        labels[rank] = _labels(_collect(it))
        assert it.num_samples == len(labels[rank])
        jit = jiop.StreamingImageRecordIter(5, SHAPE, rec, shuffle=False, workers=0,
                                            host_rank=rank, num_hosts=3)
        assert _labels(_collect(jit)) == labels[rank]
    assert sorted(sum(labels.values(), [])) == list(range(30))
    with pytest.raises(MXNetError, match="host_rank"):
        io_pipeline.StreamingImageRecordIter(5, SHAPE, rec, host_rank=3, num_hosts=3)


# ---------------------------------------------------------------------------
# the ordering contract, and the JAX package's batches
# ---------------------------------------------------------------------------

def test_imagerecorditer_threads_parity(tmp_path):
    rec, idx = _pack(tmp_path, 50)
    runs = {}
    for threads in (1, 4):
        it = tmx.io.ImageRecordIter(path_imgrec=rec, path_imgidx=idx, batch_size=8,
                                    data_shape=SHAPE, preprocess_threads=threads,
                                    input_workers=0)
        runs[threads] = _collect(it)
    assert len(runs[1]) == 7 and runs[1][-1][2] == 6  # 50 = 6 * 8 + 2
    _assert_batches_equal(runs[1], runs[4])


@pytest.mark.timeout(300)
def test_imagerecorditer_worker_parity_strict(tmp_path):
    """input_workers 0 (the thread-pool ImageIter) and 2 (the streaming
    pool) give the same batches in strict mode, and so does the JAX
    package's streaming iterator; epoch 2 stays in step across reset."""
    import mxnet_tpu as jmx

    rec, idx = _pack(tmp_path, 50)
    runs = {}
    for name, mx, workers in (("threads", tmx, 0), ("pool", tmx, 2), ("jax", jmx, 0)):
        kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=8, data_shape=SHAPE,
                  preprocess_threads=2, input_workers=workers, strict_order=True)
        if mx is jmx:
            it = jiop.StreamingImageRecordIter(8, SHAPE, rec, path_imgidx=idx, workers=0,
                                               strict_order=True, aug_recipe={
                                                   "rand_crop": False, "rand_mirror": False,
                                                   "scale": 1.0})
        else:
            it = mx.io.ImageRecordIter(**kw)
        runs[name] = _collect(it)
        it.reset()
        runs[name] += _collect(it, 2)
        if hasattr(it, "close"):
            it.close()
    _assert_batches_equal(runs["threads"], runs["pool"])
    _assert_batches_equal(runs["pool"], runs["jax"])


RECIPE = {"rand_crop": True, "rand_mirror": True, "mean": np.array([120.0, 110.0, 100.0]),
          "scale": 1.0 / 64}


@pytest.mark.timeout(300)
def test_streaming_batches_equal_jax_inline_and_pooled(tmp_path):
    """Random augmenters stay deterministic across worker placement
    (per-sample seeds from the global ordinal): the port inline, the port
    with 2 workers and the JAX package inline agree bit for bit over two
    epochs of a shuffled host shard with random crops of larger images."""
    rec, _ = _pack(tmp_path, 40, size=40)
    kw = dict(batch_size=6, data_shape=SHAPE, path_imgrec=rec, shuffle=True, seed=11,
              shuffle_buffer=16, aug_recipe=RECIPE, strict_order=True, host_rank=1,
              num_hosts=2, chunk_bytes=8192)
    runs = []
    for mod, workers in ((io_pipeline, 0), (io_pipeline, 2), (jiop, 0)):
        it = mod.StreamingImageRecordIter(workers=workers, **kw)
        got = _collect(it)
        it.reset()
        runs.append(got + _collect(it))
        it.close()
    assert len(runs[0]) == 8
    _assert_batches_equal(runs[0], runs[1])
    _assert_batches_equal(runs[0], runs[2])


def test_shuffle_buffer_mixes_across_chunks(tmp_path):
    rec, _ = _pack(tmp_path, 48)
    base = dict(batch_size=8, data_shape=SHAPE, path_imgrec=rec, workers=0, seed=5,
                strict_order=True)
    plain = io_pipeline.StreamingImageRecordIter(shuffle=False, **base)
    mixed = io_pipeline.StreamingImageRecordIter(shuffle=True, shuffle_buffer=24, **base)
    order_plain = _labels(_collect(plain))
    order_mixed = _labels(_collect(mixed))
    assert order_plain == list(range(48))
    assert sorted(order_mixed) == list(range(48)) and order_mixed != order_plain
    mixed.reset()
    e2 = _labels(_collect(mixed))
    assert sorted(e2) == list(range(48)) and e2 != order_mixed
    again = io_pipeline.StreamingImageRecordIter(shuffle=True, shuffle_buffer=24, **base)
    again.reset()
    assert _labels(_collect(again)) == e2
    jmixed = jiop.StreamingImageRecordIter(shuffle=True, shuffle_buffer=24, **base)
    assert _labels(_collect(jmixed)) == order_mixed  # the JAX package's schedule


# ---------------------------------------------------------------------------
# the cursor
# ---------------------------------------------------------------------------

def _kw(rec, seed, buf=16, **extra):
    kw = dict(batch_size=8, data_shape=SHAPE, path_imgrec=rec, workers=0, shuffle=True,
              seed=seed, shuffle_buffer=buf, strict_order=True)
    kw.update(extra)
    return kw


def test_skip_repositions_without_decode(tmp_path):
    rec, _ = _pack(tmp_path, 64)
    ref = _collect(io_pipeline.StreamingImageRecordIter(**_kw(rec, 3)))
    it = io_pipeline.StreamingImageRecordIter(**_kw(rec, 3))
    it.skip(3)
    assert it.sample_position == 24
    _assert_batches_equal(_collect(it), ref[3:])


def test_seek_sample_absolute_rewind_and_seek_epoch(tmp_path):
    rec, _ = _pack(tmp_path, 64)
    ref = _collect(io_pipeline.StreamingImageRecordIter(**_kw(rec, 9, buf=8)))
    it = io_pipeline.StreamingImageRecordIter(**_kw(rec, 9, buf=8))
    it.seek_sample(40)
    _assert_batches_equal(_collect(it, 1), [ref[5]])
    it.seek_sample(8)  # rewinding restarts the same epoch's schedule
    _assert_batches_equal(_collect(it, 1), [ref[1]])
    it.reset()
    epoch1 = _collect(it)
    it.seek_epoch(0)  # back to epoch 0's order, not a new one
    _assert_batches_equal(_collect(it), ref)
    it.seek_epoch(1)
    _assert_batches_equal(_collect(it), epoch1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONSUME_THEN_HANG = """
import os, sys, time
from mxnet_tpu_torch import cpu, io_pipeline
rec, cursor_file = sys.argv[1], sys.argv[2]
with cpu():
    it = io_pipeline.StreamingImageRecordIter(
        6, (3, %d, %d), rec, workers=0, shuffle=True, seed=17, shuffle_buffer=12,
        strict_order=True, host_rank=1, num_hosts=2)
    it.next()
    it.next()
with open(cursor_file + ".tmp", "w") as f:
    f.write(str(it.sample_position))
os.rename(cursor_file + ".tmp", cursor_file)
time.sleep(300)  # the parent SIGKILLs us here
""" % (SIZE, SIZE)


def _child_env(extra=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.update(extra or {})
    return env


@pytest.mark.timeout(300)
def test_sigkill_resume_repositions_bitwise(tmp_path):
    """A child consumes two batches, reports its cursor and dies by
    SIGKILL; a fresh iterator seeks there and goes on bit for bit."""
    import subprocess

    rec, _ = _pack(tmp_path, 60)
    kw = dict(batch_size=6, data_shape=SHAPE, path_imgrec=rec, workers=0, shuffle=True,
              seed=17, shuffle_buffer=12, strict_order=True, host_rank=1, num_hosts=2)
    ref = _collect(io_pipeline.StreamingImageRecordIter(**kw))
    assert len(ref) >= 4
    cursor_file = str(tmp_path / "cursor")
    child = subprocess.Popen([sys.executable, "-c", CONSUME_THEN_HANG, rec, cursor_file],
                             env=_child_env())
    try:
        deadline = time.monotonic() + 240
        while not os.path.exists(cursor_file):
            assert child.poll() is None, "child died before reporting its cursor"
            assert time.monotonic() < deadline, "child never reported"
            time.sleep(0.05)
        os.kill(child.pid, signal.SIGKILL)
        assert child.wait(timeout=30) == -signal.SIGKILL
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(cursor_file) as f:
        cursor = int(f.read())
    assert cursor == 2 * kw["batch_size"]
    resumed = io_pipeline.StreamingImageRecordIter(**kw)
    resumed.seek_sample(cursor)
    _assert_batches_equal(_collect(resumed), ref[2:])


def test_sample_position_lands_in_manifest(tmp_path):
    import glob

    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = {"module": {"arg": {}, "aux": {}, "opt": {"kind": "none"}}, "epoch": 0,
             "nbatch": 7, "sample_position": 7 * 48, "global_step": 7}
    mgr.save(state, step=7)
    mgr.wait()
    manifest = sorted(glob.glob(str(tmp_path / "ckpt" / "*" / "MANIFEST.json")))[-1]
    with open(manifest) as f:
        assert json.load(f)["sample_position"] == 336


# ---------------------------------------------------------------------------
# handoff, telemetry, relaxed mode, quarantine, children
# ---------------------------------------------------------------------------

def test_device_feed_handoff_and_telemetry(tmp_path):
    from mxnet_tpu_torch import telemetry as _tm

    rec, _ = _pack(tmp_path, 32)
    was = _tm.enabled()
    _tm.enable()
    try:
        inner = io_pipeline.StreamingImageRecordIter(8, SHAPE, rec, workers=0, shuffle=True,
                                                     seed=1, shuffle_buffer=8,
                                                     strict_order=True)
        fed = tmx.io.DeviceFeedIter(inner, tmx.cpu())
        batches = list(fed)
        assert len(batches) == 4
        assert all(b.staged_device.type == "cpu" for b in batches)
        snap = _tm.snapshot()
        assert snap["io.decode_seconds"]["streams"], snap
        assert snap["io.feed_wait_seconds"]["streams"], snap
        assert sum(s["value"] for s in snap["io.bytes_read"]["streams"]) > 0
        assert "io.queue_depth" in snap
    finally:
        if not was:
            _tm.disable()


@pytest.mark.timeout(300)
def test_relaxed_mode_covers_epoch(tmp_path):
    rec, _ = _pack(tmp_path, 36)
    it = io_pipeline.StreamingImageRecordIter(6, SHAPE, rec, workers=2, shuffle=True, seed=2,
                                              shuffle_buffer=8, strict_order=False)
    assert sorted(_labels(_collect(it))) == list(range(36))
    it.reset()
    assert sorted(_labels(_collect(it))) == list(range(36))
    it.close()


@pytest.mark.timeout(300)
def test_reset_with_chunks_in_flight(tmp_path):
    rec, _ = _pack(tmp_path, 48)
    kw = _kw(rec, 4, chunk_bytes=4096)
    ref = io_pipeline.StreamingImageRecordIter(**kw)
    ref.next()
    ref.reset()
    want = _collect(ref)
    it = io_pipeline.StreamingImageRecordIter(**dict(kw, workers=2))
    it.next()  # the pool holds chunks of epoch 0 in flight
    it.reset()
    _assert_batches_equal(_collect(it), want)
    it.close()


def test_bad_records_are_quarantined_and_budgeted(tmp_path, monkeypatch):
    rec, _ = _pack(tmp_path, 24)
    qfile = str(tmp_path / "quarantine.jsonl")
    monkeypatch.setenv("MXTPU_QUARANTINE_FILE", qfile)
    monkeypatch.setenv(fault.ENV, "bad_record=2,unit=quarantine_ok")
    it = io_pipeline.StreamingImageRecordIter(8, SHAPE, rec, workers=0, strict_order=True)
    batches = _collect(it)
    assert it.bad_records == 2
    labels = _labels(batches)
    assert labels == list(range(2, 24))  # the first two decodes failed and were skipped
    lines = [json.loads(l) for l in open(qfile)]
    assert [l["ordinal"] for l in lines] == [0, 1]
    assert all(l["type"] == "quarantine" and "injected bad record" in l["reason"]
               for l in lines)
    monkeypatch.setenv(fault.ENV, "bad_record=5,unit=quarantine_over")
    monkeypatch.setenv("MXTPU_BAD_RECORD_BUDGET", "3")
    it = io_pipeline.StreamingImageRecordIter(8, SHAPE, rec, workers=0, strict_order=True)
    with pytest.raises(MXNetError, match="MXTPU_BAD_RECORD_BUDGET=3"):
        _collect(it)


CHILD_REPORT = """
import json, os, sys
import torch
import mxnet_tpu_torch.io_pipeline  # what a decode worker imports
print(json.dumps({"jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
                  "mxnet_tpu": "mxnet_tpu" in sys.modules,
                  "cuda_init": torch.cuda.is_initialized(),
                  "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "telemetry": os.environ.get("MXTPU_TELEMETRY")}))
"""


def test_decode_children_see_no_card_and_no_jax():
    """A decode child's environment (``_child_env``) and imports: no card
    visible, telemetry off, no CUDA initialised, neither jax nor mxnet_tpu
    loaded."""
    import subprocess

    env = io_pipeline._child_env()
    assert env["CUDA_VISIBLE_DEVICES"] == "" and env["MXTPU_TELEMETRY"] == "0"
    out = subprocess.run([sys.executable, "-c", CHILD_REPORT], env=_child_env(env),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "jax": False, "mxnet_tpu": False, "cuda_init": False, "visible": "", "telemetry": "0"}
