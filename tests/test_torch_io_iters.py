"""The port's iterators that the input path brought (``mxnet_tpu_torch/io.py``:
CSVIter, MNISTIter, PrefetchingIter on the engine, DeviceFeedIter) and
``Module.fit`` fed from a .rec file, on the CPU, held to the JAX package.

From ``tests/test_io.py``: CSVIter's and MNISTIter's batches (against
JAX's: values 1e-6 relative, labels and pads exact), PrefetchingIter
scheduling its produce ops on ``engine.get()`` and keeping the caller's
context on the worker thread. From ``tests/test_resilience.py``:
``DeviceFeedIter.skip`` after staged batches equals sequential ``next()``;
here also ``reset``, the streaming source's ``seek_epoch`` and
``seek_sample`` through the feed, and the staged device on every batch.
From ``tests/test_train_recordio.py``: a small convnet trained by
``Module.fit`` on the fused dp-4 path with ``MXNET_FIT_MULTISTEP=2`` from
a .rec file through ``ImageRecordIter`` lands within the fit-parity
tolerance of JAX's fit (atol 2e-4 of each parameter's max), and the port's
fit is bit for bit the same with ``MXTPU_DEVICE_FEED`` on and off. A fit
fed by the shuffled streaming iterator, preempted in its second epoch,
resumes at the checkpoint's epoch (``seek_epoch``) and ``sample_position``
(``seek_sample``) bit for bit, with the feed and without it, and a staged
batch on another device than the trainer's is refused."""
import gzip
import os
import random
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io_pipeline, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import checkpoint as ck
from mxnet_tpu_torch.resilience import fault

_ENV = ("MXTPU_AMP", "MXTPU_SHARD_UPDATE", "MXTPU_BUCKET_BYTES", "MXNET_FIT_MULTISTEP",
        "MXTPU_FAULT_INJECT", "MXTPU_CKPT_INTERVAL", "MXTPU_DEVICE_FEED", "MXTPU_FEED_DEPTH",
        "MXTPU_INPUT_WORKERS", "MXNET_ENGINE_TYPE")


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    with tmx.cpu():
        yield
    io_pipeline.shutdown_all()


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(it):
    return [(_np(b.data[0]), _np(b.label[0]), b.pad or 0) for b in it]


def _assert_same(a, b, rtol=0.0):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_allclose(da, db, rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# CSVIter, MNISTIter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(0)
    data = rng.rand(22, 3, 2).astype("f")
    labels = np.arange(22).astype("f")
    dpath, lpath = str(tmp_path / "data.csv"), str(tmp_path / "label.csv")
    np.savetxt(dpath, data.reshape(22, 6), delimiter=",")
    np.savetxt(lpath, labels, delimiter=",")
    runs = []
    for mx in (jmx, tmx):
        it = mx.io.CSVIter(data_csv=dpath, data_shape=(3, 2), label_csv=lpath, batch_size=5,
                           round_batch=round_batch)
        first = _batches(it)
        it.reset()
        runs.append(first + _batches(it))
    _assert_same(runs[1], runs[0], rtol=1e-6)
    np.testing.assert_allclose(runs[1][0][0], data[:5], rtol=1e-6)


@pytest.mark.parametrize("gz", [True, False], ids=["gzip", "raw"])
def test_mnist_iter_matches_jax(tmp_path, gz):
    rng = np.random.RandomState(1)
    imgs = (rng.rand(50, 28, 28) * 255).astype(np.uint8)
    lbls = (np.arange(50) % 10).astype(np.uint8)
    suffix = ".gz" if gz else ""
    img_path = str(tmp_path / ("images-idx3-ubyte" + suffix))
    lbl_path = str(tmp_path / ("labels-idx1-ubyte" + suffix))
    opener = gzip.open if gz else open
    with opener(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 50, 28, 28) + imgs.tobytes())
    with opener(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, 50) + lbls.tobytes())
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3, flat=True)):
        runs = [_batches(mx.io.MNISTIter(image=img_path, label=lbl_path, batch_size=10, **kw))
                for mx in (jmx, tmx)]
        _assert_same(runs[1], runs[0])
    assert runs[1][0][0].shape == (10, 784) and runs[1][0][0].max() <= 1.0


# ---------------------------------------------------------------------------
# PrefetchingIter on the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("etype", ["ThreadedEnginePerDevice", "ThreadedEngine", "NaiveEngine"])
def test_prefetching_iter_schedules_on_engine(monkeypatch, etype):
    from mxnet_tpu_torch import engine

    monkeypatch.setenv("MXNET_ENGINE_TYPE", etype)
    monkeypatch.setattr(engine, "_ENGINE", None)
    eng = engine.get()
    pushes = []
    orig_push = eng.push

    def counting_push(fn, const_vars=(), mutable_vars=(), priority=0):
        pushes.append(mutable_vars)
        return orig_push(fn, const_vars=const_vars, mutable_vars=mutable_vars,
                         priority=priority)

    monkeypatch.setattr(eng, "push", counting_push)
    X = np.arange(24, dtype=np.float32).reshape(12, 2)
    y = np.arange(12, dtype=np.float32)
    pre = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(X, y, batch_size=4))
    seen = [b.data[0].asnumpy()[0, 0] for b in pre]
    assert seen == [0.0, 8.0, 16.0]
    assert len([mv for mv in pushes if len(mv) == 1]) >= 4
    pre.reset()
    b = next(iter(pre))
    assert b.data[0].shape == (4, 2)
    assert b.data[0].context == tmx.cpu()  # the caller's context, on the worker


def test_prefetching_iter_surfaces_a_source_error():
    class Boom(tmx.io.NDArrayIter):
        def next(self):
            raise ValueError("source failed")

    pre = tmx.io.PrefetchingIter(Boom(np.zeros((4, 2), "f"), np.zeros(4, "f"), batch_size=2))
    with pytest.raises(ValueError, match="source failed"):
        pre.next()


# ---------------------------------------------------------------------------
# DeviceFeedIter
# ---------------------------------------------------------------------------

def _feed_source():
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    y = np.arange(16, dtype=np.float32)
    return tmx.io.NDArrayIter(x, y, batch_size=2)


def _first(b):
    return float(b.data[0].asnumpy()[0, 0])


@pytest.mark.parametrize("depth", ["1", "2", "5"])
def test_devicefeed_iter_skip_matches_sequential(monkeypatch, depth):
    monkeypatch.setenv("MXTPU_FEED_DEPTH", depth)
    ref = _feed_source()
    ref.reset()
    ref.skip(5)
    want = ref.next().data[0].asnumpy()
    feed = tmx.io.DeviceFeedIter(_feed_source(), tmx.cpu())
    assert feed.depth == int(depth) and len(feed._staged) == int(depth)
    feed.reset()
    feed.next()  # batches staged before the skip
    feed.skip(4)  # 1 consumed + 4 skipped = at batch 5
    got = feed.next()
    np.testing.assert_array_equal(got.data[0].asnumpy(), want)
    assert got.staged_device == torch.device("cpu")


def test_devicefeed_iter_rewind_and_reset_match_sequential():
    seq = [_first(b) for b in _feed_source()]
    feed = tmx.io.DeviceFeedIter(_feed_source(), tmx.cpu())
    assert [_first(b) for b in feed] == seq
    feed.reset()
    assert [_first(feed.next()) for _ in range(3)] == seq[:3]
    feed.reset()  # staged batches dropped mid-epoch
    assert [_first(b) for b in feed] == seq
    # a source without seek_epoch / seek_sample gets none through the feed
    assert not hasattr(feed, "seek_epoch") and not hasattr(feed, "seek_sample")
    assert feed.num_hosts == 1
    with pytest.raises(StopIteration):
        feed.next()
    feed.reset()
    assert _first(feed.next()) == seq[0]
    # a host batch is copied, never shared with the source
    src = _feed_source()
    feed = tmx.io.DeviceFeedIter(src, tmx.cpu(), depth=1)
    b = feed.next()
    assert b.data[0]._data.data_ptr() != src.getdata()[0]._data.data_ptr()
    with pytest.raises(MXNetError, match="depth"):
        tmx.io.DeviceFeedIter(_feed_source(), tmx.cpu(), depth=0)


# ---------------------------------------------------------------------------
# Module.fit from a .rec file
# ---------------------------------------------------------------------------

N_CLASSES, SIDE = 4, 12


def _grating(rng, cls):
    theta = np.pi * cls / N_CLASSES
    yy, xx = np.mgrid[0:SIDE, 0:SIDE].astype(np.float32) / SIDE
    wave = np.sin(2 * np.pi * 2.5 * (np.cos(theta) * xx + np.sin(theta) * yy)
                  + rng.uniform(0, 2 * np.pi))
    img = 127 + 80 * wave[..., None] + rng.randn(SIDE, SIDE, 3) * 20
    return np.clip(img, 0, 255).astype(np.uint8)


def _pack(tmp_path, n=64, seed=0):
    rng = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "train.rec"), str(tmp_path / "train.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        cls = int(rng.randint(N_CLASSES))
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(cls), i, 0),
                                         _grating(rng, cls), img_fmt=".png"))
    w.close()
    return rec


def _convnet(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1), name="c1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=N_CLASSES, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _rec_iter(mx, rec, **kw):
    args = dict(path_imgrec=rec, data_shape=(3, SIDE, SIDE), batch_size=16, shuffle=True,
                mean_r=127.0, mean_g=127.0, mean_b=127.0, scale=1.0 / 60.0,
                preprocess_threads=1)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def _fit_rec(mx, rec, epochs=2, **kw):
    random.seed(0)
    np.random.seed(0)
    mx.random.seed(0)
    mod = mx.mod.Module(_convnet(mx), context=[mx.cpu(i) for i in range(4)])
    metric = mx.metric.create("acc")
    mod.fit(_rec_iter(mx, rec, **kw), eval_metric=metric, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
            initializer=mx.init.Xavier(), num_epoch=epochs)
    assert mod._fused_trainer is not None
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}, metric.get()[1]


def test_fit_from_recordio_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    rec = _pack(tmp_path)
    monkeypatch.setenv("MXNET_FIT_MULTISTEP", "2")
    jp, jacc = _fit_rec(jmx, rec)
    tp, tacc = _fit_rec(tmx, rec)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        scale = float(np.abs(jp[n]).max())
        np.testing.assert_allclose(tp[n] / scale, jp[n] / scale, rtol=0, atol=2e-4, err_msg=n)
    assert abs(tacc - jacc) <= 1.0 / 64
    monkeypatch.setenv("MXTPU_DEVICE_FEED", "1")
    on, on_acc = _fit_rec(tmx, rec)
    for n in tp:
        np.testing.assert_array_equal(on[n], tp[n], err_msg=n)
    assert on_acc == tacc


def _stream(rec):
    return io_pipeline.StreamingImageRecordIter(
        16, (3, SIDE, SIDE), rec, shuffle=True, seed=5, shuffle_buffer=16, workers=0,
        aug_recipe={"rand_mirror": True, "mean": np.array([127.0, 127.0, 127.0]),
                    "scale": 1.0 / 60.0})


def _fit_stream(rec, ckpt, resume=None):
    np.random.seed(0)
    tmx.random.seed(0)
    mod = tmx.mod.Module(_convnet(tmx), context=[tmx.cpu(i) for i in range(4)])
    mod.fit(_stream(rec), kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier(), num_epoch=2, checkpoint_dir=ckpt, resume=resume)
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def test_streaming_source_repositions_through_the_feed(tmp_path):
    pytest.importorskip("PIL")
    rec = _pack(tmp_path)

    def firsts(it, n):
        return [float(_np(it.next().data[0]).sum()) for _ in range(n)]

    src = _stream(rec)
    epoch0 = firsts(src, 4)
    src.reset()
    epoch1 = firsts(src, 4)
    feed = tmx.io.DeviceFeedIter(_stream(rec), tmx.cpu(), depth=3)
    assert feed.num_hosts == 1
    assert firsts(feed, 2) == epoch0[:2]
    feed.seek_epoch(1)  # staged epoch-0 batches dropped, epoch 1's order replayed
    assert firsts(feed, 4) == epoch1
    feed.seek_epoch(0)
    feed.seek_sample(32)  # 2 batches of 16 into epoch 0
    assert firsts(feed, 2) == epoch0[2:]
    feed.iter.close()
    src.close()


def test_preempted_streaming_fit_resumes_at_sample_position(tmp_path, monkeypatch):
    _preempt_and_resume(tmp_path, monkeypatch, feed="1")


def test_preempted_streaming_fit_resumes_without_the_feed(tmp_path, monkeypatch):
    _preempt_and_resume(tmp_path, monkeypatch, feed="0")


def _preempt_and_resume(tmp_path, monkeypatch, feed):
    pytest.importorskip("PIL")
    monkeypatch.setenv("MXTPU_DEVICE_FEED", feed)
    rec = _pack(tmp_path)
    want = _fit_stream(rec, str(tmp_path / "ref"))
    seeks = []
    orig = io_pipeline.StreamingImageRecordIter.seek_sample

    def spy(self, pos):
        seeks.append(pos)
        return orig(self, pos)

    monkeypatch.setattr(io_pipeline.StreamingImageRecordIter, "seek_sample", spy)
    monkeypatch.setenv(fault.ENV, "preempt_at_step=6,unit=stream_resume_feed%s" % feed)
    with pytest.raises(SystemExit) as exc:
        _fit_stream(rec, str(tmp_path / "crash"))
    assert exc.value.code == ck.EXIT_PREEMPTED
    monkeypatch.delenv(fault.ENV)
    state = ck.CheckpointManager(str(tmp_path / "crash")).load()
    # epoch 1 of 4-batch epochs: the stream replays epoch 1's shuffle first
    assert (state["epoch"], state["nbatch"], state["sample_position"]) == (1, 2, 32)
    got = _fit_stream(rec, str(tmp_path / "crash"), resume="auto")
    assert seeks == [32]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_staged_batch_on_another_device_is_refused():
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    y = np.zeros(16, np.float32)
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(data, num_hidden=2, name="fc"),
                                name="softmax")
    mod = tmx.mod.Module(net, context=[tmx.cpu(i) for i in range(4)])
    it = tmx.io.NDArrayIter(x, y, batch_size=8)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.init_optimizer(kvstore="device")
    batch = tmx.io.DeviceFeedIter(it, tmx.cpu()).next()
    mod._fused_trainer.device = torch.device("meta")
    with pytest.raises(MXNetError, match="staged on cpu"):
        mod._make_fused_batch(batch)


# ---------------------------------------------------------------------------
# entry points: im2rec, train_imagenet, input_bench
# ---------------------------------------------------------------------------

def test_im2rec_packs_what_jax_reads(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    from mxnet_tpu import recordio as jrec
    from mxnet_tpu_torch.tools import im2rec

    rng = np.random.RandomState(3)
    root = tmp_path / "images"
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (20, 24, 3)).astype(np.uint8)).save(
                root / cls / ("%d.png" % i))
    prefix = str(tmp_path / "set")
    lst, classes = im2rec.make_list(prefix, str(root))
    assert classes == {"cat": 0, "dog": 1} and len(open(lst).readlines()) == 6
    assert im2rec.pack(prefix, str(root), num_workers=1, img_fmt=".png", resize=12) == 6
    r = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    for i in r.keys:
        header, img = jrec.unpack_img(r.read_idx(i))
        assert img.shape == (12, 14, 3) and header.label in (0.0, 1.0)
    r.close()


def test_train_imagenet_runs_on_the_host(tmp_path):
    pytest.importorskip("PIL")
    from mxnet_tpu_torch.examples import train_imagenet

    rec = _pack(tmp_path, n=32)
    mod = train_imagenet.main([
        "--ctx", "cpu", "--num-devices", "4", "--data-train", rec, "--network", "resnet",
        "--num-layers", "8", "--image-shape", "3,%d,%d" % (SIDE, SIDE), "--num-classes",
        str(N_CLASSES), "--batch-size", "8", "--num-epochs", "1", "--data-nthreads", "2"])
    assert mod._fused_trainer is not None
    mod = train_imagenet.main(["--ctx", "cpu", "--benchmark", "2", "--num-layers", "8",
                               "--image-shape", "3,%d,%d" % (SIDE, SIDE), "--num-classes", "4",
                               "--batch-size", "2", "--num-epochs", "1"])
    assert mod._fused_trainer is None


def test_input_bench_on_the_host():
    from mxnet_tpu_torch.tools import input_bench

    out = input_bench.main(["--cpu", "--images", "48", "--side", "40", "--crop", "32",
                            "--batch-size", "8", "--threads", "1,2", "--workers", ""])
    assert [r["mode"] for r in out["rows"]] == ["threads", "threads"]
    assert all(r["img_per_s"] > 0 for r in out["rows"])
    img = np.random.RandomState(0).randint(0, 255, (5, 7, 3)).astype(np.uint8)
    from mxnet_tpu_torch import native

    if native.available():
        np.testing.assert_array_equal(native.imdecode_png(input_bench.png_bytes(img)), img)
