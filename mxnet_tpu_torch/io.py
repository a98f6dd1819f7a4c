"""Data iterators of the PyTorch port (counterpart of ``mxnet_tpu/io.py``):
DataDesc, DataBatch (with ``pad``), DataIter, NDArrayIter (the three
``last_batch_handle`` modes, shuffle through ``np.random``), ResizeIter,
PrefetchingIter, DeviceFeedIter, MNISTIter, CSVIter, and the record
iterators ImageRecordIter, ImageDetRecordIter and DetRecordIter (over
``image`` and ``io_pipeline``), each with ``skip`` for checkpoint resume.
Batches are NDArrays on the current context, made from the host arrays as
the JAX package makes them, so both packages see the same batches, pads
and shuffle order from one ``np.random`` seed.

PrefetchingIter schedules each source's produce op on the host dependency
engine (``engine.get()``) while the caller consumes the current batch.
DeviceFeedIter stages the next ``MXTPU_FEED_DEPTH`` batches on a device:
the inner iterator runs under ``cpu()``, its batches go through pinned
host buffers and are copied with ``non_blocking`` on a side CUDA stream,
one event a batch, which ``next()`` makes the current stream wait on.
``Module.fit`` installs it on the fused path when ``MXTPU_DEVICE_FEED=1``
(off by default, unlike the JAX package). On a CPU device the staging is
a plain copy.
"""
from __future__ import annotations

import contextlib
import functools
import gzip
import os
import struct
import time
from collections import deque, namedtuple

import numpy as np
import torch

from . import ndarray as nd
from . import telemetry as _tm
from .base import MXNetError
from .context import Context
from .ndarray import NDArray

DataDesc = namedtuple("DataDesc", ["name", "shape"])

_H_FEED_WAIT = _tm.histogram(
    "io.feed_wait_seconds",
    "Host time DeviceFeedIter.next() spends handing over the staged batch and re-filling "
    "the pipeline (the device copies themselves are async and overlap compute)")


class DataBatch:
    """One mini-batch."""

    def __init__(self, data, label=None, pad=None, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator."""

    def __init__(self):
        self.batch_size = 0

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(), pad=self.getpad(),
                             index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def skip(self, num_batches):
        """Advance past ``num_batches`` batches without using them (checkpoint
        resume repositions a freshly reset iterator so). This generic form
        consumes batches, and so serves ResizeIter and PrefetchingIter as in
        the JAX package; NDArrayIter moves its cursor instead."""
        for _ in range(int(num_batches)):
            try:
                self.next()
            except StopIteration:
                return

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _rename(descs, mapping):
    return [DataDesc(mapping[x[0]], x[1]) for x in descs]


class PrefetchingIter(DataIter):
    """Prefetcher over one or more iterators: each source owns an engine
    Var, and its produce op (the next batch) is pushed with that Var as
    its mutable var while the caller consumes the current batch, so
    production is serialized per source (under
    ``MXNET_ENGINE_TYPE=NaiveEngine`` it runs synchronously). A source's
    exception surfaces in the consumer. The caller's context is entered on
    the worker thread."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        from . import engine as _engine

        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self._engine = _engine.get()
        self._slots = [self._engine.new_variable() for _ in range(self.n_iter)]
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self._errors = [None] * self.n_iter
        self._pending = [None] * self.n_iter  # op handles from push()
        self._prefetch_all()

    def _prefetch(self, i, ctx):
        def _produce():
            # the caller's ``with ctx:`` is thread-local: enter it on the worker
            with ctx if ctx is not None else contextlib.nullcontext():
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except Exception as e:  # surfaced in the consumer, never a stale batch
                    self.next_batch[i] = None
                    self._errors[i] = e

        self._pending[i] = self._engine.push(_produce, mutable_vars=(self._slots[i],))

    def _prefetch_all(self):
        ctx = getattr(Context._default_ctx, "value", None)
        for i in range(self.n_iter):
            self._prefetch(i, ctx)

    def _await_batches(self):
        for i, opr in enumerate(self._pending):
            # wait on the produce op itself where the engine returns a
            # handle; a wait_for_var would push one more op a batch
            if opr is not None and hasattr(opr, "done"):
                opr.done.wait()
            else:
                self._engine.wait_for_var(self._slots[i])
        for i, err in enumerate(self._errors):
            if err is not None:
                self._errors[i] = None
                raise err

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([_rename(i.provide_data, r) for r, i in zip(self.rename_data, self.iters)],
                   [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([_rename(i.provide_label, r)
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        self._await_batches()  # let in-flight produces land first
        for i in self.iters:
            i.reset()
        self._prefetch_all()

    def iter_next(self):
        self._await_batches()
        if self.next_batch[0] is None:
            for b in self.next_batch:
                assert b is None, "Number of entry mismatches between iterators"
            return False
        for b in self.next_batch:
            assert b.pad == self.next_batch[0].pad, "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index, provide_data=self.provide_data,
            provide_label=self.provide_label)
        self._prefetch_all()  # produce the next round while the caller consumes this one
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _feed_device(sharding):
    """The torch.device a DeviceFeedIter stages on: a Context, a
    torch.device, or None for the current context."""
    if sharding is None:
        return Context.current_context().torch_device
    if isinstance(sharding, Context):
        return sharding.torch_device
    if isinstance(sharding, torch.device):
        return sharding
    raise MXNetError("DeviceFeedIter: cannot place batches on %r" % (sharding,))


_STAGING_STREAMS = {}


def _staging_stream(device):
    """The device's one staging stream, made once: a high-priority stream,
    so it never coincides with the normal-priority pool streams that CUDA
    graph captures take, and a fit after a fit does not walk the pool."""
    stream = _STAGING_STREAMS.get(device)
    if stream is None:
        stream = _STAGING_STREAMS[device] = torch.cuda.Stream(device, priority=-1)
    return stream


class DeviceFeedIter(DataIter):
    """Device-resident feed: keeps up to ``depth`` (``MXTPU_FEED_DEPTH``,
    default 2) upcoming batches staged on ``sharding``'s device, so the
    next batch's host-to-device copy overlaps the current step.

    The inner iterator runs under ``cpu()`` and gives host batches. On a
    CUDA device each tensor is copied into a pinned host buffer, then
    ``non_blocking`` into a fresh device tensor on the device's staging
    stream (one a device, shared by every DeviceFeedIter); one event
    a batch records the copies, and ``next()`` makes the current stream
    wait on it and ties the tensors to that stream (``record_stream``). A
    pinned buffer goes back to the free list with its batch's event and is
    written again only after that event completes, so ``reset``, ``skip``
    and the source's ``seek_epoch`` / ``seek_sample`` (forwarded where the
    source has them) may drop staged batches with copies in flight. The
    handed-over batch carries ``staged_device``; ``Module`` takes its
    tensors as they are. On a CPU device staging is a plain copy.
    """

    def __init__(self, data_iter, sharding=None, label_sharding=None, depth=None):
        super().__init__()
        if depth is None:
            try:
                depth = int(os.environ.get("MXTPU_FEED_DEPTH", "2"))
            except ValueError:
                depth = 2
        if depth < 1:
            raise MXNetError("DeviceFeedIter depth must be >= 1, got %d" % depth)
        self.iter = data_iter
        self.depth = depth
        self.device = _feed_device(sharding)
        label_device = (_feed_device(label_sharding) if label_sharding is not None
                        else self.device)
        if label_device != self.device:
            raise MXNetError("DeviceFeedIter: data on %s and labels on %s; the port stages "
                             "a batch on one device" % (self.device, label_device))
        self.batch_size = data_iter.batch_size
        self._cuda = self.device.type == "cuda"
        self._stream = _staging_stream(self.device) if self._cuda else None
        self._staged = deque()  # (DataBatch, event, pinned buffers)
        self._free = {}  # (shape, dtype) -> [(pinned buffer, event of its last copy)]
        self._exhausted = False
        self.current_batch = None
        for name in ("seek_epoch", "seek_sample"):
            if hasattr(data_iter, name):  # the source's repositioning, behind the staged batches
                setattr(self, name, functools.partial(self._reposition, name))
        self._fill()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def num_hosts(self):
        return getattr(self.iter, "num_hosts", 1)

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _pinned(self, t):
        key = (tuple(t.shape), t.dtype)
        free = self._free.get(key)
        if free:
            buf, event = free.pop()
            event.synchronize()  # its last copy out has finished
            return buf
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def _place(self, arr, pinned):
        t = arr._data if isinstance(arr, NDArray) else torch.as_tensor(np.asarray(arr))
        if t.device == self.device:
            return t  # already there (a source that makes device batches)
        if t.device.type != "cpu":
            raise MXNetError("DeviceFeedIter: a batch on %s cannot be staged on %s"
                             % (t.device, self.device))
        if not self._cuda:
            return t.clone()
        buf = self._pinned(t)
        buf.copy_(t)
        pinned.append(buf)
        with torch.cuda.stream(self._stream):
            return buf.to(self.device, non_blocking=True)

    def _stage_one(self):
        """Pull one host batch and enqueue its copies to the device."""
        if self._exhausted:
            return False
        from .context import cpu

        try:
            with cpu():
                b = self.iter.next()
        except StopIteration:
            self._exhausted = True
            return False
        pinned = []
        batch = DataBatch(
            data=[self._place(a, pinned) for a in (b.data or [])],
            label=[self._place(a, pinned) for a in (b.label or [])],
            pad=b.pad, index=b.index, bucket_key=b.bucket_key,
            provide_data=b.provide_data, provide_label=b.provide_label)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
        self._staged.append((batch, event, pinned))
        return True

    def _release(self, entry):
        """Return an entry's pinned buffers to the free list with its event
        (a dropped entry's copies may still be in flight)."""
        _batch, event, pinned = entry
        for buf in pinned:
            self._free.setdefault((tuple(buf.shape), buf.dtype), []).append((buf, event))

    def _drop_staged(self):
        while self._staged:
            self._release(self._staged.popleft())

    def _fill(self):
        while len(self._staged) < self.depth and self._stage_one():
            pass

    def _reposition(self, how, *args):
        """Drop the staged batches, call the source's ``how`` (``reset``,
        ``seek_epoch``, ``seek_sample``) with ``args``, stage again."""
        self._drop_staged()
        self._exhausted = False
        self.current_batch = None
        getattr(self.iter, how)(*args)
        self._fill()

    def reset(self):
        self._reposition("reset")

    def skip(self, num_batches):
        """Resume: the staged batches count first, the rest goes to the inner
        iterator's (possibly O(1)) skip; then stage again."""
        num_batches = int(num_batches)
        while num_batches > 0 and self._staged:
            self._release(self._staged.popleft())
            num_batches -= 1
        if num_batches > 0:
            self.iter.skip(num_batches)
        self._fill()

    def next(self):
        t0 = time.perf_counter()
        if not self._staged:
            self._fill()
        if not self._staged:
            raise StopIteration
        entry = self._staged.popleft()
        batch, event, _pinned = entry
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.data + batch.label:
                t.record_stream(stream)
        self._release(entry)
        batch.data = [NDArray(t) for t in batch.data]
        batch.label = [NDArray(t) for t in batch.label]
        batch.staged_device = self.device
        self.current_batch = batch
        self._fill()  # keep `depth` batches staged
        _H_FEED_WAIT.observe(time.perf_counter() - t0)
        return batch

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Input data as a list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them or dict")
    for k, v in data.items():
        if isinstance(v, NDArray):
            data[k] = v.asnumpy()
    return list(data.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays; ``last_batch_handle`` is "pad" (the
    last batch wraps around and reports its pad), "discard" or
    "roll_over" (the remainder opens the next epoch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False, last_batch_handle="pad",
                 data_name="data", label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]
        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:]))) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:]))) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def skip(self, num_batches):
        """Cursor math, no data touched. Clamped where sequential next()
        calls stop (the increment of the first failing iter_next still
        lands): roll_over's reset() derives the next epoch's wrap offset
        from the cursor, so skip(k) leaves the value k next()s would."""
        target = self.cursor + int(num_batches) * self.batch_size
        if target >= self.num_data:
            to_end = -(-(self.num_data - self.cursor) // self.batch_size)
            target = min(target, self.cursor + max(1, to_end) * self.batch_size)
        self.cursor = target

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(), pad=self.getpad(),
                             index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [nd.array(x[1][self.cursor:self.cursor + self.batch_size])
                    for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.array(np.concatenate((x[1][self.cursor:], x[1][:pad]), axis=0))
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _read_idx_file(path, native_ok=True):
    """An MNIST idx file as a uint8 numpy array (native reader for an
    uncompressed file where the host library loaded)."""
    if native_ok and not path.endswith(".gz"):
        from . import native

        if native.available():
            return native.mnist_read(path)
    with (gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")) as f:
        head = f.read(4)
        ndim = head[3]
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class MNISTIter(DataIter):
    """MNIST idx-format reader (the C++ iter_mnist.cc): images scaled to
    [0, 1], shuffled with ``RandomState(seed)``, the last partial batch
    discarded."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False, silent=False,
                 seed=0, input_shape=None, **kwargs):
        super().__init__()
        imgs = _read_idx_file(image)
        lbls = _read_idx_file(label)
        num, rows, cols = imgs.shape
        imgs = imgs.astype(np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, rows, cols)
        if input_shape is not None:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        if shuffle:
            rng = np.random.RandomState(seed)
            order = rng.permutation(imgs.shape[0])
            imgs, lbls = imgs[order], lbls[order]
        self._inner = NDArrayIter(imgs, lbls.astype(np.float32), batch_size=batch_size,
                                  last_batch_handle="discard")
        self.batch_size = batch_size

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def skip(self, num_batches):
        self._inner.skip(num_batches)


def _read_csv(path):
    """A CSV of floats as a 2-d float32 array (rows as in the file): the
    native parser where the host library loaded, else ``np.loadtxt``."""
    from . import native

    if native.available():
        with open(path) as f:
            first = f.readline()
        cols = max(1, len([v for v in first.strip().split(",") if v.strip()]))
        vals = native.csv_read_floats(path, os.path.getsize(path) // 2 + 1)
        return vals.reshape(-1, cols)
    return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)


class CSVIter(DataIter):
    """CSV reader (the C++ iter_csv.cc); ``round_batch`` rolls the last
    partial batch over into the next epoch."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,), batch_size=1,
                 round_batch=True, **kwargs):
        super().__init__()
        data = _read_csv(data_csv).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _read_csv(label_csv).reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        self._inner = NDArrayIter(data, label, batch_size=batch_size,
                                  last_batch_handle="roll_over" if round_batch else "pad")
        self.batch_size = batch_size

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def skip(self, num_batches):
        self._inner.skip(num_batches)


def ImageRecordIter(**kwargs):
    """RecordIO image iterator (the C++ iter_image_recordio_2.cc) over
    ``image.ImageIter.from_recordio_params``: path_imgrec, data_shape,
    batch_size, mean_r/g/b, scale, rand_crop, rand_mirror, shuffle,
    preprocess_threads. With ``input_workers`` > 0 (or
    ``MXTPU_INPUT_WORKERS``) the streaming pipeline takes over
    (``io_pipeline.StreamingImageRecordIter``)."""
    from .image import ImageIter

    return ImageIter.from_recordio_params(**kwargs)


def ImageDetRecordIter(**kwargs):
    """Detection RecordIO iterator (the C++ iter_image_det_recordio.cc):
    labels as [c, h, w, len, packed..., pad]."""
    from .image import ImageDetIter

    return ImageDetIter(**kwargs)


def DetRecordIter(**kwargs):
    """ImageDetRecordIter with the SSD label reshape to (batch, max_objects,
    object_width)."""
    from .image import DetRecordIter as _Det

    return _Det(**kwargs)


MXDataIter = DataIter  # the reference's name for its C iterators' wrapper
