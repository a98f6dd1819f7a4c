"""Data iterators of the PyTorch port (counterpart of ``mxnet_tpu/io.py``):
DataDesc, DataBatch (with ``pad``), DataIter, NDArrayIter (the three
``last_batch_handle`` modes, shuffle through ``np.random``), ResizeIter and
PrefetchingIter, each with ``skip`` for checkpoint resume. Batches are
NDArrays on the current context, made from
the host arrays as the JAX package makes them, so both packages see the
same batches, pads and shuffle order from one ``np.random`` seed.

PrefetchingIter produces the next batch on a worker thread while the
caller consumes the current one (the JAX package schedules the same
produce op on its host engine). Not ported yet: DeviceFeedIter (its
double-buffered device staging), MNISTIter, CSVIter and ImageRecordIter.
"""
from __future__ import annotations

import contextlib
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import ndarray as nd
from .context import Context
from .ndarray import NDArray

DataDesc = namedtuple("DataDesc", ["name", "shape"])


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
    """Prefetcher over one or more iterators: each source's next batch is
    produced on a worker thread while the caller consumes the current one;
    a source's exception surfaces in the consumer."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self._pool = ThreadPoolExecutor(max_workers=self.n_iter)
        self.current_batch = None
        self._pending = [None] * self.n_iter
        self._prefetch_all()

    def _produce(self, i, ctx):
        # the caller's ``with ctx:`` is thread-local: enter it on the worker
        with ctx if ctx is not None else contextlib.nullcontext():
            try:
                return self.iters[i].next()
            except StopIteration:
                return None

    def _prefetch_all(self):
        ctx = getattr(Context._default_ctx, "value", None)
        self._pending = [self._pool.submit(self._produce, i, ctx) for i in range(self.n_iter)]

    def _await_batches(self):
        return [f.result() for f in self._pending]

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
        batches = self._await_batches()
        if batches[0] is None:
            for b in batches:
                assert b is None, "Number of entry mismatches between iterators"
            self._pending = [self._pool.submit(lambda: None) for _ in range(self.n_iter)]
            return False
        for b in batches:
            assert b.pad == batches[0].pad, "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([b.data for b in batches], []), sum([b.label for b in batches], []),
            batches[0].pad, batches[0].index, provide_data=self.provide_data,
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


def _not_ported(name, line):
    def make(*args, **kwargs):
        raise NotImplementedError(
            "%s is not ported to PyTorch yet (mxnet_tpu/io.py:%d)" % (name, line))

    make.__name__ = name
    return make


DeviceFeedIter = _not_ported("DeviceFeedIter", 290)
MNISTIter = _not_ported("MNISTIter", 562)
CSVIter = _not_ported("CSVIter", 606)
ImageRecordIter = _not_ported("ImageRecordIter", 642)
