"""Runtime kernel compilation — ``mx.rtc`` of the PyTorch port (counterpart
of ``mxnet_tpu/rtc.py``; kernel K5).

The reference's own contract (``python/mxnet/rtc.py`` +
``src/common/mxrtc.cc``): the user hands over the BODY of a CUDA C kernel
as a string; it is compiled at run time by NVRTC, cached, and launched
with ``push(ins, outs, grid_dims, block_dims)``. The JAX package's Pallas
body is the TPU's redesign of that contract; the port returns to CUDA C.

- **Decoration.** The body is wrapped as
  ``extern "C" __global__ void <name>(const T* <in>..., T* <out>...)``,
  ``T`` following each array's dtype (:data:`CTYPES`). Before the body
  each array's shape is declared as compile-time constants
  ``<name>_size``, ``<name>_ndim`` and ``<name>_shape<i>``, and its element
  type as ``<name>_t`` — they stand in for the shapes a Pallas ref carries.
- **Cache.** One compile per (shapes, dtypes) of the inputs and outputs,
  as the JAX package keys it (``rtc.py:65-66``); the constructor compiles
  its template arrays' signature, so a bad source raises
  :class:`MXNetError` carrying NVRTC's log at once.
- **Launch.** ``cuLaunchKernel`` on ``torch.cuda.current_stream()`` with
  both ``grid_dims`` and ``block_dims`` honoured (the JAX package ignores
  ``block_dims``: Mosaic owns the tiling there); ``block_dims`` None means
  one thread. Results are written straight into ``outs``. Each Rtc keeps
  a launch record (``_nvrtc.LaunchRecord``) for each (shapes, dtypes,
  devices, grid, block) it was pushed with: the compiled function, the
  checked grid and block, and the argument array handed to the CUDA driver.
  A push checks its arrays in one pass (count, NDArray, dtype,
  contiguity; the device and the launch dimensions are part of the key,
  checked when a record is made, so a key that fails never gets one and
  raises on every push) and writes their data pointers into the record.
- **CPU.** CUDA C cannot run on the host: an Rtc whose arrays are on the
  CPU raises :class:`MXNetError`, as the reference's rtc was GPU-only.

``Rtc.launches`` counts launches and ``Rtc.compiles`` / ``compile_seconds``
NVRTC compiles, over every Rtc. Example::

    x = mx.nd.ones((8, 128), ctx=mx.gpu(0))
    y = mx.nd.zeros((8, 128), ctx=mx.gpu(0))
    k = mx.rtc.Rtc('axpy', [('x', x)], [('y', y)], '''
        for (long long i = threadIdx.x; i < y_size; i += blockDim.x)
            y[i] = x[i] * 2.0f;''')
    k.push([x], [y], (1, 1, 1), (128, 1, 1))
"""
from __future__ import annotations

import textwrap
import time

import numpy as np
import torch

from . import _nvrtc
from . import profiler
from .base import MXNetError, dtype_name
from .ndarray import NDArray

CTYPES = {
    torch.float32: "float", torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
    torch.float64: "double", torch.int32: "int", torch.int64: "long long",
    torch.int8: "signed char", torch.uint8: "unsigned char",
}
_HEADERS = {"__half": "cuda_fp16.h", "__nv_bfloat16": "cuda_bf16.h"}
MAX_THREADS = 1024
_MAX_BLOCK = (1024, 1024, 64)
_MAX_GRID = (2**31 - 1, 65535, 65535)


def ctype_of(dtype):
    """The CUDA C element type of a torch dtype; raises for any other."""
    if dtype not in CTYPES:
        raise MXNetError("Rtc: dtype %s has no CUDA C type here (takes %s)"
                         % (dtype_name(dtype), ", ".join(dtype_name(d) for d in CTYPES)))
    return CTYPES[dtype]


def decorate(name, inputs, outputs, body):
    """The CUDA C source compiled for ``body``: ``inputs`` / ``outputs`` are
    lists of (name, shape, torch dtype)."""
    types = [ctype_of(d) for _, _, d in list(inputs) + list(outputs)]
    lines = ["#include <%s>" % _HEADERS[t] for t in sorted(set(types)) if t in _HEADERS]
    params = ["const %s* %s" % (t, n) for (n, _, _), t in zip(inputs, types)]
    params += ["%s* %s" % (t, n) for (n, _, _), t in zip(outputs, types[len(inputs):])]
    lines.append('extern "C" __global__ void %s(%s)' % (name, ", ".join(params)))
    lines.append("{")
    for (n, shape, _), t in zip(list(inputs) + list(outputs), types):
        lines.append("    typedef %s %s_t;" % (t, n))
        lines.append("    [[maybe_unused]] constexpr long long %s_size = %dLL;"
                     % (n, int(np.prod(shape, dtype=np.int64)) if shape else 1))
        lines.append("    [[maybe_unused]] constexpr int %s_ndim = %d;" % (n, len(shape)))
        lines += ["    [[maybe_unused]] constexpr long long %s_shape%d = %dLL;" % (n, i, d)
                  for i, d in enumerate(shape)]
    lines.append(textwrap.indent(textwrap.dedent(body).strip("\n"), "    "))
    lines.append("}")
    return "\n".join(lines) + "\n"


def launch_dims(grid_dims, block_dims):
    """(grid, block) as 3-tuples of positive ints; raises past the card's
    limits (1024 threads a block)."""
    def dims(v, what):
        v = tuple(int(d) for d in (v if v is not None else (1,)))
        if not 1 <= len(v) <= 3 or any(d < 1 for d in v):
            raise MXNetError("Rtc: %s dims must be 1 to 3 positive ints, got %s" % (what, v))
        return v + (1,) * (3 - len(v))

    grid, block = dims(grid_dims, "grid"), dims(block_dims, "block")
    if int(np.prod(block)) > MAX_THREADS or any(b > m for b, m in zip(block, _MAX_BLOCK)):
        raise MXNetError("Rtc: block %s is more than %d threads a block (limits %s)"
                         % (block, MAX_THREADS, _MAX_BLOCK))
    if any(g > m for g, m in zip(grid, _MAX_GRID)):
        raise MXNetError("Rtc: grid %s is past the card's limits %s" % (grid, _MAX_GRID))
    return grid, block


def check_arrays(rtc_name, names, arrays, kind):
    """(name, shape, dtype) of each array; raises on a wrong count, a
    non-NDArray, an unsupported dtype or a non-contiguous array."""
    arrays = list(arrays)
    if len(arrays) != len(names):
        raise MXNetError("Rtc %s: wrong number of arrays: %d %s for %s"
                         % (rtc_name, len(arrays), kind, names))
    specs = []
    for n, a in zip(names, arrays):
        if not isinstance(a, NDArray):
            raise MXNetError("Rtc %s: %s %s is not an NDArray" % (rtc_name, kind, n))
        ctype_of(a._data.dtype)
        if not a._data.is_contiguous():
            raise MXNetError("Rtc %s: %s %s is not contiguous" % (rtc_name, kind, n))
        specs.append((n, tuple(a.shape), a._data.dtype))
    return specs


def device_of(rtc_name, arrays):
    """The one CUDA device of ``arrays``; raises for CPU arrays or several
    devices."""
    devices = {a._data.device for a in arrays}
    if any(d.type != "cuda" for d in devices):
        raise MXNetError("Rtc %s: arrays on %s; CUDA C runs on a CUDA device only, not on "
                         "the host" % (rtc_name, sorted(map(str, devices))))
    if len(devices) != 1:
        raise MXNetError("Rtc %s: arrays on several devices %s"
                         % (rtc_name, sorted(map(str, devices))))
    return devices.pop()


class Rtc:
    """A CUDA C kernel body compiled at run time (see the module docstring).

    ``inputs`` / ``outputs`` are (name, NDArray) templates on one CUDA
    device; ``kernel`` is the body."""

    launches = 0
    compiles = 0
    compile_seconds = 0.0

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        profiler.register_kernel_label(name, "K5")  # attribute_trace's label
        self.in_names = [n for n, _ in inputs]
        self.out_names = [n for n, _ in outputs]
        self.kernel_source = kernel
        self._cache = {}
        self._records = {}
        ins = check_arrays(name, self.in_names, [a for _, a in inputs], "inputs")
        outs = check_arrays(name, self.out_names, [a for _, a in outputs], "outputs")
        device = device_of(name, [a for _, a in list(inputs) + list(outputs)])
        self._function(ins, outs, device)

    def _function(self, ins, outs, device):
        key = (tuple(s for _, s, _ in ins), tuple(dtype_name(d) for _, _, d in ins),
               tuple(s for _, s, _ in outs), tuple(dtype_name(d) for _, _, d in outs))
        entry = self._cache.get(key)
        if entry is None:
            source = decorate(self.name, ins, outs, self.kernel_source)
            t0 = time.perf_counter()
            try:
                cubin = _nvrtc.compile_cubin(source, "%s.cu" % self.name)
            except MXNetError as e:
                raise MXNetError("Rtc %s: %s" % (self.name, e)) from None
            Rtc.compile_seconds += time.perf_counter() - t0
            Rtc.compiles += 1
            entry = self._cache[key] = {"source": source, "cubin": cubin, "functions": {}}
        fn = entry["functions"].get(device.index)
        if fn is None:
            fn = entry["functions"][device.index] = _nvrtc.load_function(
                entry["cubin"], self.name, device.index)
        return fn

    def push(self, ins, outs, grid_dims=(1, 1, 1), block_dims=None):
        """Run the kernel on ``ins`` / ``outs`` (NDArray lists matching the
        templates' names), ``grid_dims`` blocks of ``block_dims`` threads;
        results are written into ``outs``."""
        arrays_in, arrays_out = list(ins), list(outs)
        sig, ptrs = [], []
        for kind, names, arrays in (("inputs", self.in_names, arrays_in),
                                    ("outputs", self.out_names, arrays_out)):
            if len(arrays) != len(names):
                check_arrays(self.name, names, arrays, kind)  # raises
            for n, a in zip(names, arrays):
                if not isinstance(a, NDArray):
                    raise MXNetError("Rtc %s: %s %s is not an NDArray" % (self.name, kind, n))
                t = a._data
                if t.dtype not in CTYPES:
                    ctype_of(t.dtype)  # raises
                if not t.is_contiguous():
                    raise MXNetError("Rtc %s: %s %s is not contiguous" % (self.name, kind, n))
                sig += (t.shape, t.dtype, t.get_device())
                ptrs.append(t.data_ptr())
        key = (tuple(sig), _dims_key(grid_dims), _dims_key(block_dims))
        record = self._records.get(key)
        if record is None:
            record = self._records[key] = self._record(arrays_in, arrays_out, grid_dims,
                                                       block_dims)
        _nvrtc.launch(record, ptrs)
        Rtc.launches += 1
        return outs

    def _record(self, ins, outs, grid_dims, block_dims):
        """The launch record of arrays that passed ``push``'s checks: the
        launch dimensions and the device are checked here."""
        grid, block = launch_dims(grid_dims, block_dims)
        device = device_of(self.name, ins + outs)
        fn = self._function(check_arrays(self.name, self.in_names, ins, "inputs"),
                            check_arrays(self.name, self.out_names, outs, "outputs"), device)
        return _nvrtc.LaunchRecord(fn, device.index, grid, block, len(ins) + len(outs))


def _dims_key(dims):
    """``grid_dims`` or ``block_dims`` as a dictionary key."""
    return dims if dims is None or isinstance(dims, tuple) else tuple(dims)


def rtc(name, inputs, outputs, kernel):
    """Functional alias mirroring ``mx.rtc.Rtc``."""
    return Rtc(name, inputs, outputs, kernel)
