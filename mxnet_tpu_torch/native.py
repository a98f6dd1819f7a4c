"""ctypes bindings for the port's native host library (counterpart of
``mxnet_tpu/native.py``): the dependency engine, the mmap-indexed RecordIO
reader, the MNIST and CSV parsers and the JPEG / PNG decoders of
``mxnet_tpu_torch/src/*.cc``.

The library is built with ``g++`` (``src/Makefile``) at first use into
``build/native/libmxtpu_torch.so`` beside the package (never into the
package directory), keyed on a hash of the sources and the host's C
library: a stale stamp rebuilds, into a temporary file renamed into
place, so concurrent processes (decode workers, test workers) each load a
whole library. A host with no ``g++``
keeps the pure-Python paths: ``available()`` gates every fast path, and a
failed build is remembered for the process. This is host code; nothing here
touches CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
LIB_PATH = BUILD_DIR / "libmxtpu_torch.so"
_STAMP = BUILD_DIR / "libmxtpu_torch.so.sha256"


def _source_hash():
    """The stamp: the sources and the host's machine and C library, so a
    library built on another host is rebuilt, not loaded."""
    h = hashlib.sha256(repr((platform.machine(), platform.libc_ver())).encode())
    for f in sorted(SRC_DIR.iterdir()):
        if f.suffix in (".cc", ".h") or f.name == "Makefile":
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def build():
    """Build the library if its stamp does not match the sources; returns
    its path. Raises ``subprocess.CalledProcessError`` or ``OSError`` when
    ``make`` / ``g++`` fail."""
    digest = _source_hash()
    if LIB_PATH.exists() and _STAMP.exists() and _STAMP.read_text().strip() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libmxtpu_torch-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["make", "-s", "-B", "TARGET=" + tmp], cwd=SRC_DIR, check=True,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    stamp_tmp = str(_STAMP) + ".%d" % os.getpid()
    with open(stamp_tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(stamp_tmp, _STAMP)
    return LIB_PATH


def _bind(lib):
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.engine_create.restype = ctypes.c_void_p
    lib.engine_create.argtypes = [ctypes.c_int]
    lib.engine_destroy.argtypes = [ctypes.c_void_p]
    lib.engine_new_var.restype = ctypes.c_int64
    lib.engine_new_var.argtypes = [ctypes.c_void_p]
    lib.engine_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, c_i64p,
                                ctypes.c_int, c_i64p, ctypes.c_int]
    lib.engine_wait_for_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.engine_wait_all.argtypes = [ctypes.c_void_p]
    lib.recio_open.restype = ctypes.c_void_p
    lib.recio_open.argtypes = [ctypes.c_char_p]
    lib.recio_num_records.restype = ctypes.c_int64
    lib.recio_num_records.argtypes = [ctypes.c_void_p]
    lib.recio_record.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.recio_record.argtypes = [ctypes.c_void_p, ctypes.c_int64, c_i64p]
    lib.recio_payload_offset.restype = ctypes.c_int64
    lib.recio_payload_offset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.recio_close.argtypes = [ctypes.c_void_p]
    lib.mnist_read_header.restype = ctypes.c_int
    lib.mnist_read_header.argtypes = [ctypes.c_char_p, c_i64p, ctypes.POINTER(ctypes.c_int)]
    lib.mnist_read_data.restype = ctypes.c_int
    lib.mnist_read_data.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.csv_parse_floats.restype = ctypes.c_int64
    lib.csv_parse_floats.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int64]
    for name in ("imdecode_jpeg", "imdecode_png"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8),
                       ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


def get_lib():
    """The loaded library (building it if needed), or None where it cannot
    be built or loaded; the failure is remembered for the process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is False:
            return None
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError):
            _LIB = False
            return None
        _bind(lib)
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


_ENGINE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class NativeEngine:
    """Native threaded dependency engine (drop-in for engine.ThreadedEngine)."""

    def __init__(self, num_workers=4):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.engine_create(num_workers)
        # ONE ffi closure for the engine's lifetime; ops are dispatched by
        # the void* ctx (an id into _pending). A closure a push could never
        # be freed safely: the worker is still in the closure's epilogue
        # when the Python function returns.
        self._pending = {}  # cb_id -> python fn
        self._cb_lock = threading.Lock()
        self._cb_id = 0  # ids start at 1: c_void_p(0) arrives as None

        def _dispatch(ctx):
            with self._cb_lock:
                fn = self._pending.pop(ctx, None)
            if fn is not None:
                fn()

        self._c_dispatch = _ENGINE_CB(_dispatch)

    def new_variable(self):
        return self._lib.engine_new_var(self._h)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name=None):
        from .base import MXNetError

        # repeated or overlapping vars would deadlock the dependency queues
        # (a write queued behind this op's own read or write)
        if len(set(mutable_vars)) != len(tuple(mutable_vars)):
            raise MXNetError("engine.push: duplicate mutable vars")
        if len(set(const_vars)) != len(tuple(const_vars)):
            raise MXNetError("engine.push: duplicate const vars")
        dup = set(const_vars) & set(mutable_vars)
        if dup:
            raise MXNetError("engine.push: vars %s appear in both const_vars and mutable_vars"
                             % sorted(dup))
        with self._cb_lock:
            self._cb_id += 1
            cb_id = self._cb_id
            self._pending[cb_id] = fn
        n_c, n_m = len(const_vars), len(mutable_vars)
        c_arr = (ctypes.c_int64 * max(n_c, 1))(*const_vars)
        m_arr = (ctypes.c_int64 * max(n_m, 1))(*mutable_vars)
        self._lib.engine_push(self._h, ctypes.cast(self._c_dispatch, ctypes.c_void_p),
                              ctypes.c_void_p(cb_id), c_arr, n_c, m_arr, n_m)

    def raise_pending(self):
        pass  # native ops report failure through their own callbacks

    def wait_for_var(self, var):
        self._lib.engine_wait_for_var(self._h, var)

    def wait_for_all(self):
        self._lib.engine_wait_all(self._h)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            try:
                self._lib.engine_destroy(self._h)
            except Exception:
                pass
            self._h = None


class NativeRecordReader:
    """mmap-indexed RecordIO reader (the native fast path for .rec files)."""

    def __init__(self, path):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.recio_open(path.encode())
        if not self._h:
            raise IOError("cannot open recordio file %s" % path)

    def __len__(self):
        return self._lib.recio_num_records(self._h)

    def read(self, i) -> bytes:
        n = ctypes.c_int64()
        ptr = self._lib.recio_record(self._h, i, ctypes.byref(n))
        if not ptr:
            raise IndexError(i)
        if n.value == 0:
            return b""  # zero-length records are valid
        return ctypes.string_at(ptr, n.value)

    def payload_offset(self, i) -> int:
        off = self._lib.recio_payload_offset(self._h, i)
        if off < 0:
            raise IndexError(i)
        return off

    def close(self):
        if getattr(self, "_h", None):
            self._lib.recio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def csv_read_floats(path, expected):
    """Parse a CSV of floats natively into a float32 numpy array of at most
    ``expected`` values."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.empty(expected, np.float32)
    n = lib.csv_parse_floats(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             expected)
    if n < 0:
        raise IOError("cannot parse %s" % path)
    return buf[:n]


def mnist_read(path):
    """An uncompressed MNIST idx file as a uint8 numpy array of its header's
    shape (the native header reader and one read of the payload)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    dims = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    if lib.mnist_read_header(path.encode(), dims, ctypes.byref(ndim)) != 0 \
            or not 0 < ndim.value <= 8:
        raise IOError("cannot read the idx header of %s" % path)
    shape = tuple(int(d) for d in dims[:ndim.value])
    out = np.empty(int(np.prod(shape)), np.uint8)
    if lib.mnist_read_data(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           out.size) != 0:
        raise IOError("truncated idx payload in %s" % path)
    return out.reshape(shape)


def _decode(name, buf, gray):
    lib = get_lib()
    if lib is None:
        return None
    fn = getattr(lib, name)
    data = bytes(buf)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    need = fn(data, len(data), None, 0, int(gray), ctypes.byref(w), ctypes.byref(h),
              ctypes.byref(c))
    if need < 0:
        return None
    out = np.empty(int(need), np.uint8)
    got = fn(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(need),
             int(gray), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if got != need:
        return None
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    return out.reshape(shape)


def imdecode_jpeg(buf, gray=False):
    """Native JPEG decode to an HWC uint8 numpy array, or None when the
    buffer is not a decodable JPEG or libjpeg is not on this host. ctypes
    releases the GIL for the call, so decode threads run in parallel."""
    return _decode("imdecode_jpeg", buf, gray)


def imdecode_png(buf, gray=False):
    """Native PNG decode (8-bit gray / RGB / RGBA, not interlaced) to an HWC
    uint8 numpy array with PIL's pixels, or None for any other PNG or a
    host without libz."""
    return _decode("imdecode_png", buf, gray)
