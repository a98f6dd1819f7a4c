"""ctypes bindings to NVRTC and the CUDA driver API, for ``rtc.Rtc``.

NVRTC compiles a CUDA C source at run time to CUBIN for ``sm_90a``; the
driver API loads it into torch's primary context (``cuModuleLoadData``,
``cuModuleGetFunction``) and launches it on a torch stream
(``cuLaunchKernel``) through a :class:`LaunchRecord`, which keeps the
function, its checked grid and block and the argument array it hands the
CUDA driver, so a launch only writes the data pointers into that array.
``libnvrtc.so.12`` or ``libnvrtc.so`` is looked for on the loader path,
then under ``$CUDA_HOME/lib64`` (default ``/usr/local/cuda``);
``libcuda.so.1`` on the loader path. Nothing is loaded when this module
is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from .base import MXNetError

ARCH = "sm_90a"
_lock = threading.Lock()
_libs = {}
_contexts = {}  # device index -> retained primary CUcontext

_P, _I, _U, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_size_t
_NVRTC_SIGNATURES = {
    "nvrtcCreateProgram": [ctypes.POINTER(_P), ctypes.c_char_p, ctypes.c_char_p, _I, _P, _P],
    "nvrtcCompileProgram": [_P, _I, ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcGetProgramLogSize": [_P, ctypes.POINTER(_S)],
    "nvrtcGetProgramLog": [_P, ctypes.c_char_p],
    "nvrtcGetCUBINSize": [_P, ctypes.POINTER(_S)],
    "nvrtcGetCUBIN": [_P, ctypes.c_char_p],
    "nvrtcDestroyProgram": [ctypes.POINTER(_P)],
}
_CUDA_SIGNATURES = {
    "cuInit": [_U],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [ctypes.POINTER(_P), _I],
    "cuCtxSetCurrent": [_P],
    "cuCtxGetCurrent": [ctypes.POINTER(_P)],
    "cuModuleLoadData": [ctypes.POINTER(_P), ctypes.c_char_p],
    "cuModuleGetFunction": [ctypes.POINTER(_P), _P, ctypes.c_char_p],
    "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P, ctypes.POINTER(_P), _P],
    "cuGetErrorString": [_I, ctypes.POINTER(ctypes.c_char_p)],
}


def cuda_home():
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"


def _open(names, what):
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    for name in names:
        path = os.path.join(cuda_home(), "lib64", name)
        if os.path.isfile(path):
            return ctypes.CDLL(path)
    raise MXNetError("%s not found: tried %s on the loader path and under %s/lib64"
                     % (what, ", ".join(names), cuda_home()))


def _lib(key):
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key not in _libs:
            if key == "nvrtc":
                lib, sigs = _open(("libnvrtc.so.12", "libnvrtc.so"), "NVRTC"), _NVRTC_SIGNATURES
            else:
                lib, sigs = _open(("libcuda.so.1", "libcuda.so"), "the CUDA driver"), \
                    _CUDA_SIGNATURES
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            if key == "nvrtc":
                lib.nvrtcGetErrorString.argtypes = [_I]
                lib.nvrtcGetErrorString.restype = ctypes.c_char_p
            _libs[key] = lib
        return _libs[key]


def _nvrtc_check(rc, what):
    if rc != 0:
        msg = _lib("nvrtc").nvrtcGetErrorString(rc)
        raise MXNetError("%s: NVRTC error %d (%s)" % (what, rc, msg.decode() if msg else "?"))


def _cu_check(rc, what):
    if rc != 0:
        text = ctypes.c_char_p()
        _lib("cuda").cuGetErrorString(rc, ctypes.byref(text))
        raise MXNetError("%s: CUDA driver error %d (%s)"
                         % (what, rc, text.value.decode() if text.value else "?"))


def options():
    """NVRTC options: the card's architecture, C++17, and CUDA's include
    directory so that cuda_fp16.h and cuda_bf16.h resolve."""
    opts = ["--gpu-architecture=%s" % ARCH, "--std=c++17"]
    include = os.path.join(cuda_home(), "include")
    if os.path.isdir(include):
        opts.append("-I%s" % include)
    return opts


def compile_cubin(source, filename):
    """CUBIN of ``source``; raises :class:`MXNetError` carrying NVRTC's log
    when the source does not compile."""
    lib = _lib("nvrtc")
    prog = _P()
    _nvrtc_check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        filename.encode(), 0, None, None), "nvrtcCreateProgram")
    try:
        opts = [o.encode() for o in options()]
        rc = lib.nvrtcCompileProgram(prog, len(opts), (ctypes.c_char_p * len(opts))(*opts))
        size = _S()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if rc != 0:
            raise MXNetError("NVRTC could not compile %s (options %s):\n%s"
                             % (filename, " ".join(options()), log.value.decode(errors="replace")))
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)), "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _primary_context(index):
    """torch's primary context of CUDA device ``index``, retained once."""
    ctx = _contexts.get(index)
    if ctx is None:
        torch.cuda.init()
        lib = _lib("cuda")
        with _lock:
            if index not in _contexts:
                _cu_check(lib.cuInit(0), "cuInit")
                dev, handle = _I(), _P()
                _cu_check(lib.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
                _cu_check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(handle), dev),
                          "cuDevicePrimaryCtxRetain")
                _contexts[index] = handle
            ctx = _contexts[index]
    return ctx


def load_function(cubin, name, index):
    """The CUfunction ``name`` of ``cubin`` loaded on CUDA device ``index``
    (in its primary context, made current on this thread for the load and
    the previous one restored after it)."""
    ctx = _primary_context(index)
    lib = _lib("cuda")
    prev = _P()
    _cu_check(lib.cuCtxGetCurrent(ctypes.byref(prev)), "cuCtxGetCurrent")
    _cu_check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    try:
        module, fn = _P(), _P()
        _cu_check(lib.cuModuleLoadData(ctypes.byref(module), cubin), "cuModuleLoadData")
        _cu_check(lib.cuModuleGetFunction(ctypes.byref(fn), module, name.encode()),
                  "cuModuleGetFunction(%s)" % name)
    finally:
        _cu_check(lib.cuCtxSetCurrent(prev), "cuCtxSetCurrent")
    return fn


class LaunchRecord:
    """One launch configuration of a CUfunction: device ``index``, the
    checked ``grid`` and ``block`` 3-tuples, and ``n_args`` pointer
    arguments. ``slots`` are the arguments' ``c_void_p`` values and
    ``params`` the ``void**`` array that points at them, which
    ``cuLaunchKernel`` reads when it is called; ``head`` holds its first
    eight arguments; ``lock`` keeps two threads from filling the slots of
    one record at once."""

    __slots__ = ("fn", "index", "grid", "block", "slots", "params", "head", "ctx", "lock")

    def __init__(self, fn, index, grid, block, n_args):
        self.fn, self.index = fn, index
        self.grid, self.block = tuple(grid), tuple(block)
        self.slots = [_P() for _ in range(n_args)]
        self.params = (_P * n_args)(*[ctypes.addressof(a) for a in self.slots])
        self.head = (fn, *self.grid, *self.block, 0)  # function, dims, no dynamic smem
        self.ctx = None  # the primary context, looked up at the first launch
        self.lock = threading.Lock()


_current = threading.local()  # this thread's out slot for cuCtxGetCurrent


def _raw_stream(index):
    """The cudaStream_t of device ``index``'s current torch stream, as an
    int: ``torch.cuda.current_stream(index).cuda_stream`` without building
    a Stream object (about a tenth of its host time)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(record, pointers):
    """Launch ``record``'s function with the data pointers ``pointers`` (one
    per argument, in order) on the current torch stream of its device.
    The launch goes to the context current on this thread: when that is
    not the device's primary context (another device's, or none on a new
    thread), the primary one is made current for the launch and the
    previous one restored after it, so torch's current device is left as
    it was."""
    lib = _lib("cuda")
    ctx = record.ctx
    if ctx is None:
        ctx = record.ctx = _primary_context(record.index)
    stream = _raw_stream(record.index)
    cur = getattr(_current, "ctx", None)
    if cur is None:
        cur = _current.ctx = _P()
    rc = lib.cuCtxGetCurrent(ctypes.byref(cur))
    if rc:
        _cu_check(rc, "cuCtxGetCurrent")
    prev = cur.value
    switch = prev != ctx.value
    if switch:
        _cu_check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    try:
        with record.lock:
            for slot, ptr in zip(record.slots, pointers):
                slot.value = ptr
            rc = lib.cuLaunchKernel(*record.head, stream, record.params, None)
    finally:
        if switch:
            _cu_check(lib.cuCtxSetCurrent(prev), "cuCtxSetCurrent")
    if rc:
        _cu_check(rc, "cuLaunchKernel")
