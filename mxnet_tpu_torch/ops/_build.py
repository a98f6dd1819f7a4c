"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under ``mxnet_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, named after
the source and the hash of its text, of every header beside it
(``csrc/*.cuh``) and of the flags, in ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``). One source may hold
several kernels' entry points. A library already built for the same hash
is reused; otherwise the first call that needs a kernel builds it, so a
fresh checkout needs nothing but ``nvcc``. ``build()`` starts one
``nvcc`` per source, all together. A failed build raises
:class:`KernelBuildError` with the compiler's output — there is no
fallback.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source file, C entry point, ctypes argtypes)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNELS = {
    "flash_attn_fwd": (
        "flash_attn_fwd.cu", "mxtt_flash_attn_fwd",
        [_P] * 5 + [_I] * 4 + [_L] * 9 + [_F, _I, _I, _P]),
    "flash_split": (
        "flash_attn_fwd.cu", "mxtt_flash_split",
        [_I] + [_P] * 4 + [_L] * 12 + [_P] + [_I] * 4 + [_P]),
    "flash_attn_bwd_dq": (
        "flash_attn_bwd.cu", "mxtt_flash_attn_bwd_dq",
        [_P] * 7 + [_I] * 4 + [_L] * 12 + [_F, _I, _I, _P]),
    "flash_attn_bwd_dkv": (
        "flash_attn_bwd.cu", "mxtt_flash_attn_bwd_dkv",
        [_P] * 8 + [_I] * 4 + [_L] * 12 + [_F, _I, _I, _P]),
    "conv_bwd_filter": (
        "conv_bwd.cu", "mxtt_conv_bwd_filter", [_P] * 6 + [_I] * 16 + [_P]),
    "conv_bwd_input": (
        "conv_bwd.cu", "mxtt_conv_bwd_input", [_P] * 5 + [_I] * 13 + [_P]),
    "conv_channels_last": (
        "conv_bwd.cu", "mxtt_conv_channels_last", [_P, _P] + [_I] * 4 + [_P]),
    "slab_update": (
        "slab_update.cu", "mxtt_slab_update", [_I, _I, _P, _P, _I, _I, _P]),
    "nms": ("nms.cu", "mxtt_nms", [_P] * 4 + [_I] * 3 + [_P]),
}

_lock = threading.Lock()
_loaded = {}


class KernelBuildError(MXNetError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from source at first use")


def library_path(name, csrc=None):
    """Where the library holding kernel ``name`` lives: named after its
    source, keyed on the hash of the source, of every header beside it
    (name and text; a source may include any of them) and of the compiler
    flags, so an edited header never reuses a stale library. ``csrc`` is
    the directory of the sources, ``CSRC`` by default; another one holds
    an edited copy of them (an A/B variant), whose libraries get other
    hashes in the same ``BUILD_DIR``."""
    csrc = CSRC if csrc is None else Path(csrc)
    src = csrc / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("%s-%s.so" % (src.stem, digest.hexdigest()[:16]))


@contextlib.contextmanager
def build_locks(libs):
    """Exclusive file locks on ``<lib>.lock`` for every library path in
    ``libs`` (taken in sorted order, so two builders never deadlock),
    released on exit: the builders of one library, in any process, take
    turns."""
    with contextlib.ExitStack() as stack:
        for lib in sorted(set(libs)):
            f = stack.enter_context(open(str(lib) + ".lock", "a"))
            fcntl.flock(f, fcntl.LOCK_EX)
            stack.callback(fcntl.flock, f, fcntl.LOCK_UN)
        yield


def build(names=None, csrc=None):
    """Build the sources of every named kernel (default: all) that have no
    library for their current hash, one ``nvcc`` per source, all started
    together, under :func:`build_locks`; ``csrc`` as in
    :func:`library_path`. Returns ``{source stem: compiler log}`` for the
    sources built by this call (not those another process built while
    this one waited for the lock)."""
    csrc = CSRC if csrc is None else Path(csrc)
    names = list(KERNELS) if names is None else list(names)
    todo = {}
    for n in names:
        lib = library_path(n, csrc)
        if not lib.is_file():
            todo[csrc / KERNELS[n][0]] = lib
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with build_locks(todo.values()):
        # another process may have built them while this one waited
        todo = {src: lib for src, lib in todo.items() if not lib.is_file()}
        if not todo:
            return {}
        nvcc = nvcc_path()
        procs = {}
        for src, lib in todo.items():
            tmp = lib.with_name("%s.tmp%d" % (lib.name, os.getpid()))
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (tmp, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for name, (tmp, lib, proc) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode, out))
                continue
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)  # atomic: a reader sees all of it or nothing
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name, csrc=None):
    """The ctypes entry point of kernel ``name``, built first if needed;
    ``csrc`` as in :func:`library_path`."""
    key = name if csrc is None else (name, str(csrc))
    fn = _loaded.get(key)
    if fn is not None:
        return fn
    with _lock:
        if key not in _loaded:
            build([name], csrc)
            lib = ctypes.CDLL(str(library_path(name, csrc)))
            _, entry, argtypes = KERNELS[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[key] = fn
        return _loaded[key]
