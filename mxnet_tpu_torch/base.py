"""Core shared definitions of the PyTorch port (counterpart of
``mxnet_tpu/base.py``): the framework's error type and version, the dtype
registry and the string form of operator attributes used by symbols and
their graph JSON."""
from __future__ import annotations

import ast
import contextlib
import gc
import os

import numpy as np
import torch

__version__ = "0.9.5"


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: reference ``base.py:MXNetError``)."""


def release_for_capture(device):
    """Before a CUDA graph capture: finish the device's work, collect
    Python's cyclic garbage (a fused Module refers to itself, so an older
    graph can wait there) and empty the allocator's cache, as the capture
    does first; the memory reserved next is the capture pool's baseline."""
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def graph_capture(graph, **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with Python's cyclic collector
    held off: a collection inside a capture that destroys an older graph
    makes a call the capture forbids and invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        if enabled:
            gc.enable()


_DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


def bucket_bytes_env():
    """MXTPU_BUCKET_BYTES: the size cap of one flat update bucket, as the
    JAX package reads it (``mxnet_tpu/base.py:144``). Missing, empty or
    garbage: 4 MiB; negative clamps to 0 (0 turns the flat update off and
    the per-parameter update on)."""
    raw = os.environ.get("MXTPU_BUCKET_BYTES")
    if raw is None or raw == "":
        return _DEFAULT_BUCKET_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        return _DEFAULT_BUCKET_BYTES


# ---------------------------------------------------------------------------
# dtype registry: the integer codes of mshadow's TypeFlag, as in the JAX
# package, so serialized params and graph JSON agree.
# ---------------------------------------------------------------------------
_DTYPE_NP_TO_MX = {
    np.float32: 0,
    np.float64: 1,
    np.float16: 2,
    np.uint8: 3,
    np.int32: 4,
    np.int8: 5,
    np.int64: 6,
}
try:  # numpy has no bfloat16 of its own; ml_dtypes provides one where installed
    import ml_dtypes

    _DTYPE_NP_TO_MX[ml_dtypes.bfloat16] = 12
    bfloat16 = ml_dtypes.bfloat16
except ImportError:  # pragma: no cover
    bfloat16 = None

_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}

_DTYPE_NAMES = {
    "float32": np.float32,
    "float64": np.float64,
    "float16": np.float16,
    "uint8": np.uint8,
    "int32": np.int32,
    "int8": np.int8,
    "int64": np.int64,
}
if bfloat16 is not None:
    _DTYPE_NAMES["bfloat16"] = bfloat16


def np_dtype(dtype):
    """Normalize any dtype spec (np dtype, type, string, mx code) to a numpy type."""
    if dtype is None:
        return np.float32
    if isinstance(dtype, (int, np.integer)) and not isinstance(dtype, bool):
        return _DTYPE_MX_TO_NP[int(dtype)]
    if isinstance(dtype, str):
        if dtype not in _DTYPE_NAMES:
            raise MXNetError("unknown dtype name %s" % dtype)
        return _DTYPE_NAMES[dtype]
    d = np.dtype(dtype)
    for k in _DTYPE_NP_TO_MX:
        if np.dtype(k) == d:
            return k
    raise MXNetError("unsupported dtype %s" % dtype)


def dtype_name(dtype) -> str:
    """The dtype's name; also takes a torch dtype, and "bfloat16" where
    numpy has no bfloat16."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    if isinstance(dtype, (int, np.integer)) and int(dtype) == 12:
        return "bfloat16"
    return np.dtype(np_dtype(dtype)).name


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "uint8": torch.uint8, "int8": torch.int8,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype):
    """Any dtype spec (numpy type, name, mshadow code, torch dtype) as a torch
    dtype; ``None`` means float32."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bool":
        return torch.bool
    if dtype is not None and not isinstance(dtype, (int, np.integer, str)) \
            and np.dtype(dtype) == np.bool_:
        return torch.bool
    return _TORCH_DTYPES[dtype_name(dtype)]


def mx_dtype_code(dtype) -> int:
    """The mshadow TypeFlag of a dtype (12 for bfloat16, the TPU-era
    extension code the JAX package writes)."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        return 12
    return _DTYPE_NP_TO_MX[np_dtype(name)]


# ---------------------------------------------------------------------------
# attribute strings: Symbol attrs and graph JSON keep every parameter as a
# string (the reference's dmlc::Parameter wire format).
# ---------------------------------------------------------------------------
def parse_attr_value(value):
    """Parse a string attr ('(2,2)', 'True', '0.9', 'relu') into a Python value."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    if s in ("None", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def attr_repr(value) -> str:
    """Inverse of :func:`parse_attr_value` — stringify for graph JSON."""
    if isinstance(value, bool):
        return "True" if value else "False"
    if value is None:
        return "None"
    if isinstance(value, (list, tuple)):
        if len(value) == 1:  # "(100,)" — "(100)" would parse back as int
            return "(" + attr_repr(value[0]) + ",)"
        return "(" + ", ".join(attr_repr(v) for v in value) + ")"
    return str(value)
