"""NDArray: the imperative tensor API of the PyTorch port (counterpart of
``mxnet_tpu/ndarray.py``).

An NDArray wraps a ``torch.Tensor`` on one device. Every ``mx.nd.<op>``
is generated from the operator registry (``_make_ndarray_function``) and
runs through :func:`imperative_invoke`: attrs canonicalised as in the JAX
package, the operator's ``fcompute`` run eagerly on the tensors, updated
states (``mutate_inputs``, aux states) and ``out=`` written in place into
the existing tensors, and the call recorded on the autograd tape while
training. In-place mutation (``+=``, ``a[:] =``, ``out=``) writes into the
tensor itself; the JAX package's ``_data`` rebinding and its engine hooks
have no counterpart. Results never alias an input: a view an operator
returns is copied, so an NDArray keeps value semantics, as a jax.Array has.

``save`` / ``load`` keep the dmlc ``.params`` bytes of
``mxnet_tpu/ndarray.py:583-716`` (magic 0x112), so a file crosses packages
both ways. ``asnumpy`` of a bfloat16 array returns float32: numpy has no
bfloat16 where ``ml_dtypes`` is missing.
"""
from __future__ import annotations

import builtins
import struct
import sys

import numpy as np
import torch

from . import autograd as _autograd
from . import random as _random
from .base import MXNetError, bfloat16 as _np_bfloat16, dtype_name, mx_dtype_code, torch_dtype
from .context import Context, as_context
from .ops import registry as _registry
from .ops import (broadcast_reduce, elemwise, indexing, init_ops, matrix, nn,  # noqa: F401
                  optimizer_ops, rnn_op, sample, spatial)

__all__ = ["NDArray", "zeros", "ones", "array", "empty", "full", "arange",
           "concatenate", "load", "save", "imperative_invoke", "waitall"]

# op-namespace generation below shadows some builtins at module scope
# (slice, sum, abs, ...); functions here reach them through ``builtins``.

_NP_OF_TORCH = {
    torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
    torch.uint8: np.uint8, torch.int8: np.int8, torch.int32: np.int32,
    torch.int64: np.int64, torch.bool: np.bool_,
}


def _np_dtype_of(td):
    """numpy type of a torch dtype; bfloat16 is ml_dtypes' where installed,
    else ``torch.bfloat16``."""
    if td == torch.bfloat16:
        return _np_bfloat16 if _np_bfloat16 is not None else torch.bfloat16
    return _NP_OF_TORCH[td]


def _tensor(value, device, dtype=None):
    """A numpy array, list or scalar as a tensor on ``device`` (``dtype``
    a torch dtype; None keeps numpy's)."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=dtype or value.dtype)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _own(t, inputs):
    """``t`` as a contiguous tensor that shares no storage with ``inputs``."""
    ptr = t.untyped_storage().data_ptr()
    if any(torch.is_tensor(x) and x.untyped_storage().data_ptr() == ptr for x in inputs):
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def imperative_invoke(opdef, inputs, attrs, out=None, ctx=None):
    """Invoke an operator imperatively on NDArrays.

    Parity: MXImperativeInvoke (c_api_ndarray.cc:322). An operator with
    NDArray inputs runs on their device; one without (creation, sampling)
    on ``ctx`` or the current context. Autograd recording hooks in where
    RecordImperativeFCompute does (c_api_ndarray.cc:375).
    """
    if isinstance(opdef, str):
        opdef = _registry.get(opdef)
    if attrs:
        opdef.check_call_attrs(attrs)  # typo net (dmlc::Parameter analog)
    attrs = opdef.canon_attrs(attrs)
    is_train = _autograd.is_training()
    recording = _autograd.is_recording()
    nds = [x for x in inputs if isinstance(x, NDArray)]
    device = nds[0]._data.device if nds else as_context(ctx).torch_device
    arrays = [x._data if isinstance(x, NDArray) else _tensor(x, device) for x in inputs]
    run_attrs = dict(attrs)
    if not nds:
        run_attrs["__device__"] = device
    rec_attrs = dict(run_attrs)
    if opdef.needs_rng:
        gen = _random.generator(device)
        if recording:
            rec_attrs["__rng__"] = _random.fork(gen)
        run_attrs["__rng__"] = gen
    with torch.no_grad():
        results = list(opdef.fcompute(run_attrs, arrays, is_train))
    # Trailing results map to reference-mutated inputs: explicit
    # mutate_inputs (sgd_mom_update's momentum) or aux states (BatchNorm's
    # moving_mean/var, which the reference mutates via FMutateInputs).
    n_aux = len(opdef.list_auxiliary_states(attrs))
    n_args = opdef.num_inputs(attrs)
    n_writeback = len(opdef.mutate_inputs) + n_aux
    n_out = len(results) - n_writeback
    outs = results[:n_out]
    writeback_idx = list(opdef.mutate_inputs) + list(range(n_args, n_args + n_aux))
    with torch.no_grad():
        for idx, val in zip(writeback_idx, results[n_out:]):
            if idx < len(inputs) and isinstance(inputs[idx], NDArray):
                inputs[idx]._write(val)
        if out is not None:
            out_list = [out] if isinstance(out, NDArray) else list(out)
            for o, v in zip(out_list, outs):
                o._write(v)
        else:
            out_list = [NDArray(_own(v, arrays)) for v in outs]
    if ctx is not None and out is None and nds:
        ctx = as_context(ctx)
        out_list = [o.as_in_context(ctx) for o in out_list]
    ret = out_list[0] if len(out_list) == 1 else out_list

    if recording:
        # record ALL inputs positionally; non-NDArray inputs keep their
        # converted tensor so backward replay sees the same arity
        recorded = [x if isinstance(x, NDArray) else a for x, a in zip(inputs, arrays)]
        _autograd.record_op(opdef, rec_attrs, recorded, out_list)
    return ret


class NDArray:
    """An n-dimensional array on a device: a ``torch.Tensor`` written in
    place by in-place operators."""

    __slots__ = ("_data",)
    # prefer our operators over numpy's in mixed expressions
    __array_priority__ = 1000.0

    def __init__(self, data):
        self._data = data

    def _write(self, value):
        """Write ``value`` (a tensor of this shape) into this array's tensor."""
        if tuple(value.shape) != tuple(self._data.shape):
            raise MXNetError("cannot write a %s result into an NDArray of shape %s"
                             % (tuple(value.shape), self.shape))
        self._data.copy_(value)

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return _np_dtype_of(self._data.dtype)

    @property
    def context(self):
        return Context(self._data.device)

    ctx = context

    @property
    def T(self):
        return imperative_invoke("transpose", [self], {})

    # -- sync ---------------------------------------------------------------
    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A host copy as a numpy array (bfloat16 as float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        host = t.cpu()
        return host.numpy().copy() if host is t else host.numpy()

    def __array__(self, dtype=None, copy=None):
        """numpy protocol; ``copy=False`` raises, as the JAX package's does:
        a device-backed array cannot promise a zero-copy view."""
        if copy is False:
            raise ValueError(
                "NDArray.__array__: cannot guarantee zero-copy for "
                "device-backed data (np.asarray(nd, copy=False))")
        a = self.asnumpy()
        if dtype is not None and a.dtype != np.dtype(dtype):
            return a.astype(dtype, copy=True)
        return a

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    # -- conversion / movement ---------------------------------------------
    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype), copy=True))

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is self:
                return other
            with torch.no_grad():
                other._write(self._data)
            return other
        if isinstance(other, (Context, torch.device, str)):
            return NDArray(self._data.to(as_context(other).torch_device, copy=True))
        raise MXNetError("copyto: unsupported target %r" % (other,))

    def copy(self):
        return NDArray(self._data.clone())

    def as_in_context(self, context):
        if self.context == as_context(context):
            return self
        return self.copyto(context)

    # -- shape manipulation -------------------------------------------------
    def reshape(self, shape):
        if isinstance(shape, int):
            shape = (shape,)
        return imperative_invoke("Reshape", [self], {"shape": tuple(shape)})

    def broadcast_to(self, shape):
        return imperative_invoke("broadcast_to", [self], {"shape": tuple(shape)})

    # -- indexing -----------------------------------------------------------
    def _key(self, key):
        if isinstance(key, NDArray):
            return key._data.to(torch.int32).long()
        if isinstance(key, builtins.slice) and key.step not in (None, 1):
            raise MXNetError("NDArray only supports step=1 slicing")
        if isinstance(key, (int, np.integer, builtins.slice, tuple)):
            return key
        raise MXNetError("unsupported index %r" % (key,))

    def __getitem__(self, key):
        return NDArray(self._data[self._key(key)].clone())

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not np.isscalar(value):
            value = _tensor(value, self._data.device, self._data.dtype)
        with torch.no_grad():
            self._data[self._key(key)] = value

    def slice(self, start, stop):
        return NDArray(self._data[start:stop].clone())

    def at(self, idx):
        return NDArray(self._data[idx].clone())

    # -- arithmetic ---------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            if a.shape == b.shape:
                return imperative_invoke(op, [a, b], {})
            return imperative_invoke("broadcast_" + _BCAST_NAME[op], [a, b], {})
        if np.isscalar(other):
            name = ("_r" + scalar_op[1:]) if reverse and op in _NONCOMMUTATIVE else scalar_op
            return imperative_invoke(name, [self], {"scalar": float(other)})
        if isinstance(other, np.ndarray):
            return self._binop(array(other, ctx=self.context, dtype=self.dtype), op, scalar_op,
                               reverse)
        if torch.is_tensor(other):
            return self._binop(NDArray(other), op, scalar_op, reverse)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __div__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    __truediv__ = __div__

    def __rdiv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar", reverse=True)

    __rtruediv__ = __rdiv__

    def __pow__(self, o):
        return self._binop(o, "_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binop(o, "_power", "_power_scalar", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binop(o, "_mod", "_mod_scalar", reverse=True)

    def __neg__(self):
        return imperative_invoke("negative", [self], {})

    def __eq__(self, o):
        if isinstance(o, (NDArray, int, float, np.ndarray)):
            return self._binop(o, "_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (NDArray, int, float, np.ndarray)):
            return self._binop(o, "_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, o):
        return self._binop(o, "_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, result):
        with torch.no_grad():
            self._write(result._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __idiv__(self, o):
        return self._inplace(self.__div__(o))

    __itruediv__ = __idiv__

    def __len__(self):
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(builtins.map(str, self.shape)), self.context)

    def __getstate__(self):
        return {"data": self.asnumpy(), "dtype": dtype_name(self._data.dtype)}

    def __setstate__(self, state):
        self._data = _tensor(state["data"], "cpu", torch_dtype(state.get("dtype")))


_BCAST_NAME = {
    "elemwise_add": "add",
    "elemwise_sub": "sub",
    "elemwise_mul": "mul",
    "elemwise_div": "div",
    "_power": "power",
    "_mod": "mod",
    "_equal": "equal",
    "_not_equal": "not_equal",
    "_greater": "greater",
    "_greater_equal": "greater_equal",
    "_lesser": "lesser",
    "_lesser_equal": "lesser_equal",
}
_NONCOMMUTATIVE = {"elemwise_sub", "elemwise_div", "_power", "_mod"}


# --------------------------------------------------------------------------
# creation API
# --------------------------------------------------------------------------
def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def empty(shape, ctx=None, dtype=np.float32):
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=np.float32):
    return full(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype=np.float32):
    return full(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype=np.float32):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=as_context(ctx).torch_device))


def array(source_array, ctx=None, dtype=None):
    """An NDArray of ``source_array`` (numpy, list, NDArray) on ``ctx``;
    float64 sources become float32 unless ``dtype`` says otherwise."""
    device = as_context(ctx).torch_device
    if isinstance(source_array, NDArray):
        t = source_array._data
        return NDArray(t.to(device=device, dtype=torch_dtype(dtype) if dtype else t.dtype,
                            copy=True))
    arr = np.asarray(source_array)
    if dtype is None:
        dtype = arr.dtype if arr.dtype != np.float64 else np.float32
    return NDArray(_tensor(arr, device, torch_dtype(dtype)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=np.float32):
    if stop is None:
        start, stop = 0, start
    out = np.arange(start, stop, step)
    if repeat > 1:
        out = np.repeat(out, repeat)
    return NDArray(_tensor(out, as_context(ctx).torch_device, torch_dtype(dtype)))


def concatenate(arrays, axis=0, always_copy=True):
    return NDArray(torch.cat([a._data for a in arrays], dim=axis))


def onehot_encode(indices, out):
    depth = out.shape[1]
    return imperative_invoke("one_hot", [indices], {"depth": depth}, out=out)


def waitall():
    """Parity: MXNDArrayWaitAll — barrier on all queued device work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# --------------------------------------------------------------------------
# serialization — the dmlc .params bytes of the JAX package (reference
# src/ndarray/ndarray.cc:604-689). Container layout (all little-endian):
#   uint64 magic=0x112, uint64 reserved=0
#   uint64 n_arrays, then per array (NDArray::Save):
#     uint32 ndim, ndim x uint32 dims          (mshadow TShape::Save)
#     int32 dev_type, int32 dev_id             (Context::Save; written 1,0)
#     int32 type_flag                          (mshadow dtype code)
#     raw contiguous data
#   uint64 n_names, then per name: uint64 len + bytes
# The JAX package's older MXTPU001 container is read too.
# --------------------------------------------------------------------------
_DMLC_MAGIC = 0x112
_LEGACY_MAGIC = b"MXTPU001"


def save(fname, data):
    with open(fname, "wb") as f:
        _save_fileobj(f, data)


def save_buffer(data):
    """Serialize NDArrays to bytes (the c_predict param-bytes format)."""
    import io

    f = io.BytesIO()
    _save_fileobj(f, data)
    return f.getvalue()


def _raw_bytes(t):
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _save_fileobj(f, data):
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    f.write(struct.pack("<QQ", _DMLC_MAGIC, 0))
    f.write(struct.pack("<Q", len(arrays)))
    for a in arrays:
        t = a._data
        if t.dim() == 0:
            # reference TShape cannot express 0-d (ndim 0 means "none")
            raise MXNetError(
                "cannot save 0-d NDArray in the .params format; "
                "reshape to (1,) first")
        code = mx_dtype_code(t.dtype)
        if code > 6:
            import warnings

            warnings.warn(
                "saving dtype %s with extension code %d: this .params "
                "file will not load in reference MXNet (cast to float32 "
                "first for cross-compatibility)" % (dtype_name(t.dtype), code),
                stacklevel=3)
        f.write(struct.pack("<I", t.dim()))
        f.write(struct.pack("<%dI" % t.dim(), *t.shape))
        f.write(struct.pack("<ii", 1, 0))  # Context: cpu(0)
        f.write(struct.pack("<i", code))
        f.write(_raw_bytes(t))
    f.write(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        f.write(struct.pack("<Q", len(b)))
        f.write(b)


def load(fname):
    """NDArrays from a .params file, on the current context."""
    with open(fname, "rb") as f:
        return _load_fileobj(f, fname)


def load_buffer(buf):
    """Deserialize NDArrays from an in-memory bytes buffer (parity: the
    c_predict_api path, MXNDListCreate over param bytes)."""
    import io

    return _load_fileobj(io.BytesIO(buf), "<buffer>")


def _load_fileobj(f, fname):
    head = f.read(8)
    if head == _LEGACY_MAGIC:
        return _load_legacy(f, fname)
    if len(head) < 8 or struct.unpack("<Q", head)[0] != _DMLC_MAGIC:
        raise MXNetError("invalid NDArray file %s" % fname)
    f.read(8)  # reserved
    return _load_dmlc(f, fname)


def _from_bytes(raw, code, shape, fname):
    """An NDArray of dtype ``code`` and ``shape`` from its raw bytes."""
    if code == 12:
        t = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(torch.bfloat16)
        return NDArray(t.reshape(shape).to(as_context(None).torch_device))
    dt = np.dtype(_np_of_code(code, fname))
    return array(np.frombuffer(raw, dtype=dt).reshape(shape), dtype=dt)


def _load_dmlc(f, fname):
    (n_arr,) = struct.unpack("<Q", f.read(8))
    arrays = []
    for _ in range(n_arr):
        (ndim,) = struct.unpack("<I", f.read(4))
        if ndim == 0:
            raise MXNetError("%s: empty (none) NDArray entry" % fname)
        shape = struct.unpack("<%dI" % ndim, f.read(4 * ndim))
        f.read(8)  # Context (dev_type, dev_id): arrays land on the current context
        (code,) = struct.unpack("<i", f.read(4))
        size = 2 if code == 12 else np.dtype(_np_of_code(code, fname)).itemsize
        arrays.append(_from_bytes(f.read(int(np.prod(shape)) * size), code, shape, fname))
    (n_names,) = struct.unpack("<Q", f.read(8))
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<Q", f.read(8))
        names.append(f.read(ln).decode())
    if names:
        return dict(zip(names, arrays))
    return arrays


def _np_of_code(code, fname):
    from .base import _DTYPE_MX_TO_NP

    if code not in _DTYPE_MX_TO_NP:
        raise MXNetError("%s: unknown dtype code %d" % (fname, code))
    return _DTYPE_MX_TO_NP[code]


def _load_legacy(f, fname):
    """The JAX package's MXTPU001 container (magic already consumed)."""
    n_arr, n_names = struct.unpack("<qq", f.read(16))
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<q", f.read(8))
        names.append(f.read(ln).decode())
    arrays = []
    for _ in range(n_arr):
        (code,) = struct.unpack("<q", f.read(8))
        (ndim,) = struct.unpack("<q", f.read(8))
        shape = struct.unpack("<%dq" % ndim, f.read(8 * ndim)) if ndim else ()
        size = 2 if code == 12 else np.dtype(_np_of_code(code, fname)).itemsize
        count = int(np.prod(shape)) if shape else 1
        arrays.append(_from_bytes(f.read(count * size), code, shape, fname))
    if names:
        return dict(zip(names, arrays))
    return arrays


# --------------------------------------------------------------------------
# op namespace generation — parity with _init_ndarray_module
# (reference ndarray.py:917): every registered op becomes a module function.
# --------------------------------------------------------------------------
def _make_ndarray_function(opdef):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        inputs = []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and builtins.all(
                isinstance(x, NDArray) for x in a
            ):
                inputs.extend(a)
            else:
                inputs.append(a)
        return imperative_invoke(opdef, inputs, kwargs, out=out, ctx=ctx)

    fn.__name__ = opdef.name
    fn.__doc__ = opdef.docstring()
    return fn


def _init_ndarray_module():
    module = sys.modules[__name__]
    for name, opdef in list(_registry._REGISTRY.items()):
        if not hasattr(module, name):
            setattr(module, name, _make_ndarray_function(opdef))


_SAMPLER_ARGS = {
    "_sample_uniform": ("low", "high"),
    "_sample_normal": ("loc", "scale"),
    "_sample_gamma": ("alpha", "beta"),
    "_sample_exponential": ("lam",),
    "_sample_poisson": ("lam",),
    "_sample_negbinomial": ("k", "p"),
    "_sample_gennegbinomial": ("mu", "alpha"),
}


def _init_random_module():
    """Expose samplers as mx.random.uniform/normal/... (reference random.py)."""
    rnd = sys.modules[_random.__name__]

    def make(op):
        def fn(*args, **kwargs):
            # reference signature: uniform(low, high, shape, ctx, dtype)
            names = _SAMPLER_ARGS[op]
            for n, v in zip(names, args):
                kwargs.setdefault(n, v)
            rest = args[len(names):]
            if rest:
                kwargs.setdefault("shape", rest[0])
            if len(rest) > 1:
                kwargs.setdefault("ctx", rest[1])
            ctx = kwargs.pop("ctx", None)
            out = kwargs.pop("out", None)
            if out is not None:
                kwargs.setdefault("shape", out.shape)
                ctx = ctx or out.context
            kwargs.setdefault("shape", (1,))
            return imperative_invoke(_registry.get(op), [], kwargs, out=out, ctx=ctx)

        fn.__name__ = op
        return fn

    rnd.uniform = make("_sample_uniform")
    rnd.normal = make("_sample_normal")
    rnd.gamma = make("_sample_gamma")
    rnd.exponential = make("_sample_exponential")
    rnd.poisson = make("_sample_poisson")
    rnd.negative_binomial = make("_sample_negbinomial")
    rnd.generalized_negative_binomial = make("_sample_gennegbinomial")


_init_ndarray_module()
_init_random_module()


def imdecode(buf, index=0, flag=1, mean=None, clip_rect=None, out=None, **kwargs):
    """Decode an encoded image buffer to an HWC float32 NDArray on the
    current context (the reference's NDArray function, src/io/image_io.cc):
    ``flag`` 0 for one gray channel, ``clip_rect`` (x0, y0, x1, y1) crops,
    ``mean`` is subtracted, ``out`` receives the result. Decoding runs on
    the host (``image.imdecode``); unknown options raise."""
    if kwargs:
        raise MXNetError("imdecode: unsupported option(s) %s" % sorted(kwargs))
    from . import image as _image
    from .context import cpu

    with cpu():
        img = _image.imdecode(buf, flag=flag)._data
    if clip_rect is not None:
        x0, y0, x1, y1 = (int(v) for v in clip_rect)
        img = img[y0:y1, x0:x1]
    if mean is not None:
        mean_t = mean._data.cpu() if isinstance(mean, NDArray) else torch.as_tensor(
            np.asarray(mean, np.float32))
        img = img.to(torch.float32) - mean_t
    res = NDArray(img.contiguous().to(Context.current_context().torch_device))
    if out is not None:
        out[:] = res
        return out
    return res
