"""Standalone inference — ``c_predict_api`` parity and the serving pool
(counterpart of ``mxnet_tpu/predict.py``).

Parity: reference ``src/c_api/c_predict_api.cc`` /
``include/mxnet/c_predict_api.h:59-140``: a self-contained predictor —
``MXPredCreate(symbol_json, param_bytes, dev, input_shapes)`` →
``MXPredSetInput`` → ``MXPredForward`` → ``MXPredGetOutput``.

``Predictor`` keeps every bound executor in an LRU pool keyed on the
input-shape signature (``reshape()`` to a shape seen before is a dict
lookup), and all executors share one set of parameter tensors through
``shared_exec`` binding. ``compile()`` prepares the serving fast path per
bucket up front. Where the JAX package AOT-compiles one XLA executable a
bucket, here a bucket on the card is one captured ``torch.cuda.CUDAGraph``
of the bucket executor's ``_GraphProgram``: static input tensors, one
eager warm-up run (a second under ``torch.cuda.set_sync_debug_mode
("error")``, so an op that reads a host value is named), then the capture;
all graphs of a Predictor share one memory pool. A ``predict_batch`` copies
the numpy inputs into the static tensors through pinned memory, replays,
and copies the outputs to the host once. There is no eager fallback on
the card: a capture that fails raises ``MXNetError`` naming the bucket. On
the CPU the same program runs eagerly, because the caller chose that
device. Every dispatch notes its signature (``note_signature``), so the
anatomy recompile detector audits the steady state: a bucket that
``predict_batch`` meets first is captured on the spot and counts as a
plan miss.

The amalgamation analog is ``export_bundle``/``load_bundle``: one file
that holds symbol JSON + params with per-section and per-tensor CRC32s,
byte-compatible with the JAX package's bundles in both directions.

Deliberate difference: ``Predictor(ctx=None)`` runs on ``gpu(0)`` (the
JAX package's default is ``cpu()``) and raises without a card.

Env knobs: ``MXTPU_SERVE_EXEC_CACHE`` (LRU capacity, default 8),
``MXTPU_SERVE_QUANT=int8`` (experimental weight quantization,
serving/quant.py).
"""
from __future__ import annotations

import collections
import json
import os
import struct
import threading
import time
import zlib

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as sym_mod
from . import telemetry as _tm
from . import operator as _operator
from .base import MXNetError, graph_capture, release_for_capture
from .context import as_context, cpu, gpu

_H_DISPATCH_SECONDS = _tm.histogram(
    "predict.dispatch_seconds",
    "wall time per predict_batch dispatch (inputs in, outputs on the host)")
_C_EXEC_EVICTIONS = _tm.counter(
    "predict.exec_evictions",
    "executors dropped from the shape-signature LRU pool")


def _exec_cache_cap():
    try:
        return max(1, int(os.environ.get("MXTPU_SERVE_EXEC_CACHE", "8")))
    except ValueError:
        return 8


def _shape_key(input_shapes):
    return tuple(sorted(
        (name, tuple(int(d) for d in shape))
        for name, shape in input_shapes.items()))


def _host_params(raw):
    """``nd.load_buffer`` of param bytes, on the host whatever the current
    context (the predictor copies them into its executors)."""
    with cpu():
        return nd.load_buffer(bytes(raw))


class Predictor(object):
    """``MXPredCreate`` equivalent.

    Parameters
    ----------
    symbol_json : str — symbol graph JSON (``Symbol.tojson()``)
    param_raw : bytes | dict — serialized params (``nd.save`` format with
        ``arg:``/``aux:`` prefixed names, as ``save_checkpoint`` writes)
        or an already-loaded {name: NDArray} dict
    input_shapes : dict of name → shape
    ctx : Context (default gpu(0); raises without a card)
    quant : None | "int8" — weight quantization mode (default: the
        MXTPU_SERVE_QUANT env var). "int8" stores dense/conv weights as
        int8 + per-output-channel scales and dequantizes at bind
        (serving/quant.py, experimental).
    """

    def __init__(self, symbol_json, param_raw, input_shapes, ctx=None,
                 quant=None):
        self.symbol = sym_mod.load_json(symbol_json)
        ctx = as_context(ctx) if ctx is not None else gpu(0)
        ctx.torch_device  # noqa: B018  (raises for a card that is not there)
        if isinstance(param_raw, (bytes, bytearray)):
            loaded = _host_params(param_raw)
        else:
            loaded = param_raw
        if not isinstance(loaded, dict):
            raise MXNetError(
                "Predictor needs NAMED params (a dict serialized by "
                "nd.save / save_checkpoint); got an unnamed list")
        arg_params, aux_params = {}, {}
        for k, v in loaded.items():
            if k.startswith("arg:"):
                arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k] = v
        self._ctx = ctx
        self._input_shapes = dict(input_shapes)
        self._arg_params = arg_params
        self._aux_params = aux_params
        self.quant = quant if quant is not None else os.environ.get(
            "MXTPU_SERVE_QUANT", "")
        if self.quant not in ("", "int8"):
            raise MXNetError(
                "unsupported MXTPU_SERVE_QUANT mode %r (only int8)"
                % self.quant)
        if self.quant == "int8":
            from .serving import quant as _quant

            self._arg_params = _quant.quantize_arg_params(self._arg_params)
        # LRU pool: shape signature -> bound Executor; all entries share
        # parameter tensors with the first-ever bind (_shared_exec)
        self._exec_cache = collections.OrderedDict()
        self._serve_cache = {}  # shape signature -> _ServeFn
        self._shared_exec = None
        self._exec = None
        # one capture or replay at a time: the graphs share one memory pool
        # and a capture must not meet other work of this predictor
        self._lock = threading.RLock()
        self._pool = None  # the graphs' memory pool, made at the first capture
        self._bind()

    # -- executor pool -------------------------------------------------
    def _bind(self):
        self._exec = self._executor_for(_shape_key(self._input_shapes),
                                        self._input_shapes)

    def _executor_for(self, key, input_shapes):
        exec_ = self._exec_cache.get(key)
        if exec_ is not None:
            self._exec_cache.move_to_end(key)
            return exec_
        exec_ = self.symbol.simple_bind(
            ctx=self._ctx, grad_req="null", shared_exec=self._shared_exec,
            **input_shapes)
        self._load_params_into(exec_)
        if self._shared_exec is None:
            self._shared_exec = exec_
        self._exec_cache[key] = exec_
        cap = _exec_cache_cap()
        while len(self._exec_cache) > cap:
            old_key, _ = self._exec_cache.popitem(last=False)
            self._serve_cache.pop(old_key, None)  # its graph goes with it
            _C_EXEC_EVICTIONS.inc()
        return exec_

    def _dequant(self, name, arr):
        if self.quant == "int8":
            from .serving import quant as _quant

            return _quant.maybe_dequantize(arr)
        return arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)

    def _load_params_into(self, exec_):
        # `[:] =` writes into the shared tensors in place: graphs captured
        # before read the same storage
        for name, arr in self._arg_params.items():
            if name in exec_.arg_dict:
                data = self._dequant(name, arr)
                if tuple(exec_.arg_dict[name].shape) != tuple(data.shape):
                    raise MXNetError(
                        "param %s shape mismatch %s vs %s"
                        % (name, tuple(data.shape),
                           tuple(exec_.arg_dict[name].shape)))
                exec_.arg_dict[name][:] = data
        for name, arr in self._aux_params.items():
            if name in exec_.aux_dict:
                exec_.aux_dict[name][:] = (
                    arr.asnumpy() if hasattr(arr, "asnumpy")
                    else np.asarray(arr))

    # -- c_predict_api surface ----------------------------------------
    def set_input(self, name, data):
        """``MXPredSetInput``."""
        if name not in self._input_shapes:
            raise MXNetError("unknown input %s" % name)
        data = np.asarray(data)
        want = tuple(self._exec.arg_dict[name].shape)
        if tuple(data.shape) != want:
            raise MXNetError(
                "input %s shape %s does not match bound shape %s"
                % (name, tuple(data.shape), want))
        self._exec.arg_dict[name][:] = data

    def forward(self):
        """``MXPredForward``."""
        with self._lock:
            self._exec.forward(is_train=False)

    def get_output(self, index=0):
        """``MXPredGetOutput`` → numpy."""
        return self._exec.outputs[index].asnumpy()

    def reshape(self, new_input_shapes):
        """``MXPredReshape``: switch to new input shapes, keeping the
        weights. Previously-seen shape signatures reuse their executor from
        the LRU pool (the reference rebinds every time)."""
        self._input_shapes.update(new_input_shapes)
        self._bind()

    def predict(self, **inputs):
        """Convenience: set all inputs, forward, return all outputs."""
        for name, data in inputs.items():
            self.set_input(name, data)
        self.forward()
        return [o.asnumpy() for o in self._exec.outputs]

    # -- serving fast path ---------------------------------------------
    def compile(self, input_shapes_list=None):
        """Prepare the serving fast path for each shape bucket up front
        (default: the currently-bound shapes): on the card, warm up and
        capture one CUDA graph a bucket. After this, ``predict_batch`` for
        any compiled bucket is one graph replay."""
        if input_shapes_list is None:
            input_shapes_list = [dict(self._input_shapes)]
        with self._lock:
            for shapes in input_shapes_list:
                merged = dict(self._input_shapes)
                merged.update(shapes)
                key = _shape_key(merged)
                if key in self._serve_cache:
                    continue
                exec_ = self._executor_for(key, merged)
                if self._pool is None and exec_._ctx.device_type == "gpu":
                    self._pool = torch.cuda.graph_pool_handle()
                self._serve_cache[key] = _ServeFn(exec_, merged, self._pool)
        return self

    def predict_batch(self, **inputs):
        """Serving dispatch: route the named input arrays through the
        bucket of their exact shape signature, compiling (on the card,
        capturing) it on first sight. Returns a list of numpy outputs.
        Every call notes its signature so the recompile detector audits
        the steady state."""
        merged = dict(self._input_shapes)
        for name, data in inputs.items():
            if name not in self._input_shapes:
                raise MXNetError("unknown input %s" % name)
            merged[name] = tuple(np.asarray(data).shape)
        key = _shape_key(merged)
        with self._lock:
            fn = self._serve_cache.get(key)
            if fn is None:
                self.compile([merged])
                fn = self._serve_cache[key]
            return fn(inputs)

    @property
    def cached_shape_keys(self):
        """Shape signatures currently resident in the executor pool."""
        return list(self._exec_cache)


class _ServeFn(object):
    """The forward of one input-shape bucket: the bucket executor's program
    over its parameter tensors, on static input tensors; on the card one
    captured CUDA graph, on the CPU the program run eagerly.

    ``stats`` holds the capture's ms and the bytes it took from the pool."""

    def __init__(self, exec_, input_shapes, pool=None):
        self._exec = exec_
        self._program = program = exec_._program
        self._data_names = data_names = tuple(sorted(input_shapes))
        self._output_names = list(exec_._output_names)
        self._device = device = exec_._ctx.torch_device
        const_args = {
            name: arr._data
            for name, arr in zip(exec_._arg_names, exec_.arg_arrays)
            if name not in input_shapes
        }
        aux_vals = {n: a._data for n, a in zip(exec_._aux_names, exec_.aux_arrays)}
        self._rng = None
        if program.needs_rng:
            self._rng = torch.Generator(device=device)
            self._rng.manual_seed(0)
        self._shapes = [tuple(int(d) for d in input_shapes[n]) for n in data_names]
        self._dtypes = [exec_.arg_dict[n]._data.dtype for n in data_names]
        self._static = [torch.zeros(s, dtype=dt, device=device)
                        for s, dt in zip(self._shapes, self._dtypes)]
        self._pinned = None
        rng = self._rng

        def serve():
            args = dict(const_args)
            args.update(zip(data_names, self._static))
            with torch.no_grad():
                outs, _ = program(args, aux_vals, rng, False)
            return outs

        self._serve = serve
        self._sig = tuple(
            (n, s, str(dt).replace("torch.", ""), "serve")
            for n, s, dt in zip(data_names, self._shapes, self._dtypes))
        program.note_signature(self._sig)
        self._graph = None
        self._outs = None
        self.stats = {}
        if device.type == "cuda":
            self._capture(pool)


    def _capture(self, pool):
        """Warm up, then capture the program into one CUDA graph (refused for
        a graph that holds a Custom or ROIPooling node)."""
        dev = self._device
        what = "bucket %s" % (self._sig,)
        _operator.refuse_capture(self._program, "the forward of %s" % what)
        self._serve()  # lazy set-up: library handles, algorithm choices
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            self._serve()
        except RuntimeError as exc:
            if "synchronizing CUDA operation" not in str(exc):
                raise
            raise MXNetError("the forward of %s waited for the device (a host read), which a "
                             "CUDA graph cannot capture: %s" % (what, exc)) from exc
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        release_for_capture(dev)  # the delta from here is the graph's
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if self._rng is not None:
            graph.register_generator_state(self._rng)
        t0 = time.perf_counter()
        try:
            with graph_capture(graph, pool=pool):
                outs = self._serve()
        except Exception as exc:
            raise MXNetError("capturing the forward of %s into a CUDA graph failed: %s"
                             % (what, exc)) from exc
        torch.cuda.synchronize(dev)
        self.stats = {"capture_ms": 1e3 * (time.perf_counter() - t0),
                      "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}
        self._graph, self._outs = graph, outs
        self._pinned = [torch.empty(s, dtype=dt, pin_memory=True)
                        for s, dt in zip(self._shapes, self._dtypes)]
        self._out_pinned = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                            for o in outs]

    def __call__(self, inputs):
        self._program.note_signature(self._sig)
        host = []
        for name, shape in zip(self._data_names, self._shapes):
            data = np.asarray(inputs[name])
            if tuple(data.shape) != shape:
                raise MXNetError(
                    "input %s shape %s does not match compiled bucket %s"
                    % (name, tuple(data.shape), shape))
            host.append(torch.from_numpy(np.ascontiguousarray(data)))
        t0 = time.perf_counter()
        if self._graph is None:
            for static, h in zip(self._static, host):
                static.copy_(h)
            outs = [o.numpy().copy() if o.dtype != torch.bfloat16
                    else o.float().numpy() for o in self._serve()]
        else:
            for static, pinned, h in zip(self._static, self._pinned, host):
                pinned.copy_(h)
                static.copy_(pinned, non_blocking=True)
            self._graph.replay()
            for o, pinned in zip(self._outs, self._out_pinned):
                pinned.copy_(o, non_blocking=True)
            torch.cuda.current_stream(self._device).synchronize()
            outs = [p.float().numpy() if p.dtype == torch.bfloat16 else p.numpy().copy()
                    for p in self._out_pinned]
        _H_DISPATCH_SECONDS.observe(time.perf_counter() - t0)
        return outs


# --------------------------------------------------------------------------
# amalgamation analog: single-file inference bundle
# --------------------------------------------------------------------------

_BUNDLE_MAGIC_V1 = b"MXTPUPRED1"
_BUNDLE_MAGIC = b"MXTPUPRED2"


def _tensor_crcs(save_dict):
    return {
        name: zlib.crc32(np.ascontiguousarray(arr.asnumpy()).tobytes())
        for name, arr in save_dict.items()
    }


def export_bundle(fname, symbol, arg_params, aux_params=None):
    """Write symbol JSON + params as ONE file (the role the reference's
    amalgamation plays: a self-contained deployable predict artifact).
    The v2 header carries a manifest with per-section and per-tensor
    CRC32s, so corruption is caught at load, not at first NaN. The bytes
    are the JAX package's for the same symbol and params."""
    js = symbol.tojson().encode()
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    if aux_params:
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_bytes = nd.save_buffer(save_dict)
    manifest = json.dumps({
        "version": 2,
        "symbol": {"bytes": len(js), "crc32": zlib.crc32(js)},
        "params": {"bytes": len(param_bytes),
                   "crc32": zlib.crc32(param_bytes)},
        "tensors": _tensor_crcs(save_dict),
    }).encode()
    with open(fname, "wb") as f:
        f.write(_BUNDLE_MAGIC)
        f.write(struct.pack("<qqq", len(manifest), len(js),
                            len(param_bytes)))
        f.write(manifest)
        f.write(js)
        f.write(param_bytes)


def _verify_bundle_params(fname, manifest, param_bytes):
    """Per-tensor CRC verification: decode the param dict and check each
    tensor against the manifest so a corrupt bundle names the exact
    tensor."""
    loaded = _host_params(param_bytes)
    want = manifest.get("tensors", {})
    for name, arr in loaded.items():
        if name not in want:
            raise MXNetError(
                "bundle %s: tensor %s missing from manifest (corrupt or "
                "tampered)" % (fname, name))
        got = zlib.crc32(np.ascontiguousarray(arr.asnumpy()).tobytes())
        if got != want[name]:
            raise MXNetError(
                "bundle %s: tensor %s fails CRC32 (corrupt)"
                % (fname, name))
    missing = set(want) - set(loaded)
    if missing:
        raise MXNetError(
            "bundle %s: tensors %s listed in manifest but absent"
            % (fname, sorted(missing)))
    return loaded


def load_bundle(fname, input_shapes, ctx=None, quant=None):
    """Load an ``export_bundle`` file (of either package) into a ready
    Predictor. v2 bundles are CRC-verified section by section and tensor
    by tensor; any mismatch raises naming the file and the tensor. v1
    bundles (no manifest) still load."""
    with open(fname, "rb") as f:
        magic = f.read(len(_BUNDLE_MAGIC))
        if magic == _BUNDLE_MAGIC_V1:
            js_len, p_len = struct.unpack("<qq", f.read(16))
            js = f.read(js_len).decode()
            param_bytes = f.read(p_len)
            return Predictor(js, param_bytes, input_shapes, ctx=ctx,
                             quant=quant)
        if magic != _BUNDLE_MAGIC:
            raise MXNetError("%s is not a predictor bundle" % fname)
        m_len, js_len, p_len = struct.unpack("<qqq", f.read(24))
        manifest_raw = f.read(m_len)
        js_raw = f.read(js_len)
        param_bytes = f.read(p_len)
    try:
        manifest = json.loads(manifest_raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise MXNetError(
            "bundle %s: manifest section unreadable (corrupt header)"
            % fname)
    if len(js_raw) != manifest["symbol"]["bytes"] or \
            zlib.crc32(js_raw) != manifest["symbol"]["crc32"]:
        raise MXNetError(
            "bundle %s: symbol section fails CRC32 (corrupt)" % fname)
    if len(param_bytes) != manifest["params"]["bytes"] or \
            zlib.crc32(param_bytes) != manifest["params"]["crc32"]:
        # locate the guilty tensor for the error message before failing
        try:
            _verify_bundle_params(fname, manifest, param_bytes)
        except MXNetError:
            raise
        except Exception:
            pass  # params not even decodable — use the section error
        raise MXNetError(
            "bundle %s: params section fails CRC32 (corrupt)" % fname)
    loaded = _verify_bundle_params(fname, manifest, param_bytes)
    return Predictor(js_raw.decode(), loaded, input_shapes, ctx=ctx,
                     quant=quant)


def params_from_checkpoint(ckpt_dir):
    """``{arg:.../aux:...}`` f32 NDArrays on the host from a resilience
    checkpoint directory of either package, through its MANIFEST/CRC
    verification (the deep per-tensor check): the f32-master (AMP) path
    from training to serving. Corruption raises ``CheckpointError`` naming
    the file and tensor."""
    from .resilience import checkpoint as ckpt

    ckpt.verify_checkpoint(ckpt_dir, deep=True)
    state = ckpt.load_state(ckpt_dir, verify=False)
    params = {}
    host = cpu()
    for name, arr in state["module"]["arg"].items():
        params["arg:%s" % name] = nd.array(np.asarray(arr, np.float32), ctx=host)
    for name, arr in state["module"]["aux"].items():
        params["aux:%s" % name] = nd.array(np.asarray(arr, np.float32), ctx=host)
    return params
