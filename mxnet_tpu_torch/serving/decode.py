"""Slot-based continuous batching for KV-cached autoregressive decode
(counterpart of ``mxnet_tpu/serving/decode.py``).

A fixed pool of KV-cache slots decodes in lock-step — one ``decode_step``
per token for the whole pool — while new requests join mid-flight through
a bucketed ``prefill`` that writes their K/V into freed slots without
disturbing the others. Finished sequences (EOS or token budget) release
their slot at once; the next admission reuses it. One extra scratch row
pads partially filled prefill buckets, so padding never touches a live
slot.

Works with any model exposing the
``models.transformer.transformer_lm_serving`` contract:
``init_cache(slots, device)``, ``prefill(params, cache, tokens, slots,
lengths)``, ``decode_step(params, cache, tokens)``. The cache lives on the
engine's device and the model updates it in place.

On the card the decode step is one captured ``torch.cuda.CUDAGraph``, the
port's counterpart of the JAX package's one jitted step with the cache
donated: ``compile()`` runs the step eagerly (a second time under
``torch.cuda.set_sync_debug_mode("error")``, so a host read is named) and
captures it on a static ``[slots + 1]`` int32 token tensor; a decode copies
the host tokens into that tensor and replays, and the logits are a static
tensor read by an ``argmax`` on the device. The graph holds the addresses
of the cache tensors, so nothing may rebind them: the engine checks after
every prefill that they stay put. Without ``compile()`` the first decode
runs eagerly on the loop thread and captures after it (a miss on the hot
path). A capture that fails raises ``MXNetError``; there is no eager
fallback on the card. Prefill stays eager. Every dispatch notes its
signature with the anatomy recompile detector (``_note_dispatch``): each
(engine, bucket)'s first sight is its warm-up.

Env knobs: ``MXTPU_SERVE_SLOTS`` (decode batch, default 4),
``MXTPU_SERVE_MAX_LEN`` (KV window, model-side default).
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError, graph_capture, release_for_capture
from ..context import resolve_device
from . import buckets as _buckets
from .engine import ServeClosed

_H_PREFILL = _tm.histogram(
    "serve.prefill_seconds", "prefill dispatch wall time")
_H_DECODE = _tm.histogram(
    "serve.decode_step_seconds", "one lock-step decode step")
_H_GEN_WAIT = _tm.histogram(
    "serve.gen_queue_wait_seconds", "generation request enqueue -> admit")
_H_GEN_E2E = _tm.histogram(
    "serve.gen_e2e_seconds", "generation request enqueue -> done")
_G_GEN_QUEUE = _tm.gauge("serve.gen_queue_depth", "generation requests waiting")
_G_SLOTS = _tm.gauge(
    "serve.slot_occupancy", "active decode slots / total slots")
_C_TOKENS = _tm.counter("serve.tokens", "generated tokens")
_C_GEN_REQS = _tm.counter("serve.gen_requests", "completed generations")
_C_ADMITTED = _tm.counter("serve.admissions", "prefill admissions")


class _GenRequest(object):
    __slots__ = ("prompt", "max_new", "eos_id", "tokens", "error", "done",
                 "t_enqueue", "t_admit")

    def __init__(self, prompt, max_new, eos_id):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise MXNetError("empty prompt")
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.tokens = []  # generated continuation
        self.error = None
        self.done = threading.Event()
        self.t_enqueue = time.perf_counter()
        self.t_admit = None

    def result(self, timeout=None):
        if not self.done.wait(timeout):
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class _Slot(object):
    __slots__ = ("request", "last_token")

    def __init__(self):
        self.request = None
        self.last_token = 0


_ENGINE_IDS = iter(range(1 << 30))


class GenerationEngine(object):
    """Continuous-batching decode loop over a KV-cache model.

    Parameters
    ----------
    params : the model's parameters (``params_from_jax(...)``), on ``device``
    model : ``(init_cache, prefill, decode_step)`` from
        ``transformer_lm_serving`` (or anything with that contract)
    slots : decode batch size (default MXTPU_SERVE_SLOTS or 4)
    max_len : KV window — only used to derive prefill length buckets
    mesh : passed to prefill; a mesh (or mapping of axis sizes) whose
        'sp' axis is > 1 runs each prefill's attention as ring attention
        over sp sequence blocks (every length bucket must divide by sp);
        the decode step is the same either way
    device : where the cache lives and the model runs; default the CUDA
        card (raises without one), ``"cpu"`` to run on the host
    """

    def __init__(self, params, model, slots=None, max_len=256, mesh=None,
                 device=None):
        init_cache, prefill, decode_step = model
        self.device = resolve_device(device)
        p_dev = getattr(params, "device", None)
        if p_dev is not None and torch.device(p_dev) != self.device:
            raise MXNetError(
                "params live on %s but the engine runs on %s"
                % (p_dev, self.device))
        self.slots = slots if slots is not None else int(
            os.environ.get("MXTPU_SERVE_SLOTS", "4"))
        env_max_len = int(os.environ.get("MXTPU_SERVE_MAX_LEN", "0"))
        self.max_len = env_max_len if env_max_len > 0 else max_len
        self.params = params
        self.mesh = mesh
        self.len_buckets = _buckets.bucket_ladder(self.max_len, base=8)
        self.count_buckets = _buckets.bucket_ladder(self.slots)
        # one extra scratch row: admission pads its slot-index vector
        # with the scratch, so a partially-filled prefill bucket never
        # clobbers a live slot's cache row
        self._scratch = self.slots
        self._cache = init_cache(self.slots + 1, device=self.device)
        self._prefill = prefill
        self._decode = decode_step
        self._slot_state = [_Slot() for _ in range(self.slots)]
        self._free = list(range(self.slots))
        self._pending = collections.deque()
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._draining = False
        self._thread = None
        self._admitting = []  # popped from the queue, not yet in a slot
        # recompile accounting: one anatomy program uid per (engine,
        # bucket), so each bucket's first dispatch is warm-up-exempt
        self._engine_id = next(_ENGINE_IDS)
        self._seen_sigs = set()
        # the captured decode step (cuda): graph, static tokens and logits,
        # and the cache addresses it reads
        self._decode_graph = None
        self._static_tokens = self._tokens_pinned = self._decode_logits = None
        self._cache_ptrs = None
        self.decode_stats = {"captures": 0, "capture_ms": None, "pool_bytes": None}

    # -- recompile detector hookup ------------------------------------
    def _note_dispatch(self, kind, shape):
        sig = ((kind, tuple(shape), "int32", "serve"),)
        if sig not in self._seen_sigs:
            self._seen_sigs.add(sig)
            _tm.anatomy.note_plan_miss("serve:e%d:%s:%s" % (
                self._engine_id, kind,
                "x".join(str(d) for d in shape)), sig)

    def _cache_addresses(self):
        return {k: self._cache[k].data_ptr() for k in ("k", "v", "pos_map", "length")}

    def _prefill_call(self, toks, ids, lens):
        self._note_dispatch("prefill", tuple(toks.shape))
        toks, ids, lens = (torch.from_numpy(a).to(self.device)
                           for a in (toks, ids, lens))
        self._cache, last = self._prefill(
            self.params, self._cache, toks, ids, lens, mesh=self.mesh)
        if self._cache_ptrs is not None and self._cache_addresses() != self._cache_ptrs:
            raise MXNetError(
                "prefill moved the KV cache (%s, captured at %s): the captured decode "
                "step would read freed memory" % (self._cache_addresses(), self._cache_ptrs))
        return last

    def _decode_call(self, toks):
        self._note_dispatch("decode", tuple(toks.shape))
        if self._decode_graph is None:
            self._cache, logits = self._decode(
                self.params, self._cache, torch.from_numpy(toks).to(self.device))
            if self.device.type == "cuda":
                # a miss on the hot path: this tick ran eagerly, the next replays
                self._capture_decode()
            return logits
        self._tokens_pinned.copy_(torch.from_numpy(toks))
        self._static_tokens.copy_(self._tokens_pinned, non_blocking=True)
        self._decode_graph.replay()
        return self._decode_logits

    def _capture_decode(self):
        """Capture ``decode_step`` on the static token tensor into one CUDA
        graph (nothing runs). The step must have run eagerly before, so that
        its lazy set-up (the PE table on the card, library handles) is done."""
        dev = self.device
        n = self.slots + 1
        if self._static_tokens is None:
            self._static_tokens = torch.zeros((n,), dtype=torch.int32, device=dev)
            self._tokens_pinned = torch.zeros((n,), dtype=torch.int32, pin_memory=True)
        release_for_capture(dev)  # the delta from here is the graph's
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with graph_capture(graph):
                cache, logits = self._decode(self.params, self._cache, self._static_tokens)
        except Exception as exc:
            raise MXNetError("capturing the decode step (tokens [%d] int32) into a CUDA "
                             "graph failed: %s" % (n, exc)) from exc
        torch.cuda.synchronize(dev)
        if cache is not self._cache:
            raise MXNetError("the captured decode step returned another cache: it must "
                             "update the cache in place")
        self._decode_graph, self._decode_logits = graph, logits
        self._cache_ptrs = self._cache_addresses()
        self.decode_stats = {"captures": self.decode_stats["captures"] + 1,
                             "capture_ms": 1e3 * (time.perf_counter() - t0),
                             "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}

    # -- warm-up -------------------------------------------------------
    def compile(self, prompt_lengths=None):
        """Run every (count-bucket × length-bucket) prefill and the decode
        step once, and on the card capture the decode step. The first calls
        build the CUDA kernels, let the matmul library settle its choices
        and fill the allocator's cache, so the serving loop meets none of
        it. Prefill writes only the scratch row; the decode step advances
        every row, which admission resets."""
        lengths = prompt_lengths or self.len_buckets
        len_set = sorted({
            _buckets.covering_value(self.len_buckets, int(l)) for l in lengths
            if _buckets.covering_value(self.len_buckets, int(l)) is not None})
        for nb in self.count_buckets:
            for T in len_set:
                self._prefill_call(
                    np.zeros((nb, T), np.int32),
                    np.full((nb,), self._scratch, np.int32),
                    np.ones((nb,), np.int32))
        if self._decode_graph is None:
            zeros = torch.zeros((self.slots + 1,), dtype=torch.int32, device=self.device)
            self._note_dispatch("decode", tuple(zeros.shape))
            self._decode(self.params, self._cache, zeros)
            if self.device.type == "cuda":
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self._decode(self.params, self._cache, zeros)
                except RuntimeError as exc:
                    if "synchronizing CUDA operation" not in str(exc):
                        raise
                    raise MXNetError("the decode step waited for the device (a host read), "
                                     "which a CUDA graph cannot capture: %s" % exc) from exc
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                self._capture_decode()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- lifecycle -----------------------------------------------------
    def start(self, precompile=True):
        if self._thread is not None:
            return self
        if precompile:
            self.compile()
        self._draining = False
        self._thread = threading.Thread(
            target=self._run, name="mxtt-serve-decode", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout=60.0):
        """Stop admitting, finish every queued + in-flight generation,
        stop the loop. Idempotent."""
        with self._lock:
            self._draining = True
            self._have_work.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    # -- client surface ------------------------------------------------
    def submit(self, prompt, max_new=16, eos_id=None):
        req = _GenRequest(prompt, max_new, eos_id)
        if req.prompt.size > self.max_len:
            raise MXNetError(
                "prompt length %d exceeds KV window %d"
                % (req.prompt.size, self.max_len))
        with self._lock:
            if self._draining:
                raise ServeClosed(
                    "generation engine is draining; not accepting new work")
            self._pending.append(req)
            _G_GEN_QUEUE.set(len(self._pending))
            self._have_work.notify()
        return req

    def generate(self, prompt, max_new=16, eos_id=None, timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(prompt, max_new, eos_id).result(timeout)

    # -- scheduler -----------------------------------------------------
    @property
    def active(self):
        return sum(1 for s in self._slot_state if s.request is not None)

    def step(self):
        """One scheduler iteration: admit pending requests into free
        slots (bucketed prefill), then advance every active sequence by
        one token. Returns True if any work happened. The background
        thread calls this in a loop; tests may drive it directly."""
        admitted = self._admit()
        decoded = self._decode_tick()
        return admitted or decoded

    def _admit(self):
        with self._lock:
            if not self._pending or not self._free:
                return False
            take = min(len(self._pending), len(self._free))
            reqs = [self._pending.popleft() for _ in range(take)]
            slot_ids = [self._free.pop(0) for _ in range(take)]
            self._admitting = reqs
            _G_GEN_QUEUE.set(len(self._pending))
        n = len(reqs)
        nb = _buckets.covering_value(self.count_buckets, n)
        T = _buckets.covering_value(
            self.len_buckets, max(r.prompt.size for r in reqs))
        toks = np.zeros((nb, T), np.int32)
        lens = np.ones((nb,), np.int32)
        ids = np.full((nb,), self._scratch, np.int32)
        now = time.perf_counter()
        for i, (req, sid) in enumerate(zip(reqs, slot_ids)):
            toks[i, :req.prompt.size] = req.prompt
            lens[i] = req.prompt.size
            ids[i] = sid
            req.t_admit = now
            _H_GEN_WAIT.observe(now - req.t_enqueue)
        t0 = time.perf_counter()
        last = self._prefill_call(toks, ids, lens)
        # argmax on the device, then one small copy (first maximum wins,
        # as with np.argmax)
        first = torch.argmax(last[:n], dim=-1).tolist()
        _H_PREFILL.observe(time.perf_counter() - t0)
        _C_ADMITTED.inc(n)
        for req, sid, tok in zip(reqs, slot_ids, first):
            slot = self._slot_state[sid]
            slot.request = req
            slot.last_token = tok
            self._finish_token(sid, tok)
        self._admitting = []
        _G_SLOTS.set(self.active / float(self.slots))
        return True

    def _finish_token(self, sid, token):
        """Record one generated token for a slot; evict on EOS or
        budget. Eviction is host-side only — prefill fully resets a
        ring row on reuse, so freeing a slot costs zero device work."""
        slot = self._slot_state[sid]
        req = slot.request
        req.tokens.append(token)
        _C_TOKENS.inc()
        if (len(req.tokens) >= req.max_new
                or (req.eos_id is not None and token == req.eos_id)):
            slot.request = None
            req.done.set()
            _H_GEN_E2E.observe(time.perf_counter() - req.t_enqueue)
            _C_GEN_REQS.inc()
            with self._lock:
                self._free.append(sid)
            _G_SLOTS.set(self.active / float(self.slots))

    def _decode_tick(self):
        active = [i for i, s in enumerate(self._slot_state)
                  if s.request is not None]
        if not active:
            return False
        toks = np.zeros((self.slots + 1,), np.int32)
        for i in active:
            toks[i] = self._slot_state[i].last_token
        t0 = time.perf_counter()
        logits = self._decode_call(toks)
        nxt = torch.argmax(logits, dim=-1).tolist()
        _H_DECODE.observe(time.perf_counter() - t0)
        for i in active:
            self._slot_state[i].last_token = nxt[i]
            self._finish_token(i, nxt[i])
        return True

    def _run(self):
        try:
            while True:
                if not self.step():
                    with self._lock:
                        if self._draining and not self._pending:
                            return
                        self._have_work.wait(0.05)
        except Exception as exc:  # the loop's boundary: fail, never hang, waiters
            logging.getLogger(__name__).exception("generation loop stopped")
            self._fail_all(exc)

    def _fail_all(self, exc):
        """Stop admitting and hand ``exc`` to every queued, admitting and
        decoding request."""
        with self._lock:
            self._draining = True
            reqs = list(self._pending) + list(self._admitting)
            self._pending.clear()
        reqs += [s.request for s in self._slot_state if s.request is not None]
        for req in reqs:
            if not req.done.is_set():
                req.error = exc
                req.done.set()
