"""Telemetry exporters of the port: structured JSONL + Prometheus text
dump (counterpart of ``mxnet_tpu/telemetry/export.py``).

Two sinks, both optional and env-driven so production jobs opt in
without code changes:

- ``MXTPU_TELEMETRY_FILE`` — every span appends one JSON line as it
  closes; ``flush_metrics()`` (called per fit epoch, on ``flush()``, and
  at interpreter exit) appends a full ``{"type": "metrics"}`` registry
  snapshot. ``mxnet_tpu_torch/tools/trace_summary.py`` reads this format.
  With ``MXTPU_RUN_DIR`` set the default sink is the fleet stream
  ``<run_dir>/telemetry_r<rank>.jsonl``, beside a ``clock_<rank>.json``
  handshake.
- ``MXTPU_TELEMETRY_PROM_FILE`` — ``render_prometheus()`` text written
  on every flush, and periodically (every
  ``MXTPU_TELEMETRY_PROM_INTERVAL`` seconds, default 30) by a daemon
  thread, for a node-exporter-style textfile collector to scrape.

Also home of the per-step device gauges: ``sample_device_memory()``
reads the caching allocator's ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info`` of each card in use into the JAX package's
``device.memory.*`` gauges (nothing on the CPU, as there).
"""
from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time

from . import registry as _reg

RUN_DIR_ENV = "MXTPU_RUN_DIR"

_lock = threading.Lock()
_host = socket.gethostname()
_seq = 0  # per-process metrics-snapshot sequence (fleet merge idempotence)
_handshake_done = False


def fleet_rank():
    """This process's rank in the run: DMLC_RANK (launcher), else RANK
    (torch.distributed's launchers), else 0. Read per call — launchers
    set it after import."""
    for var in ("DMLC_RANK", "RANK"):
        val = os.environ.get(var)
        if val:
            try:
                return int(val)
            except ValueError:
                pass
    return 0


def _tags_enabled():
    # default ON: fleet aggregation needs every record to say who wrote it
    return os.environ.get("MXTPU_RANK_TAGS", "1") not in ("", "0")


def tag_record(record):
    """Stamp rank/pid/host identity onto a JSONL record (copy, don't
    mutate the caller's dict). MXTPU_RANK_TAGS=0 opts out."""
    if not _tags_enabled():
        return record
    record = dict(record)
    record.setdefault("rank", fleet_rank())
    record.setdefault("pid", os.getpid())
    record.setdefault("host", _host)
    return record


def _default_rank_sink():
    """``<MXTPU_RUN_DIR>/telemetry_r<rank>.jsonl`` when a run dir is
    configured (the fleet aggregator's discovery convention), else None."""
    run_dir = os.environ.get(RUN_DIR_ENV)
    if not run_dir:
        return None
    return os.path.join(run_dir, "telemetry_r%d.jsonl" % fleet_rank())


def write_clock_handshake(run_dir=None, rank=None):
    """Write ``clock_<rank>.json`` into the run dir: a paired
    (wall-clock, monotonic) reading taken at write time. The aggregator
    compares the file's mtime (stamped by the shared filesystem's
    clock) against the recorded wall reading to place every rank's
    timestamps on one timeline even when local clocks drift."""
    run_dir = run_dir or os.environ.get(RUN_DIR_ENV)
    if not run_dir:
        return None
    rank = fleet_rank() if rank is None else rank
    path = os.path.join(run_dir, "clock_%d.json" % rank)
    rec = {"rank": rank, "pid": os.getpid(), "host": _host,
           "wall": time.time(), "mono": time.monotonic()}
    try:
        os.makedirs(run_dir, exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def _maybe_handshake():
    """Write the clock handshake once per process, the first time the
    JSONL sink is actually used with a run dir configured."""
    global _handshake_done
    if _handshake_done or not os.environ.get(RUN_DIR_ENV):
        return
    _handshake_done = True
    write_clock_handshake()


def ensure_fleet_sink():
    """Adopt the per-rank run-dir sink if telemetry is enabled, a run
    dir is set, and no explicit MXTPU_TELEMETRY_FILE overrode it; write
    the clock handshake either way. Called from ``telemetry.enable()``."""
    if not _reg._enabled:
        return
    if _jsonl_path is None and not os.environ.get("MXTPU_TELEMETRY_FILE"):
        default = _default_rank_sink()
        if default is not None:
            set_jsonl_path(default)
    _maybe_handshake()


_jsonl_path = os.environ.get("MXTPU_TELEMETRY_FILE") or None
if _jsonl_path is None and _reg._enabled:
    # MXTPU_TELEMETRY=1 + MXTPU_RUN_DIR: land per-rank streams where the
    # fleet aggregator looks, with no further configuration
    _jsonl_path = _default_rank_sink()
_jsonl_fh = None
_prom_path = os.environ.get("MXTPU_TELEMETRY_PROM_FILE") or None
_prom_interval = float(os.environ.get("MXTPU_TELEMETRY_PROM_INTERVAL", "30"))
_prom_thread = None
_prom_stop = threading.Event()


def jsonl_path():
    return _jsonl_path


def set_jsonl_path(path):
    """Point (or stop, with None) the JSONL sink at ``path``."""
    global _jsonl_path, _jsonl_fh
    with _lock:
        if _jsonl_fh is not None:
            try:
                _jsonl_fh.close()
            except OSError:
                pass
            _jsonl_fh = None
        _jsonl_path = path or None


def _fh():
    """Open the JSONL sink lazily (caller holds _lock)."""
    global _jsonl_fh
    if _jsonl_fh is None and _jsonl_path is not None:
        _jsonl_fh = open(_jsonl_path, "a")
    return _jsonl_fh


def emit_span(record):
    if _jsonl_path is None:
        return
    _maybe_handshake()
    line = json.dumps(tag_record(record))
    with _lock:
        fh = _fh()
        if fh is not None:
            fh.write(line + "\n")
            fh.flush()


# any structured record ({"type": "anatomy"|"recompile"|...}) goes down
# the same sink; the span name is historical
emit_record = emit_span


def flush_metrics():
    """Append a registry snapshot to the JSONL sink and rewrite the
    Prometheus file, whichever are configured."""
    global _seq
    if _jsonl_path is not None:
        _maybe_handshake()
        with _lock:
            _seq += 1
            seq = _seq
        line = json.dumps(tag_record({
            "type": "metrics", "ts": time.time(), "seq": seq,
            "metrics": _reg.snapshot(),
        }))
        with _lock:
            fh = _fh()
            if fh is not None:
                fh.write(line + "\n")
                fh.flush()
    write_prometheus_file()


def set_prometheus_file(path, interval=None):
    """Configure the Prometheus text sink; interval > 0 starts the
    periodic writer thread."""
    global _prom_path, _prom_interval
    _prom_path = path or None
    if interval is not None:
        _prom_interval = float(interval)
    if _prom_path is not None and _prom_interval > 0:
        _start_prom_thread()


def write_prometheus_file():
    if _prom_path is None:
        return
    text = _reg.render_prometheus()
    tmp = _prom_path + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, _prom_path)  # atomic vs a concurrent scraper
    except OSError:
        pass  # export is advisory; never take training down


def _start_prom_thread():
    global _prom_thread
    if _prom_thread is not None and _prom_thread.is_alive():
        return
    _prom_stop.clear()

    def _loop():
        while not _prom_stop.wait(_prom_interval):
            if _reg._enabled:
                write_prometheus_file()

    _prom_thread = threading.Thread(
        target=_loop, name="mxtpu-telemetry-prom", daemon=True)
    _prom_thread.start()


def stop_prom_thread():
    _prom_stop.set()


# -- device memory gauges ---------------------------------------------
_capacity = {}  # card index -> its memory capacity in bytes (mem_get_info)


def sample_device_memory():
    """Read each card's allocator statistics into gauges: bytes in use and
    their peak (``torch.cuda.memory_stats``) and the card's capacity
    (``torch.cuda.mem_get_info``). Safe to call per step; a process that
    has not touched a card (the CPU) records nothing, and a card the
    process holds no memory on is skipped (reading its capacity would
    create a context there)."""
    if not _reg._enabled:
        return
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    for dev in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(dev)
            if not stats.get("allocated_bytes.all.peak"):
                continue
            if dev not in _capacity:  # a driver call; the capacity never changes
                _capacity[dev] = torch.cuda.mem_get_info(dev)[1]
            limit = _capacity[dev]
        except Exception:  # noqa: BLE001 — backend-dependent surface
            continue
        for key, val in (("bytes_in_use", stats.get("allocated_bytes.all.current")),
                         ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak")),
                         ("bytes_limit", limit)):
            if val is not None:
                _reg.gauge("device.memory." + key).set(val, device=str(dev))


def _at_exit():
    """Interpreter-exit flush: a crashed-after-N-epochs run still leaves
    its last metrics snapshot on disk."""
    if _reg._enabled and (_jsonl_path is not None or _prom_path is not None):
        try:
            flush_metrics()
        except Exception:  # noqa: BLE001 — exit path must not raise
            pass


atexit.register(_at_exit)

if (_prom_path is not None and _prom_interval > 0
        and os.environ.get("MXTPU_TELEMETRY_PROM_FILE")):
    _start_prom_thread()
