"""Profiler API of the port (counterpart of ``mxnet_tpu/profiler.py``).

Parity: reference ``python/mxnet/profiler.py`` (chrome trace-event
output). ``profiler_set_config`` / ``profiler_set_state`` drive
``torch.profiler.profile`` over the host and, where there is a card, the
CUDA device (Kineto, through CUPTI), and keep a host-side chrome trace of
framework-level events (telemetry spans, ``scope``, ``record_event``) as
the JAX package does. While it runs, every telemetry span is also a
``torch.profiler.record_function`` range, so the Kineto trace holds the
framework's spans around the kernels they launched.

- ``dump_profile()`` writes the host trace to the configured filename;
  stopping the profiler writes it too, and exports the Kineto trace
  beside it (:func:`kineto_path`: ``profile.json`` ->
  ``profile.kineto.json``).
- :func:`start_trace` / :func:`stop_trace` trace into a directory
  (``<dir>/kineto.json``) outside the MXNet profiler state: the port's
  ``start_jax_trace`` / ``stop_jax_trace``, which raise naming these.
- :func:`attribute_trace` reads an exported Kineto trace and reports
  device milliseconds by kernel and by framework op. Each device kernel
  carries the correlation id of the runtime call that launched it
  (``cudaLaunchKernel``, ``cuLaunchKernel`` for NVRTC's, or the
  ``cudaGraphLaunch`` of a replay); the launch's innermost enclosing
  ``record_function`` range (a span) or aten op on its thread is the
  framework op. This takes the place of the JAX package's
  ``hlo_metadata_map``, which maps XLA fusions to source lines through
  HLO metadata that PyTorch does not have. The port's kernels are labelled
  K1–K5 (:data:`KERNEL_LABELS`; NVRTC kernels by the names ``Rtc``
  registers).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

_state = {
    "mode": "symbolic",
    "filename": "profile.json",
    "running": False,
    "events": [],
    "dirty": False,  # events recorded since the last dump
    "torch_prof": None,  # the torch.profiler.profile of the running session
    "trace": None,  # a start_trace session: (profile, directory)
}
_lock = threading.Lock()

# substring of a device kernel's name -> the TPU kernel it ports (the
# table in PERF.md); NVRTC kernels are added by name as Rtc compiles them
KERNEL_LABELS = {
    "flash_fwd_split_sm90": "K4f",
    "flash_fwd_sm90": "K4f",
    "flash_split_kernel": "K4f",
    "flash_dq_sm90": "K4dq",
    "flash_dkv_sm90": "K4dkv",
    "conv_wgrad_reduce_kernel": "K2",
    "conv_wgrad_sm90": "K2",
    "conv_dgrad_sm90": "K3",
    "slab_update_kernel": "K1",
}


def register_kernel_label(name, label):
    """Label device kernels named ``name`` (an Rtc kernel: K5)."""
    KERNEL_LABELS[name] = label


def kernel_label(name):
    """K1–K5 of a device kernel's name, or None for a kernel of a library."""
    for sub, label in KERNEL_LABELS.items():
        if sub in name:
            return label
    return None


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Parity MXSetProfilerConfig. mode: 'symbolic' | 'all'."""
    _state["mode"] = mode
    _state["filename"] = filename


def kineto_path(filename=None):
    """Where stopping the profiler exports the Kineto (device) trace: the
    host trace's filename with ``.kineto.json`` for ``.json``."""
    base = filename or _state["filename"]
    root = base[:-5] if base.endswith(".json") else base
    return root + ".kineto.json"


def _torch_profile():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def profiler_set_state(state="stop"):
    """Parity MXSetProfilerState. state: 'run' | 'stop'."""
    if state == "run":
        if _state["running"]:
            return
        with _lock:
            _state["events"] = []  # fresh session
            _state["dirty"] = False
        prof = _torch_profile()
        prof.start()
        _state["torch_prof"] = prof
        _state["running"] = True
        _state["t0"] = time.time()
    elif state == "stop":
        _state["running"] = False
        prof, _state["torch_prof"] = _state["torch_prof"], None
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(kineto_path())
        # auto-flush: stopping a session writes the trace without a
        # separate dump_profile() call (which stays available and
        # idempotent — events are only cleared when a new run starts)
        if _state["dirty"]:
            dump_profile()
    else:
        raise ValueError("state must be 'run' or 'stop'")


def open_range(name):
    """A ``record_function`` range entered for ``name`` while the profiler
    runs (None otherwise); close it with :func:`close_range`."""
    if _state["torch_prof"] is None and _state["trace"] is None:
        return None
    import torch

    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng


def close_range(rng):
    rng.__exit__(None, None, None)


def record_event_complete(name, ts_us, dur_us, category="operator", pid=0,
                          args=None):
    """Record one complete chrome-trace ``"X"`` event (ts + dur), the
    form every consumer (chrome://tracing, perfetto, trace_summary)
    pairs for free — unpaired B/E records break on dropped ends."""
    if not _state["running"]:
        return
    event = {
        "name": name,
        "cat": category,
        "ph": "X",
        "ts": ts_us,
        "dur": dur_us,
        "pid": pid,
        "tid": threading.get_ident() % 10000,
    }
    if args:
        event["args"] = {k: str(v) for k, v in args.items()}
    with _lock:
        _state["events"].append(event)
        _state["dirty"] = True


def record_event(name, begin_us, end_us, category="operator", pid=0):
    """Host-side event recording hook (OprExecStat equivalent)."""
    record_event_complete(name, begin_us, end_us - begin_us,
                          category=category, pid=pid)


class scope:
    """Context manager stamping one chrome-trace event."""

    def __init__(self, name, category="operator"):
        self.name = name
        self.category = category

    def __enter__(self):
        self.t0 = time.time() * 1e6
        return self

    def __exit__(self, *a):
        record_event(self.name, self.t0, time.time() * 1e6, self.category)


def dump_profile():
    """Parity MXDumpProfile — writes chrome trace-event JSON.

    Idempotent: events persist until the next profiler_set_state("run")
    starts a fresh session, so stop's auto-flush and an explicit dump
    write the same file."""
    with _lock:
        events = sorted(_state["events"], key=lambda e: e["ts"])
        _state["dirty"] = False
    trace = {
        "traceEvents": [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 0,
                "args": {"name": "mxnet_tpu_torch host"},
            }
        ]
        + events,
        "displayTimeUnit": "ms",
    }
    with open(_state["filename"], "w") as f:
        json.dump(trace, f)


@atexit.register
def _dump_at_exit():
    """Flush undumped events at interpreter exit so a run that never
    reached profiler_set_state("stop") still leaves its trace."""
    if _state["dirty"]:
        try:
            dump_profile()
        except OSError:
            pass  # target dir may be gone during teardown


def start_trace(log_dir):
    """Trace host and card into ``log_dir`` until :func:`stop_trace`
    (spans become ranges meanwhile)."""
    if _state["trace"] is not None:
        raise RuntimeError("a trace is already running")
    prof = _torch_profile()
    prof.start()
    _state["trace"] = (prof, log_dir)


def stop_trace():
    """Stop :func:`start_trace`'s session; returns the path of its Kineto
    trace, ``<log_dir>/kineto.json``."""
    prof, log_dir = _state["trace"]
    _state["trace"] = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "kineto.json")
    prof.export_chrome_trace(path)
    return path


def start_jax_trace(log_dir):
    raise NotImplementedError(
        "start_jax_trace drives jax.profiler; the port traces with "
        "profiler.start_trace(log_dir) / profiler.stop_trace()")


def stop_jax_trace():
    raise NotImplementedError(
        "stop_jax_trace drives jax.profiler; the port traces with "
        "profiler.start_trace(log_dir) / profiler.stop_trace()")


def _load_trace(path):
    """traceEvents of a chrome trace file (``.gz`` too), or of the newest
    ``*.json`` under a directory."""
    import glob
    import gzip

    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "**", "*.json*"), recursive=True),
                       key=os.path.getmtime)
        if not paths:
            raise FileNotFoundError("no trace under %r" % path)
        path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_RANGE_CATS = ("user_annotation", "cpu_op")


def attribute_trace(trace_path, top=30):
    """Device milliseconds of an exported Kineto trace, by kernel and by
    framework op (see the module docstring).

    Returns ``{"kernels": [{"kernel", "label", "ms", "launches"}],
    "ops": [{"op", "ms", "launches"}], "device_ms", "unattributed_ms"}``,
    each list sorted by ms descending (``top`` rows; None for all). A
    kernel whose launch lies in no range counts under op ``"?"``."""
    events = _load_trace(trace_path)
    launches = {}  # correlation id -> launch event
    ranges = {}  # (pid, tid) -> [(ts, end, depth order, name)]
    kernels = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels.append(e)
        elif cat in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat in _RANGE_CATS:
            name = e.get("name", "")
            if name.startswith("ProfilerStep"):
                continue
            ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), cat, name))

    def enclosing(launch):
        """The innermost range (a span or an aten op) around a launch on
        its thread: of those that contain it, the one that began last."""
        if launch is None:
            return "?"
        ts = float(launch["ts"])
        best = None
        for lo, hi, cat, name in ranges.get((launch.get("pid"), launch.get("tid")), ()):
            if lo <= ts <= hi and (best is None or lo >= best[0]):
                best = (lo, hi, cat, name)
        return best[3] if best else "?"

    by_kernel, by_op = {}, {}
    total = 0.0
    for k in kernels:
        ms = float(k.get("dur", 0)) / 1e3
        total += ms
        name = k.get("name", "")
        row = by_kernel.setdefault(name, {"kernel": name, "label": kernel_label(name),
                                          "ms": 0.0, "launches": 0})
        row["ms"] += ms
        row["launches"] += 1
        op = enclosing(launches.get((k.get("args") or {}).get("correlation")))
        orow = by_op.setdefault(op, {"op": op, "ms": 0.0, "launches": 0})
        orow["ms"] += ms
        orow["launches"] += 1
    krows = sorted(by_kernel.values(), key=lambda r: -r["ms"])
    orows = sorted(by_op.values(), key=lambda r: -r["ms"])
    return {"kernels": krows[:top] if top else krows,
            "ops": orows[:top] if top else orows,
            "device_ms": total,
            "unattributed_ms": by_op.get("?", {}).get("ms", 0.0)}
