"""BaseModule of the PyTorch port (counterpart of
``mxnet_tpu/module/base_module.py``): the ``fit`` loop, ``score`` /
``predict`` / ``iter_predict``, ``forward_backward`` and the parameter
file codec.

``fit`` runs the JAX package's loop in its order: bind, init_params,
init_optimizer, then per epoch reset the metric, per batch forward /
backward / update / update_metric and the batch callbacks, then the epoch
callbacks with the synced params and the validation score, then reset the
data. ``checkpoint_dir`` / ``resume`` / ``guardrails`` wire in
``resilience`` as the JAX package does (``mxnet_tpu/module/base_module.py:
413-820``): async snapshots every ``MXTPU_CKPT_INTERVAL`` steps and at each
epoch end, a final checkpoint and ``EXIT_PREEMPTED`` on SIGTERM/SIGINT,
resume with the iterator's ``skip``, the fault points of
``MXTPU_FAULT_INJECT``, and the guard's skip / rewind / verdict ladder.
Snapshots, fault points and the guard's observations fall on step-group
boundaries. A checkpoint stores numpy's stream as ``rng.numpy`` and the
torch generators as ``rng.torch``; ``rng.mx`` (the JAX package's key
stream) is left None, so that package's resume skips it, and the port
ignores it in a JAX checkpoint.

Across the processes of a launched job (a ``dist_*`` kvstore of several
workers) rank 0 writes the checkpoints; every rank captures the state
(across processes in "shard" mode the capture gathers the optimizer
state's blocks, a collective). With ``checkpoint_dir`` the ranks agree on a
preemption signal at each step-group boundary (one small all-reduce, after
the elastic poll), so a signal that reaches one rank has every rank capture
the final checkpoint at the same boundary, wait for rank 0 to write it and
exit ``EXIT_PREEMPTED``. Under ``MXTPU_RUN_DIR`` every fitting rank
keeps its heartbeat files (``parallel/heartbeat.py``: the kvstore's writer,
or one ``fit`` starts) and ticks their progress mark after each step.
``MXTPU_ELASTIC=1`` with ``checkpoint_dir`` and a world
(``MXTPU_WORLD_SIZE``, else ``DMLC_NUM_WORKER``) above 1 arms the elastic
shrink of the JAX package (``mxnet_tpu/module/base_module.py:543-700``):
every ``MXTPU_ELASTIC_POLL`` seconds, at a step-group boundary, a rank
reads ``lost_nodes`` of the run dir (``MXTPU_ELASTIC_TIMEOUT``); when a
peer is lost, the lowest surviving rank writes a final checkpoint and
exits ``EXIT_RESHAPE`` (76), and ``tools/watchdog.py --elastic`` relaunches
at the surviving world, where ``resume="auto"`` restores the same state at
the new dp (the cursor moves by global samples). A fused step whose state
is sharded across processes cannot gather it without the lost peer: that
rank exits 76 without a final checkpoint, and the relaunch resumes from
the last interval checkpoint.

``monitor`` is installed after bind (``install_monitor``), which keeps
training on the executor path, and is armed (``tic``) before and read
(``toc_print``) after every batch, as in the JAX package.

With telemetry on (``telemetry.enable()`` or ``MXTPU_TELEMETRY=1``) the
loop records the JAX package's metrics and records under its names: the
``fit.step_seconds`` / ``fit.epoch_seconds`` histograms, ``fit.step`` and
``fit.step_group`` spans, the card's memory gauges each step, a metrics
snapshot at each epoch end, the per-op cost table (``op_costs``) once,
and the step anatomy (``telemetry.anatomy``): one ``anatomy`` record every
``MXTPU_ANATOMY_INTERVAL`` steps and at each epoch end.

``MXNET_FIT_MULTISTEP=K`` (K > 1) on the fused path groups K batches into
one ``Module.update_multi`` (on the card one replay of a CUDA graph of K
steps), which gives the bits of K single steps; the metric and
``batch_end_callback`` still see every batch, with its own ``nbatch`` and
the normal ``locals`` keys, after its group. A trailing partial group, or a
batch whose shape breaks the group, takes the single-step path. Without a
fused trainer the knob changes nothing. ``MXNET_FIT_MULTISTEP=auto`` hands
K to :class:`_MultistepAutoTuner`, as in the JAX package. A graph that
holds a ``Custom`` or ``ROIPooling`` node cannot be captured
(``operator.refuse_capture``): under ``=K`` ``fit`` raises, under
``=auto`` it keeps K at 1.

With ``MXTPU_DEVICE_FEED=1`` ``fit`` wraps the training iterator in
``io.DeviceFeedIter`` on the fused trainer's device: the next batches are
staged through pinned host memory on a side stream while the current step
runs, and the step takes them without a copy. The JAX package installs
it by default; the port does not (its step time did not move with it,
and one run on the card ended with other BatchNorm statistics than the
same fit without it, cause not found). A resume positions an iterator
that has ``seek_epoch`` / ``seek_sample`` (the streaming record iterator,
and a DeviceFeedIter over one) at the checkpoint's epoch and
``sample_position``, so a shuffled stream resumed in a later epoch replays
that epoch's order; the guard's rewind uses ``seek_epoch`` where there is
one. ``MXTPU_METRIC_INTERVAL`` changes no result in the JAX package and is
not read.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
import signal
import time

import numpy as np
import torch

from .. import metric as metric_mod
from .. import ndarray as nd
from .. import operator as _operator
from .. import random as _rnd
from .. import telemetry as _tm
from ..initializer import Uniform
from ..io import DataDesc  # noqa: F401  (re-exported for subclasses)
from ..model import BatchEndParam
from ..parallel import mesh as _mesh
from ..resilience import fault as _fault
from ..resilience.checkpoint import restricted_loads as _ckpt_loads

_H_STEP_SECONDS = _tm.histogram(
    "fit.step_seconds", "Wall time of one fit-loop optimizer step "
    "(forward_backward + update), labelled by epoch")
_H_EPOCH_SECONDS = _tm.histogram(
    "fit.epoch_seconds", "Wall time of one training epoch")
_C_RESUME_LOADED = _tm.counter(
    "resume.loaded", "fit() calls that restored state from a checkpoint")
_C_RESUME_NONE = _tm.counter(
    "resume.none_found",
    "fit() resume requests that found no valid checkpoint")
_C_PREEMPTED = _tm.counter(
    "fit.preempted",
    "fit() loops that exited through the SIGTERM/SIGINT grace path "
    "after writing a final checkpoint")


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, epoch, nbatch, eval_metric, local_vars):
    """Invoke batch/epoch callbacks with the reference's BatchEndParam."""
    if callbacks is None:
        return
    params = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                           locals=local_vars)
    for cb in _as_list(callbacks):
        cb(params)


def _poison_batch(batch, mode):
    """Fault injection (``nan_grad_at_step`` / ``loss_spike_at_step``): a
    shallow copy of ``batch`` whose data is NaN or scaled by 1e4, labels
    and metadata intact, on the data's own context."""
    factor = float("nan") if mode == "nan" else 1.0e4
    out = copy.copy(batch)
    out.data = [nd.array(np.asarray(d.asnumpy(), dtype=np.float32) * factor, ctx=d.context)
                for d in batch.data]
    return out


def _fit_multistep():
    """K of ``MXNET_FIT_MULTISTEP`` (1 when unset or not a number), or
    "auto"."""
    raw = os.environ.get("MXNET_FIT_MULTISTEP", "1").strip()
    if raw.lower() == "auto":
        return "auto"
    try:
        return int(raw)
    except ValueError:
        return 1


class _MultistepAutoTuner:
    """``MXNET_FIT_MULTISTEP=auto``: grow the fused-step group depth K
    until host dispatch is invisible next to device time (the JAX
    package's tuner, ``mxnet_tpu/module/base_module.py:96``).

    After each full K-group the tuner reads the phase totals
    (``module.dispatch_host_seconds`` et al — the same counters the
    anatomy record reports) and estimates the dispatch share of the
    group's wall time by the anatomy's disjointness rule (dispatch minus
    its staging sub-window, clamped at zero; device time is the wall
    remainder after every host phase). While the share exceeds
    ``MXTPU_DISPATCH_TARGET_FRAC`` (default 0.05) and K <
    ``MXNET_FIT_MULTISTEP_MAX`` (default 32), K doubles.

    A new depth is a new group: on the card its first group runs eagerly
    (the warm-up) and its second is captured into a CUDA graph, the
    port's counterpart of the JAX package's recompile. The first
    ``skip_groups`` groups at each depth are left out of the measurement
    (the fit loop passes 2 on the card, for the warm-up and the capture;
    1 elsewhere, as in the JAX package), and when K grows the fit loop
    frees the previous depth's graph and buffers
    (``ShardedTrainStep.release_groups``). Once the target is met (or the
    cap is hit) the tuner settles: K is frozen, every later group replays
    the same graph, and the steady state captures nothing.

    Decisions land in the telemetry JSONL as ``type=multistep_auto``
    records, and the current depth is stamped onto every anatomy
    interval record via :func:`telemetry.anatomy.note_multistep`."""

    _KEYS = {"dispatch": "module.dispatch_host_seconds",
             "stage": "module.stage_host_seconds",
             "input": "io.feed_wait_seconds"}

    def __init__(self, logger=None, skip_groups=1):
        def _env(name, default, cast):
            try:
                return cast(os.environ.get(name, default))
            except ValueError:
                return cast(default)

        self.target = _env("MXTPU_DISPATCH_TARGET_FRAC", "0.05", float)
        self.k_max = max(1, _env("MXNET_FIT_MULTISTEP_MAX", "32", int))
        # measure at least this many steps per decision so one noisy
        # group can't trigger a doubling
        self.min_steps = max(1, _env("MXTPU_MULTISTEP_AUTO_STEPS", "8", int))
        self.skip_groups = max(1, int(skip_groups))
        self.k = min(2, self.k_max)
        self.settled = self.k >= self.k_max
        self.logger = logger
        self.last_frac = None
        self._skip = self.skip_groups
        self._steps = 0
        self._base = None
        self._t0 = None
        _tm.anatomy.note_multistep(self.k, settled=self.settled)

    def _totals(self):
        return {k: _tm.REGISTRY.total(v) for k, v in self._KEYS.items()}

    def _arm(self):
        self._base = self._totals()
        self._t0 = time.perf_counter()
        self._steps = 0

    def after_group(self, k_done):
        """Called by the fit loop after each full K-group dispatch."""
        if self.settled or k_done != self.k:
            return
        if not _tm.enabled():
            # no phase counters to steer by: freeze at the initial depth
            self._settle(None, "telemetry disabled")
            return
        if self._skip:
            # the first groups at this depth carry the warm-up and the
            # capture; start measuring after them
            self._skip -= 1
            if not self._skip:
                self._arm()
            return
        self._steps += k_done
        if self._steps < self.min_steps:
            return
        now = self._totals()
        wall = max(time.perf_counter() - self._t0, 1e-9)
        disp = now["dispatch"] - self._base["dispatch"]
        stage = now["stage"] - self._base["stage"]
        feed = now["input"] - self._base["input"]
        # the anatomy's disjointness rule: the dispatch window includes
        # staging, so subtract it; device time is what is left of wall
        # after every host phase
        disp_adj = max(disp - stage, 0.0)
        device = max(wall - feed - stage - disp_adj, 1e-9)
        frac = disp_adj / device
        self.last_frac = frac
        if frac <= self.target:
            self._settle(frac, "target met")
        elif self.k >= self.k_max:
            self._settle(frac, "depth cap")
        else:
            self.k = min(self.k * 2, self.k_max)
            self._skip = self.skip_groups
            self._record(frac, grown=True)
            if self.logger is not None:
                self.logger.info(
                    "fit multistep auto: dispatch %.1f%% of device time > %.1f%% target, "
                    "growing K to %d", 100 * frac, 100 * self.target, self.k)

    def _settle(self, frac, why):
        self.settled = True
        self._record(frac, grown=False, why=why)
        if self.logger is not None:
            self.logger.info(
                "fit multistep auto: settled at K=%d (%s%s)", self.k, why,
                "" if frac is None else ", dispatch at %.1f%% of device time" % (100 * frac))

    def _record(self, frac, grown, why=None):
        _tm.anatomy.note_multistep(self.k, settled=self.settled, dispatch_frac=frac)
        rec = {"type": "multistep_auto", "k": self.k, "settled": self.settled,
               "grown": grown, "target_frac": self.target}
        if frac is not None:
            rec["dispatch_frac"] = round(frac, 4)
        if why:
            rec["why"] = why
        _tm.anatomy.emit_decision(rec)


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in [n for n in names if n not in args]:
        candidates = [a for a in args if not a.endswith(("_weight", "_bias", "_gamma", "_beta"))]
        msg = ("You created Module with Module(..., %s_names=%s) but input with name '%s' is "
               "not found in symbol.list_arguments(). Did you mean one of:\n\t%s"
               % (typename, str(names), name, "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class _ReadOnlyCheckpoints:
    """A CheckpointManager whose saves do nothing: a rank other than 0 of
    a multi-process job reads the checkpoints rank 0 writes."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name == "inner":
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    def save(self, state, step):
        return None

    def save_async(self, state, step):
        return None


class _ElasticPoll:
    """The elastic shrink's liveness poll (``MXTPU_ELASTIC=1``): peers that
    ``heartbeat.lost_nodes`` declares lost, at most every ``poll`` seconds."""

    def __init__(self, run_dir, world, rank, poll, timeout):
        from ..parallel import heartbeat as _hb

        self._hb = _hb
        self.dir, self.world, self.rank = run_dir, world, rank
        self.poll_s, self.timeout = poll, timeout
        self._next = 0.0

    def poll(self):
        now = time.monotonic()
        if now < self._next:
            return []
        self._next = now + self.poll_s
        return [r for r in self._hb.lost_nodes(self.dir, self.world, timeout=self.timeout)
                if r != self.rank]

    def writes_final(self, lost):
        """The lowest surviving rank writes the final checkpoint."""
        return self.rank == min(r for r in range(self.world) if r not in lost)


def _elastic_config(rank):
    """An :class:`_ElasticPoll` under ``MXTPU_ELASTIC=1`` with a run dir and
    a world above 1, else None."""
    if os.environ.get("MXTPU_ELASTIC") != "1":
        return None

    def _num(name, default, cast):
        try:
            return cast(os.environ.get(name, default))
        except ValueError:
            return cast(default)

    run_dir = os.environ.get("MXTPU_RUN_DIR")
    world = _num("MXTPU_WORLD_SIZE", os.environ.get("DMLC_NUM_WORKER", "0"), int)
    if not run_dir or world <= 1:
        return None
    return _ElasticPoll(run_dir, world, rank, _num("MXTPU_ELASTIC_POLL", "5", float),
                        _num("MXTPU_ELASTIC_TIMEOUT", "60", float))


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- inference ---------------------------------------------------------
    def _infer_batches(self, eval_data, num_batch, reset, want_outputs=True):
        """Yield (nbatch, batch, unpadded outputs) over an eval iterator."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                return
            self.forward(batch, is_train=False)
            outs = None
            if want_outputs:
                pad = batch.pad or 0
                outs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield nbatch, batch, outs

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0):
        """Run inference over eval_data, accumulating eval_metric."""
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        n_seen = 0
        for nbatch, batch, _outs in self._infer_batches(eval_data, num_batch, reset,
                                                        want_outputs=False):
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback, epoch, nbatch, eval_metric, locals())
            n_seen = nbatch + 1
        _fire(score_end_callback, epoch, n_seen, eval_metric, locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Generator over (outputs, nbatch, batch)."""
        for nbatch, batch, outs in self._infer_batches(eval_data, num_batch, reset):
            yield outs, nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False):
        """Outputs over an iterator, merged across batches by default."""
        collected = [[o.copy() for o in outs]
                     for _n, _b, outs in self._infer_batches(eval_data, num_batch, reset)]
        if not collected or not merge_batches:
            return collected
        arity = len(collected[0])
        if any(len(outs) != arity for outs in collected):
            raise AssertionError("Cannot merge batches, as num of outputs is not the same in "
                                 "mini-batches. Maybe bucketing is used?")
        merged = [nd.concatenate([outs[i] for outs in collected]) for i in range(arity)]
        if arity == 1 and not always_output_list:
            return merged[0]
        return merged

    # -- training ----------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc", epoch_end_callback=None,
            batch_end_callback=None, kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), eval_end_callback=None,
            eval_batch_end_callback=None, initializer=Uniform(0.01), arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            checkpoint_dir=None, resume=None, guardrails=None):
        """The training loop; see the module docstring.

        ``checkpoint_dir`` (a path or a ``resilience.CheckpointManager``)
        turns on atomic full-state checkpoints: at every epoch end, every
        ``MXTPU_CKPT_INTERVAL`` optimizer steps (both in the background),
        and on SIGTERM/SIGINT (finish the step group in flight, write a
        final checkpoint, exit ``resilience.EXIT_PREEMPTED``).
        ``resume="auto"`` (or a step number) restores params, optimizer
        state, RNG streams, the metric and the iterator's position from the
        newest checkpoint that verifies; the run goes on bit for bit as one
        never interrupted. ``guardrails="auto"`` (with ``checkpoint_dir``)
        arms the fused step's skip gate, watches its (loss, grad-norm²,
        gate_ok) stream with ``resilience.GuardrailMonitor``, stamps
        checkpoints with their health, rewinds to the newest known-good
        one on repeated anomalies and exits ``resilience.EXIT_GUARDRAIL``
        with a verdict when ``MXTPU_GUARD_MAX_REWINDS`` is spent."""
        from ..resilience import checkpoint as _ckpt
        from ..resilience import guardrail as _guard

        assert num_epoch is not None, "please specify number of epochs"
        self.bind(data_shapes=train_data.provide_data, label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        fit_k = _fit_multistep()
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = metric_mod.create(eval_metric)
        if validation_metric is None:
            validation_metric = eval_metric
        trainer = getattr(self, "_fused_trainer", None)

        # -- checkpoints (resilience/checkpoint.py) ---------------------------
        ckpt_mgr = None
        if checkpoint_dir is not None:
            ckpt_mgr = (checkpoint_dir if isinstance(checkpoint_dir, _ckpt.CheckpointManager)
                        else _ckpt.CheckpointManager(checkpoint_dir))
        elif resume is not None:
            raise ValueError("fit(resume=...) requires checkpoint_dir")
        try:
            ckpt_interval = max(0, int(os.environ.get(_ckpt.ENV_INTERVAL, "0")))
        except ValueError:
            ckpt_interval = 0
        kv = getattr(self, "_kvstore", None)
        dist_rank, dist_workers = 0, 1
        if kv is not None and "dist" in kv.type:
            dist_rank, dist_workers = kv.rank, kv.num_workers
        elif trainer is not None and trainer.nproc > 1:
            # a fused step over a mesh that spans processes (param_specs'
            # tp across processes): rank 0 writes, as under a dist kvstore
            dist_rank, dist_workers = trainer.prank, trainer.nproc
        else:
            try:
                dist_rank = int(os.environ.get("DMLC_RANK", "0"))
            except ValueError:
                dist_rank = 0
        if ckpt_mgr is not None and dist_workers > 1 and dist_rank != 0:
            ckpt_mgr = _ReadOnlyCheckpoints(ckpt_mgr)  # rank 0 writes the checkpoints
        elastic = _elastic_config(dist_rank) if ckpt_mgr is not None else None
        fleet_hb = getattr(kv, "_heartbeat", None)
        own_hb = None
        run_dir = os.environ.get("MXTPU_RUN_DIR")
        if run_dir and fleet_hb is None:
            from ..parallel import heartbeat as _hb

            try:
                fleet_hb = own_hb = _hb.HeartbeatWriter(run_dir, dist_rank).start()
            except OSError:
                fleet_hb = None

        # -- guardrails (resilience/guardrail.py) -----------------------------
        guard_mon = None
        if guardrails is not None:
            if guardrails != "auto":
                raise ValueError('guardrails must be "auto" or None, got %r' % (guardrails,))
            if ckpt_mgr is None:
                raise ValueError("fit(guardrails=...) requires checkpoint_dir: rewind-to-last-"
                                 "good needs somewhere to rewind to")
            if trainer is None:
                # the gate and the diag stream live in the fused step
                self.logger.warning("guardrails: no fused trainer on this module; anomaly "
                                    "detection disabled")
            else:
                trainer.arm_guard()
                guard_mon = _guard.GuardrailMonitor(logger=self.logger)
        fit_data = train_data
        if trainer is not None and os.environ.get("MXTPU_DEVICE_FEED", "0") == "1":
            from ..io import DeviceFeedIter

            # the next batches' host-to-device copies overlap this step
            fit_data = DeviceFeedIter(train_data, trainer.device)
        auto_tuner = None
        host_bound = _operator.uncapturable_nodes(self.symbol) if trainer is not None else []
        spans = trainer is not None and getattr(trainer, "nproc", 1) > 1
        if fit_k == "auto":
            fit_k = 1
            if spans:
                self.logger.info("fit multistep auto: K=1, the step's gloo collectives over "
                                 "%d processes cannot be captured", trainer.nproc)
            elif host_bound:
                # a graph that reads the host at each call cannot be
                # captured: the tuner keeps such a fit at one step
                self.logger.info("fit multistep auto: K=1, the graph holds %s",
                                 "; ".join(host_bound))
            elif trainer is not None and monitor is None and hasattr(self, "update_multi"):
                # on the card a depth's first group is the warm-up and its
                # second the capture: both stay out of the measurement
                auto_tuner = _MultistepAutoTuner(
                    self.logger, skip_groups=2 if trainer.device.type == "cuda" else 1)
                fit_k = auto_tuner.k
        use_multi = (fit_k > 1 and trainer is not None and monitor is None
                     and hasattr(self, "update_multi"))
        if use_multi:
            _operator.refuse_capture(self.symbol, "MXNET_FIT_MULTISTEP=%d's grouped steps"
                                     % fit_k)
            trainer.compile_multi(fit_k)  # raises for an ungrouped optimizer

        def _restore_from_state(state):
            """Module, optimizer and RNG from a checkpoint state dict (resume
            and rewind); returns (epoch, skip, global step, metric blob)."""
            self._restore_train_state(state["module"])
            rng = state.get("rng") or {}
            if rng.get("numpy") is not None:
                np.random.set_state(rng["numpy"])
            if rng.get("torch") is not None:
                _rnd.set_states(rng["torch"])
            elif rng.get("mx") is not None:
                self.logger.info("resume: the checkpoint's JAX key stream (rng.mx) does not "
                                 "apply to torch generators; left as seeded")
            epoch = int(state.get("epoch", 0))
            skip = int(state.get("nbatch", 0))
            gs = int(state.get("global_step", 0))
            # the cursor counts batches at the writer's global batch; at
            # another global batch, keep the global sample position
            topo, cur = state.get("topology"), self._topology()
            loop_seek["sample_position"] = state.get("sample_position")
            if topo and cur:
                wgb = int(topo.get("global_batch") or 0)
                cgb = int(cur.get("global_batch") or 0)
                if wgb and cgb and wgb != cgb:
                    loop_seek["sample_position"] = None  # the batch cursor translates
                    samples = skip * wgb
                    skip, rem = divmod(samples, cgb)
                    if rem:
                        self.logger.warning(
                            "resume: sample position %d is not a multiple of the new global "
                            "batch %d; %d samples will be fed again", samples, cgb, rem)
            ckpt_mgr.last_step = gs
            return epoch, skip, gs, state.get("metric")

        resume_skip, resume_metric, gs0 = 0, None, 0
        loop_seek = {"sample_position": None}  # a resume's sample cursor, used once
        if ckpt_mgr is not None and resume is not None:
            if resume == "auto":
                # under guardrails the newest HEALTHY snapshot: one stamped
                # mid-anomaly would resume the divergence a rewind escaped
                state = ckpt_mgr.load_last_good() if guard_mon is not None else ckpt_mgr.load()
            elif isinstance(resume, int) and not isinstance(resume, bool):
                state = ckpt_mgr.load(step=resume)
            else:
                raise ValueError('resume must be "auto" or a checkpoint step, got %r'
                                 % (resume,))
            if state is None:
                _C_RESUME_NONE.inc()
                self.logger.info("resume: no valid checkpoint under %s; starting fresh",
                                 ckpt_mgr.directory)
            else:
                _C_RESUME_LOADED.inc()
                begin_epoch, resume_skip, gs0, resume_metric = _restore_from_state(state)
                loop_seek["resumed"] = True
                if guard_mon is not None:
                    guard_mon.restore(state.get("health"))
                    trainer.guard_threshold = guard_mon.gate_threshold()
                self.logger.info("resume: restored step %d (epoch %d, batch %d)",
                                 gs0, begin_epoch, resume_skip)

        loop = {"gs": gs0, "done": resume_skip, "epoch": begin_epoch, "last_saved": gs0}
        preempt = {"flag": False}

        def _capture(epoch_next, nbatch_done):
            try:
                metric_blob = pickle.dumps(eval_metric, protocol=2)
            except Exception:  # an unpicklable custom metric: resume restarts its epoch
                metric_blob = None
            topo = self._topology()
            sample_pos = None
            if topo and topo.get("global_batch"):
                sample_pos = int(nbatch_done) * int(topo["global_batch"])
            blob = {
                "module": self._capture_train_state(),
                "epoch": int(epoch_next),
                "nbatch": int(nbatch_done),
                "sample_position": sample_pos,
                "global_step": int(loop["gs"]),
                "metric": metric_blob,
                # rng.mx stays None: it is the JAX package's key stream, which
                # its resume restores whenever it is set
                "rng": {"numpy": np.random.get_state(), "mx": None,
                        "torch": _rnd.get_states()},
                "topology": topo,
            }
            if guard_mon is not None:
                blob["health"] = guard_mon.health_blob(loop["gs"])
            return blob

        def _after_steps(epoch, done, n_new):
            """Bookkeeping after ``n_new`` batches trained (``done`` batches of
            this epoch now trained): the fault points of each step, the guard's
            diag, a pending preemption and the interval snapshots, always on a
            group boundary, so a snapshot's state matches its cursor."""
            if _fault.configured():
                for step in range(loop["gs"] + 1, loop["gs"] + n_new + 1):
                    _fault.fire("step", step=step)
            loop["gs"] += n_new
            loop["done"] = done
            loop["epoch"] = epoch
            _tm.anatomy.on_steps(n_new)
            if fleet_hb is not None:
                fleet_hb.progress(n_new)
            if guard_mon is not None:
                rewind = False
                for t, diag in self._drain_guard_diag():
                    verdict = guard_mon.observe(t, float(diag[0]), float(diag[1]),
                                                float(diag[2]))
                    rewind = rewind or verdict == "rewind"
                # the warmed statistics back into the gate: a device scalar,
                # so a captured group reads it without a recapture
                trainer.guard_threshold = guard_mon.gate_threshold()
                if rewind:
                    raise _guard.GuardrailRewind(step=loop["gs"], epoch=epoch, nbatch=done,
                                                 reason=guard_mon.last_reason)
            if ckpt_mgr is None:
                return
            if elastic is not None:
                lost = elastic.poll()
                if lost:
                    if trainer is not None and trainer.state_sharded:
                        self.logger.info(
                            "elastic: replica(s) %s declared lost; the optimizer state is "
                            "sharded across processes and cannot be gathered without them, "
                            "so no final checkpoint: the relaunch resumes from the last "
                            "one; exiting %d for shrink-and-continue", lost,
                            _ckpt.EXIT_RESHAPE)
                        raise SystemExit(_ckpt.EXIT_RESHAPE)
                    writer = elastic.writes_final(lost)
                    if writer:
                        getattr(ckpt_mgr, "inner", ckpt_mgr).save(_capture(epoch, done),
                                                                  loop["gs"])
                    self.logger.info(
                        "elastic: replica(s) %s declared lost; checkpoint at step %d %s, "
                        "exiting %d for shrink-and-continue", lost, loop["gs"],
                        "written" if writer else "left to the lowest surviving rank",
                        _ckpt.EXIT_RESHAPE)
                    raise SystemExit(_ckpt.EXIT_RESHAPE)
            spans = _mesh.process_count() > 1
            if spans:
                # the ranks take a signal at different boundaries: they agree
                # on it first, so every rank captures at the same one (in
                # "shard" mode a capture gathers the state, a collective)
                preempt["flag"] = bool(_mesh.allreduce_sum(
                    torch.tensor([float(preempt["flag"])])).item() > 0)
            if preempt["flag"]:
                ckpt_mgr.save(_capture(epoch, done), loop["gs"])
                if spans:
                    # no rank exits (and has the launcher kill the job)
                    # before rank 0's checkpoint is on disk
                    _mesh.barrier("preempt-checkpoint")
                _C_PREEMPTED.inc()
                self.logger.info("preempted: checkpoint at step %d written, exiting %d",
                                 loop["gs"], _ckpt.EXIT_PREEMPTED)
                raise SystemExit(_ckpt.EXIT_PREEMPTED)
            if ckpt_interval and loop["gs"] - loop["last_saved"] >= ckpt_interval:
                loop["last_saved"] = loop["gs"]
                ckpt_mgr.save_async(_capture(epoch, done), loop["gs"])

        old_handlers = {}
        if ckpt_mgr is not None:
            def _on_preempt(signum, frame):
                # a flag only: the loop checkpoints at the next group boundary,
                # where the state and the iterator's position agree
                preempt["flag"] = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    old_handlers[sig] = signal.signal(sig, _on_preempt)
                except ValueError:
                    pass  # not the main thread: periodic checkpoints still work

        try:
            while True:
                try:
                    self._fit_epochs(fit_data, eval_data, eval_metric, validation_metric,
                                     begin_epoch, num_epoch, batch_end_callback,
                                     epoch_end_callback, eval_end_callback,
                                     eval_batch_end_callback, fit_k if use_multi else 1,
                                     _after_steps, ckpt_mgr, loop, _capture, resume_skip,
                                     resume_metric, loop_seek, monitor, auto_tuner)
                    break
                except _guard.GuardrailRewind as rw:
                    # -- rewind to the last good checkpoint -------------------
                    self._drain_guard_diag()
                    ckpt_mgr.wait()  # an in-flight snapshot must land first
                    state = (ckpt_mgr.load_last_good()
                             if guard_mon.rewinds < guard_mon.max_rewinds else None)
                    if state is None:
                        # budget spent (or nothing good on disk): the verdict
                        # where the watchdog looks, then stop
                        paths = _guard.write_verdict({
                            "action": "abort", "reason": rw.reason, "step": rw.step,
                            "epoch": rw.epoch, "nbatch": rw.nbatch,
                            "rewinds": guard_mon.rewinds, "budget": guard_mon.max_rewinds,
                            "last_clean_step": guard_mon.last_clean_step,
                        }, extra_dir=ckpt_mgr.directory)
                        self.logger.error(
                            "guardrail: unrecoverable anomaly at step %d (%s); rewind budget "
                            "%d/%d spent, verdict at %s, exiting %d", rw.step, rw.reason,
                            guard_mon.rewinds, guard_mon.max_rewinds, paths or "<nowhere>",
                            _guard.EXIT_GUARDRAIL)
                        raise SystemExit(_guard.EXIT_GUARDRAIL)
                    _guard.count_rewind(guard_mon)
                    if _fault.configured():
                        # the target is chosen, nothing restored yet: a kill
                        # here must leave a relaunch able to recover
                        _fault.fire("rewind", step=rw.step)
                    begin_epoch, resume_skip, gs0, resume_metric = _restore_from_state(state)
                    loop_seek["sample_position"] = None  # the rewind skips past the trip
                    guard_mon.restore(state.get("health"))
                    trainer.guard_threshold = guard_mon.gate_threshold()
                    if begin_epoch == rw.epoch:
                        # skip past the batch that tripped the detector
                        resume_skip = max(resume_skip, rw.nbatch)
                    self.logger.warning(
                        "guardrail: rewound to last-good step %d (epoch %d) after anomaly at "
                        "step %d; re-entering at batch %d (%d/%d rewinds spent)", gs0,
                        begin_epoch, rw.step, resume_skip, guard_mon.rewinds,
                        guard_mon.max_rewinds)
                    # seek_epoch keeps the epoch counter (and with it the
                    # shuffle order); reset() for order-free sources
                    if hasattr(fit_data, "seek_epoch"):
                        fit_data.seek_epoch(begin_epoch)
                    else:
                        fit_data.reset()
                    loop.update(gs=gs0, done=resume_skip, epoch=begin_epoch, last_saved=gs0)
        finally:
            for sig, handler in old_handlers.items():
                try:
                    signal.signal(sig, handler)
                except ValueError:
                    pass
            if ckpt_mgr is not None:
                ckpt_mgr.wait()
            if own_hb is not None:
                own_hb.stop()

    def _drain_guard_diag(self):
        """Guard diag samples queued since the last drain (none on the
        executor path; Module overrides it for the fused path)."""
        return []

    def _note_op_costs(self, train_data):
        """The bound symbol's per-op analytic cost table into the telemetry
        JSONL once a fit (``type=op_costs``); perf_doctor ranks its
        memory-bound ops as kernel candidates. Advisory: a symbol-less
        module or a shapeless iterator is skipped."""
        if not _tm.anatomy.enabled():
            return
        try:
            sym = getattr(self, "symbol", None)
            if sym is None:
                return
            shapes = {desc[0]: tuple(desc[1])
                      for desc in list(getattr(train_data, "provide_data", None) or [])
                      + list(getattr(train_data, "provide_label", None) or [])}
            if not shapes:
                return
            _tm.anatomy.note_op_costs(_tm.costmodel.analytic_op_costs(sym, **shapes))
        except Exception:  # noqa: BLE001 — advisory only
            pass

    def _fit_epochs(self, train_data, eval_data, eval_metric, validation_metric, begin_epoch,
                    num_epoch, batch_end_callback, epoch_end_callback, eval_end_callback,
                    eval_batch_end_callback, fit_k, _after_steps, ckpt_mgr, loop, _capture,
                    resume_skip, resume_metric, loop_seek=None, monitor=None, auto_tuner=None):
        """The epoch loop of :meth:`fit` (split out so that fit's signal
        handlers and rewind loop stay readable)."""
        _tm.anatomy.begin_loop()
        self._note_op_costs(train_data)

        def _k():
            # the auto tuner's depth is live (it grows between groups); a
            # fixed MXNET_FIT_MULTISTEP=K never changes
            return auto_tuner.k if auto_tuner is not None else fit_k

        def _single(epoch, nbatch, data_batch, local_vars):
            if monitor is not None:
                monitor.tic()
            with _tm.span("fit.step", epoch=epoch, nbatch=nbatch):
                t0 = time.perf_counter()
                self.forward_backward(data_batch)
                self.update()
                _H_STEP_SECONDS.observe(time.perf_counter() - t0, epoch=str(epoch))
            if _tm.enabled():
                _tm.sample_device_memory()
            self.update_metric(eval_metric, data_batch.label)
            if monitor is not None:
                monitor.toc_print()
            _fire(batch_end_callback, epoch, nbatch, eval_metric, local_vars)
            _after_steps(epoch, nbatch + 1, 1)

        def _flush_group(pending, epoch):
            def _cb_locals(nbatch, data_batch):
                # the single-step path's locals keys, for callbacks that
                # read locals["self"] or locals["data_batch"]
                return dict(self=self, train_data=train_data, data_batch=data_batch,
                            epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                            monitor=monitor)

            if len(pending) < _k():
                # a partial trailing group: the single-step path
                for nbatch, db in pending:
                    _single(epoch, nbatch, db, _cb_locals(nbatch, db))
                return
            with _tm.span("fit.step_group", epoch=epoch, k=len(pending)):
                t0 = time.perf_counter()
                steps = self.update_multi([db for _, db in pending])
                dt = time.perf_counter() - t0
            if _tm.enabled():
                # the amortized cost a step, comparable with the single path's
                for _ in pending:
                    _H_STEP_SECONDS.observe(dt / len(pending), epoch=str(epoch))
                _tm.sample_device_memory()
            for (nbatch, db), outs in zip(pending, steps):
                self._install_step_outputs(outs)
                self.update_metric(eval_metric, db.label)
                _fire(batch_end_callback, epoch, nbatch, eval_metric, _cb_locals(nbatch, db))
            # one group is one dispatch: its step bookkeeping, and any
            # snapshot, lands on the group's boundary
            _after_steps(epoch, pending[-1][0] + 1, len(pending))
            if auto_tuner is not None:
                k_was = auto_tuner.k
                auto_tuner.after_group(len(pending))
                if auto_tuner.k != k_was:
                    # the deeper group captures anew; the old one's graph goes
                    self._fused_trainer.release_groups(auto_tuner.k)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            skip = resume_skip if epoch == begin_epoch else 0
            if skip and resume_metric is not None:
                # resumed mid-epoch: the interrupted epoch's accumulation,
                # through __dict__ so the validation_metric alias stays live
                eval_metric.__dict__.update(
                    _ckpt_loads(resume_metric, "train_state.pkl metric").__dict__)
            pos = loop_seek.pop("sample_position", None) if loop_seek else None
            if loop_seek and loop_seek.pop("resumed", False) and hasattr(train_data,
                                                                          "seek_epoch"):
                # a resumed run's source replays this epoch's order (its
                # shuffle), as the interrupted run's source did
                train_data.seek_epoch(epoch)
            if skip:
                # trained batches are skipped, never fed again: at the
                # checkpoint's sample position where the source can seek
                if pos is not None and hasattr(train_data, "seek_sample"):
                    hosts = max(1, getattr(train_data, "num_hosts", 1))
                    train_data.seek_sample(int(pos) // hosts)
                else:
                    train_data.skip(skip)
            pending = []  # (nbatch, data_batch) awaiting a K-group flush
            for nbatch, data_batch in enumerate(train_data, start=skip):
                if _fault.configured():
                    # poison injection: this batch feeds step gs + len(pending) + 1
                    mode = _fault.batch_poison(loop["gs"] + len(pending) + 1)
                    if mode:
                        data_batch = _poison_batch(data_batch, mode)
                if _k() == 1:
                    _single(epoch, nbatch, data_batch, locals())
                    continue
                if pending and any(tuple(p.shape) != tuple(d.shape)
                                   for p, d in zip(pending[0][1].data, data_batch.data)):
                    # a shape break: flush what is pending first
                    _flush_group(pending, epoch)
                    pending = []
                pending.append((nbatch, data_batch))
                if len(pending) == _k():
                    _flush_group(pending, epoch)
                    pending = []
            if pending:
                _flush_group(pending, epoch)
            # close the partial anatomy interval on the epoch boundary, so
            # its phase deltas land in the flush below
            _tm.anatomy.emit_interval(force=True)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            if _tm.enabled():
                _H_EPOCH_SECONDS.observe(time.time() - tic)
                _tm.flush()  # a metrics snapshot an epoch (JSONL + prom)
            # sync params (and multi-device aux) back to the host copies
            arg_now, aux_now = self.get_params()
            self.set_params(arg_now, aux_now)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_now, aux_now)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            if ckpt_mgr is not None and loop["gs"] > loop["last_saved"]:
                # the epoch-end snapshot: epoch + 1, batch 0, so a resume
                # starts the next epoch cleanly; in the background
                loop["last_saved"] = loop["gs"]
                ckpt_mgr.save_async(_capture(epoch + 1, 0), loop["gs"])
            train_data.reset()

    # -- symbol and params -------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        self.init_params(initializer=None, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def save_params(self, fname):
        """``arg:`` / ``aux:`` arrays in the dmlc ``.params`` bytes, written
        atomically (a crash mid-write leaves the previous file)."""
        from ..resilience.checkpoint import atomic_file

        arg_params, aux_params = self.get_params()
        blob = {"arg:" + k: v for k, v in arg_params.items()}
        blob.update({"aux:" + k: v for k, v in aux_params.items()})
        with atomic_file(fname) as f:
            nd._save_fileobj(f, blob)

    def load_params(self, fname):
        split = {"arg": {}, "aux": {}}
        for key, value in nd.load(fname).items():
            kind, _, name = key.partition(":")
            if kind not in split or not name:
                raise ValueError("Invalid param file " + fname)
            split[kind][name] = value
        self.set_params(split["arg"], split["aux"])

    # -- computation interface ---------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError(
            "%s does not take a Monitor; Module, BucketingModule, "
            "SequentialModule and MutableModule do" % type(self).__name__)
