"""Training-loop callbacks of the PyTorch port (counterpart of
``mxnet_tpu/callback.py``): Speedometer, ProgressBar, do_checkpoint,
module_checkpoint and log_train_metric, with the reference's log formats
(downstream log scrapers parse them)."""
from __future__ import annotations

import logging
import sys
import time

from . import telemetry as _tm

_G_SAMPLES_PER_SEC = _tm.gauge(
    "fit.samples_per_sec", "Training throughput over the Speedometer's "
    "last window")


def _every(period, fn):
    """Epoch-end callback firing fn on each period-th (1-based) epoch."""
    period = max(1, int(period))

    def _callback(iter_no, *state):
        epoch = iter_no + 1
        if epoch % period == 0:
            fn(epoch, *state)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Checkpoint a Module every ``period`` epochs."""
    return _every(period, lambda epoch, *_s: mod.save_checkpoint(
        prefix, epoch, save_optimizer_states))


def do_checkpoint(prefix, period=1):
    """Checkpoint (symbol, args, aux) every ``period`` epochs: the
    epoch_end_callback shape fit() passes (iter_no, sym, arg, aux)."""
    from .model import save_checkpoint

    return _every(period, lambda epoch, sym, arg, aux: save_checkpoint(
        prefix, epoch, sym, arg, aux))


def log_train_metric(period, auto_reset=False):
    """Log the running training metric every ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f", param.epoch, param.nbatch,
                             name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class _Throughput:
    """Samples/sec sampled every ``frequent`` batches; owns the window
    state, epoch rollovers included."""

    def __init__(self, batch_size, frequent):
        self.batch_size = batch_size
        self.frequent = frequent
        self._since = None
        self._last_batch = 0

    def sample(self, nbatch):
        """samples/sec when a full window just closed at nbatch, else None
        (off-period batch, first window still filling, or an epoch rollover
        that restarts the window)."""
        rolled = nbatch < self._last_batch
        if not rolled and nbatch % self.frequent != 0:
            return None
        now = time.time()
        armed = self._since is not None
        elapsed = max(now - (self._since or now), 1e-12)
        n_batches = nbatch - self._last_batch
        self._since = now
        self._last_batch = nbatch
        if rolled or not armed:
            return None
        return n_batches * self.batch_size / elapsed


class Speedometer:
    """Log throughput (and the running metric, which it resets) every
    ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._meter = _Throughput(batch_size, frequent)

    def __call__(self, param):
        nbatch = param.nbatch
        speed = self._meter.sample(nbatch)
        if speed is None:
            return
        _G_SAMPLES_PER_SEC.set(speed)
        if param.eval_metric is not None:
            name_values = param.eval_metric.get_name_value()
            param.eval_metric.reset()
            for name, value in name_values:
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                             param.epoch, nbatch, speed, name, value)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec", param.epoch, nbatch,
                         speed)


class ProgressBar:
    """Render batch progress as a fixed-width terminal bar."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        done = int(round(self.bar_len * frac))
        pct = -(-100 * param.nbatch // self.total)  # ceil
        sys.stdout.write("[%s] %s%%\r" % ("=" * done + "-" * (self.bar_len - done), pct))
