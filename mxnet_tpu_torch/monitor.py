"""Tensor-level training monitor of the port (counterpart of
``mxnet_tpu/monitor.py``).

Capability parity with reference ``python/mxnet/monitor.py``: install on
executors, collect a statistic of every op output whose name matches a
pattern on every ``interval``-th step, plus the matching weights at
``toc``. The reference pipes executor outputs through
Executor::SetMonitorCallback (graph_executor.cc:760); here the
executor's monitor hook (``Executor.set_monitor_callback``) feeds the
same records. A captured CUDA graph runs no callback, so a monitored
``Module`` trains on the executor path (see ``Module.install_monitor``).
Re-designed around an explicit record list and a single ``_format`` path
rather than the reference's queue/string concatenation."""
from __future__ import annotations

import logging
import re
from math import sqrt

from . import ndarray as nd
from .ndarray import NDArray


def _rms(x):
    """Default statistic: ||x||_2 / sqrt(n) — scale-free activation/
    weight magnitude."""
    return nd.norm(x) / sqrt(x.size)


class Monitor(object):
    """Collects (step, tensor_name, stat) records while activated.

    Use: ``mon.install(exe)`` once per executor, then per batch
    ``mon.tic()`` before forward and ``mon.toc()``/``toc_print()`` after.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func or _rms
        self.interval = interval
        self.sort = sort
        self._pattern = re.compile(pattern)
        self.activated = False
        self.step = 0
        self.exes = []
        self._records = []
        # bound hook the executor calls with every op output
        self.stat_helper = self._observe

    def _observe(self, name, array):
        if self.activated and self._pattern.match(name):
            self._records.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def _sync(self):
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()

    def tic(self):
        """Arm collection if this step is on the interval."""
        if self.step % self.interval == 0:
            self._sync()
            self._records = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Disarm and return [(step, name, formatted stat)] — including
        a stat of each matching weight, not just op outputs."""
        if not self.activated:
            return []
        self._sync()
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self._pattern.match(name):
                    self._records.append(
                        (self.step, name, self.stat_func(array)))
        self.activated = False
        records = sorted(self._records, key=lambda r: r[1]) if self.sort \
            else self._records
        out = [(step, name, self._format(stat))
               for step, name, stat in records]
        self._records = []
        return out

    @staticmethod
    def _format(stat):
        vals = [stat] if isinstance(stat, NDArray) else stat
        assert isinstance(vals, list)
        parts = []
        for v in vals:
            assert isinstance(v, NDArray)
            parts.append(str(v.asscalar() if v.shape == (1,) else v.asnumpy()))
        return "\t".join(parts) + "\t"

    def toc_print(self):
        for step, name, val in self.toc():
            logging.info("Batch: {:7d} {:30s} {:s}".format(step, name, val))
