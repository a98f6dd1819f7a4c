"""Learning-rate schedules of the PyTorch port (counterpart of
``mxnet_tpu/lr_scheduler.py``): closed-form functions of the update count,
so a schedule can be evaluated again for any step (the fused trainer asks
for each step's lr on the host) and resumes from a saved count."""
from __future__ import annotations

import logging


class LRScheduler:
    """Maps a global update count to a learning rate. ``base_lr`` is set
    by the owning Optimizer from its ``learning_rate``."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_stage = 0

    def _stage(self, num_update):
        """How many decay boundaries lie strictly below ``num_update``."""
        raise NotImplementedError()

    def _lr_at_stage(self, k):
        raise NotImplementedError()

    def __call__(self, num_update):
        k = self._stage(num_update)
        lr = self._lr_at_stage(k)
        if k != self._last_stage:
            self._last_stage = k
            logging.info("Update[%d]: Change learning rate to %0.5e", num_update, lr)
        return lr


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(floor((num_update-1)/step)), floored at
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _stage(self, num_update):
        return max(0, num_update - 1) // self.step

    def _lr_at_stage(self, k):
        return max(self.stop_factor_lr, self.base_lr * self.factor ** k)


class MultiFactorScheduler(LRScheduler):
    """Decay by ``factor`` at each boundary of the increasing list ``step``
    (boundaries are update counts, exclusive)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list")
        if any(s < 1 for s in step):
            raise ValueError("Schedule step must be greater or equal than 1")
        if any(b >= a for a, b in zip(step[1:], step)):
            raise ValueError("Schedule step must be an increasing integer list")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor

    def _stage(self, num_update):
        return sum(1 for boundary in self.step if num_update > boundary)

    def _lr_at_stage(self, k):
        return self.base_lr * self.factor ** k
