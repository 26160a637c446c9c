"""Learning-rate schedules (counterpart of
``incubator_mxnet_tpu/optimizer/lr_scheduler.py``).

A scheduler maps the optimizer's update count to a learning rate.  The
optimizer counts an update before it reads the rate, so the first
update reads ``scheduler(1)`` (``begin_num_update + 1`` after a
resume).  During the first ``warmup_steps`` updates the rate climbs
linearly from ``warmup_begin_lr`` to ``base_lr`` (``warmup_mode
"linear"``) or stays at ``base_lr`` (``"constant"``).  Plain Python
arithmetic on floats, in the JAX package's order, so both give the same
floats.

``FactorScheduler`` and ``MultiFactorScheduler`` are stateful, as in the
JAX package: a call moves ``count``/``cur_step_ind`` and ``base_lr``
forward, and a later call with a smaller ``num_update`` does not move
them back.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * \
                num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        return self.warmup_final_lr  # constant

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, down to ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor,
                               self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor once past each update count in ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind < len(self.step) and \
                num_update > self.step[self.cur_step_ind]:
            self.base_lr *= self.factor
            self.cur_step_ind += 1
        return self.base_lr


class PolyScheduler(LRScheduler):
    """From ``base_lr`` after the warm-up to ``final_lr`` at
    ``max_update``, along ``(1 - progress) ** pwr``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (frac ** self.power)


class CosineScheduler(LRScheduler):
    """From ``base_lr`` after the warm-up to ``final_lr`` at
    ``max_update``, along half a cosine."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        t = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * t)) / 2
