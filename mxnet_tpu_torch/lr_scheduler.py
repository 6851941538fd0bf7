"""Learning-rate schedulers (counterpart of `mxnet_tpu/lr_scheduler.py`;
reference: python/mxnet/lr_scheduler.py). Pure host arithmetic: a
scheduler maps the update count to a learning rate, which the optimizer
(`optimizer.Optimizer(lr_scheduler=...)`) reads before each update."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmUpScheduler"]


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
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        return self.warmup_final_lr * (num_update / max(self.warmup_steps, 1)) ** 2

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates, floored at stop_factor_lr."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = (num_update - self.warmup_steps) // self.step
        return max(self.base_lr * (self.factor ** n), self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each step milestone."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.steps = sorted(step)
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.steps:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        span = max(self.max_update - self.warmup_steps, 1)
        t = min(num_update - self.warmup_steps, span) / span
        return self.final_lr + (self.base_lr - self.final_lr) * (1 - t) ** self.power


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        span = max(self.max_update - self.warmup_steps, 1)
        t = min(num_update - self.warmup_steps, span) / span
        return self.final_lr + (self.base_lr - self.final_lr) \
            * (1 + math.cos(math.pi * t)) / 2


class WarmUpScheduler(LRScheduler):
    """Linear warmup wrapped around any base scheduler (reference:
    gluonnlp-style WarmUpScheduler; upstream schedulers take
    warmup_steps inline — this is the composable form): lr ramps
    0 -> base over `warmup_steps`, then delegates."""

    def __init__(self, base_scheduler, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear", **kwargs):
        if getattr(base_scheduler, "warmup_steps", 0):
            raise ValueError(
                "WarmUpScheduler: base scheduler already has "
                "warmup_steps — composing two warmups would dip the lr "
                "right after the outer ramp ends")
        base_lr = getattr(base_scheduler, "base_lr", 0.01)
        super().__init__(base_lr=base_lr, warmup_steps=int(warmup_steps),
                         warmup_begin_lr=warmup_begin_lr,
                         warmup_mode=warmup_mode)
        self.base_scheduler = base_scheduler

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)   # base-class ramp
        return self.base_scheduler(num_update - self.warmup_steps)
