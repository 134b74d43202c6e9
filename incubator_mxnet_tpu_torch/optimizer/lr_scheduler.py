"""Learning-rate schedulers (counterpart of
``incubator_mxnet_tpu/optimizer/lr_scheduler.py``).

``scheduler(num_update) -> lr`` is the host schedule, with the JAX
package's state and quirks: FactorScheduler's ``count`` and
MultiFactorScheduler's ``cur_step_ind`` advance as the updates pass, and
``warmup_final_lr`` keeps the ``base_lr`` given at construction (an
optimizer's ``learning_rate`` later replaces ``base_lr`` only).

Every stock scheduler also has :meth:`LRScheduler.as_torch`, the
counterpart of ``as_jax``: the closed form ``fn(t) -> lr`` over a 0-d f32
tensor ``t`` (the update count on the device), in torch ops only, so that
a captured training step computes each step's lr from its own count with
nothing read back to the host. It is evaluated against the scheduler's
state when ``as_torch`` is called, so a stateful schedule hands off
mid-run as long as ``t`` moves forward. A custom subclass returns None;
its callers then sample the host schedule step by step.
"""
from __future__ import annotations

import math

import torch

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "LinearScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = ((self.warmup_final_lr - self.warmup_begin_lr) *
                   num_update / self.warmup_steps)
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise ValueError(self.warmup_mode)

    def _torch_warmup(self, t, main_lr):
        """`main_lr` (a 0-d f32 tensor) under the warmup ramp: the
        closed form of :meth:`get_warmup_lr`."""
        if not self.warmup_steps:
            return main_lr
        if self.warmup_mode == "linear":
            w = (self.warmup_begin_lr
                 + (self.warmup_final_lr - self.warmup_begin_lr)
                 * t / self.warmup_steps)
        elif self.warmup_mode == "constant":
            w = torch.full_like(main_lr, self.warmup_begin_lr)
        else:
            raise ValueError(self.warmup_mode)
        return torch.where(t < self.warmup_steps, w, main_lr)

    def as_torch(self):
        """The closed form ``fn(t) -> lr`` over a 0-d f32 tensor, or None
        where the schedule has none (a custom subclass)."""
        return None

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor, self.stop_factor_lr)
        return self.base_lr

    def as_torch(self):
        # the host drops once a `step` boundary crossed: floor((t - 1) /
        # step) drops in all, of which count / step are behind it already
        base, factor = float(self.base_lr), float(self.factor)
        stop, step = float(self.stop_factor_lr), int(self.step)
        done = self.count // step

        def fn(t):
            drops = torch.clamp(torch.floor((t - 1.0) / step) - done, min=0.0)
            lr = torch.clamp(base * torch.pow(factor, drops), min=stop)
            return self._torch_warmup(t, lr)
        return fn


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        assert list(step) == sorted(step)
        self.step = list(step)
        self.factor = factor
        self.cur_step_ind = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while (self.cur_step_ind < len(self.step)
               and num_update > self.step[self.cur_step_ind]):
            self.base_lr *= self.factor
            self.cur_step_ind += 1
        return self.base_lr

    def as_torch(self):
        """As :meth:`LRScheduler.as_torch`; the steps still ahead are a
        tensor on `t`'s device, made at the first call there (so a CUDA
        graph captures this after one call outside the capture)."""
        base, factor = float(self.base_lr), float(self.factor)
        remaining = self.step[self.cur_step_ind:]
        on_device = {}

        def fn(t):
            steps = on_device.get(t.device)
            if steps is None:
                steps = on_device[t.device] = torch.tensor(
                    remaining, dtype=torch.float32, device=t.device)
            drops = (t > steps).sum().to(torch.float32)
            lr = base * torch.pow(factor, drops)
            return self._torch_warmup(t, lr)
        return fn


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return (self.final_lr
                + (self.base_lr - self.final_lr) * (1 - frac) ** self.power)

    def as_torch(self):
        base, final = float(self.base_lr), float(self.final_lr)
        power, w = float(self.power), int(self.warmup_steps)
        max_update, max_steps = int(self.max_update), int(self.max_steps)

        def fn(t):
            frac = (t - w) / max_steps
            lr = final + (base - final) * torch.pow(
                torch.clamp(1.0 - frac, min=0.0), power)
            lr = torch.where(t >= max_update, final, lr)
            return self._torch_warmup(t, lr)
        return fn


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return (self.final_lr + (self.base_lr - self.final_lr) *
                (1 + math.cos(math.pi * frac)) / 2)

    def as_torch(self):
        base, final = float(self.base_lr), float(self.final_lr)
        w, max_update = int(self.warmup_steps), int(self.max_update)
        max_steps = int(self.max_steps)

        def fn(t):
            frac = (t - w) / max_steps
            lr = final + (base - final) * (1.0 + torch.cos(math.pi * frac)) / 2
            lr = torch.where(t >= max_update, final, lr)
            return self._torch_warmup(t, lr)
        return fn


class LinearScheduler(PolyScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kwargs):
        super().__init__(max_update, base_lr, pwr=1, final_lr=final_lr,
                         **kwargs)
