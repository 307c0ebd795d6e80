"""Learning-rate schedulers (counterpart of ``hetu_tpu/lr_scheduler.py``).

The same classes and the same stateful ``step()``/``get()`` surface. The
executor reads a schedule through ``get_traced(step)``: here a plain
function of the step that returns a host float, where the JAX package
traces it into the step's program. It computes in float32, as the JAX
package's traced form does, so both packages hand the optimizer the same
float32 learning rate at every step.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


class FixedScheduler:
    def __init__(self, learning_rate):
        if learning_rate < 0:
            raise ValueError(f"learning_rate must be >= 0, got "
                             f"{learning_rate}")
        self.learning_rate = learning_rate
        self.step_count = 0

    def step(self):
        self.step_count += 1
        return self.get()

    def get(self):
        return self.learning_rate

    def get_traced(self, step) -> float:
        """The learning rate at ``step``, a float32 value as a host float."""
        return float(_f32(self.learning_rate))


class StepScheduler(FixedScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, ending=1e-8):
        super().__init__(learning_rate)
        if step_size <= 0:
            raise ValueError(f"step_size must be > 0, got {step_size}")
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.ending = float(ending)

    def get(self):
        lr = self.learning_rate * self.gamma ** (self.step_count // self.step_size)
        return max(lr, self.ending)

    def get_traced(self, step) -> float:
        k = _f32(int(step) // self.step_size)
        lr = _f32(self.learning_rate) * _f32(self.gamma) ** k
        return float(max(lr, _f32(self.ending)))


class MultiStepScheduler(FixedScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1):
        super().__init__(learning_rate)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def get(self):
        k = sum(1 for m in self.milestones if self.step_count >= m)
        return self.learning_rate * self.gamma ** k

    def get_traced(self, step) -> float:
        k = sum(1 for m in self.milestones if int(step) >= m)
        return float(_f32(self.learning_rate) * _f32(self.gamma) ** _f32(k))


class ExponentialScheduler(FixedScheduler):
    def __init__(self, learning_rate, gamma=0.9, ending=1e-8):
        super().__init__(learning_rate)
        self.gamma = float(gamma)
        self.ending = float(ending)

    def get(self):
        return max(self.learning_rate * self.gamma ** self.step_count, self.ending)

    def get_traced(self, step) -> float:
        lr = _f32(self.learning_rate) * _f32(self.gamma) ** _f32(step)
        return float(max(lr, _f32(self.ending)))


class CosineScheduler(FixedScheduler):
    """Cosine decay to ``ending`` over ``decay_steps``, after an optional
    linear warm-up of ``warmup_steps``."""

    def __init__(self, learning_rate, decay_steps, ending=0.0, warmup_steps=0):
        super().__init__(learning_rate)
        self.decay_steps = int(decay_steps)
        self.ending = float(ending)
        self.warmup_steps = int(warmup_steps)

    def get(self):
        return self.get_traced(self.step_count)

    def get_traced(self, step) -> float:
        step_f = _f32(step)
        warm = (min(step_f / _f32(max(self.warmup_steps, 1)), _f32(1.0))
                if self.warmup_steps > 0 else _f32(1.0))
        frac = min(max(step_f / _f32(max(self.decay_steps, 1)), _f32(0.0)),
                   _f32(1.0))
        # the cosine of the float32 argument, correctly rounded to float32
        # (as XLA's float32 cosine gives it; numpy's float32 cosine is an
        # ulp off in places)
        c = _f32(np.cos(np.float64(_f32(np.pi) * frac)))
        cos = _f32(0.5) * (_f32(1.0) + c)
        lr = _f32(self.ending) + (_f32(self.learning_rate)
                                  - _f32(self.ending)) * cos
        return float(warm * lr)


class ReduceOnPlateauScheduler(FixedScheduler):
    """Lowers the rate by ``factor`` when the value passed to ``step``
    stops improving for ``patience`` steps. It depends on those values,
    not on the step: ``get_traced`` is the current rate."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, ending=1e-8):
        super().__init__(learning_rate)
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode must be 'rel' or 'abs', got "
                             f"{threshold_mode!r}")
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.ending = float(ending)
        self.best = None
        self.num_bad = 0
        self.cooldown_count = 0
        self.cur_lr = learning_rate

    def _better(self, value):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            delta = self.threshold * abs(self.best)
        else:
            delta = self.threshold
        return value < self.best - delta if self.mode == "min" \
            else value > self.best + delta

    def step(self, value):
        self.step_count += 1
        if self._better(value):
            self.best = value
            self.num_bad = 0
        elif self.cooldown_count > 0:
            self.cooldown_count -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.cur_lr = max(self.cur_lr * self.factor, self.ending)
                self.num_bad = 0
                self.cooldown_count = self.cooldown
        return self.cur_lr

    def get(self):
        return self.cur_lr

    def get_traced(self, step) -> float:
        return float(_f32(self.cur_lr))
