"""LR schedules (the port of ``deepspeed_tpu/runtime/lr_schedules.py:20-183``;
reference ``runtime/lr_schedules.py``): LRRangeTest, OneCycle, WarmupLR,
WarmupDecayLR and WarmupCosineLR.

Each schedule is pure arithmetic, ``get_lr(step) -> float``, plus the
reference's stateful ``step()``/``get_last_lr()`` surface.  The engine hands
``get_lr`` to the optimizer, which evaluates it at its 1-based step count;
the value is rounded to fp32 where the optimizer uses it, as the JAX package
evaluates it in fp32 inside its compiled step.
"""

import math

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


class _LRSchedule:

    def __init__(self, optimizer=None):
        self.optimizer = optimizer
        self.last_batch_iteration = -1
        self._last_lr = None

    def get_lr(self, step):
        raise NotImplementedError

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = [float(self.get_lr(last_batch_iteration))]

    def get_last_lr(self):
        if self._last_lr is None:
            self.step(0)
        return self._last_lr

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_LRSchedule):
    """Reference ``lr_schedules.py:633``: warmup then constant."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        super().__init__(optimizer)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _warmup_factor(self, step):
        step = max(step, 1)
        if self.warmup_type == WARMUP_LOG_RATE:
            return min(1.0, self.inverse_log_warm_up * math.log(step))
        return min(1.0, step / self.warmup_num_steps)

    def get_lr(self, step):
        f = self._warmup_factor(step)
        return self.warmup_min_lr + (self.warmup_max_lr -
                                     self.warmup_min_lr) * f


class WarmupDecayLR(WarmupLR):
    """Reference ``:723``: warmup then linear decay to 0 at
    ``total_num_steps``."""

    def __init__(self, optimizer=None, total_num_steps=10000, **kw):
        super().__init__(optimizer, **kw)
        self.total_num_steps = total_num_steps

    def get_lr(self, step):
        if step < self.warmup_num_steps:
            f = self._warmup_factor(step)
        else:
            f = _clip((self.total_num_steps - step) /
                      max(1.0, self.total_num_steps - self.warmup_num_steps),
                      0.0, 1.0)
        return self.warmup_min_lr + (self.warmup_max_lr -
                                     self.warmup_min_lr) * f


class WarmupCosineLR(_LRSchedule):
    """Reference ``:774``: linear warmup then cosine decay to
    ``cos_min_ratio``."""

    def __init__(self, optimizer=None, total_num_steps=10000,
                 warmup_min_ratio=0.0, warmup_num_steps=1000,
                 cos_min_ratio=0.0001, warmup_type=WARMUP_LINEAR_RATE,
                 last_batch_iteration=-1, warmup_max_lr=0.001):
        super().__init__(optimizer)
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.warmup_max_lr = warmup_max_lr
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self, step):
        if step < self.warmup_num_steps:
            ratio = self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * \
                min(1.0, step / self.warmup_num_steps)
        else:
            progress = _clip((step - self.warmup_num_steps) /
                             max(1, self.total_num_steps -
                                 self.warmup_num_steps), 0.0, 1.0)
            ratio = self.cos_min_ratio + (1 - self.cos_min_ratio) * 0.5 * \
                (1.0 + math.cos(math.pi * progress))
        return self.warmup_max_lr * ratio


class OneCycle(_LRSchedule):
    """Reference ``:371``: cycle lr between min and max, then decay."""

    def __init__(self, optimizer=None, cycle_min_lr=1e-5, cycle_max_lr=1e-3,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 last_batch_iteration=-1, **unused):
        super().__init__(optimizer)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = cycle_first_step_size
        self.second = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self, step):
        total = self.first + self.second
        if step < total:
            if step < self.first:
                frac = _clip(step / self.first, 0.0, 1.0)
            else:
                frac = 1.0 - _clip((step - self.first) / self.second, 0.0,
                                   1.0)
            return self.cycle_min_lr + (self.cycle_max_lr -
                                        self.cycle_min_lr) * frac
        decay_steps = max(0.0, step - total)
        if self.decay_step_size > 0:
            decay_steps = math.floor(decay_steps / self.decay_step_size)
        return self.cycle_min_lr / (1.0 + self.decay_lr_rate * decay_steps)


class LRRangeTest(_LRSchedule):
    """Reference ``:273``: sweep lr for tuning."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self, step):
        interval = (math.floor(step / self.step_size) if self.staircase
                    else step / self.step_size)
        return self.min_lr * (1.0 + self.step_rate * interval)


VALID_LR_SCHEDULES = {
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
}


def get_lr_scheduler(name, params, optimizer=None):
    if name not in VALID_LR_SCHEDULES:
        raise ValueError(f"unknown lr schedule {name!r}; valid: "
                         f"{sorted(VALID_LR_SCHEDULES)}")
    return VALID_LR_SCHEDULES[name](optimizer=optimizer, **(params or {}))
