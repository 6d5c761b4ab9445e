"""Loss scaling (the port of ``deepspeed_tpu/runtime/loss_scaler.py``;
reference ``runtime/fp16/loss_scaler.py:270``): the static scaler (bf16 and
fp32 training use it with scale 1.0), the dynamic fp16 scaler, and
``has_overflow``.

The JAX scaler's state is a pytree carried through the jitted step; here
:class:`LossScaleState` holds host values (an fp32 scale, two ints), and the
engine updates it once per boundary after reading the overflow flag.  The
update rules are the JAX package's (``loss_scaler.py:74-100``): on overflow
the hysteresis counts down and, once it runs out, the scale divides by
``scale_factor`` (not below ``min_scale``) and the hysteresis resets; after
``scale_window`` overflow-free steps in a row the scale multiplies by
``scale_factor``.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class LossScaleState:
    scale: float              # an fp32 value
    growth_tracker: int       # consecutive non-overflow steps
    hysteresis: int           # remaining tolerated overflows before shrink


def _f32(x):
    return float(np.float32(x))


class StaticLossScaler:
    """Reference ``LossScaler``: a fixed scale that never updates (an
    overflowing step is still skipped)."""

    def __init__(self, scale=1.0):
        self.static_scale = float(scale)
        self.dynamic = False

    def init(self):
        return LossScaleState(scale=_f32(self.static_scale), growth_tracker=0,
                              hysteresis=1)

    def update(self, state, overflow):
        return state

    def skip_on_overflow(self):
        return True


class DynamicLossScaler(StaticLossScaler):
    """Reference ``DynamicLossScaler``: double every ``scale_window``
    overflow-free steps; on overflow consume hysteresis, then halve."""

    def __init__(self, init_scale=2**16, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis
        self.dynamic = True

    def init(self):
        return LossScaleState(scale=_f32(self.static_scale), growth_tracker=0,
                              hysteresis=self.delayed_shift)

    def update(self, state, overflow):
        """The next state after a boundary with or without ``overflow``."""
        if overflow:
            hysteresis = state.hysteresis - 1
            if hysteresis <= 0:
                scale = _f32(max(_f32(state.scale / self.scale_factor),
                                 _f32(self.min_scale)))
                return LossScaleState(scale=scale, growth_tracker=0,
                                      hysteresis=self.delayed_shift)
            return replace(state, growth_tracker=0, hysteresis=hysteresis)
        tracker = state.growth_tracker + 1
        scale = state.scale
        if tracker >= self.scale_window:
            scale, tracker = _f32(state.scale * self.scale_factor), 0
        hysteresis = (state.hysteresis if self.consecutive_hysteresis
                      else self.delayed_shift)
        return LossScaleState(scale=scale, growth_tracker=tracker,
                              hysteresis=hysteresis)


def has_overflow(grads):
    """True (a 0-dim bool tensor) when any gradient holds a non-finite
    value; the engine calls it on the unscaled gradients when fp16 or the
    finite-grad guard is on."""
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in grads]
    if not flags:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack(flags).any()


def create_loss_scaler(fp16_enabled, loss_scale=0.0, dynamic_args=None):
    """Factory mirroring reference ``CreateLossScaler``
    (``loss_scaler.py:115``): bf16/fp32 get the static scale 1.0; fp16 a
    static ``loss_scale`` when it is > 0, else the dynamic scaler from
    ``dynamic_args`` (``init_scale``, ``scale_window``, ``min_scale``,
    ``delayed_shift``)."""
    if not fp16_enabled:
        return StaticLossScaler(1.0)
    if loss_scale and loss_scale > 0:
        return StaticLossScaler(loss_scale)
    args = dynamic_args or {}
    return DynamicLossScaler(
        init_scale=args.get("init_scale", 2**16),
        scale_window=args.get("scale_window", 1000),
        min_scale=args.get("min_scale", 1.0),
        delayed_shift=args.get("delayed_shift", 1),
    )
