"""Loss scaling (the port of ``deepspeed_tpu/runtime/loss_scaler.py``): the
static scaler, which bf16 and fp32 training use with scale 1.0, and
``has_overflow``.  The dynamic fp16 scaler is ROADMAP queue A item 6."""

import torch

from ..utils.not_ported import not_ported


class StaticLossScaler:
    """Reference ``LossScaler``: a fixed scale that never updates."""

    def __init__(self, scale=1.0):
        self.cur_scale = float(scale)


def has_overflow(grads):
    """True (a 0-dim bool tensor) when any gradient holds a non-finite
    value.  No caller yet: the finite-grad guard (ROADMAP queue A item 4)
    and the fp16 overflow skip (item 6) will call it."""
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in grads]
    if not flags:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack(flags).any()


def create_loss_scaler(fp16_enabled, loss_scale=0.0, dynamic_args=None):
    """Factory mirroring reference ``CreateLossScaler``: bf16/fp32 get the
    static scale 1.0; fp16 scaling is not ported yet."""
    if fp16_enabled:
        raise not_ported("fp16 loss scaling", 6)
    return StaticLossScaler(1.0)
