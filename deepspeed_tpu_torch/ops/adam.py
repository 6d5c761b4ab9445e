"""Fused Adam/AdamW (the port of ``deepspeed_tpu/ops/adam.py:58-116``:
``fused_adam``, ``FusedAdam``, ``FusedAdamW``) over fp32 state.

The JAX transform returns updates for the engine to add; the port's
:meth:`FusedAdamTransform.step` updates the fp32 target (and the bf16 copy
of the parameters) in place, through kernel B2
(``ops/kernels/optimizers.py:fused_adam_step``: the CUDA kernel on the card,
its plain version on the CPU).  The state is the JAX one: a step ``count``,
the moments, and ``lr_override`` — NaN follows the configured lr or
schedule, anything else replaces it (``adam.py:44-55``), which is how a
write to ``optimizer.param_groups[0]["lr"]`` takes effect.  The schedule is
evaluated at the 1-based count, and the lr is used as an fp32 value.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .kernels.optimizers import fused_adam_step, fused_adam_step_plain


@dataclass
class ScaleByAdamState:
    count: int
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    lr_override: float = field(default=math.nan)


def resolve_lr(cur_lr, state):
    """The ``lr_override`` when set, else the schedule's value."""
    ov = state.lr_override
    return cur_lr if ov is None or math.isnan(ov) else ov


class FusedAdamTransform:
    """FusedAdam/FusedAdamW (reference ``ops/adam/fused_adam.py:18``) on
    flat fp32 buffers.  ``lr_fn``: optional schedule step → lr overriding
    ``lr`` (the engine wires the LR scheduler through it)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                 lr_fn=None):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.lr_fn = lr_fn

    def init(self, target):
        """Zero moments shaped like the fp32 target."""
        return ScaleByAdamState(
            count=0, exp_avg=torch.zeros_like(target, dtype=torch.float32),
            exp_avg_sq=torch.zeros_like(target, dtype=torch.float32))

    def current_lr(self, count, state):
        """The fp32 lr of the update with 1-based ``count``."""
        lr = self.lr_fn(count) if self.lr_fn is not None else self.lr
        return float(np.float32(resolve_lr(lr, state)))

    def step(self, grad, state, target, param_out=None, grad_scale=None,
             leaves=None):
        """One update, in place: ``target`` (fp32 flat master) and the
        state's moments; ``param_out`` (bf16 flat, or None) gets the new
        target.  ``grad_scale``: 0-dim fp32 tensor multiplying the
        gradient.  ``leaves``: None runs kernel B2 over the flat buffers
        (its plain version on the CPU); a list of (offset, numel) runs the
        plain version leaf by leaf on any device."""
        count = state.count + 1
        hyper = dict(lr=self.current_lr(count, state), beta1=self.betas[0],
                     beta2=self.betas[1], eps=self.eps,
                     weight_decay=self.weight_decay, count=count,
                     adam_w_mode=self.adam_w_mode,
                     bias_correction=self.bias_correction,
                     grad_scale=grad_scale)
        if leaves is None:
            fused_adam_step(grad, target, state.exp_avg, state.exp_avg_sq,
                            param_out, **hyper)
        else:
            views = lambda t: (None if t is None else  # noqa: E731
                               [t[o:o + n] for o, n in leaves])
            fused_adam_step_plain(views(grad), views(target),
                                  views(state.exp_avg),
                                  views(state.exp_avg_sq), views(param_out),
                                  **hyper)
        state.count = count


def fused_adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True, lr_fn=None):
    """FusedAdam/FusedAdamW (reference ``ops/adam/fused_adam.py:18``)."""
    return FusedAdamTransform(lr=lr, betas=betas, eps=eps,
                              weight_decay=weight_decay,
                              adam_w_mode=adam_w_mode,
                              bias_correction=bias_correction, lr_fn=lr_fn)


def fused_adamw(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                **kw):
    return fused_adam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                      adam_w_mode=True, **kw)


# Reference import-surface aliases (``deepspeed/ops/adam/fused_adam.py:18``)
FusedAdam = fused_adam
FusedAdamW = fused_adamw
