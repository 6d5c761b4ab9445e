"""Fused Adam/AdamW (the port of ``deepspeed_tpu/ops/adam.py:58-116``:
``fused_adam``, ``FusedAdam``, ``FusedAdamW``) over fp32 state, and the base
the port's other optimizers share (``ops/lamb.py``, ``ops/lion.py``).

The JAX transforms return updates for the engine to add; the port's
:meth:`FlatTransform.step` updates the fp32 target (and the low-precision
copy of the parameters) in place, through a kernel of
``ops/kernels/optimizers.py`` (B2 for Adam: the CUDA kernel on the card, its
plain version on the CPU) over the engine's flat buffers.  The state is the
JAX one: a step ``count``, the moments, and ``lr_override`` — NaN follows
the configured lr or schedule, anything else replaces it
(``adam.py:44-55``), which is how a write to
``optimizer.param_groups[0]["lr"]`` takes effect.  The schedule is
evaluated at the 1-based count, and the lr is used as an fp32 value.  The
state also keeps the leaves of the flat buffer, ``[(offset, numel)]``:
the plain versions run leaf by leaf over them, and LAMB's per-leaf trust
ratio needs them.
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
    leaves: list = None


def resolve_lr(cur_lr, state):
    """The ``lr_override`` when set, else the schedule's value."""
    ov = state.lr_override
    return cur_lr if ov is None or math.isnan(ov) else ov


def pinned(t):
    """Whether ``t`` is in pinned host memory (offloaded state)."""
    return t.device.type == "cpu" and torch.cuda.is_available() and \
        t.is_pinned()


def zeros_as(target, pin=False):
    """fp32 zeros shaped like ``target`` on its device, or in pinned host
    memory when it is pinned or ``pin`` (offloaded state: the moments live
    beside the master)."""
    if pin or pinned(target):
        return torch.zeros(target.shape, dtype=torch.float32,
                           pin_memory=True)
    return torch.zeros_like(target, dtype=torch.float32)


def whole_buffer(target, leaves):
    """``leaves`` as a list of (offset, numel), or the whole buffer as one
    leaf."""
    if leaves is None:
        return [(0, target.numel())]
    return [(int(o), int(n)) for o, n in leaves]


class FlatTransform:
    """An optimizer over the engine's flat fp32 buffers: ``init(target,
    leaves)`` makes the state, ``step(grad, state, target, ...)`` applies
    one update in place.  ``lr_fn``: optional schedule step → lr overriding
    ``lr`` (the engine wires the LR scheduler through it)."""

    def __init__(self, lr, lr_fn=None):
        self.lr = lr
        self.lr_fn = lr_fn

    def current_lr(self, count, state):
        """The fp32 lr of the update with 1-based ``count``."""
        lr = self.lr_fn(count) if self.lr_fn is not None else self.lr
        return float(np.float32(resolve_lr(lr, state)))

    # the state's fields that persist between steps (offload moves them
    # with the master; scratch stays where the kernels run)
    MOMENTS = ("exp_avg", "exp_avg_sq")

    def init(self, target, leaves=None, device=None, pin=False):
        """The state for the fp32 ``target``: its moments beside it, or
        pinned on the host with ``pin`` (:func:`zeros_as`); scratch and
        tables on ``device`` (default: the target's)."""
        raise NotImplementedError

    def step(self, grad, state, target, param_out=None, grad_scale=None,
             use_kernel=True):
        """One update, in place: ``target`` (the fp32 flat master) and the
        state; ``param_out`` (the flat low-precision parameters, or None)
        gets the new target.  ``grad_scale``: 0-dim fp32 tensor multiplying
        the gradient (the clip coefficient over the loss scale), or None.
        ``use_kernel=False`` runs the kernel's plain version leaf by leaf
        on any device (``chip_smoke.py`` compares the two on the card).
        Returns what the kernel reports (LAMB: per-leaf sums and trust
        ratios), or None."""
        count = state.count + 1
        out = self._apply(grad, state, target, param_out, grad_scale,
                          use_kernel, count, self.current_lr(count, state))
        state.count = count
        return out

    def _apply(self, grad, state, target, param_out, grad_scale, use_kernel,
               count, lr):
        raise NotImplementedError


def leaf_views(state, *bufs):
    """Each flat buffer (or None) as a list of the state's leaf views."""
    return [None if t is None else [t[o:o + n] for o, n in state.leaves]
            for t in bufs]


class FusedAdamTransform(FlatTransform):
    """FusedAdam/FusedAdamW (reference ``ops/adam/fused_adam.py:18``) on
    flat fp32 buffers, through kernel B2."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                 lr_fn=None):
        super().__init__(lr, lr_fn)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def init(self, target, leaves=None, device=None, pin=False):
        """Zero moments shaped like the fp32 target."""
        return ScaleByAdamState(
            count=0, exp_avg=zeros_as(target, pin),
            exp_avg_sq=zeros_as(target, pin),
            leaves=whole_buffer(target, leaves))

    def _apply(self, grad, state, target, param_out, grad_scale, use_kernel,
               count, lr):
        hyper = dict(lr=lr, beta1=self.betas[0], beta2=self.betas[1],
                     eps=self.eps, weight_decay=self.weight_decay,
                     count=count, adam_w_mode=self.adam_w_mode,
                     bias_correction=self.bias_correction,
                     grad_scale=grad_scale)
        if use_kernel:
            fused_adam_step(grad, target, state.exp_avg, state.exp_avg_sq,
                            param_out, **hyper)
        else:
            fused_adam_step_plain(*leaf_views(
                state, grad, target, state.exp_avg, state.exp_avg_sq,
                param_out), **hyper)


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
