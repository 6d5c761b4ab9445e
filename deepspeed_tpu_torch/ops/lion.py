"""Fused Lion and SGD (the port of ``deepspeed_tpu/ops/lion.py``:
``fused_lion``, ``FusedLion``, ``sgd``; reference
``csrc/lion/multi_tensor_lion.cu``).

Lion: the sign of the interpolated momentum, decoupled weight decay
(``lion.py:34-42``), through kernel B8 (``ops/kernels/optimizers.py:
fused_lion_step``) over the engine's flat buffers.  SGD has no kernel in
the JAX package either: it is plain PyTorch on the flat buffers.
"""

from dataclasses import dataclass, field
import math

import torch

from .adam import FlatTransform, leaf_views, whole_buffer, zeros_as
from .kernels.optimizers import fused_lion_step, fused_lion_step_plain


@dataclass
class ScaleByLionState:
    count: int
    exp_avg: torch.Tensor     # None for SGD without momentum
    lr_override: float = field(default=math.nan)
    leaves: list = None


class FusedLionTransform(FlatTransform):
    """FusedLion on flat fp32 buffers, through kernel B8."""

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0,
                 lr_fn=None):
        super().__init__(lr, lr_fn)
        self.betas = tuple(betas)
        self.weight_decay = weight_decay

    MOMENTS = ("exp_avg", )

    def init(self, target, leaves=None, device=None, pin=False):
        return ScaleByLionState(count=0, exp_avg=zeros_as(target, pin),
                                leaves=whole_buffer(target, leaves))

    def _apply(self, grad, state, target, param_out, grad_scale, use_kernel,
               count, lr):
        hyper = dict(lr=lr, beta1=self.betas[0], beta2=self.betas[1],
                     weight_decay=self.weight_decay, grad_scale=grad_scale)
        if use_kernel:
            fused_lion_step(grad, target, state.exp_avg, param_out, **hyper)
        else:
            fused_lion_step_plain(*leaf_views(state, grad, target,
                                              state.exp_avg, param_out),
                                  **hyper)


class SGDTransform(FlatTransform):
    """Plain SGD (reference maps config "sgd" to ``torch.optim.SGD``; JAX
    ``lion.py:56``): optional L2 weight decay, momentum and Nesterov, in
    plain PyTorch on the flat buffers (the gaps between leaves stay 0)."""

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0,
                 nesterov=False, lr_fn=None):
        super().__init__(lr, lr_fn)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    MOMENTS = ("exp_avg", )

    def init(self, target, leaves=None, device=None, pin=False):
        mu = None if self.momentum == 0.0 else zeros_as(target, pin)
        return ScaleByLionState(count=0, exp_avg=mu,
                                leaves=whole_buffer(target, leaves))

    def _apply(self, grad, state, target, param_out, grad_scale, use_kernel,
               count, lr):
        # plain PyTorch where the target lies (offloaded: on the host)
        g = grad.float().to(target.device)
        if grad_scale is not None:
            g = g * grad_scale.to(target.device)
        if self.weight_decay != 0.0:
            g = g + self.weight_decay * target
        d = g
        if self.momentum != 0.0:
            state.exp_avg.mul_(self.momentum).add_(g)
            d = state.exp_avg
            if self.nesterov:
                d = g + self.momentum * d
        target.sub_(torch.tensor(lr, dtype=torch.float32,
                                 device=target.device) * d)
        if param_out is not None:
            param_out.copy_(target)


def fused_lion(lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0, lr_fn=None):
    return FusedLionTransform(lr=lr, betas=betas, weight_decay=weight_decay,
                              lr_fn=lr_fn)


def sgd(lr=1e-3, momentum=0.0, weight_decay=0.0, nesterov=False,
        lr_fn=None):
    """Plain SGD (reference maps config "sgd" to torch.optim.SGD)."""
    return SGDTransform(lr=lr, momentum=momentum, weight_decay=weight_decay,
                        nesterov=nesterov, lr_fn=lr_fn)


# Reference import-surface aliases (``deepspeed/ops/lion``).
FusedLion = fused_lion
