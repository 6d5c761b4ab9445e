"""Fused LAMB (the port of ``deepspeed_tpu/ops/lamb.py``: ``fused_lamb``,
``FusedLamb``; reference ``deepspeed/ops/lamb/fused_lamb.py``).

LAMB = Adam's preconditioner + a per-leaf trust ratio ||p|| / ||u||,
clipped to [min_coeff, max_coeff] and 1 where either norm is 0
(``lamb.py:41-59``).  The JAX transform computes it leaf by leaf in XLA;
the port runs kernel B3 (``ops/kernels/optimizers.py:fused_lamb_step``)
over the engine's flat buffers: phase 1 for every leaf in one launch, the
ratios formed on the card, phase 2 in one launch.  The leaf partition is the
model's own (each kernel, bias and norm weight is one leaf, as in flax),
because the ratio is per leaf.
"""

from dataclasses import dataclass, field
import math

import torch

from .adam import FlatTransform, leaf_views, whole_buffer
from .kernels.optimizers import (LambTable, fused_lamb_step,
                                 fused_lamb_step_plain)


@dataclass
class ScaleByLambState:
    count: int
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    update: torch.Tensor      # fp32 scratch for u, the flat buffer's size
    table: LambTable
    lr_override: float = field(default=math.nan)
    leaves: list = None


class FusedLambTransform(FlatTransform):
    """FusedLamb on flat fp32 buffers, through kernel B3."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, max_coeff=10.0,
                 min_coeff=0.01, lr_fn=None):
        super().__init__(lr, lr_fn)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, target, leaves=None):
        """Zero moments and the u scratch shaped like the fp32 target, and
        the chunk table of its leaves on the target's device."""
        leaves = whole_buffer(target, leaves)
        zeros = lambda: torch.zeros_like(target, dtype=torch.float32)  # noqa
        return ScaleByLambState(
            count=0, exp_avg=zeros(), exp_avg_sq=zeros(), update=zeros(),
            table=LambTable(leaves, device=target.device), leaves=leaves)

    def _apply(self, grad, state, target, param_out, grad_scale, use_kernel,
               count, lr):
        hyper = dict(lr=lr, beta1=self.betas[0], beta2=self.betas[1],
                     eps=self.eps, weight_decay=self.weight_decay,
                     count=count, bias_correction=self.bias_correction,
                     max_coeff=self.max_coeff, min_coeff=self.min_coeff,
                     grad_scale=grad_scale)
        if use_kernel:
            return fused_lamb_step(grad, target, state.exp_avg,
                                   state.exp_avg_sq, state.update, param_out,
                                   table=state.table, **hyper)
        g, p, m, v, out, u = leaf_views(state, grad, target, state.exp_avg,
                                        state.exp_avg_sq, param_out,
                                        state.update)
        return fused_lamb_step_plain(g, p, m, v, out, u, **hyper)


def fused_lamb(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
               bias_correction=True, max_coeff=10.0, min_coeff=0.01,
               lr_fn=None):
    """Reference FusedLamb semantics incl. trust-ratio clamping (max_coeff /
    min_coeff match ``deepspeed/ops/lamb/fused_lamb.py`` defaults)."""
    return FusedLambTransform(lr=lr, betas=betas, eps=eps,
                              weight_decay=weight_decay,
                              bias_correction=bias_correction,
                              max_coeff=max_coeff, min_coeff=min_coeff,
                              lr_fn=lr_fn)


# Reference import-surface alias (``deepspeed/ops/lamb``).
FusedLamb = fused_lamb
