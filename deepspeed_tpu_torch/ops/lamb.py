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

Under ZeRO at more than one rank a rank holds one piece of some leaves.
The engine then sets the state's ``reduce_sums``: phase 1's sums of p·p and
u·u, one row a piece, go to it and come back as the whole leaves' sums
(summed over the ranks), and phase 2 takes its ratios from those.  With the
kernels each piece's chunk partials are summed on the card, in order and in
float64 (:func:`piece_sums`), and handed to phase 2 as one partial a piece;
nothing goes through the host.
"""

from dataclasses import dataclass, field
import math

import torch

from .adam import FlatTransform, leaf_views, whole_buffer, zeros_as
from .kernels.optimizers import (LambTable, fused_lamb_phase1,
                                 fused_lamb_phase1_plain, fused_lamb_phase2,
                                 fused_lamb_phase2_plain, fused_lamb_step,
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
    # ZeRO: [pieces, 2] local sums -> the whole leaves' sums, a row a piece
    reduce_sums: object = None


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

    def init(self, target, leaves=None, device=None, pin=False):
        """Zero moments shaped like the fp32 target; the u scratch and the
        chunk table of its leaves on ``device`` (default: the target's)."""
        leaves = whole_buffer(target, leaves)
        device = target.device if device is None else device
        return ScaleByLambState(
            count=0, exp_avg=zeros_as(target, pin),
            exp_avg_sq=zeros_as(target, pin),
            update=torch.zeros(target.shape, dtype=torch.float32,
                               device=device),
            table=LambTable(leaves, device=device), leaves=leaves)

    def _apply(self, grad, state, target, param_out, grad_scale, use_kernel,
               count, lr):
        hyper = dict(lr=lr, beta1=self.betas[0], beta2=self.betas[1],
                     eps=self.eps, weight_decay=self.weight_decay,
                     count=count, bias_correction=self.bias_correction,
                     max_coeff=self.max_coeff, min_coeff=self.min_coeff,
                     grad_scale=grad_scale)
        if state.reduce_sums is not None:
            return self._apply_sharded(grad, state, target, param_out,
                                       use_kernel, hyper)
        if use_kernel:
            return fused_lamb_step(grad, target, state.exp_avg,
                                   state.exp_avg_sq, state.update, param_out,
                                   table=state.table, **hyper)
        g, p, m, v, out, u = leaf_views(state, grad, target, state.exp_avg,
                                        state.exp_avg_sq, param_out,
                                        state.update)
        return fused_lamb_step_plain(g, p, m, v, out, u, **hyper)

    @staticmethod
    def _apply_sharded(grad, state, target, param_out, use_kernel, hyper):
        """Both phases on this rank's pieces, the trust ratios from the
        whole leaves' sums (``state.reduce_sums``)."""
        ratio_kw = {k: hyper.pop(k) for k in ("lr", "max_coeff",
                                              "min_coeff")}
        table = state.table
        if use_kernel and state.update.is_cuda:
            partials = fused_lamb_phase1(grad, target, state.exp_avg,
                                         state.exp_avg_sq, state.update,
                                         table, **hyper)
            sums = state.reduce_sums(piece_sums(partials, table))
            # phase 2 sums a piece's partials in order: one partial a piece
            partials.zero_()
            partials[table.leaf_chunks[:-1].long()] = sums
            return fused_lamb_phase2(target, state.update, param_out, table,
                                     partials, **ratio_kw)
        g, p, m, v, out, u = leaf_views(state, grad, target, state.exp_avg,
                                        state.exp_avg_sq, param_out,
                                        state.update)
        sums = state.reduce_sums(fused_lamb_phase1_plain(g, p, m, v, u,
                                                         **hyper))
        ratios = fused_lamb_phase2_plain(p, u, out, sums, **ratio_kw)
        return torch.cat([sums, ratios[:, None]], dim=1)


def piece_sums(partials, table):
    """[pieces, 2] fp32: each piece's rows of phase 1's chunk partials
    (``table.leaf_chunks`` bounds them) summed in order in float64, on the
    partials' device and without a host sync (``unsafe``: the table's
    bounds are not checked on the host)."""
    if not table.n_leaves:
        return partials.new_zeros(0, 2)
    return torch.segment_reduce(partials[:table.n_chunks].double(), "sum",
                                offsets=table.leaf_chunks, axis=0,
                                unsafe=True).float()


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
