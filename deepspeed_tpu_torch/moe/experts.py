"""Experts (the port of ``deepspeed_tpu/moe/experts.py``; reference
``deepspeed/moe/experts.py:13``).

JAX holds every expert in ONE vmapped flax module whose parameters carry a
leading E dimension (``experts.py:31``).  The port stores the same stacked
``[E, …]`` parameters under the same names (``deepspeed_moe.experts.fc1.
kernel`` is JAX's ``deepspeed_moe/experts/fc1/kernel``), in flax's
``[in, out]`` layout, so that a flax tree maps onto the module by joining
its path with dots, and the expert-parallel split is a slice of dimension
0: at ep > 1 the engine keeps only a rank's own experts ``[e0, e1)`` of
each stack (:meth:`Experts.localize`), and the rank computes those.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _dtype(name):
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [*stack, n_in, n_out] and ``bias``
    [*stack, n_out] kept in fp32; the product in ``dtype`` (inputs and
    parameters cast to it, as flax's ``Dense(dtype=...)``).  A stacked
    Dense takes [E', C, n_in] and the slice ``[e0, e1)`` of its stack."""

    def __init__(self, n_in, n_out, bias=True, stack=None, dtype="float32",
                 device=None):
        super().__init__()
        lead = () if stack is None else (stack, )
        self.dtype = _dtype(dtype)
        self.stacked = stack is not None
        self.kernel = nn.Parameter(torch.zeros(*lead, n_in, n_out,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(*lead, n_out, device=device))
                     if bias else None)

    def forward(self, x, experts=None):
        dt = self.dtype
        k, b = self.kernel, self.bias
        if self.stacked and experts is not None:
            k = k[experts[0]:experts[1]]
            b = None if b is None else b[experts[0]:experts[1]]
        x = x.to(dt)
        if self.stacked:
            y = torch.einsum("ecd,edf->ecf", x, k.to(dt))
            return y if b is None else y + b.to(dt)[:, None, :]
        y = x @ k.to(dt)
        return y if b is None else y + b.to(dt)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's defaults: lecun-normal kernel, zero bias."""
        fan_in = self.kernel.shape[-2]
        self.kernel.normal_(0.0, 1.0 / math.sqrt(fan_in),
                            generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class ExpertFFN(nn.Module):
    """The default expert: a 2-layer GELU MLP (flax ``nn.gelu``, the tanh
    form).  ``stack``: the number of experts of a stacked module (the
    :class:`Experts` container's), None for one MLP (PR-MoE's residual)."""

    def __init__(self, hidden_size, intermediate_size, dtype="float32",
                 stack=None, device=None):
        super().__init__()
        self.fc1 = Dense(hidden_size, intermediate_size, stack=stack,
                         dtype=dtype, device=device)
        self.fc2 = Dense(intermediate_size, hidden_size, stack=stack,
                         dtype=dtype, device=device)

    def forward(self, x, experts=None):
        return self.fc2(F.gelu(self.fc1(x, experts), approximate="tanh"),
                        experts)


class Experts(nn.Module):
    """The stack of ``num_experts`` experts: an ``expert_module`` built
    with ``stack=num_experts``; input [E', C, D] for the global experts
    ``[e0, e1)`` (default all).  ``first``: the global index of the
    stack's first expert (0 but after :meth:`localize`)."""

    def __init__(self, expert_module, expert_kwargs, num_experts,
                 device=None):
        super().__init__()
        self.num_experts = num_experts
        self.first = 0
        self.experts = expert_module(**expert_kwargs, stack=num_experts,
                                     device=device)

    def localize(self, e0, e1):
        """Keep the experts ``[e0, e1)`` of every stack (the engine's
        expert-parallel split; a no-op when already done)."""
        if self.first == e0 and all(
                p.shape[0] == e1 - e0 for p in self.experts.parameters()):
            return
        for m in self.experts.modules():
            for name, p in list(m.named_parameters(recurse=False)):
                setattr(m, name, nn.Parameter(p.data[e0:e1].clone()))
        self.first = e0

    @property
    def whole(self):
        """Whether the stack holds all ``num_experts`` (not localized)."""
        return next(self.experts.parameters()).shape[0] == self.num_experts

    def forward(self, x, experts=None):
        if experts is not None:
            experts = (experts[0] - self.first, experts[1] - self.first)
        return self.experts(x, experts)


def expert_sharding_rules():
    """JAX's partition rule for the stacks, ``{"experts/*": "ep"}``: every
    leaf under an ``experts`` scope is split over ep along dimension 0
    (the port computes its slice; ``moe/utils.py:is_moe_param`` names the
    leaves)."""
    return {"experts/*": "ep"}
