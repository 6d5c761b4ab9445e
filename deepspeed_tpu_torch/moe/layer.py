"""The MoE layer (the port of ``deepspeed_tpu/moe/layer.py``; reference
``deepspeed/moe/layer.py:17``).

``MoE(hidden_size, num_experts=8, k=1, ...)`` wraps the experts and owns
the gate; ``forward(x)`` returns ``(output, l_aux, exp_counts)`` as the
reference's.  The gate runs in fp32 (JAX ``layer.py:49-54``).  Noise:
with ``noisy_gate_policy="Jitter"`` the gate's input is multiplied by
uniform noise in [1 - 1e-2, 1 + 1e-2], with ``"RSample"`` top-1 selection
adds Gumbel noise; both only in training and only from a
``torch.Generator`` (JAX's ``gating`` rng): the one the caller passes, else
``gating_generator``, which an engine with the ``moe`` block on sets
(seeded from ``moe.gating_seed``, else the config's ``seed``, and reseeded
at each micro-step), so a run without one is deterministic.
``use_residual`` is
PR-MoE: a dense expert beside the MoE, mixed by a learned 2-way softmax
coefficient.

Expert parallelism: the layer gates over the global batch and exchanges
the dispatched buffer through :func:`..moe.engine.dispatch_combine` (its
docstring has the collectives); at ep > 1 this rank computes its
``E / ep`` experts.
"""

import torch
from torch import nn

from ..accelerator import full_fp32_matmul
from . import engine as moe_engine
from .experts import Dense, ExpertFFN, Experts
from .sharded_moe import TopKGate

JITTER_EPS = 1e-2


class MoE(nn.Module):
    """Parameters under JAX's names: ``gate.kernel`` [D, E] (fp32, no
    bias), ``deepspeed_moe.experts.*`` the stacks, and with
    ``use_residual`` ``residual_mlp.*`` and ``coefficient.{kernel,bias}``
    [D, 2], [2]."""

    def __init__(self, hidden_size, num_experts=8, expert_module=ExpertFFN,
                 expert_kwargs=None, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, drop_tokens=True,
                 use_residual=False, dtype="float32", device=None):
        super().__init__()
        if noisy_gate_policy not in (None, "Jitter", "RSample"):
            raise ValueError(f"noisy_gate_policy {noisy_gate_policy!r}: "
                             "None, 'Jitter' or 'RSample'")
        D = hidden_size
        self.hidden_size = D
        self.num_experts = num_experts
        self.k = k
        self.noisy_gate_policy = noisy_gate_policy
        self.use_residual = use_residual
        kwargs = expert_kwargs or {"hidden_size": D,
                                   "intermediate_size": 4 * D,
                                   "dtype": dtype}
        self.gate = Dense(D, num_experts, bias=False, device=device)
        self.gating = TopKGate(k=k, capacity_factor=capacity_factor,
                               eval_capacity_factor=eval_capacity_factor,
                               min_capacity=min_capacity,
                               noisy_gate_policy=noisy_gate_policy,
                               drop_tokens=drop_tokens)
        self.deepspeed_moe = Experts(expert_module, kwargs, num_experts,
                                     device=device)
        if use_residual:
            self.residual_mlp = expert_module(**kwargs, device=device)
            self.coefficient = Dense(D, 2, device=device)
        self.gating_generator = None

    def forward(self, x, used_token=None, generator=None):
        """x: [B, S, D] or [T, D] → (out of x's shape, l_aux, exp_counts
        [E] over the global batch)."""
        D = self.hidden_size
        shape = x.shape
        tokens = x.reshape(-1, D)
        gate_in = tokens.float()
        if generator is None:
            generator = self.gating_generator
        noisy = self.training and generator is not None
        if noisy and self.noisy_gate_policy == "Jitter":
            u = torch.rand(gate_in.shape, generator=generator,
                           device=gate_in.device)
            gate_in = gate_in * (1.0 - JITTER_EPS + 2 * JITTER_EPS * u)
        with full_fp32_matmul():
            logits = self.gate(gate_in)
        group = moe_engine.token_group()
        l_aux, combine, dispatch, exp_counts = self.gating(
            logits, train=self.training,
            rng=generator if noisy else None, group=group)
        out = moe_engine.dispatch_combine(tokens, combine, dispatch,
                                          self.deepspeed_moe)
        if self.use_residual:
            mlp = self.residual_mlp(tokens)
            with full_fp32_matmul():
                coef = torch.softmax(self.coefficient(tokens.float()),
                                     dim=-1)
            out = (out.float() * coef[..., 0:1] +
                   mlp.float() * coef[..., 1:2]).to(out.dtype)
        return out.reshape(shape), l_aux, exp_counts

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's initializers from ``generator``: lecun-normal kernels
        (each expert's from its own fan-in), zero biases."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
        return self
