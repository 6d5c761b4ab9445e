"""OnebitLamb (the port of ``deepspeed_tpu/runtime/fp16/onebit/lamb.py``;
reference ``runtime/fp16/onebit/lamb.py:447``).

Warmup: exact LAMB, each leaf's trust ratio ‖p‖/‖u‖ clipped to
``[min_coeff, max_coeff]``.  After ``freeze_step``: the momentum goes
through the 1-bit all-reduce and each leaf's trust ratio stays at its last
warmup value (``extra["coeff"]``).
"""

import torch

from .common import OnebitTransform


class OnebitLamb(OnebitTransform):

    name = "OnebitLamb"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, freeze_step=100, max_coeff=10.0,
                 min_coeff=0.01, cuda_aware=False, comm_backend_name="nccl",
                 lr_fn=None, **_):
        super().__init__(lr, betas, eps, weight_decay, lr_fn)
        self.freeze_step = freeze_step
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init_extra(self, target, leaves):
        # the frozen scaling coefficient of each leaf, 1 to start
        return {"coeff": torch.ones(len(leaves), dtype=torch.float32,
                                    device=target.device)}

    def update(self, g, state, p, count, lr, group, n):
        b1, b2 = self.betas
        m, v = state.exp_avg, state.exp_avg_sq
        warm = count <= self.freeze_step
        if warm:
            g_avg = self.pmean(g, group, n)
            m.copy_(b1 * m + (1 - b1) * g_avg)
            v.copy_(b2 * v + (1 - b2) * g_avg * g_avg)
        else:
            m.copy_(self.compressed_mean(b1 * m + (1 - b1) * g, state,
                                         group))
        u = m / (torch.sqrt(v) + self.eps) + self.weight_decay * p
        coeff = state.extra["coeff"]
        if warm:
            for i, (o, k) in enumerate(state.leaves):
                pl, ul = p[o:o + k], u[o:o + k]
                p_norm = torch.sqrt(torch.sum(pl * pl))
                u_norm = torch.sqrt(torch.sum(ul * ul))
                ratio = torch.where(
                    (p_norm > 0) & (u_norm > 0),
                    torch.clamp(p_norm / u_norm, self.min_coeff,
                                self.max_coeff),
                    torch.ones_like(p_norm))
                coeff[i] = ratio
        for i, (o, k) in enumerate(state.leaves):
            p[o:o + k] = p[o:o + k] - lr * coeff[i] * u[o:o + k]
