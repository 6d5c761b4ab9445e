"""OnebitAdam (the port of ``deepspeed_tpu/runtime/fp16/onebit/adam.py``;
reference ``runtime/fp16/onebit/adam.py:14``).

While ``count <= freeze_step``: exact Adam on the ranks' mean gradient.
After it: the variance is frozen and the momentum is averaged with the
1-bit error-feedback all-reduce.  No bias correction (the reference's
``p -= lr * exp_avg / (sqrt(exp_avg_sq) + eps)``).
"""

import torch

from .common import OnebitTransform


class OnebitAdam(OnebitTransform):

    name = "OnebitAdam"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, freeze_step=100, cuda_aware=False,
                 comm_backend_name="nccl", lr_fn=None, **_):
        super().__init__(lr, betas, eps, weight_decay, lr_fn)
        self.freeze_step = freeze_step

    def update(self, g, state, p, count, lr, group, n):
        b1, b2 = self.betas
        m, v = state.exp_avg, state.exp_avg_sq
        if count <= self.freeze_step:
            g_avg = self.pmean(g, group, n)
            m.copy_(b1 * m + (1 - b1) * g_avg)
            v.copy_(b2 * v + (1 - b2) * g_avg * g_avg)
        else:
            m.copy_(self.compressed_mean(b1 * m + (1 - b1) * g, state,
                                         group))
        upd = m / (torch.sqrt(v) + self.eps)
        p.copy_(p - lr * (upd + self.weight_decay * p))
