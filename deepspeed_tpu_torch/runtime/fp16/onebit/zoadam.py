"""ZeroOneAdam, 0/1 Adam (the port of
``deepspeed_tpu/runtime/fp16/onebit/zoadam.py``; reference
``runtime/fp16/onebit/zoadam.py:363``), with JAX's two phases:

* variance warmup (``count <= var_freeze_step``): every step the local
  momentum goes through the 1-bit all-reduce, and the variance refreshes
  every ``var_update_scaler``-th step from the synced momentum (JAX's
  stated deviation from the reference, which refreshes it from dense
  gradients);
* local steps: the variance is frozen, and the ranks sync only every
  ``interval`` steps, the interval doubling every ``local_step_scaler``
  steps up to ``2**local_step_clipper``.  Between syncs each rank steps on
  its own momentum and records its applied updates in ``acc`` (and the
  summed lr in ``lrs``); a sync undoes the local drift, averages the
  accumulated update in momentum units through the 1-bit all-reduce,
  applies the average and takes the synced momentum from it (the
  reference's ``momentum_accumulator`` reconcile, ``zoadam.py:244-265``).
  After every sync the replicas agree again, to rounding.

Every leaf shares the step's phase, so ``vc`` and ``lrs`` (one value a
leaf in JAX) are the same for every leaf; they are kept per leaf, as in
JAX's state, and ``acc`` flat like the master.
"""

import numpy as np
import torch

from .common import OnebitTransform


class ZeroOneAdam(OnebitTransform):

    name = "ZeroOneAdam"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, var_freeze_step=100000,
                 var_update_scaler=16, local_step_scaler=32678,
                 local_step_clipper=16, cuda_aware=False,
                 comm_backend_name="nccl", lr_fn=None, **_):
        super().__init__(lr, betas, eps, weight_decay, lr_fn)
        self.var_freeze_step = var_freeze_step
        self.var_update_scaler = var_update_scaler
        self.local_step_scaler = local_step_scaler
        self.local_step_clipper = local_step_clipper

    def init_extra(self, target, leaves):
        z = lambda: torch.zeros(len(leaves), dtype=torch.float32,
                                device=target.device)
        return {"vc": z(), "acc": torch.zeros_like(target,
                                                   dtype=torch.float32),
                "lrs": z()}

    def sync_due(self, count):
        """Whether step ``count`` of the local phase communicates."""
        past = max(count - self.var_freeze_step, 0)
        expo = min(past // max(1, self.local_step_scaler),
                   self.local_step_clipper)
        return count % (1 << expo) == 0

    def update(self, g, state, p, count, lr, group, n):
        b1, b2 = self.betas
        eps, wd = self.eps, self.weight_decay
        m, v, x = state.exp_avg, state.exp_avg_sq, state.extra
        warm = count <= self.var_freeze_step
        var_due = warm and (count - 1) % max(1, self.var_update_scaler) == 0
        x["vc"] += float(var_due)
        vc = float(x["vc"][0]) if len(x["vc"]) else 0.0
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        corr = float(np.float32(1.0) -
                     np.float32(b2) ** np.float32(max(vc, 1.0)))

        def denom(v_):
            return torch.sqrt(v_ / corr) + eps

        if warm:
            m.copy_(self.compressed_mean(b1 * m + (1 - b1) * g, state,
                                         group))
            if var_due:
                v.copy_(b2 * v + (1 - b2) * m * m)
            upd = (m / bc1) / denom(v) + wd * p
            p.copy_(p - lr * upd)
            x["acc"].zero_()
            x["lrs"].zero_()
            return
        m_loc = b1 * m + (1 - b1) * g
        upd = (m_loc / bc1) / denom(v) + wd * p
        p_loc = p - lr * upd
        acc = x["acc"] - lr * upd
        lrs = float(np.float32(float(x["lrs"][0]) if len(x["lrs"]) else 0.0)
                    + np.float32(lr))
        if not self.sync_due(count):
            p.copy_(p_loc)
            m.copy_(m_loc)
            x["acc"].copy_(acc)
            x["lrs"].fill_(lrs)
            return
        p_undo = p_loc - acc
        lrs_safe = max(lrs, 1e-30)
        d = denom(v)
        q = -(acc * d / lrs_safe) * bc1
        m_sync = self.compressed_mean(q, state, group)
        p.copy_(p_undo - float(np.float32(lrs_safe) / np.float32(bc1)) *
               m_sync / d)
        m.copy_(m_sync)
        x["acc"].zero_()
        x["lrs"].zero_()
