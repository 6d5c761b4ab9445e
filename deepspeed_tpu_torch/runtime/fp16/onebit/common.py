"""What the 1-bit optimizers share (the port of
``deepspeed_tpu/runtime/fp16/onebit/common.py``).

A 1-bit optimizer takes the gradient reduction over: the engine skips its
dense all-reduce and hands each rank's own gradients to :meth:`OnebitTransform
.onebit_step`, whose leaf updates average what they need over the ranks,
exactly in warmup and with the 1-bit all-reduce after it.  The state is
JAX's ``OnebitState`` over the engine's flat fp32 buffers:

* ``exp_avg`` (JAX ``mu``) and ``exp_avg_sq`` (``nu``), replicated, flat
  like the master;
* ``worker_error`` and ``server_error``: this rank's residuals, each leaf's
  of :func:`~..comm.compressed.error_shapes` size, concatenated in leaf
  order;
* ``extra``: the optimizer's per-leaf values ({name: tensor}).

The leaf updates run in fp32, as plain PyTorch on the rank's device.  The
engine max-reduces the fp16 overflow flag over the ranks first; an
overflow leaves every piece of state as it was (JAX ``pick``).  The norm
the engine reports is that of the synced momentum (``common.py:180-184``).
"""

import math
from dataclasses import dataclass, field

import torch

from .... import comm as dist
from ....ops.adam import FlatTransform, whole_buffer
from ... import comm as rcomm


@dataclass
class OnebitState:
    count: int
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    worker_error: torch.Tensor
    server_error: torch.Tensor
    extra: dict
    lr_override: float = field(default=math.nan)
    leaves: list = None
    errors: list = None      # [(we offset, we size, se offset, se size)]
    world: int = 1


def check_compatible(engine, name):
    """JAX ``common.py:47``: ZeRO stage 0 on a pure data-parallel mesh (no
    tp, sp or pp)."""
    if engine.zero_stage > 0:
        raise ValueError(f"{name} is incompatible with ZeRO stages > 0 "
                         "(reference 1-bit optimizers have the same scope)")
    if engine.tp_world_size > 1 or engine.seq_parallel_world_size > 1 or \
            engine.pp_world_size > 1:
        raise ValueError(f"{name} requires a pure data-parallel mesh")


class OnebitTransform(FlatTransform):
    """The base of the three: ``init`` makes :class:`OnebitState`,
    :meth:`onebit_step` applies one update from this rank's gradients."""

    MOMENTS = ("exp_avg", "exp_avg_sq")
    name = "Onebit"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, lr_fn=None):
        super().__init__(lr, lr_fn)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay

    def init_extra(self, target, leaves):
        """{name: tensor} of the optimizer's own state."""
        return {}

    def init(self, target, leaves=None, device=None, pin=False, world=1):
        leaves = whole_buffer(target, leaves)
        errors, we_off, se_off = [], 0, 0
        for _, k in leaves:
            we, se = rcomm.error_shapes(k, world)
            errors.append((we_off, we, se_off, se))
            we_off += we
            se_off += se
        z = lambda n: torch.zeros(n, dtype=torch.float32,
                                  device=target.device)
        return OnebitState(
            count=0, exp_avg=torch.zeros_like(target, dtype=torch.float32),
            exp_avg_sq=torch.zeros_like(target, dtype=torch.float32),
            worker_error=z(we_off), server_error=z(se_off),
            extra=self.init_extra(target, leaves), leaves=leaves,
            errors=errors, world=world)

    def step(self, *a, **kw):
        raise TypeError(f"{self.name} steps through the engine "
                        "(onebit_step): it reduces the gradients itself")

    # ---------------------------------------------------------- helpers
    @staticmethod
    def views(state, flat):
        return [flat[o:o + k] for o, k in state.leaves]

    @staticmethod
    def pmean(g, group, n):
        """JAX ``pmean``: the sum over the ranks over n."""
        if n <= 1:
            return g
        return dist.all_reduce(g.clone(), group=group) / n

    def compressed_mean(self, flat, state, group):
        """Each leaf of ``flat`` through the 1-bit all-reduce (one set of
        collectives for all leaves); the result is a new flat buffer, and
        the state's error buffers are updated."""
        if state.world <= 1:
            return flat
        xs = self.views(state, flat)
        wes = [state.worker_error[a:a + b] for a, b, _, _ in state.errors]
        ses = [state.server_error[c:c + d] for _, _, c, d in state.errors]
        out, nwe, nse = rcomm.compressed_allreduce_many(xs, wes, ses, group)
        res = flat.clone()
        for (o, k), t in zip(state.leaves, out):
            res[o:o + k].copy_(t)
        for (a, b, c, d), w, s in zip(state.errors, nwe, nse):
            state.worker_error[a:a + b].copy_(w)
            state.server_error[c:c + d].copy_(s)
        return res

    def onebit_step(self, grad, state, target, group=None):
        """One update from this rank's fp32 gradient ``grad`` (unscaled):
        ``target`` (the fp32 master or parameters) and the state in place.
        Returns the norm of the synced momentum (a 0-dim tensor)."""
        count = state.count + 1
        lr = self.current_lr(count, state)
        self.update(grad, state, target, count, lr, group, state.world)
        state.count = count
        return torch.linalg.vector_norm(state.exp_avg)

    def update(self, g, state, p, count, lr, group, n):
        raise NotImplementedError

