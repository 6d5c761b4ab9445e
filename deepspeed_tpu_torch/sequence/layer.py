"""Ulysses sequence parallelism (the port of
``deepspeed_tpu/sequence/layer.py``; reference ``deepspeed/sequence/
layer.py``: ``DistributedAttention`` ``:300``, ``single_all_to_all``
``:182``).

The model runs with the sequence split over the sp group: rank q holds
positions ``[q·S/sp, (q+1)·S/sp)``.  Around attention an all-to-all
reshards from sequence-split to head-split (each rank holds the whole
sequence for H/sp heads), the local attention runs, and the inverse
all-to-all restores the sequence split.  The all-to-alls are
``comm/functional.py:all_to_all`` over the sp group, whose backward is the
inverse all-to-all.  The causal mask applies after the first one, over
the whole sequence.

The local attention is ``ops/attention.py:attention_core``: kernel B1 on
the card, the plain version on the CPU.  The JAX package's Ulysses calls
its XLA attention there even on a TPU (``layer.py:36``); both compute the
same function (ROADMAP queue C, facts).

GQA and uneven heads (reference ``uneven_heads_all2all`` ``:72-196``): q
heads are zero-padded to the next multiple of sp and sliced back after the
inverse all-to-all; kv heads are routed, not gathered: each rank builds,
from its sequence chunk, the kv head every destination rank's q block
needs, and one all-to-all delivers exactly those, so kv after the reshard
is [B, S, H_local, D] like q.  The routing tables are computed on the host
from (H, n_kv, sp), as JAX computes them at trace time.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..comm.functional import all_to_all
from ..ops.attention import attention_core
from ..utils import groups


def _default_attention(q, k, v, causal=True, softmax_scale=None, window=0,
                       use_kernel=True):
    """The local core over [B, S, H, D] blocks with matched head counts."""
    return attention_core(q, k, v, causal=causal,
                          softmax_scale=softmax_scale, window=window,
                          use_kernel=use_kernel)


def single_all_to_all(x, scatter_idx, gather_idx, group):
    """Reference ``:182``: scatter ``scatter_idx`` over the group, gather
    ``gather_idx`` (differentiable)."""
    return all_to_all(x, group, scatter_idx, gather_idx)


class DistributedAttention:
    """Reference ``DistributedAttention`` (``sequence/layer.py:300``).

    ``local_attention``: callable (q, k, v, **kw) → out on [B, S, H, D]
    blocks.  ``sequence_process_group``: the group the sequence is split
    over (default: the mesh's sp group, looked up at each call).  Call it
    on the rank's sequence chunk, [B, S/sp, H, D] q and [B, S/sp, n_kv, D]
    kv (kv at its own width: GQA is aligned inside)."""

    def __init__(self, local_attention=None, sequence_process_group=None,
                 scatter_idx=2, gather_idx=1):
        self.local_attn = local_attention or _default_attention
        self.group = sequence_process_group
        self.scatter_idx = scatter_idx  # head dim of [B, S, H, D]
        self.gather_idx = gather_idx    # sequence dim

    @staticmethod
    def _check_gqa_heads(n_q_heads, n_kv):
        """GQA needs q heads in whole groups per kv head: otherwise the
        routing would attend the surplus q heads to the wrong kv head."""
        if n_q_heads % n_kv != 0:
            raise ValueError(
                f"invalid GQA config: {n_q_heads} query heads are not an "
                f"integer multiple of {n_kv} kv heads — each kv head must "
                "serve the same whole number of q heads")

    def _align_gqa_local(self, q, k, v):
        """sp = 1: kv repeated to q's head count for the local core."""
        n_kv, H = k.shape[self.scatter_idx], q.shape[self.scatter_idx]
        if n_kv != H:
            self._check_gqa_heads(H, n_kv)
            rep = H // n_kv
            k = k.repeat_interleave(rep, dim=self.scatter_idx)
            v = v.repeat_interleave(rep, dim=self.scatter_idx)
        return k, v

    def _group(self):
        return (self.group if self.group is not None
                else groups._get_sequence_parallel_group())

    def __call__(self, query, key, value, **kwargs):
        group = self._group()
        sp = group.size()
        if sp == 1:
            key, value = self._align_gqa_local(query, key, value)
            return self.local_attn(query, key, value, **kwargs)
        h = self.scatter_idx
        H = query.shape[h]
        hpad = (-H) % sp      # uneven heads: zero-pad to a multiple of sp
        if hpad:
            widths = [0, 0] * (query.dim() - 1 - h) + [0, hpad]
            query = F.pad(query, widths)
        # sequence-split [B, S/sp, Hp, D] → head-split [B, S, Hp/sp, D]
        q = all_to_all(query, group, h, self.gather_idx)
        k = self._kv_reshard(key, group, H)
        v = self._kv_reshard(value, group, H)
        out = self.local_attn(q, k, v, **kwargs)
        out = all_to_all(out, group, self.gather_idx, h)
        if hpad:
            out = out.narrow(h, 0, H)
        return out

    def _kv_reshard(self, t, group, n_q_heads):
        """kv with the head count of the rank's (padded) q block:

        * both head counts divisible by sp: all-to-all like q, then the
          local group-repeat (contiguous head blocks keep q↔kv alignment);
        * else: slot (r, j) of [sp × qh_local] takes the kv head of global
          (padded) q head r·qh_local + j (padding heads clamp to the last
          real one; their output is sliced away), and one all-to-all
          scatters the slots and gathers the sequence."""
        sp, h = group.size(), self.scatter_idx
        n_kv = t.shape[h]
        self._check_gqa_heads(n_q_heads, n_kv)
        rep = max(1, n_q_heads // n_kv)  # q heads per kv head
        if n_kv % sp == 0 and n_q_heads % sp == 0:
            t = all_to_all(t, group, h, self.gather_idx)
            if n_kv != n_q_heads:
                t = t.repeat_interleave(rep, dim=h)
            return t
        qh_local = -(-n_q_heads // sp)
        g = np.arange(sp * qh_local)
        kv_idx = np.minimum(g, n_q_heads - 1) // rep
        t = t.index_select(h, torch.as_tensor(kv_idx, device=t.device))
        return all_to_all(t, group, h, self.gather_idx)


class UlyssesAttention(DistributedAttention):
    """Name parity with the user-facing import in reference examples."""
