"""Ring attention (the port of ``deepspeed_tpu/sequence/ring_attention.py``):
context parallelism over the sp group.

Rank r holds the r-th block of the sequence.  Its k/v blocks circulate
the ring (``comm/functional.py:send_next_recv_prev``, k and v in one
exchange a hop, sp − 1 hops), and each rank folds every block into its
queries; at hop t it holds the block of rank (r − t) mod sp, which fixes
the causal offsets.  The S×S scores never exist and, unlike Ulysses, the
head count need not divide sp.

Every fold is kernel B1 (``sequence/blockwise.py``): the diagonal block
``causal=True``, a past block ``causal=False``, a future block skipped
(so under a causal mask rank r folds r + 1 blocks and the ranks wait for
the last one; a zigzag or striped layout would balance them, but it
changes the engine's sequence split, which JAX does not do).  The
backward is one autograd Function: it rotates k and v again with their
fp32 dk/dv beside them (k, v, dk, dv in one exchange a hop), runs B1's
dq and dk/dv passes on every live pair from the final o and lse, and a
last hop hands each dk/dv back to its owner.  k/v circulate at their own
head count (GQA), where JAX repeats them first; the function is the same.

The ring is written over its feed: :class:`RingBlocks` moves the blocks
through an exchange (a group's ring shift), and :func:`ring_attention_blocks`
runs the sp blocks of one device in the ring's order with the exchange
replaced by indexing (``chip_smoke.py`` drives a ring of four on one card
that way).
"""

import torch

from ..comm.functional import send_next_recv_prev
from .blockwise import LocalBlocks, blockwise_attention
from .layer import DistributedAttention


class RingBlocks:
    """The ring's feed over a process group: at hop t this rank holds the
    k/v block of group rank (r − t) mod n, each block ``block`` positions
    long.  ``exchange`` takes a list of tensors, sends them to the next
    rank and returns what the previous one sent."""

    def __init__(self, group, block, exchange=send_next_recv_prev):
        self.block = block
        self.shift = lambda ts: exchange(ts, group)   # noqa: E731
        self.n, self.rank = group.size(), group.rank()

    def forward_blocks(self, k, v):
        for t in range(self.n):
            if t:
                k, v = self.shift([k, v])
            yield k, v, ((self.rank - t) % self.n) * self.block

    def backward_blocks(self, k, v):
        """The blocks again, each with its fp32 dk/dv accumulators, which
        travel with it."""
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(self.n):
            if t:
                k, v, dk, dv = self.shift([k, v, dk, dv])
            self.dk, self.dv = dk, dv
            yield k, v, ((self.rank - t) % self.n) * self.block, dk, dv

    def finish(self):
        """After sp − 1 hops rank r holds block r + 1's sums: one more hop
        hands them to their owner."""
        dk, dv = self.shift([self.dk, self.dv])
        self.dk = self.dv = None
        return dk, dv


def ring_attention_local(q, k, v, group, causal=True, softmax_scale=None,
                         use_kernel=True):
    """Ring attention on this rank's sequence block over ``group`` (JAX's
    ``axis_name``): q [B, S/sp, H, D], k/v [B, S/sp, Hkv, D] → [B, S/sp, H,
    D]; differentiable."""
    Sl = q.shape[1]
    return blockwise_attention(q, k, v, RingBlocks(group, Sl),
                               q_start=group.rank() * Sl, causal=causal,
                               softmax_scale=softmax_scale,
                               use_kernel=use_kernel)


def ring_attention_blocks(q, k, v, sp, causal=True, softmax_scale=None,
                          use_kernel=True):
    """The ring of ``sp`` ranks on one device: q, k, v hold the whole
    sequence [B, S, H(kv), D]; virtual rank r attends its block of q to
    the k/v blocks in the ring's order ((r − t) mod sp at hop t), taken
    by indexing instead of an exchange.  → [B, S, H, D]."""
    S = q.shape[1]
    if S % sp:
        raise ValueError(f"sequence {S} does not split into {sp} blocks")
    Sl = S // sp
    outs = [blockwise_attention(
        q[:, r * Sl:(r + 1) * Sl], k, v,
        LocalBlocks(Sl, order=[(r - t) % sp for t in range(sp)]),
        q_start=r * Sl, causal=causal, softmax_scale=softmax_scale,
        use_kernel=use_kernel) for r in range(sp)]
    return torch.cat(outs, dim=1)


class RingAttention(DistributedAttention):
    """``DistributedAttention`` with the ring backend (JAX ``:88``): the
    group lookup and the sp = 1 path (the local core, GQA aligned) are
    inherited; at sp > 1 the ring replaces the all-to-alls."""

    def __call__(self, query, key, value, causal=True, softmax_scale=None,
                 use_kernel=True, window=0):
        if window:
            raise NotImplementedError(
                "sliding_window is not supported by the ring SP backend; "
                "use sp_backend='ulysses'")
        group = self._group()
        if group.size() == 1:
            return super().__call__(query, key, value, causal=causal,
                                    softmax_scale=softmax_scale,
                                    use_kernel=use_kernel)
        return ring_attention_local(query, key, value, group, causal=causal,
                                    softmax_scale=softmax_scale,
                                    use_kernel=use_kernel)
