"""Blockwise attention over key/value blocks: the fold, the merge and the
backward that ring attention (``sequence/ring_attention.py``) and FPDT's
chunked attention (``sequence/fpdt_layer.py``) share.

The JAX package folds each (query block, key/value block) pair as plain
einsums over an fp32 score block (``ring_attention.py:44-59``,
``fpdt_layer.py:58-70``) and takes the gradients from autodiff through
its scan.  At a card's sizes such a block is gigabytes a pair, so here
every pair is kernel B1 (``ops/kernels/flash_attention.py``):

* forward: B1's forward gives each pair's o and fp32 lse, and the pairs
  are merged in fp32 by :func:`update_out_and_lse` (JAX's rule,
  ``fpdt_layer.py:41``);
* backward (:class:`BlockwiseAttention`): for every pair B1's dq and
  dk/dv kernels run with the FINAL merged o and lse, as ring flash
  attention does: P_ij = exp(s_ij − lse), delta = rowsum(dO·O).  dq sums
  over the pairs in fp32, each key block's dk/dv in fp32.  The forward
  saves q, the local k/v, o and lse only;
* masks: B1's causal mask is bottom-right.  A causal pair is cut by
  :func:`causal_pairs` into the rows that see the whole key block
  (``causal=False``) and the rows whose visible keys end at their own
  position (``causal=True`` on a sub-block whose last query and last key
  coincide); a pair no query sees is skipped.  JAX folds such pairs fully
  masked, which computes the same function.  GQA: k/v stay at their own
  head count (B1 takes Hkv | Hq), where JAX repeats them first.

A *feed* hands the key/value blocks to the fold and takes their gradients
back: :class:`LocalBlocks` cuts the local k/v into chunks (in any order);
``ring_attention.py``'s ring feed rotates them around a group.  On CPU
tensors every pair runs B1's plain versions (``_plain_fwd``,
``_plain_bwd_dq``, ``_plain_bwd_dkv``, which return and take the lse); on
CUDA tensors the kernels, or the call raises.
"""

import torch

from ..ops._use_kernels import use_kernels
from ..ops.kernels.flash_attention import (DEAD_ROW_LSE, _plain_bwd_dkv,
                                           _plain_bwd_dq, _plain_fwd,
                                           flash_attention_bwd_dkv,
                                           flash_attention_bwd_dq,
                                           flash_attention_fwd)

NEG_INF = DEAD_ROW_LSE   # JAX's NEG_INF (fpdt_layer.py:37) is also -1e30


def update_out_and_lse(out, lse, new_out, new_lse):
    """Merge a new chunk's attention output into the running (out, lse)
    (JAX ``fpdt_layer.py:41``): out [B, Sq, H, D] fp32, lse [B, Sq, H]
    fp32; returns the merged pair.  Rows dead in both stay dead (lse
    -1e30, out the mean of two zeros)."""
    max_lse = torch.maximum(lse, new_lse)
    w_old = torch.exp(lse - max_lse)
    w_new = torch.exp(new_lse - max_lse)
    denom = w_old + w_new
    merged = (out * (w_old / denom)[..., None] +
              new_out * (w_new / denom)[..., None])
    return merged, max_lse + torch.log(denom)


def causal_pairs(q0, q1, k0, k1, causal):
    """The B1 calls that attend queries at global positions [q0, q1) to
    keys at [k0, k1): ``[(qa, qb, ka, kb, causal)]``, row and key ranges
    relative to the blocks.  Causal: query p sees key j when p >= j."""
    if not causal or k1 - 1 <= q0:
        return [(0, q1 - q0, 0, k1 - k0, False)]
    if k0 > q1 - 1:
        return []
    # rows [lo, hi) see keys [k0, row]: B1's bottom-right mask over keys
    # [k0, hi); the rows from k1 on see the whole block
    lo, hi = max(q0, k0), min(q1, k1)
    pairs = [(lo - q0, hi - q0, 0, hi - k0, True)]
    if q1 > k1:
        pairs.append((k1 - q0, q1 - q0, 0, k1 - k0, False))
    return pairs


def _kernels(q, use_kernel):
    return use_kernel and use_kernels(q)


def pair_forward(q, k, v, scale, causal, use_kernel=True):
    """One pair through B1's forward: (o in q's dtype, lse [B, Sq, H]
    fp32; -1e30 where a row sees no key)."""
    fwd = flash_attention_fwd if _kernels(q, use_kernel) else _plain_fwd
    o, lse = fwd(q.contiguous(), k.contiguous(), v.contiguous(), scale,
                 causal)
    return o, lse.transpose(1, 2)


def pair_backward(q, k, v, o, do, lse, scale, causal, use_kernel=True):
    """One pair through B1's dq and dk/dv passes, from the final o and
    ``lse`` ([B, H, Sq] fp32): (dq, dk, dv) in the inputs' dtypes."""
    if _kernels(q, use_kernel):
        bwd_dq, bwd_dkv = flash_attention_bwd_dq, flash_attention_bwd_dkv
    else:
        bwd_dq, bwd_dkv = _plain_bwd_dq, _plain_bwd_dkv
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, delta = bwd_dq(q, k, v, o, do, lse, scale, causal)
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def fold(q, blocks, q_start, causal, scale, use_kernel=True):
    """Attend q [B, Sq, H, D] (global positions from ``q_start``) to every
    ``(k, v, k_start)`` of ``blocks``: (out fp32, lse [B, Sq, H] fp32)."""
    B, S, H, D = q.shape
    out = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
    lse = torch.full((B, S, H), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for k, v, k_start in blocks:
        for a, b, c, d, cz in causal_pairs(q_start, q_start + S, k_start,
                                           k_start + k.shape[1], causal):
            o, l = pair_forward(q[:, a:b], k[:, c:d], v[:, c:d], scale, cz,
                                use_kernel)
            out[:, a:b], lse[:, a:b] = update_out_and_lse(
                out[:, a:b], lse[:, a:b], o.float(), l)
    return out, lse


class LocalBlocks:
    """A feed over the local k/v, cut into blocks of ``block`` positions
    along dim 1, visited in ``order`` (block indices; default
    ascending)."""

    def __init__(self, block, order=None):
        self.block, self.order = block, order

    def _indices(self, k):
        n = -(-k.shape[1] // self.block)
        return range(n) if self.order is None else self.order

    def forward_blocks(self, k, v):
        for i in self._indices(k):
            lo = i * self.block
            yield k[:, lo:lo + self.block], v[:, lo:lo + self.block], lo

    def backward_blocks(self, k, v):
        """Each block with the fp32 slots its dk and dv are summed into."""
        self.dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        self.dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in self._indices(k):
            sl = slice(i * self.block, (i + 1) * self.block)
            yield k[:, sl], v[:, sl], sl.start, self.dk[:, sl], self.dv[:, sl]

    def finish(self):
        """(dk, dv) of the local k/v, fp32; the feed lets go of them (the
        autograd node that holds the feed lives as long as the graph)."""
        dk, dv = self.dk, self.dv
        self.dk = self.dv = None
        return dk, dv


class BlockwiseAttention(torch.autograd.Function):
    """q [B, Sq, H, D] against the key/value blocks of ``feed`` (over k, v
    [B, Sk, Hkv, D]), causal over global positions (q's from ``q_start``):
    the module docstring's forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, feed, q_start, causal, scale, use_kernel):
        out, lse = fold(q, feed.forward_blocks(k, v), q_start, causal, scale,
                        use_kernel)
        o = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse.transpose(1, 2).contiguous())
        ctx.cfg = (feed, q_start, causal, scale, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        feed, q_start, causal, scale, use_kernel = ctx.cfg
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        S = q.shape[1]
        for kb, vb, k_start, dk, dv in feed.backward_blocks(k, v):
            for a, b, c, d, cz in causal_pairs(q_start, q_start + S, k_start,
                                               k_start + kb.shape[1], causal):
                g_q, g_k, g_v = pair_backward(
                    q[:, a:b], kb[:, c:d], vb[:, c:d], o[:, a:b], do[:, a:b],
                    lse[:, :, a:b], scale, cz, use_kernel)
                dq[:, a:b] += g_q.float()
                dk[:, c:d] += g_k.float()
                dv[:, c:d] += g_v.float()
        dk, dv = feed.finish()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def blockwise_attention(q, k, v, feed, q_start=0, causal=True,
                        softmax_scale=None, use_kernel=True):
    """[B, Sq, H, D] attention of q to the blocks ``feed`` hands over,
    differentiable in q, k and v."""
    scale = (float(softmax_scale) if softmax_scale is not None
             else q.shape[-1]**-0.5)
    return BlockwiseAttention.apply(q, k, v, feed, int(q_start),
                                    bool(causal), scale, bool(use_kernel))
