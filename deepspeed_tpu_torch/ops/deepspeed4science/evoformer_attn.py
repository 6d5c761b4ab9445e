"""Evoformer (MSA) attention: the port of ``deepspeed_tpu/ops/
deepspeed4science/evoformer_attn.py`` (reference ``deepspeed/ops/
deepspeed4science/evoformer_attn.py:DS4Sci_EvoformerAttention``).

Attention over MSA tensors ``[B, N, L, H, D]`` with two additive biases:

* ``biases[0]`` — mask bias ``[B, N, 1, 1, L]`` (a key mask, broadcast over
  heads and queries);
* ``biases[1]`` — pair bias ``[B, 1, H, L, L]`` (broadcast over the MSA row
  axis N).

Two paths, chosen by shape as in the JAX package:

* with a full pair bias, :func:`_flash_bias_route` folds N into the batch
  and calls ``ops/kernels/flash_bias.py:flash_attention_bias`` — on the
  card its four CUDA kernels (forward, dq, dk/dv and dbias, the pair
  bias's gradient reduced over the N rows inside the kernel), on the CPU
  their plain versions, so the CPU computes what the card computes.  The
  MASK bias gets no gradient on this route.  ``DS_TPU_EVOFORMER_FLASH=0``
  or ``DS_TPU_DISABLE_PALLAS_ATTN`` (the switch of every attention site,
  ``ops/_use_kernels.py``) sends such a call to the chunked path instead
  (to train a mask bias); a kernel that fails raises, it never falls
  back;
* every other call (no pair bias, e.g. MSA column attention) takes
  :func:`evoformer_attention`: plain PyTorch in query blocks of 256, each
  under ``torch.utils.checkpoint`` (the JAX path's ``jax.checkpoint``), so
  the backward recomputes a block's probabilities instead of keeping
  ``[*, H, L, L]``.  It launches no kernel of the port.
"""

import math
import os

import torch
from torch.utils.checkpoint import checkpoint

from .._use_kernels import kernels_disabled
from ..kernels.flash_bias import flash_attention_bias


def _block(qb, kh, vh, scale, *biases):
    """One query block: fp32 scores and softmax, the dtype's P·V with an
    fp32 sum (JAX's ``preferred_element_type=float32``), ``[*, H, bq, D]``
    in q's dtype."""
    dtype = qb.dtype
    s = (qb.float() @ kh.float().transpose(-1, -2)) * scale
    for b in biases:
        s = s + b.float()
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    o = p.to(dtype).float() @ vh.float()
    return (o / p.sum(dim=-1, keepdim=True)).to(dtype)


def evoformer_attention(q, k, v, biases=(), softmax_scale=None, block_q=256):
    """Gated-MSA-style attention with additive biases.

    Args:
      q, k, v: ``[*, L, H, D]`` (reference layout — heads after sequence).
      biases: tensors broadcastable against scores ``[*, H, Lq, Lk]``.
      softmax_scale: defaults to ``1/sqrt(D)``.
      block_q: query chunk; ``L <= block_q`` uses the direct unchunked
        path.

    Returns ``[*, L, H, D]`` in ``q.dtype``.
    """
    *_, L, H, D = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qh, kh, vh = (x.movedim(-2, -3) for x in (q, k, v))   # [*, H, L, D]
    biases = list(biases)
    if L <= block_q:
        return _block(qh, kh, vh, scale, *biases).movedim(-3, -2)
    outs = []
    for start in range(0, L, block_q):
        rows = slice(start, start + block_q)
        # a bias with a query axis is sliced; one broadcast over it is not
        bs = [b if b.shape[-2] == 1 else b[..., rows, :] for b in biases]
        outs.append(checkpoint(_block, qh[..., rows, :], kh, vh, scale, *bs,
                               use_reentrant=False))
    return torch.cat(outs, dim=-2).movedim(-3, -2)


def _flash_bias_route(Q, K, V, bs):
    """Full pair-bias attention through the bias-operand flash kernels
    (``ops/kernels/flash_bias.py``): Q, K, V folded to ``[B·N, L, H, D]``,
    the pair bias to ``[B, H, L, L]`` (a batch group of N), the mask to
    ``[B·N, 1, 1, L]``.

    Returns None when the route does not apply: no pair bias, a bias of
    another shape, ``DS_TPU_EVOFORMER_FLASH=0`` or
    ``DS_TPU_DISABLE_PALLAS_ATTN`` set.  On this route the MASK bias gets
    no gradient.
    """
    if os.environ.get("DS_TPU_EVOFORMER_FLASH") == "0" or kernels_disabled():
        return None
    B, N, L, H, D = Q.shape
    mask_bias = pair_bias = None
    for b in bs:
        if b.shape[-2] == 1 and b.shape[-3] == 1 and b.shape[1] == N:
            mask_bias = b                      # [B, N, 1, 1, L]
        elif b.shape[1] == 1 and b.shape[-2] == L and b.shape[2] == H:
            pair_bias = b                      # [B, 1, H, L, L]
        else:
            return None
    if pair_bias is None:
        return None
    out = flash_attention_bias(
        Q.reshape(B * N, L, H, D), K.reshape(B * N, L, H, D),
        V.reshape(B * N, L, H, D),
        bias=pair_bias.reshape(B, H, L, L),       # Gb = N batch group
        mask_bias=(None if mask_bias is None
                   else mask_bias.reshape(B * N, 1, 1, L)),
        causal=False)
    return out.reshape(B, N, L, H, D)


def DS4Sci_EvoformerAttention(Q, K, V, biases):
    """Reference-parity entry (``evoformer_attn.py:88
    DS4Sci_EvoformerAttention``).

    ``Q/K/V``: ``[B, N, L, H, D]`` MSA tensors; ``biases`` a list of at most
    two: mask bias ``[B, N, 1, 1, L]`` then pair bias ``[B, 1, H, L, L]``
    (either may be None/absent).  With a full pair bias the call runs the
    bias-operand flash kernels (on CUDA tensors; their plain versions on
    CPU tensors); otherwise the chunked plain path.
    """
    assert len(biases) <= 2, "at most two biases (mask, pair)"
    bs = [b for b in biases if b is not None]
    L = Q.shape[-3]
    for b in bs:
        assert b.shape[-1] == L and b.ndim == Q.ndim, (
            f"bias shape {tuple(b.shape)} incompatible with Q "
            f"{tuple(Q.shape)}")
    out = _flash_bias_route(Q, K, V, bs)
    if out is not None:
        return out
    return evoformer_attention(Q, K, V, biases=bs)
