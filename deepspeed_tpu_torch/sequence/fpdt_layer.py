"""FPDT — Fully Pipelined Distributed Transformer (the port of
``deepspeed_tpu/sequence/fpdt_layer.py``; reference ``deepspeed/sequence/
fpdt_layer.py``).

* :func:`chunked_attention` (JAX ``:73``): attention over q chunks, each
  against the kv chunks through ``sequence/blockwise.py`` (kernel B1 a
  pair, merged in fp32, chunks entirely above the diagonal skipped), each
  q chunk's body under non-reentrant ``torch.utils.checkpoint`` as JAX's
  ``jax.checkpoint(body)``: the backward recomputes it;
* :class:`SequenceChunk` / :class:`FPDTHostOffloadAttention` (JAX
  ``:151``, ``:170``): k/v chunks kept in pinned host memory and streamed
  back to the card chunk by chunk; the card holds at most two chunks (the
  one merged, the one in flight) whatever the context;
* :func:`fpdt_ffn`, :func:`fpdt_logits_loss` (``:246``, ``:261``): the FFN
  and the LM loss over sequence slabs under checkpoint, so the 4H
  intermediate and the [S, V] logits never exist whole;
* :class:`FPDT_Attention` (``:289``): Ulysses' all-to-all around the
  chunked local attention.

:func:`update_out_and_lse` is the fp32 merge (``:41``).  B1's lse is
[B, H, Sq]; the functions here keep JAX's [B, Sq, H].
"""

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .blockwise import (NEG_INF, LocalBlocks, blockwise_attention,
                        pair_forward, update_out_and_lse)


def _scale(q, softmax_scale):
    return (float(softmax_scale) if softmax_scale is not None
            else q.shape[-1]**-0.5)


def _chunk_attend(q, k, v, causal=False, softmax_scale=None):
    """One (q chunk, kv chunk) pair through B1: (out fp32 [B, Sq, H, D],
    lse fp32 [B, Sq, H]).  JAX's takes a boolean mask; B1 takes
    ``causal`` (bottom-right), the only mask its callers build."""
    o, lse = pair_forward(q, k, v, _scale(q, softmax_scale), causal)
    return o.float(), lse


def chunked_attention(q, k, v, q_chunk=1024, kv_chunk=1024, causal=True,
                      softmax_scale=None):
    """[B, S, H, D] → [B, S, H, D] in chunks: memory O(q_chunk × kv_chunk)
    a pair instead of O(S²).  The causal mask is over positions from 0 for
    q and k alike (JAX's).  Shapes that do not tile fall back to one
    chunk, as in JAX (``:84-87``); q and kv chunks may differ (each pair
    is cut on the diagonal, ``blockwise.causal_pairs``)."""
    S, Sk = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Sk)
    if S % q_chunk or Sk % kv_chunk:
        q_chunk = S if S % q_chunk else q_chunk
        kv_chunk = Sk if Sk % kv_chunk else kv_chunk
    scale = _scale(q, softmax_scale)

    def one_q_chunk(q_blk, k, v, q_start):
        return blockwise_attention(q_blk, k, v, LocalBlocks(kv_chunk),
                                   q_start=q_start, causal=causal,
                                   softmax_scale=scale)

    outs = []
    for q_start in range(0, S, q_chunk):
        q_blk = q[:, q_start:q_start + q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(one_q_chunk, q_blk, k, v, q_start,
                                   use_reentrant=False))
        else:
            outs.append(one_q_chunk(q_blk, k, v, q_start))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------- host offload
class SequenceChunk:
    """One k/v chunk resident in host memory (JAX ``:151``).  Chunks of a
    card tensor go to pinned host memory, copied on the caller's stream
    (an event marks the copy done); a chunk that cannot be pinned raises.
    Chunks of CPU tensors stay where they are (JAX keeps them in place
    where there is no pinned-host memory space, ``:139-148``)."""

    def __init__(self, k, v, offload=True):
        self.length = k.shape[1]
        self.device = k.device
        self.stored = None
        if offload and k.device.type == "cuda":
            self.k, self.v = (self._pinned(t) for t in (k, v))
            self.stored = torch.cuda.Event()
            self.stored.record()
        else:
            self.k, self.v = k, v

    @staticmethod
    def _pinned(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if not host.is_pinned():
            raise RuntimeError("FPDT: a host chunk could not be pinned")
        host.copy_(t, non_blocking=True)
        return host

    def fetch(self, stream=None):
        """(k, v) on the card.  ``stream``: the side stream the copy runs
        on (the caller's current stream waits on the returned tensors'
        event, :meth:`FPDTHostOffloadAttention.attend`); None copies on the
        current stream."""
        if self.stored is None:
            return self.k, self.v, None
        if stream is None:
            return (self.k.to(self.device, non_blocking=True),
                    self.v.to(self.device, non_blocking=True), None)
        stream.wait_event(self.stored)
        with torch.cuda.stream(stream):
            k = self.k.to(self.device, non_blocking=True)
            v = self.v.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return k, v, ready


class FPDTHostOffloadAttention:
    """Streaming attention over host-resident k/v chunks (JAX ``:170``;
    reference ``_FPDTGPUOffloadingAttentionImpl_``).  Append-only k/v
    (decode, eval): the card holds at most two chunks at a time; the
    context is bounded by host memory.  Forward only, as JAX uses it.

    ``double_buffer`` (default on): chunk i+1's copy to the card is issued
    on a side stream before chunk i's merge, so the copy rides the copy
    engine while B1 merges (JAX ``:227-236``); off, each chunk is copied
    on the compute stream right before its merge.  Every merge is one B1
    forward of chunk size (``self._merge``): the operands of a call do not
    grow with the context."""

    def __init__(self, chunk_size=4096, softmax_scale=None, offload=True,
                 double_buffer=True):
        self.chunk_size = chunk_size
        self.softmax_scale = softmax_scale
        self.offload = offload
        self.double_buffer = double_buffer
        self.chunks = []
        self._stream = None

    def _merge(self, q, k, v, out, lse, scale, causal):
        """(out, lse) with the pair (q, one k/v chunk) merged in: one B1
        forward (``causal``: the current block's tail)."""
        return update_out_and_lse(out, lse,
                                  *_chunk_attend(q, k, v, causal, scale))

    def append_kv(self, k, v):
        """Store a [B, S_chunk, H, D] k/v block host-side."""
        self.chunks.append(SequenceChunk(k, v, offload=self.offload))

    def reset(self):
        self.chunks = []

    @property
    def context_length(self):
        return sum(c.length for c in self.chunks)

    def _fetch(self, chunk):
        """(k, v) of ``chunk`` on the card, ordered before what the
        current stream does next."""
        stream = None
        if self.double_buffer and chunk.stored is not None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=chunk.device)
            stream = self._stream
        return chunk.fetch(stream)

    @staticmethod
    def _ready(fetched):
        k, v, ready = fetched
        if ready is not None:
            current = torch.cuda.current_stream(k.device)
            current.wait_event(ready)
            # the side stream made them: the allocator must not reuse
            # their memory before the current stream is done with them
            k.record_stream(current)
            v.record_stream(current)
        return k, v

    @torch.no_grad()
    def attend(self, q, k_new=None, v_new=None, causal_tail=True):
        """Attend q [B, Sq, H, D] over every stored chunk (and the current
        block, causally masked); then append (k_new, v_new)."""
        B, Sq, H, D = q.shape
        out = torch.zeros(B, Sq, H, D, dtype=torch.float32, device=q.device)
        lse = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32,
                         device=q.device)
        scale = _scale(q, self.softmax_scale)
        if self.chunks:
            fetched = self._fetch(self.chunks[0])
            for i in range(len(self.chunks)):
                # prefetch-ahead: chunk i+1's copy is issued before chunk
                # i's merge (on the compute stream when not double-buffered)
                nxt = (self._fetch(self.chunks[i + 1])
                       if self.double_buffer and i + 1 < len(self.chunks)
                       else None)
                k, v = self._ready(fetched)
                out, lse = self._merge(q, k, v, out, lse, scale, False)
                del k, v
                if nxt is None and i + 1 < len(self.chunks):
                    nxt = self._fetch(self.chunks[i + 1])
                fetched = nxt
        if k_new is not None:
            out, lse = self._merge(q, k_new, v_new, out, lse, scale,
                                   bool(causal_tail))
            self.append_kv(k_new, v_new)
        return out.to(q.dtype)


# ------------------------------------------------------------ chunked tails
def fpdt_ffn(ffn_fn, x, chunk_size=4096):
    """The FFN over [B, S, H] in S/chunk slabs, each under checkpoint (JAX
    ``:246``): the 4H intermediate never exists for the whole sequence.
    A sequence that does not tile runs whole, as in JAX."""
    S = x.shape[1]
    cs = min(chunk_size, S)
    if S % cs:
        return ffn_fn(x)
    run = (functools.partial(checkpoint, ffn_fn, use_reentrant=False)
           if torch.is_grad_enabled() else ffn_fn)
    return torch.cat([run(x[:, lo:lo + cs]) for lo in range(0, S, cs)],
                     dim=1)


def fpdt_logits_loss(hidden, vocab_kernel, labels, chunk_size=4096,
                     reduction="mean"):
    """Chunked LM cross entropy (JAX ``:261``): hidden [B, S, H] @
    vocab_kernel [H, V] slab by slab under checkpoint, fp32 logsumexp −
    the label's logit; the [S, V] logits never exist.  ``reduction``
    "mean" or "none" ([B, S])."""
    S = hidden.shape[1]
    cs = min(chunk_size, S)
    if S % cs:
        cs = S

    def slab(h, lab):
        logits = (h @ vocab_kernel).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return logz - gold

    run = (functools.partial(checkpoint, slab, use_reentrant=False)
           if torch.is_grad_enabled() else slab)
    losses = torch.cat([run(hidden[:, lo:lo + cs], labels[:, lo:lo + cs])
                        for lo in range(0, S, cs)], dim=1)
    if reduction == "none":
        return losses
    return losses.mean()


# ---------------------------------------------------------------- FPDT layer
class FPDT_Attention:
    """Ulysses + chunked attention (JAX ``:289``; reference
    ``FPDT_Attention``).  Call on the rank's sequence chunk [B, S/sp, H,
    D] (kv at its own width): the all-to-all reshards sequence to heads,
    the local attention runs chunked."""

    def __init__(self, q_chunk=1024, kv_chunk=1024, causal=True,
                 softmax_scale=None, sequence_process_group=None):
        from .layer import DistributedAttention
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        local = functools.partial(chunked_attention, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk, causal=causal,
                                  softmax_scale=softmax_scale)
        self.dist = DistributedAttention(
            local_attention=local,
            sequence_process_group=sequence_process_group)

    def __call__(self, q, k, v, **kw):
        return self.dist(q, k, v, **kw)
