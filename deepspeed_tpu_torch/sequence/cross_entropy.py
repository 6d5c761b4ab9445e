"""Cross entropy (the port of ``deepspeed_tpu/sequence/cross_entropy.py``;
reference ``deepspeed/sequence/cross_entropy.py``).

:func:`fused_linear_cross_entropy` is the chunked head + loss behind
``loss_chunk_vocab``: the [N, V] logits never exist, in the forward or
the backward (JAX ``:21``).

A vocabulary-sharded head (tensor parallelism) holds columns ``[start,
start + n)`` of the vocabulary on each tp rank, the last ones possibly
past the vocabulary (a padded one).  :func:`vocab_parallel_cross_entropy`
(the logits of the rank's columns) and :func:`fused_linear_cross_entropy`
with ``tp=(group, start, vocab)`` (the rank's kernel columns, chunk by
chunk) give the whole vocabulary's loss on every rank: each row's max
and sum of exponentials are combined over the group once, the target
logit comes from the rank that holds it, and pad columns take -inf.  The
gradient each rank gets for its hidden states is its columns' part
(the caller's ``copy_to_tp_region`` sums it), for its columns their
whole gradient."""

import contextlib

import torch

from ..accelerator import full_fp32_matmul


def softmax_cross_entropy_with_logits(logits, labels):
    """[..., V] logits, [...] int labels → [...] per-token loss, as fp32
    ``logsumexp(logits) - logits[label]`` (``cross_entropy.py:13``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def _chunks(w, chunk):
    """(first column, [D, chunk] slice of w) a vocabulary chunk; the last
    one padded with zero columns once, when V does not tile."""
    V = w.shape[1]
    for base in range(0, V, chunk):
        wc = w[:, base:base + chunk]
        if wc.shape[1] < chunk:
            wc = torch.nn.functional.pad(wc, (0, chunk - wc.shape[1]))
        yield base, wc


def _products(ld):
    """fp32 products run in full fp32 on the card (as the LM head's)."""
    return (full_fp32_matmul() if ld == torch.float32
            else contextlib.nullcontext())


def vocab_parallel_cross_entropy(logits, labels, start, vocab, group):
    """[..., n] logits of vocabulary columns ``[start, start + n)`` (the
    ones at or past ``vocab`` are pad), [...] int labels of the whole
    vocabulary → [...] fp32 per-token loss over the whole vocabulary,
    the same on every rank of ``group`` (None: one rank holds it all)."""
    from ..comm import ReduceOp
    from ..comm import comm as dist
    from ..comm.functional import reduce_from_tp_region
    logits = logits.float()
    n = logits.shape[-1]
    limit = min(n, vocab - start)
    if limit < n:
        cols = torch.arange(n, device=logits.device)
        logits = logits.masked_fill(cols >= limit, float("-inf"))
    m = logits.detach().amax(dim=-1)
    if group is not None:
        m = dist.all_reduce(m.contiguous(), op=ReduceOp.MAX,
                            group=group.as_flat())
    sumexp = reduce_from_tp_region(
        torch.exp(logits - m[..., None]).sum(dim=-1), group)
    local = labels.long() - start
    inside = (local >= 0) & (local < limit)
    gold = torch.gather(logits, -1, local.clamp(0, max(limit - 1, 0))
                        [..., None])[..., 0]
    gold = reduce_from_tp_region(torch.where(inside, gold,
                                             torch.zeros_like(gold)), group)
    return m + torch.log(sumexp) - gold


def _chunk_logits(xc, wc, base, V, ld):
    """fp32 [N, chunk] logits of one chunk, padded columns -inf."""
    with _products(ld):
        logits = (xc @ wc.to(ld)).float()
    pad = base + wc.shape[1] - V
    if pad > 0:
        logits[:, -pad:] = float("-inf")
    return logits


class FusedLinearCrossEntropy(torch.autograd.Function):
    """The forward runs an online logsumexp over vocabulary chunks and
    keeps each row's label logit; it saves x, w, labels and the final
    (m, s).  The backward recomputes each chunk's logits and forms
    softmax − one-hot: dx sums over the chunks (fp32), each chunk's dw
    columns are written once."""

    @staticmethod
    def forward(ctx, x, w, labels, chunk, ld, tp=None):
        N, V = x.shape[0], w.shape[1]
        xc = x.to(ld)
        m = torch.full((N, ), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros(N, dtype=torch.float32, device=x.device)
        gold = torch.zeros(N, dtype=torch.float32, device=x.device)
        lab, limit = _local_labels(labels, V, tp)
        for base, wc in _chunks(w, chunk):
            logits = _chunk_logits(xc, wc, base, limit, ld)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            inside = (lab >= base) & (lab < min(base + chunk, limit))
            idx = (lab - base).clamp(0, chunk - 1)
            g = torch.gather(logits, 1, idx[:, None])[:, 0]
            gold = torch.where(inside, g, gold)
        if tp is not None and tp[0] is not None:
            # the rows' max and sum of exponentials over the whole
            # vocabulary, once after the chunks; the owner's target logit
            from ..comm import ReduceOp
            from ..comm import comm as dist
            group = tp[0].as_flat()
            top = dist.all_reduce(m.clone(), op=ReduceOp.MAX, group=group)
            s = dist.all_reduce(s * torch.exp(m - top), group=group)
            gold = dist.all_reduce(gold, group=group)
            m = top
        ctx.save_for_backward(x, w, labels, m, s)
        ctx.cfg = (chunk, ld, tp)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, grad):
        x, w, labels, m, s = ctx.saved_tensors
        chunk, ld, tp = ctx.cfg
        V = w.shape[1]
        xc = x.to(ld)
        lse = m + torch.log(s)
        lab, limit = _local_labels(labels, V, tp)
        g = grad.float()[:, None]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
        rows = torch.arange(x.shape[0], device=x.device)
        for base, wc in _chunks(w, chunk):
            logits = _chunk_logits(xc, wc, base, limit, ld)
            p = torch.exp(logits - lse[:, None])
            inside = (lab >= base) & (lab < min(base + chunk, limit))
            p[rows[inside], (lab - base)[inside]] -= 1.0
            dlogits = (p * g).to(ld)
            n = min(chunk, V - base)
            with _products(ld):
                dx += (dlogits @ wc.to(ld).t()).float()
                dw[:, base:base + n] = (xc.t() @ dlogits[:, :n]).to(w.dtype)
        return dx.to(x.dtype), dw, None, None, None, None


def _local_labels(labels, V, tp):
    """(labels in the kernel's column coordinates, the columns that are
    vocabulary): a label outside ``[0, limit)`` is another rank's."""
    lab = labels.long()
    if tp is None:
        return lab, V
    _, start, vocab = tp
    return lab - start, max(0, min(V, vocab - start))


def fused_linear_cross_entropy(x, w, labels, chunk_size, logit_dtype=None,
                               tp=None):
    """Cross entropy of ``x @ w`` against ``labels`` without the [N, V]
    logits (JAX ``:21``): x [N, D] hidden states, w [D, V] head kernel (a
    transposed view of a [V, D] weight is fine), labels [N] int → [N] fp32
    per-token loss; differentiable in x and w.  The products run in
    ``logit_dtype`` (default x's) with fp32 results; live logits are
    [N, chunk_size] in both passes.  ``tp=(group, start, vocab)``: ``w``
    holds columns ``[start, start + V)`` of a ``vocab``-wide head sharded
    over ``group`` (module docstring)."""
    chunk = int(min(chunk_size, w.shape[1]))
    ld = x.dtype if logit_dtype is None else logit_dtype
    if isinstance(ld, str):
        ld = getattr(torch, ld)
    return FusedLinearCrossEntropy.apply(x, w, labels, chunk, ld, tp)


def vocab_sequence_parallel_cross_entropy(logits, labels, sp_group=None,
                                          reduction="mean"):
    """Per-token cross entropy; "mean" over the global sequence when
    ``sp_group`` (the group the sequence is split over) has more than one
    rank (JAX ``:74``: a pmean over the sp axis)."""
    loss = softmax_cross_entropy_with_logits(logits, labels)
    if reduction == "none":
        return loss
    local = loss.mean()
    if sp_group is not None and sp_group.size() > 1:
        from ..comm.functional import pmean
        local = pmean(local, sp_group)
    return local
