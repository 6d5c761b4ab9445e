"""Cross entropy (the port of ``deepspeed_tpu/sequence/cross_entropy.py``;
reference ``deepspeed/sequence/cross_entropy.py``).

:func:`fused_linear_cross_entropy` is the chunked head + loss behind
``loss_chunk_vocab``: the [N, V] logits never exist, in the forward or
the backward (JAX ``:21``)."""

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
    def forward(ctx, x, w, labels, chunk, ld):
        N, V = x.shape[0], w.shape[1]
        xc = x.to(ld)
        m = torch.full((N, ), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros(N, dtype=torch.float32, device=x.device)
        gold = torch.zeros(N, dtype=torch.float32, device=x.device)
        lab = labels.long()
        for base, wc in _chunks(w, chunk):
            logits = _chunk_logits(xc, wc, base, V, ld)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            inside = (lab >= base) & (lab < base + chunk)
            idx = (lab - base).clamp(0, chunk - 1)
            g = torch.gather(logits, 1, idx[:, None])[:, 0]
            gold = torch.where(inside, g, gold)
        ctx.save_for_backward(x, w, labels, m, s)
        ctx.cfg = (chunk, ld)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, grad):
        x, w, labels, m, s = ctx.saved_tensors
        chunk, ld = ctx.cfg
        V = w.shape[1]
        xc = x.to(ld)
        lse = m + torch.log(s)
        lab = labels.long()
        g = grad.float()[:, None]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
        rows = torch.arange(x.shape[0], device=x.device)
        for base, wc in _chunks(w, chunk):
            logits = _chunk_logits(xc, wc, base, V, ld)
            p = torch.exp(logits - lse[:, None])
            inside = (lab >= base) & (lab < base + chunk)
            p[rows[inside], (lab - base)[inside]] -= 1.0
            dlogits = (p * g).to(ld)
            n = min(chunk, V - base)
            with _products(ld):
                dx += (dlogits @ wc.to(ld).t()).float()
                dw[:, base:base + n] = (xc.t() @ dlogits[:, :n]).to(w.dtype)
        return dx.to(x.dtype), dw, None, None, None


def fused_linear_cross_entropy(x, w, labels, chunk_size, logit_dtype=None):
    """Cross entropy of ``x @ w`` against ``labels`` without the [N, V]
    logits (JAX ``:21``): x [N, D] hidden states, w [D, V] head kernel (a
    transposed view of a [V, D] weight is fine), labels [N] int → [N] fp32
    per-token loss; differentiable in x and w.  The products run in
    ``logit_dtype`` (default x's) with fp32 results; live logits are
    [N, chunk_size] in both passes."""
    chunk = int(min(chunk_size, w.shape[1]))
    ld = x.dtype if logit_dtype is None else logit_dtype
    if isinstance(ld, str):
        ld = getattr(torch, ld)
    return FusedLinearCrossEntropy.apply(x, w, labels, chunk, ld)


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
