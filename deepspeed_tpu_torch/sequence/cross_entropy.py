"""Cross entropy (the port of ``deepspeed_tpu/sequence/cross_entropy.py``).

``fused_linear_cross_entropy`` (the chunked head + loss behind
``LlamaConfig.loss_chunk_vocab``) is ROADMAP queue A item 3 and not ported
yet."""

import torch


def softmax_cross_entropy_with_logits(logits, labels):
    """[..., V] logits, [...] int labels → [...] per-token loss, as fp32
    ``logsumexp(logits) - logits[label]`` (``cross_entropy.py:13``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold
