"""Attention core (the port of ``deepspeed_tpu/ops/attention.py``): the one
entry point the models call.

On CUDA tensors it is the flash-attention kernels (B1,
``ops/kernels/flash_attention.py``); on CPU tensors, or on any device with
``DS_TPU_DISABLE_PALLAS_ATTN`` set (``ops/_use_kernels.py``), it is
:func:`_xla_attention`, as the JAX package runs its XLA path off the TPU
or under that switch.  The JAX dispatcher's ``try/except`` fallback to XLA
attention is not carried over: a kernel that fails to build or launch
raises.
"""

import torch

from ._use_kernels import use_kernels
from .kernels.flash_attention import flash_attention, flash_attention_plain


def _xla_attention(q, k, v, causal=True, softmax_scale=None, window=0,
                   alibi_slopes=None):
    """The JAX package's XLA path (``attention.py:17``), [B, S, H, D] with
    H shared by q, k and v: fp32 softmax over ``finfo.min``-masked logits
    (a row that sees no key gets a uniform softmax), probabilities rounded
    to q's dtype before P·V."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes).detach().to(logits.device,
                                                       torch.float32)
        logits = logits.float() + sl[None, :, None, None] * torch.arange(
            k.shape[1], dtype=torch.float32, device=logits.device)
    if causal:
        S, Sk = q.shape[1], k.shape[1]
        ones = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=Sk - S)
        if window:
            mask &= ~torch.tril(ones, diagonal=Sk - S - window)
        logits = torch.where(mask, logits.float(),
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attention_core(q, k, v, causal=True, softmax_scale=None, window=0,
                   alibi_slopes=None, use_kernel=True):
    """[B, S, H, D] attention; ``window`` > 0 = sliding-window causal
    attention (Mistral).  ``use_kernel=False`` runs the kernels' plain
    version on any device (``chip_smoke.py`` compares the two on the
    card)."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True (sliding-window "
                         "attention is defined over causal positions)")
    kw = dict(causal=causal, softmax_scale=softmax_scale, window=window,
              alibi_slopes=alibi_slopes)
    if not use_kernel:
        return flash_attention_plain(q, k, v, **kw)
    if use_kernels(q):
        return flash_attention(q, k, v, **kw)
    return _xla_attention(q, k, v, **kw)
