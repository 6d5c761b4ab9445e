"""Llama-family model (the port of ``deepspeed_tpu/models/llama.py``).

The module holds the weights under their HuggingFace names and in torch's
``[out, in]`` layouts (``model.layers.{i}.self_attn.q_proj.weight``, ...,
``lm_head.weight``), so a HuggingFace checkpoint loads by name.

Two paths use it:

* serving: the ragged step in ``inference/v2/ragged_forward.py`` reads the
  weights as they are built here — projections and the embedding in the
  serving dtype, the norm weights and the LM head in fp32 (the JAX ragged
  head runs ``x.astype(f32) @ kernel.astype(f32)``);
* training: :meth:`LlamaModel.forward` (``llama.py:217-367``), driven by
  ``runtime/engine.py``, which first installs every leaf in the compute
  dtype (norm weights and head included, as ``engine.py:511`` does) and
  keeps the fp32 master itself.  Norms take fp32 statistics and multiply by
  the weight promoted to fp32; rotary runs in fp32; the head computes in
  ``head_dtype`` (or, tied, in the model dtype, as flax ``Embed.attend``
  does); attention is ``ops/attention.py:attention_core``.

With ``use_ulysses`` (``llama.py:73-74``, ``:259-275``) the forward takes
the rank's chunk of the sequence (``engine.shard_batch`` cuts it): RoPE
runs at the chunk's global positions, attention is
``sequence/layer.py:DistributedAttention`` over the sp group, or with
``sp_backend="ring"`` ``sequence/ring_attention.py:RingAttention`` (kv at
its own width either way), and the next-token loss is the global one
(:func:`lm_loss`).  ``loss_chunk_vocab`` takes the loss through the fused
chunked head + loss (:func:`lm_loss_chunked`); ``remat_policy`` is a name
of ``runtime/activation_checkpointing``'s table.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import full_fp32_matmul
from ..comm.functional import copy_to_tp_region, reduce_from_tp_region
from ..module_inject.auto_tp import Spec, tp_local
from ..module_inject.layers import (attention_heads, gather_logits,
                                    kv_weights, tp_embedding, tp_group_of)
from ..ops.attention import attention_core
from ..runtime.activation_checkpointing.checkpointing import (policy_ops,
                                                              remat)
from ..sequence.cross_entropy import (fused_linear_cross_entropy,
                                      softmax_cross_entropy_with_logits,
                                      vocab_parallel_cross_entropy)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    sliding_window: int = 0       # 0 → full causal (Mistral sets 4096)
    attention_bias: bool = False  # Qwen2-style q/k/v biases
    # RoPE scaling (HF rope_scaling): "none" | "linear" | "llama3"
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    dtype: str = "bfloat16"
    # training: the LM head's matmul dtype ("bfloat16" runs it on the fast
    # path; cross entropy is fp32 either way)
    head_dtype: str = "float32"
    # > 0 → fused chunked head + loss over vocabulary chunks of this size
    # (sequence/cross_entropy.py): no [B, S, V] logits
    loss_chunk_vocab: int = 0
    # training: recompute each block in the backward, under a policy of
    # runtime/activation_checkpointing's table (JAX's names)
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    # sequence parallelism over the mesh's sp group: sp_backend "ulysses"
    # (all-to-all) or "ring" (ring attention)
    use_ulysses: bool = False
    sp_backend: str = "ulysses"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def rope_scaling(self):
        """Scaling tuple for :func:`_rope_freqs`, or None when unscaled."""
        if self.rope_scaling_type == "none":
            return None
        return (self.rope_scaling_type, self.rope_scaling_factor,
                self.rope_low_freq_factor, self.rope_high_freq_factor,
                self.rope_original_max_position)


def llama_7b(**overrides):
    return LlamaConfig(**{**dict(vocab_size=32000, hidden_size=4096,
                                 intermediate_size=11008, num_hidden_layers=32,
                                 num_attention_heads=32, num_key_value_heads=32),
                          **overrides})


def llama_13b(**overrides):
    return LlamaConfig(**{**dict(vocab_size=32000, hidden_size=5120,
                                 intermediate_size=13824, num_hidden_layers=40,
                                 num_attention_heads=40, num_key_value_heads=40),
                          **overrides})


def llama_tiny(**overrides):
    """Test-scale config."""
    return LlamaConfig(**{**dict(vocab_size=256, hidden_size=64,
                                 intermediate_size=128, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=2,
                                 max_position_embeddings=128),
                          **overrides})


def mistral_7b(**overrides):
    """Mistral-7B-v0.1: llama architecture + GQA + 4096 sliding window."""
    return LlamaConfig(**{**dict(vocab_size=32000, hidden_size=4096,
                                 intermediate_size=14336,
                                 num_hidden_layers=32,
                                 num_attention_heads=32,
                                 num_key_value_heads=8,
                                 sliding_window=4096, rope_theta=10000.0,
                                 max_position_embeddings=32768),
                          **overrides})


def qwen2_7b(**overrides):
    """Qwen2-7B: llama architecture + GQA + q/k/v biases."""
    return LlamaConfig(**{**dict(vocab_size=152064, hidden_size=3584,
                                 intermediate_size=18944,
                                 num_hidden_layers=28,
                                 num_attention_heads=28,
                                 num_key_value_heads=4,
                                 attention_bias=True, rope_theta=1e6,
                                 max_position_embeddings=131072),
                          **overrides})


def _rope_freqs(head_dim, max_len, theta, scaling=None):
    """cos/sin tables ``[max_len, head_dim/2]`` in numpy float64, computed
    exactly as the JAX package does (callers cast to fp32).  ``scaling`` is
    ``LlamaConfig.rope_scaling``: "linear" divides all frequencies by
    ``factor``; "llama3" is the HF piecewise rule."""
    inv = 1.0 / (theta**(np.arange(0, head_dim, 2) / head_dim))
    if scaling is not None:
        stype, factor, low_f, high_f, orig_max = scaling
        if stype == "linear":
            inv = inv / factor
        elif stype == "llama3":
            wavelen = 2 * np.pi / inv
            low_wavelen = orig_max / low_f
            high_wavelen = orig_max / high_f
            smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
            smoothed = ((1 - smooth) / factor + smooth) * inv
            inv = np.where(wavelen > low_wavelen, inv / factor,
                           np.where(wavelen < high_wavelen, inv, smoothed))
        else:
            raise ValueError(f"unsupported rope scaling type {stype!r}")
    t = np.arange(max_len)
    freqs = np.outer(t, inv)  # [S, Dh/2]
    return np.cos(freqs), np.sin(freqs)


@functools.lru_cache(maxsize=8)
def rope_tables(head_dim, max_len, theta, scaling, device):
    """fp32 cos/sin tables ``[max_len, head_dim/2]`` on ``device``."""
    cos, sin = _rope_freqs(head_dim, max_len, theta, scaling)
    return (torch.as_tensor(cos, dtype=torch.float32, device=device),
            torch.as_tensor(sin, dtype=torch.float32, device=device))


def rms_norm(x, w, eps, dtype=None):
    """fp32 statistics, times the weight promoted to fp32, cast to ``dtype``
    (default x's)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w).to(dtype or x.dtype)


def apply_rotary(x, cos, sin):
    """x: [B, S, H, Dh]; cos/sin: fp32 [Smax, Dh/2].  The products run in
    fp32 and the result is cast back to x's dtype (``llama.py:164``)."""
    S = x.shape[1]
    c = cos[:S][None, :, None, :]
    s = sin[:S][None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def lm_loss(logits, labels, attention_mask=None, loss_reduction="mean",
            sp_group=None):
    """Shifted next-token cross entropy (``llama.py:178 _lm_loss``): mean
    over positions, or over the positions the mask keeps.
    ``loss_reduction="sum_count"`` returns the sum and the count instead
    (fp32 0-dim tensors), which the engine turns into the mean over every
    rank's rows (``runtime/engine.py``).

    ``sp_group`` of more than one rank: ``logits``, ``labels`` and the mask
    are this rank's chunk of the sequence.  The shift crosses chunks, so
    the targets are the chunk of the global ``labels[:, 1:]`` (labels and
    mask gathered over the group, a few bytes a token), the global last
    position masked; "mean" is then the global mean, whose gradient is this
    chunk's share of it (summed over the group, the global gradient)."""
    return _shifted_loss(
        lambda rows, tgt: softmax_cross_entropy_with_logits(logits[:, rows],
                                                            tgt),
        labels.to(logits.device), attention_mask, loss_reduction, sp_group)


def lm_loss_chunked(x, w, labels, attention_mask, chunk, logit_dtype,
                    loss_reduction="mean", sp_group=None, tp=None):
    """:func:`lm_loss` through the fused chunked head + loss (``llama.py:189
    _lm_loss_chunked``): x [B, S, D] final hidden states, w [D, V] head
    kernel; no [B, S, V] logits.  Under sp the targets and weights are
    :func:`lm_loss`'s (the global shift), not a local ``[:, :-1]``.
    ``tp=(group, start, vocab)``: ``w`` is this rank's columns of a
    vocabulary-sharded head (``sequence/cross_entropy.py``); x must have
    entered the tp region."""

    def token_loss(rows, tgt):
        xs = x[:, rows]
        B, n, D = xs.shape
        return fused_linear_cross_entropy(
            xs.reshape(B * n, D), w, tgt.reshape(B * n), chunk,
            logit_dtype, tp).view(B, n)

    return _shifted_loss(token_loss, labels.to(x.device), attention_mask,
                         loss_reduction, sp_group)


def lm_loss_vocab_parallel(logits, labels, start, vocab, group,
                           attention_mask=None, loss_reduction="mean",
                           sp_group=None):
    """:func:`lm_loss` of a vocabulary-sharded head's logits: columns
    ``[start, start + n)`` of a ``vocab``-wide vocabulary on each rank of
    ``group`` (pad columns past ``vocab``), the loss over the whole
    vocabulary (``sequence/cross_entropy.py:vocab_parallel_cross_entropy``)
    without gathering the logits."""
    return _shifted_loss(
        lambda rows, tgt: vocab_parallel_cross_entropy(
            logits[:, rows], tgt, start, vocab, group),
        labels.to(logits.device), attention_mask, loss_reduction, sp_group)


def _shifted_loss(token_loss, labels, attention_mask, loss_reduction,
                  sp_group):
    """The next-token loss of :func:`lm_loss`; ``token_loss(rows, targets)``
    gives the fp32 per-token loss of the positions ``rows`` (a slice)."""
    sp = sp_group is not None and sp_group.size() > 1
    if sp:
        labels, m = _sp_targets(labels, attention_mask, sp_group)
        loss = token_loss(slice(None), labels)
        total, count = (loss * m).sum(), m.sum()
    else:
        loss = token_loss(slice(None, -1), labels[:, 1:])
        if attention_mask is not None:
            m = attention_mask[:, 1:].float()
            total, count = (loss * m).sum(), m.sum()
        else:
            total = loss.sum()
            # filled on the device: no copy from the host, no wait for it
            count = torch.full((), float(loss.numel()), dtype=torch.float32,
                               device=loss.device)
    if loss_reduction == "sum_count":
        return total, count
    if loss_reduction != "mean":
        raise ValueError(f"loss_reduction {loss_reduction!r}: 'mean' or "
                         "'sum_count'")
    if sp:
        from .. import comm as dist
        both = dist.all_reduce(torch.stack([total.detach(), count]),
                               group=sp_group)
        return (total + (both[0] - total.detach())) / torch.clamp(both[1],
                                                                  min=1.0)
    if attention_mask is not None:
        return total / torch.clamp(count, min=1.0)
    return loss.mean()


def _sp_targets(labels, attention_mask, group):
    """(the chunk's targets, its fp32 weights) for the rank's sequence
    chunk: the global ``labels[:, 1:]`` and mask ``[:, 1:]`` (ones without
    a mask) padded by one masked position and cut at the chunk."""
    from .. import comm as dist
    c, q = labels.shape[1], group.rank()
    group = group.as_flat()    # plain gathers, never a quantized wire
    full = dist.all_gather(labels.contiguous(), group=group, axis=1)
    m = (torch.ones_like(full, dtype=torch.float32) if attention_mask is None
         else dist.all_gather(attention_mask.float().contiguous(),
                              group=group, axis=1))
    tgt = F.pad(full[:, 1:], (0, 1))[:, q * c:(q + 1) * c]
    m = F.pad(m[:, 1:], (0, 1))[:, q * c:(q + 1) * c]
    return tgt.to(labels.device), m.to(labels.device)


def sequence_chunk(cfg, chunk_len):
    """(sp group, the chunk's first global position) of a model config:
    (None, 0) without ``use_ulysses``.  Both backends split the sequence
    the same way; they differ in the attention only."""
    if not cfg.use_ulysses:
        return None, 0
    if cfg.sp_backend not in ("ulysses", "ring"):
        raise ValueError(f"sp_backend {cfg.sp_backend!r}: 'ulysses' or "
                         "'ring'")
    from ..utils import groups
    group = groups._get_sequence_parallel_group()
    return group, group.rank() * chunk_len


def _dense(x, lin, dtype, weights=None):
    """flax ``Dense(dtype=...)``: input and weights cast to ``dtype``
    (``weights``: the ``(weight, bias)`` to use instead of ``lin``'s)."""
    w, b = weights if weights is not None else (lin.weight, lin.bias)
    bias = None if b is None else b.to(dtype)
    return F.linear(x.to(dtype), w.to(dtype), bias)


def _head_product(x, w):
    """The LM head; an fp32 product runs in full fp32 on the card (TF32 off
    for this product only, the caller's setting restored)."""
    if x.dtype != torch.float32:
        return F.linear(x, w)
    with full_fp32_matmul():
        return F.linear(x, w)


def param_count(config: LlamaConfig):
    D, I, V, L = (config.hidden_size, config.intermediate_size,
                  config.vocab_size, config.num_hidden_layers)
    H, Hkv, Dh = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    per_layer = (D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D) + 3 * D * I + 2 * D
    total = V * D + L * per_layer + D
    if not config.tie_word_embeddings:
        total += D * V
    return total


def torch_dtype(name):
    """The torch dtype of a config's dtype string ("bfloat16", ...)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class RMSNorm(nn.Module):
    """Holds the weight (fp32 as built); the ragged step applies it with
    ``config.rms_norm_eps`` (fp32 statistics)."""

    def __init__(self, dim, device=None, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x, dtype=None):
        return rms_norm(x, self.weight, self.eps, dtype)


def _linear(n_in, n_out, bias, dtype, device):
    lin = nn.Linear(n_in, n_out, bias=bias, dtype=dtype, device=device)
    lin.requires_grad_(False)
    return lin


class LlamaAttention(nn.Module):

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, H, Hkv, Dh = (cfg.hidden_size, cfg.num_attention_heads,
                         cfg.num_key_value_heads, cfg.head_dim)
        b = cfg.attention_bias
        self.config = cfg
        self.q_proj = _linear(D, H * Dh, b, dtype, device)
        self.k_proj = _linear(D, Hkv * Dh, b, dtype, device)
        self.v_proj = _linear(D, Hkv * Dh, b, dtype, device)
        self.o_proj = _linear(H * Dh, D, False, dtype, device)

    def forward(self, x, cos, sin, use_kernel=True):
        return reduce_from_tp_region(self.partial(x, cos, sin, use_kernel),
                                     tp_group_of(self.o_proj))

    def partial(self, x, cos, sin, use_kernel=True):
        """x: [B, S, D] → [B, S, D]; causal (and windowed) self-attention,
        before o_proj's reduce over the tp group (:meth:`forward` adds it;
        ``runtime/domino`` starts it async).
        GQA repeats the kv heads up to H first (``llama.py:279-282``);
        under Ulysses kv goes to ``DistributedAttention`` at its own width,
        under the ring to ``RingAttention`` (cos/sin then start at the
        chunk's first position).  Under tensor
        parallelism (``module_inject``) the heads are this rank's, read
        from the weights (``attention_heads``), x enters the tp region once
        for q, k and v, and o_proj's product is this rank's partial sum."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        B, S, _ = x.shape
        Dh = cfg.head_dim
        H, Hkv, rows, group = attention_heads(self.q_proj, self.k_proj, cfg)
        x = copy_to_tp_region(x, group)
        q = apply_rotary(_dense(x, self.q_proj, dt).view(B, S, H, Dh), cos,
                         sin)
        k = apply_rotary(_dense(x, self.k_proj, dt, kv_weights(
            self.k_proj, rows, group)).view(B, S, Hkv, Dh), cos, sin)
        v = _dense(x, self.v_proj, dt, kv_weights(
            self.v_proj, rows, group)).view(B, S, Hkv, Dh)
        if cfg.use_ulysses and cfg.sp_backend == "ring":
            # k/v circulate at their own width (JAX llama.py:259-268)
            from ..sequence.ring_attention import RingAttention
            out = RingAttention()(q, k, v, causal=True,
                                  window=cfg.sliding_window,
                                  use_kernel=use_kernel)
        elif cfg.use_ulysses:
            from ..sequence.layer import DistributedAttention
            out = DistributedAttention()(q, k, v, causal=True,
                                         window=cfg.sliding_window,
                                         use_kernel=use_kernel)
        else:
            if Hkv != H:
                k = k.repeat_interleave(H // Hkv, dim=2)
                v = v.repeat_interleave(H // Hkv, dim=2)
            out = attention_core(q, k, v, causal=True,
                                 window=cfg.sliding_window,
                                 use_kernel=use_kernel)
        return _dense(out.reshape(B, S, H * Dh), self.o_proj, dt)


class LlamaMLP(nn.Module):

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.dtype = torch_dtype(cfg.dtype)
        self.gate_proj = _linear(D, I, False, dtype, device)
        self.up_proj = _linear(D, I, False, dtype, device)
        self.down_proj = _linear(I, D, False, dtype, device)

    def forward(self, x):
        return reduce_from_tp_region(self.partial(x),
                                     tp_group_of(self.down_proj))

    def partial(self, x):
        """The MLP before down_proj's reduce over the tp group."""
        dt = self.dtype
        x = copy_to_tp_region(x, tp_group_of(self.gate_proj))
        return _dense(F.silu(_dense(x, self.gate_proj, dt)) *
                      _dense(x, self.up_proj, dt), self.down_proj, dt)


class LlamaDecoderLayer(nn.Module):

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.dtype = torch_dtype(cfg.dtype)
        eps = cfg.rms_norm_eps
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, device, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, device, eps)

    def forward(self, x, cos, sin, use_kernel=True):
        h = x + self.self_attn(self.input_layernorm(x, self.dtype), cos, sin,
                               use_kernel)
        return h + self.mlp(self.post_attention_layernorm(h, self.dtype))


class LlamaBackbone(nn.Module):

    def __init__(self, cfg, dtype, device, layer=LlamaDecoderLayer):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dtype, device=device)
        self.embed_tokens.requires_grad_(False)
        self.layers = nn.ModuleList(
            layer(cfg, dtype, device) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, device, cfg.rms_norm_eps)


class LlamaModel(nn.Module):
    """Causal-LM weights under HuggingFace names.  With
    ``tie_word_embeddings`` the fp32 ``lm_head`` is a copy of the embedding,
    made when the embedding is loaded (the head runs in fp32 either way).

    ``device="meta"`` builds the module without storage, for loading."""

    LAYER = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        dtype = torch_dtype(config.dtype)
        self.model = LlamaBackbone(config, dtype, device, self.LAYER)
        self.lm_head = _linear(config.hidden_size, config.vocab_size, False,
                               torch.float32, device)

    @property
    def device(self):
        # the final norm's weight: never quantized (quant_serving)
        return self.model.norm.weight.device

    def forward(self, input_ids, labels=None, attention_mask=None,
                use_kernel=True, loss_reduction="mean"):
        """Training forward (``llama.py:325``): logits [B, S, V] in the head
        dtype, or, with ``labels``, the shifted cross-entropy loss (fp32
        scalar; ``attention_mask`` weights it and does not enter attention,
        as in the JAX model; ``loss_reduction``: :func:`lm_loss`).
        ``use_kernel=False`` runs attention's plain version on any device.
        ``use_ulysses``: the inputs are the rank's sequence chunk (module
        docstring)."""
        x, cos, sin, sp_group = self._embed(input_ids)
        remat_on = self._remat_on()
        for layer in self.model.layers:
            if remat_on:
                x = remat(layer, self.config.remat_policy)(x, cos, sin,
                                                           use_kernel)
            else:
                x = layer(x, cos, sin, use_kernel)
        return self._head_loss(x, labels, attention_mask, loss_reduction,
                               sp_group)

    def forward_microstreams(self, n_streams, input_ids, labels=None,
                             attention_mask=None, use_kernel=True,
                             loss_reduction="mean"):
        """:meth:`forward`'s loss with the batch split into ``n_streams``
        µ-streams that run interleaved block by block
        (``runtime/domino/transformer.py:domino_layer``: each stream's tp
        reduces fly under the next stream's products); the parts' losses
        combine as ``split_microstreams`` combines them."""
        from ..runtime.domino.transformer import (check_split,
                                                  combine_losses,
                                                  domino_layer, split_batch)
        if labels is None:
            raise ValueError("forward_microstreams computes the loss: pass "
                             "labels")
        B = input_ids.shape[0]
        check_split(B, n_streams)
        xs, cos, sin, sp_group = [], None, None, None
        for ids in split_batch(input_ids, n_streams, B):
            x, cos, sin, sp_group = self._embed(ids)
            xs.append(x)
        remat_on = self._remat_on()
        for layer in self.model.layers:
            if remat_on:
                xs = remat(domino_layer, self.config.remat_policy)(
                    layer, xs, cos, sin, use_kernel)
            else:
                xs = domino_layer(layer, xs, cos, sin, use_kernel)
        parts = zip(xs, split_batch(labels, n_streams, B),
                    split_batch(attention_mask, n_streams, B))
        return combine_losses([
            self._head_loss(x, lab, mask, loss_reduction, sp_group)
            for x, lab, mask in parts])

    def _remat_on(self):
        on = self.config.remat and torch.is_grad_enabled()
        if on:
            policy_ops(self.config.remat_policy)   # an unknown name raises
        return on

    def _embed(self, input_ids):
        """(hidden states, cos, sin, sp group) of the input ids: the
        embedding in the model dtype and the rotary tables from the
        chunk's first position."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        sp_group, offset = sequence_chunk(cfg, input_ids.shape[1])
        x = tp_embedding(self.model.embed_tokens, input_ids, dt)
        cos, sin = rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, cfg.rope_scaling, x.device)
        return x, cos[offset:], sin[offset:], sp_group

    def _head_loss(self, x, labels, attention_mask, loss_reduction,
                   sp_group):
        """The final norm, the head and, with ``labels``, the loss."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        body = self.model
        x = body.norm(x, dt)
        hd = torch_dtype(cfg.head_dtype)
        head = body.embed_tokens if cfg.tie_word_embeddings else self.lm_head
        if cfg.loss_chunk_vocab and labels is not None:
            return self._chunked_loss(x, head, labels, attention_mask, hd,
                                      loss_reduction, sp_group)
        x = copy_to_tp_region(x, tp_group_of(head))
        if cfg.tie_word_embeddings:
            # flax Embed.attend promotes both sides to the model dtype
            logits = _head_product(x.to(hd).to(dt),
                                   body.embed_tokens.weight.to(dt))
        else:
            logits = _head_product(x.to(hd), self.lm_head.weight.to(hd))
        # a vocabulary-sharded head: the whole vocabulary on every rank
        logits = gather_logits(logits, head)
        if labels is None:
            return logits
        return lm_loss(logits, labels.to(logits.device), attention_mask,
                       loss_reduction, sp_group)

    def _chunked_loss(self, x, head, labels, attention_mask, hd,
                      loss_reduction, sp_group):
        """The loss through the fused chunked head + loss (JAX
        ``llama.py:343-358``): the head's weight (the embedding when tied)
        as the [D, V] kernel, products in the head dtype."""
        group = tp_group_of(head)
        tp = None
        if group is not None:
            # the rank's vocabulary columns, chunk by chunk; the rows'
            # max and sum-exp combined over tp once (JAX's GSPMD scan)
            x = copy_to_tp_region(x, group)
            tp = (group, head.tp_rank * head.weight.shape[0],
                  self.config.vocab_size)
        return lm_loss_chunked(x, head.weight.t(), labels, attention_mask,
                               self.config.loss_chunk_vocab, hd,
                               loss_reduction, sp_group, tp)

    def streaming_parts(self):
        """ZeRO-Infinity's view of the model (``runtime/zero/infinity.py``;
        JAX ``llama.py:370-440``): embed → L blocks → head, each block
        applied by ``torch.func.functional_call`` on one block module built
        on the meta device with the fetched block's leaves."""
        return llama_streaming_parts(self)

    def tie_weights(self):
        """Training with ``tie_word_embeddings``: the head IS the embedding
        (one parameter), as in the JAX model, which has no head leaf then.
        Serving keeps its separate fp32 copy instead (:meth:`load_weights`)."""
        if self.config.tie_word_embeddings:
            self.lm_head.weight = self.model.embed_tokens.weight

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator`` (a seeded ``torch.Generator``
        on the module's device): normal(0, std) projections and embedding,
        unit norms."""
        for name, p in self.named_parameters():
            init_leaf(name, p, generator, std)
        if self.config.tie_word_embeddings:
            self.lm_head.weight.copy_(self.model.embed_tokens.weight)
        return self

    @torch.no_grad()
    def load_weights(self, named_tensors, device=None):
        """Install ``(hf_name, tensor)`` pairs as the module's parameters,
        cast to each parameter's dtype and moved to ``device`` (default: the
        module's device unless it is meta).  A tensor already of the right
        dtype on the right device is installed without a copy.  Every
        parameter must be given; unknown names raise."""
        params = dict(self.named_parameters())
        if device is None:
            device = self.device
            if device.type == "meta":
                raise ValueError("load_weights on a meta module needs device=")
        device = torch.device(device)
        seen = set()
        for name, t in named_tensors:
            self._load(name, t, params, device, seen)
        missing = sorted(set(params) - seen)
        if missing:
            raise KeyError(f"checkpoint lacks {len(missing)} weight(s), "
                           f"first {missing[:4]}")
        return self

    def _load(self, name, t, params, device, seen):
        """Install one named tensor; ``params``: the module's parameters
        before loading, by name; ``seen``: the names installed so far."""
        tied = self.config.tie_word_embeddings
        if tied and name == "lm_head.weight":
            return
        if name not in params:
            raise KeyError(f"unexpected weight {name!r}")
        self._install(name, t, params[name].dtype, params[name].shape, device)
        seen.add(name)
        if tied and name == "model.embed_tokens.weight":
            self._install("lm_head.weight", t, torch.float32,
                          params["lm_head.weight"].shape, device)
            seen.add("lm_head.weight")

    def _install(self, name, t, dtype, shape, device):
        # a tensor-parallel model keeps this rank's slice of a whole tensor
        t = tp_local(self, name, t)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        *path, leaf = name.split(".")
        mod = self
        for p in path:
            mod = getattr(mod, p)
        setattr(mod, leaf, nn.Parameter(
            t.detach().to(device=device, dtype=dtype), requires_grad=False))


def tp_rules(config: LlamaConfig):
    """Tensor-parallel rules (JAX ``llama.py:441-464``): flax path suffix →
    spec.  Column-parallel q/k/v (the head dim), gate/up and the head, and
    the embedding on its vocabulary; row-parallel o/down.  JAX's ``zero``
    pin is dropped: it places ZeRO's shard of a leaf, and the port's ZeRO
    slices flat buffers."""
    tp = "tp"
    return {
        "q_proj/kernel": Spec(None, tp, None),
        "k_proj/kernel": Spec(None, tp, None),
        "v_proj/kernel": Spec(None, tp, None),
        "o_proj/kernel": Spec(tp, None),
        "gate_proj/kernel": Spec(None, tp),
        "up_proj/kernel": Spec(None, tp),
        "down_proj/kernel": Spec(tp, None),
        "embed_tokens/embedding": Spec(tp, None),
        "lm_head/kernel": Spec(None, tp),
    }


def tp_leaf_info(name, shape, cfg):
    """``(flax path, flax shape, torch dim of each flax dim)`` of an
    HF-named leaf of ``shape`` (``module_inject/auto_tp.py``); None for a
    tied head, which has no flax leaf.  A transposed kernel swaps its dims;
    a q/k/v kernel ``[H·Dh, D]`` is flax's ``[D, H, Dh]``, whose head dim is
    a slab of torch's dim 0 (its Dh dim is none)."""
    if name == "model.embed_tokens.weight":
        return ("embed_tokens", "embedding"), shape, (0, 1)
    if name == "model.norm.weight":
        return ("norm", "weight"), shape, (0, )
    if name == "lm_head.weight":
        if cfg.tie_word_embeddings:
            return None
        return ("lm_head", "kernel"), shape[::-1], (1, 0)
    parts = name.split(".")
    layer, block = f"layers_{parts[2]}", parts[3]
    if block in ("input_layernorm", "post_attention_layernorm"):
        return (layer, block, "weight"), shape, (0, )
    proj, leaf = parts[4:]
    if block == "mlp" or proj == "o_proj":
        return (layer, block, proj, "kernel"), shape[::-1], (1, 0)
    dh = cfg.head_dim
    if leaf == "bias":
        return (layer, block, proj, "bias"), (shape[0] // dh, dh), (0, None)
    return ((layer, block, proj, "kernel"), (shape[1], shape[0] // dh, dh),
            (1, 0, None))


def init_leaf(name, t, generator, std=0.02):
    """One leaf of :meth:`LlamaModel.init_weights`'s random init."""
    if name.endswith("layernorm.weight") or name == "model.norm.weight":
        t.fill_(1.0)
    elif name.endswith(".bias"):
        t.zero_()
    else:
        t.normal_(0.0, std, generator=generator)


def llama_streaming_parts(model):
    """The :class:`~..runtime.zero.infinity.StreamingSpec` of a
    :class:`LlamaModel`.  The attention mask is not threaded into the
    blocks: attention is causal-only here as in the monolithic model, and
    the mask weights the loss (JAX ``llama.py:401-404``)."""
    from torch.func import functional_call
    from ..runtime.zero.infinity import StreamingSpec
    cfg = model.config
    dt = torch_dtype(cfg.dtype)
    hd = torch_dtype(cfg.head_dtype)
    block = model.LAYER(cfg, dt, "meta")
    tied = cfg.tie_word_embeddings
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    resident = ["model.embed_tokens.weight", "model.norm.weight"] + \
        ([] if tied else ["lm_head.weight"])

    def embed_apply(res, input_ids, labels=None, attention_mask=None):
        return F.embedding(input_ids.long(),
                           res["model.embed_tokens.weight"].to(dt))

    def block_apply(w, x, use_kernel=True):
        # under sp the rotary tables start at the chunk's first position
        # and attention is DistributedAttention over the sp group
        _, offset = sequence_chunk(cfg, x.shape[1])
        cos, sin = rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, cfg.rope_scaling, x.device)
        return functional_call(block, w, (x, cos[offset:], sin[offset:],
                                          use_kernel))

    def head_apply(res, x, input_ids, labels=None, attention_mask=None,
                   loss_reduction="mean"):
        x = rms_norm(x, res["model.norm.weight"], cfg.rms_norm_eps, dt)
        if tied:
            logits = _head_product(x.to(hd).to(dt),
                                   res["model.embed_tokens.weight"].to(dt))
        else:
            logits = _head_product(x.to(hd), res["lm_head.weight"].to(hd))
        if labels is None:
            return logits
        return lm_loss(logits, labels.to(logits.device), attention_mask,
                       loss_reduction, sequence_chunk(cfg, x.shape[1])[0])

    L = cfg.num_hidden_layers
    return StreamingSpec(
        block_keys=tuple(f"layers_{i}" for i in range(L)),
        block_prefixes=tuple(f"model.layers.{i}." for i in range(L)),
        block_leaves=tuple((n, tuple(p.shape))
                           for n, p in block.named_parameters()),
        resident_keys=("embed_tokens", "norm") + (() if tied else
                                                  ("lm_head", )),
        resident_leaves=tuple((n, shapes[n]) for n in resident),
        embed_apply=embed_apply, block_apply=block_apply,
        head_apply=head_apply, init_leaf=init_leaf)


def params_from_flax(tree, cfg: LlamaConfig, dtype=None, device="cpu"):
    """The JAX package's flax param tree (numpy leaves) → an HF-named state
    dict of torch tensors for :class:`LlamaModel`.  ``dtype="float32"``
    gives the fp32 master weights the training engine takes as
    ``model_parameters`` (without ``lm_head.weight`` when tied).

    Layouts: ``{q,k,v}_proj/kernel`` ``[D, H, Dh]`` → ``[H·Dh, D]`` (bias
    ``[H, Dh]`` → ``[H·Dh]``); ``o_proj/kernel`` ``[H·Dh, D]`` → ``[D, H·Dh]``;
    MLP kernels ``[in, out]`` → ``[out, in]``; ``lm_head/kernel`` ``[D, V]``
    → ``[V, D]``; the embedding and norms keep their shapes.  ``dtype`` is
    the projection and embedding dtype (default ``cfg.dtype``); norms and
    the head stay fp32."""
    t = _flax_converter(dtype or cfg.dtype, device)
    out = _flax_attention_and_norms(tree, cfg, t)
    for i in range(cfg.num_hidden_layers):
        mlp = tree[f"layers_{i}"]["mlp"]
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out[f"model.layers.{i}.mlp.{proj}.weight"] = t(
                np.asarray(mlp[proj]["kernel"]).T)
    return out


def params_to_flax(named, cfg: LlamaConfig):
    """The exact inverse of :func:`params_from_flax`: HF-named tensors or
    arrays (any subset, e.g. one leaf, or a moment of the optimizer, which
    shares the weights' layout) → the JAX package's nested flax tree of
    fp32 numpy leaves in the flax shapes (``[H·Dh, D]`` q/k/v weights →
    ``[D, H, Dh]`` kernels, ``[out, in]`` → ``[in, out]``).  A tied head
    is the embedding, so ``lm_head.weight`` has no leaf of its own."""
    out = {}
    for name, value in named.items():
        a = (value.detach().float().cpu().numpy()
             if isinstance(value, torch.Tensor)
             else np.asarray(value, dtype=np.float32))
        path, a = _flax_leaf(name, a, cfg)
        if path is None:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(a, dtype=np.float32)
    return out


def _flax_leaf(name, a, cfg):
    """(flax path, array in the flax shape) of one HF-named leaf."""
    if name == "model.embed_tokens.weight":
        return ("embed_tokens", "embedding"), a
    if name == "model.norm.weight":
        return ("norm", "weight"), a
    if name == "lm_head.weight":
        if cfg.tie_word_embeddings:
            return None, a
        return ("lm_head", "kernel"), a.T
    parts = name.split(".")
    if parts[:2] != ["model", "layers"] or len(parts) not in (5, 6):
        raise KeyError(f"{name!r} is no Llama weight")
    layer, block = f"layers_{parts[2]}", parts[3]
    if block in ("input_layernorm", "post_attention_layernorm"):
        return (layer, block, "weight"), a
    proj, leaf = parts[4:]
    if block == "mlp":
        return (layer, "mlp", proj, "kernel"), a.T
    if proj == "o_proj":
        return (layer, "self_attn", proj, "kernel"), a.T
    heads = (cfg.num_attention_heads if proj == "q_proj"
             else cfg.num_key_value_heads)
    if leaf == "bias":
        return (layer, "self_attn", proj, "bias"), a.reshape(heads, -1)
    return (layer, "self_attn", proj, "kernel"), a.T.reshape(
        cfg.hidden_size, heads, -1)


def _flax_converter(dtype, device):
    """numpy leaf → contiguous torch tensor on ``device``, by default in
    ``dtype``."""
    dt = torch_dtype(dtype)

    def t(a, to=dt):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(
            device=device, dtype=to).contiguous()

    return t


def _flax_attention_and_norms(tree, cfg, t):
    """The leaves every Llama-skeleton model shares: embedding, final norm,
    head, and each layer's attention and norms (see
    :func:`params_from_flax`)."""
    out = {"model.embed_tokens.weight": t(tree["embed_tokens"]["embedding"]),
           "model.norm.weight": t(tree["norm"]["weight"], torch.float32)}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = t(np.asarray(tree["lm_head"]["kernel"]).T,
                                  torch.float32)
    for i in range(cfg.num_hidden_layers):
        lp = tree[f"layers_{i}"]
        pre = f"model.layers.{i}."
        attn = lp["self_attn"]
        for proj in ("q_proj", "k_proj", "v_proj"):
            k = np.asarray(attn[proj]["kernel"])          # [D, H, Dh]
            out[pre + f"self_attn.{proj}.weight"] = t(
                k.reshape(k.shape[0], -1).T)
            if "bias" in attn[proj]:
                out[pre + f"self_attn.{proj}.bias"] = t(
                    np.asarray(attn[proj]["bias"]).reshape(-1))
        out[pre + "self_attn.o_proj.weight"] = t(
            np.asarray(attn["o_proj"]["kernel"]).T)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[pre + f"{norm}.weight"] = t(lp[norm]["weight"], torch.float32)
    return out
