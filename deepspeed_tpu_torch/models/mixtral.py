"""Mixtral-family model (sparse-MoE Llama; the port of
``deepspeed_tpu/models/mixtral.py``) for serving.

Attention and norms are the port's Llama modules; the MLP is a top-k router
over ``E`` experts whose weights are STACKED as in the JAX tree — ``w1``/
``w3`` ``[E, D, I]``, ``w2`` ``[E, I, D]``, the router gate ``[D, E]``
(fp32) — so that the grouped-matmul kernel reads row-major ``[K, N]``
weight tiles and the quantized-serving groups fall on the same elements as
in the JAX package.  The stacks live under
``model.layers.{i}.block_sparse_moe.{gate,w1,w2,w3}``; everything else keeps
the Llama model's HuggingFace names.

The expert compute is :func:`moe_apply` — exact (no-drop) top-k routing, a
stable sort of token copies by expert, and the grouped matmul
(``ops/kernels/grouped_matmul.py``, kernel B7) — serving through
``inference/v2/ragged_forward.py:mixtral_ragged_step``.
"""

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.grouped_matmul import gmm, gmm_plain
from ..utils.not_ported import not_ported
from .llama import (LlamaAttention, LlamaConfig, LlamaModel, RMSNorm,
                    _flax_attention_and_norms, _flax_converter)


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    # qwen2-moe extensions (a dense shared expert; raw top-k probabilities):
    # not ported (ROADMAP queue A item S5)
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = True


def mixtral_tiny(**overrides):
    return MixtralConfig(**{**dict(vocab_size=256, hidden_size=64,
                                   intermediate_size=128, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2,
                                   max_position_embeddings=128,
                                   num_local_experts=4, num_experts_per_tok=2),
                            **overrides})


def moe_expert_ffn(x_sorted, group_sizes, w1, w2, w3, use_kernel=True):
    """Grouped SwiGLU over tokens sorted by expert (``mixtral.py:53``).
    x_sorted: [Tk, D]; group_sizes: [E] int32 on x's device; w1/w3:
    [E, D, I]; w2: [E, I, D] → [Tk, D].  ``use_kernel=False``: the grouped
    matmul's plain version."""
    mm = gmm if use_kernel else gmm_plain
    gate = mm(x_sorted, w1, group_sizes)
    up = mm(x_sorted, w3, group_sizes)
    return mm(F.silu(gate) * up, w2, group_sizes)


def moe_apply(x, router_logits, w1, w2, w3, k, norm_topk=True,
              use_kernel=True):
    """Exact (no-drop) top-k MoE (``mixtral.py:78``): fp32 softmax, top-k
    (renormalised), a stable sort of the token copies by expert, the grouped
    SwiGLU, then the routing weights — cast to the activation dtype first —
    scale each copy and a scatter-add in that dtype sums them per token.
    x: [T, D] → [T, D].  The group sizes never leave the device."""
    T, D = x.shape
    E = w1.shape[0]
    probs = torch.softmax(router_logits.float(), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)              # [T, k]
    if norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    flat_expert = topi.reshape(-1)                          # [T·k]
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // k                                   # source token
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device)
    group_sizes.index_add_(0, flat_expert,
                           torch.ones_like(flat_expert, dtype=torch.int32))
    y_sorted = moe_expert_ffn(x[token_of], group_sizes, w1, w2, w3,
                              use_kernel)
    w_sorted = topw.reshape(-1)[order].to(y_sorted.dtype)
    out = torch.zeros(T, D, dtype=y_sorted.dtype, device=x.device)
    out.index_add_(0, token_of, y_sorted * w_sorted[:, None])
    return out.to(x.dtype)


class MixtralSparseMoeBlock(nn.Module):
    """Router gate ``[D, E]`` (fp32) and stacked experts in the model
    dtype (HF ``block_sparse_moe``)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        E, D, I = (cfg.num_local_experts, cfg.hidden_size,
                   cfg.intermediate_size)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.gate = param(D, E, dt=torch.float32)
        self.w1 = param(E, D, I)
        self.w3 = param(E, D, I)
        self.w2 = param(E, I, D)


class MixtralDecoderLayer(nn.Module):

    def __init__(self, cfg, dtype, device):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.block_sparse_moe = MixtralSparseMoeBlock(cfg, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, device, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, device, eps)


_EXPERT_SLICE = re.compile(r"(.*\.block_sparse_moe\.w[123])\.(\d+)$")


class MixtralModel(LlamaModel):
    """Causal-LM weights: the Llama model's, with each layer's MLP replaced
    by :class:`MixtralSparseMoeBlock`.  Serving only: the training forward
    is not ported.

    :meth:`load_weights` takes whole tensors under the module's own names,
    and also one expert at a time as ``...block_sparse_moe.w1.{e}`` (the
    stack's ``[D, I]`` slice): each stack is allocated once on the target
    device and filled in place, so a streamed checkpoint never holds a
    per-expert copy of the model beside the stacks."""

    LAYER = MixtralDecoderLayer

    def __init__(self, config: MixtralConfig, device=None):
        if config.shared_expert_intermediate_size:
            raise not_ported("the qwen2-moe shared expert "
                             "(shared_expert_intermediate_size > 0)", "S5")
        super().__init__(config, device)

    def forward(self, *args, **kwargs):
        raise not_ported("MixtralModel training forward", 8)

    def _load(self, name, t, params, device, seen):
        """An expert slice ``...block_sparse_moe.w1.{e}`` goes into its
        stack (allocated on ``device`` at its first slice); the stack counts
        as loaded once all its experts have arrived."""
        m = _EXPERT_SLICE.match(name)
        if m is None:
            return super()._load(name, t, params, device, seen)
        stack, e = m.group(1), int(m.group(2))
        if stack not in params:
            raise KeyError(f"unexpected weight {name!r}")
        ref = params[stack]
        E = ref.shape[0]
        if tuple(t.shape) != tuple(ref.shape[1:]) or not 0 <= e < E:
            raise ValueError(f"{name}: shape {tuple(t.shape)} or index does "
                             f"not fit the stack {tuple(ref.shape)}")
        slices = [f"{stack}.{i}" for i in range(E)]
        if not any(s in seen for s in slices):
            self._install(stack, torch.empty(ref.shape, dtype=ref.dtype,
                                             device=device),
                          ref.dtype, ref.shape, device)
        owner = self
        for p in stack.split("."):
            owner = getattr(owner, p)
        owner[e].copy_(t)
        seen.add(name)
        if all(s in seen for s in slices):
            seen.add(stack)


def params_from_flax(tree, cfg: MixtralConfig, dtype=None, device="cpu"):
    """The JAX package's flax ``MixtralModel`` tree (numpy leaves) → a state
    dict for :class:`MixtralModel`: the Llama leaves as in
    ``models/llama.py:params_from_flax``, each layer's ``moe/gate/kernel``
    ``[D, E]`` in fp32 and the ``moe/w1``/``w2``/``w3`` stacks as they are,
    in ``dtype`` (default ``cfg.dtype``)."""
    t = _flax_converter(dtype or cfg.dtype, device)
    out = _flax_attention_and_norms(tree, cfg, t)
    for i in range(cfg.num_hidden_layers):
        moe = tree[f"layers_{i}"]["moe"]
        pre = f"model.layers.{i}.block_sparse_moe."
        out[pre + "gate"] = t(moe["gate"]["kernel"], torch.float32)
        for w in ("w1", "w2", "w3"):
            out[pre + w] = t(np.asarray(moe[w]))
    return out


def param_count(config: MixtralConfig):
    D, I, V, L, E = (config.hidden_size, config.intermediate_size,
                     config.vocab_size, config.num_hidden_layers,
                     config.num_local_experts)
    H, Hkv, Dh = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    per_layer = (D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D) \
        + E * 3 * D * I + D * E + 2 * D
    total = V * D + L * per_layer + D
    if not config.tie_word_embeddings:
        total += D * V
    return total
