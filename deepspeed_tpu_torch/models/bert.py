"""BERT (the port of ``deepspeed_tpu/models/bert.py``): BASELINE config 1
(BERT-base, ZeRO 0, fp32) and BERT-large.

Plain PyTorch, because the JAX model is plain XLA with no Pallas kernel:
post-LN encoder blocks, Q/K/V as ``DenseGeneral`` to ``(H, Dh)``, the
masked softmax in fp32 (masked logits filled with ``finfo(float32).min``),
exact-erf GELU, LayerNorm with eps 1e-12 (flax's, ``gpt2.LayerNorm``), word,
position and token-type embeddings, the tied MLM head (``we.attend``: both
sides in the model dtype) with the optional ``mlm_transform`` and
``mlm_bias``, ``remat`` per layer, and the masked-mean loss over labels
>= 0 (-100 is ignored).  Attention is ``einsum`` and ``softmax``, as in JAX.
fp32 products run in full fp32 on the card (TF32 off for the forward).

Parameters keep the flax names and shapes (``layer_{i}`` becomes
``layer.{i}``); :func:`params_from_flax` turns a flax tree into them.
"""

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..accelerator import full_fp32_matmul
from ..comm.functional import copy_to_tp_region, gather_from_tp_region
from ..module_inject.layers import embed_rows, tp_group_of, vocab_slice
from ..sequence.cross_entropy import (softmax_cross_entropy_with_logits,
                                      vocab_parallel_cross_entropy)
from .gpt2 import Dense, Embed, LayerNorm, _param, flax_path
from .llama import torch_dtype


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # HF BertForMaskedLM's head: dense + gelu + LayerNorm before the tied
    # decoder, and a decoder bias
    mlm_transform: bool = False
    dtype: str = "float32"
    remat: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def bert_base(**overrides):
    return BertConfig(**overrides)


def bert_large(**overrides):
    return BertConfig(**{**dict(hidden_size=1024, num_hidden_layers=24,
                                num_attention_heads=16,
                                intermediate_size=4096), **overrides})


def bert_tiny(**overrides):
    return BertConfig(**{**dict(vocab_size=256, hidden_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                intermediate_size=128,
                                max_position_embeddings=128), **overrides})


def param_count(cfg: BertConfig):
    D, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    per_layer = 4 * (D * D + D) + (D * I + I) + (I * D + D) + 4 * D
    total = (V + cfg.max_position_embeddings + cfg.type_vocab_size) * D + \
        2 * D + L * per_layer
    if cfg.mlm_transform:
        total += D * D + D + 2 * D + V
    return total


class BertLayer(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        eps = cfg.layer_norm_eps
        self.config = cfg
        self.query = Dense((D, ), (H, Dh), device)
        self.key = Dense((D, ), (H, Dh), device)
        self.value = Dense((D, ), (H, Dh), device)
        self.attention_output = Dense((H, Dh), (D, ), device)
        self.attention_ln = LayerNorm(D, eps, device)
        self.intermediate = Dense((D, ), (cfg.intermediate_size, ), device)
        self.output = Dense((cfg.intermediate_size, ), (D, ), device)
        self.output_ln = LayerNorm(D, eps, device)

    def forward(self, x, mask=None):
        """Under tensor parallelism (the rules AutoTP derives from the
        dataflow) query, key, value and intermediate are this rank's
        columns (heads) and attention_output and output its rows: x enters
        the tp region before each column-parallel product and the
        row-parallel ones reduce their partial sums."""
        dt = torch_dtype(self.config.dtype)
        h = copy_to_tp_region(x, tp_group_of(self.query))
        q, k, v = self.query(h, dt), self.key(h, dt), self.value(h, dt)
        logits = torch.einsum("bshd,bthd->bhst", q, k) * \
            self.config.head_dim**-0.5
        logits = logits.float()
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :].bool(),
                                        torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(dt)
        ctx = torch.einsum("bhst,bthd->bshd", probs, v)
        x = self.attention_ln(x + self.attention_output.row_parallel(ctx,
                                                                    dt), dt)
        h = copy_to_tp_region(x, tp_group_of(self.intermediate))
        h = F.gelu(self.intermediate(h, dt))      # BERT's exact erf GELU
        return self.output_ln(x + self.output.row_parallel(h, dt), dt)


class BertModel(nn.Module):
    """Encoder + MLM head; ``forward(input_ids, labels=None,
    attention_mask=None, token_type_ids=None)``.  Built in fp32 (the
    training engine installs the leaves in its compute dtype);
    ``device="meta"`` builds it without storage."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        cfg = self.config = config
        D = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, D, device)
        self.position_embeddings = Embed(cfg.max_position_embeddings, D,
                                         device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, D, device)
        self.embeddings_ln = LayerNorm(D, cfg.layer_norm_eps, device)
        self.layer = nn.ModuleList(BertLayer(cfg, device)
                                   for _ in range(cfg.num_hidden_layers))
        if cfg.mlm_transform:
            self.mlm_dense = Dense((D, ), (D, ), device)
            self.mlm_ln = LayerNorm(D, cfg.layer_norm_eps, device)
            self.mlm_bias = _param(cfg.vocab_size, device=device)

    def forward(self, input_ids, labels=None, attention_mask=None,
                token_type_ids=None, loss_reduction="mean"):
        """Logits [B, S, V], or with ``labels`` the masked mean of the
        token losses over labels >= 0 (``loss_reduction="sum_count"``: the
        sum and the count, for the engine's global-batch loss)."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        with (full_fp32_matmul() if dt == torch.float32
              else contextlib.nullcontext()):
            logits, (group, start) = self._logits(
                input_ids, attention_mask, token_type_ids, dt)
        sharded = group is not None or logits.shape[-1] != cfg.vocab_size
        if labels is None:
            if sharded:
                logits = gather_from_tp_region(logits, group)[
                    ..., :cfg.vocab_size]
            return logits
        labels = labels.to(logits.device).long()
        if sharded:
            per_tok = vocab_parallel_cross_entropy(
                logits, torch.clamp(labels, min=0), start, cfg.vocab_size,
                group)
        else:
            per_tok = softmax_cross_entropy_with_logits(
                logits, torch.clamp(labels, min=0))
        m = (labels >= 0).float()
        total, count = (per_tok * m).sum(), m.sum()
        if loss_reduction == "sum_count":
            return total, count
        if loss_reduction != "mean":
            raise ValueError(f"loss_reduction {loss_reduction!r}: 'mean' or "
                             "'sum_count'")
        return total / torch.clamp(count, min=1.0)

    def _logits(self, input_ids, attention_mask, token_type_ids, dt):
        cfg = self.config
        ids = input_ids.long()
        S = ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        we = self.word_embeddings.embedding.to(dt)
        x = (embed_rows(self.word_embeddings, we, ids) +
             embed_rows(self.position_embeddings,
                        self.position_embeddings.embedding.to(dt),
                        torch.arange(S, device=ids.device)[None]) +
             embed_rows(self.token_type_embeddings,
                        self.token_type_embeddings.embedding.to(dt),
                        token_type_ids))
        x = self.embeddings_ln(x, dt)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                x = checkpoint(layer, x, attention_mask, use_reentrant=False)
            else:
                x = layer(x, attention_mask)
        if cfg.mlm_transform:
            x = F.gelu(self.mlm_dense(x, dt))
            x = self.mlm_ln(x, dt)
        # flax Embed.attend: both sides promoted to the model dtype; a
        # vocabulary-sharded table gives this rank's columns
        group, start, rows = vocab_slice(self.word_embeddings, we)
        logits = F.linear(copy_to_tp_region(x.float().to(dt), group), we)
        if cfg.mlm_transform:
            bias = self.mlm_bias
            if group is not None:
                bias = copy_to_tp_region(bias, group)[start:start + rows]
            logits = logits + bias
        return logits, (group, start)

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator``: normal(0, std) kernels and
        embeddings, zero biases, unit LayerNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        return self


def tp_leaf_info(name, shape, cfg):
    """``(flax path, flax shape, torch dim of each flax dim)``
    (``module_inject/auto_tp.py``): the leaves are flax's, in flax's
    layout (``layer.{i}`` is ``layer_{i}``)."""
    return flax_path(name, "layer"), tuple(shape), tuple(range(len(shape)))


def params_from_flax(tree, cfg: BertConfig, dtype="float32", device="cpu"):
    """The JAX package's BERT flax tree (numpy leaves) → ``{name: tensor}``
    for :class:`BertModel`, every leaf in ``dtype`` and its flax shape.
    ``layer_{i}`` becomes ``layer.{i}``; the rest keeps its path."""
    dt = torch_dtype(dtype)
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = key.replace("layer_", "layer.", 1) \
                if key.startswith("layer_") else key
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, dict):
                walk(value, path)
            else:
                out[path] = torch.from_numpy(
                    np.array(value, dtype=np.float32)).to(
                        device=device, dtype=dt).contiguous()

    walk(tree, "")
    expected = {n for n, _ in BertModel(cfg, device="meta").named_parameters()}
    if set(out) != expected:
        raise KeyError(f"flax tree does not fit {cfg}: missing "
                       f"{sorted(expected - set(out))[:4]}, unknown "
                       f"{sorted(set(out) - expected)[:4]}")
    return out


def params_to_flax(named, cfg: BertConfig):
    """The exact inverse of :func:`params_from_flax`: ``{name: tensor or
    array}`` (any subset, e.g. one leaf, or a moment of the optimizer) →
    the JAX package's nested flax tree of fp32 numpy leaves (the shapes are
    flax's already; ``layer.{i}`` becomes ``layer_{i}``)."""
    out = {}
    for name, value in named.items():
        a = (value.detach().float().cpu().numpy()
             if isinstance(value, torch.Tensor)
             else np.asarray(value, dtype=np.float32))
        parts, path = name.split("."), []
        while parts:
            part = parts.pop(0)
            if part == "layer" and parts and parts[0].isdigit():
                part = f"layer_{parts.pop(0)}"
            path.append(part)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a, dtype=np.float32)
    return out
