"""Ragged (paged-KV) model forward — the port of
``deepspeed_tpu/inference/v2/ragged_forward.py`` (reference
``inference/v2/model_implementations/{llama_v2,mixtral}`` +
``kernels/ragged_ops``).

One step processes a *flat token buffer* ``[T]`` — the union of prefill
chunks and single decode tokens from many sequences — against the paged KV
cache.  Every token's K/V is written to the cache *before* attention runs,
and each token attends to cache positions ≤ its own, so a prefill chunk is
causal within itself and sees all earlier chunks.

Where the JAX step donated the cache and rebuilt it with ``.at[].set``, the
port writes the cache tensor in place and returns the same tensor.  The
large dense products (QKV, O, MLP, LM head) are ``F.linear``/``matmul``, as
the JAX package left them to XLA; attention is the paged kernel, a MoE
layer's experts the grouped-matmul kernel.  Every weight is read through
``quant_serving.weight``: under ``quantization_mode`` it is dequantized
there, just before its product.

Under tensor parallelism (``tensor_parallel.tp_size > 1``, JAX
``engine_v2.py:53-157``) the model holds this rank's slices
(``module_inject/auto_tp.py:shard_params_for_tp``) and the step runs the
rank's heads (their counts read from the weights), all-reduces after
``o_proj`` and after the dense or MoE MLP, looks the embedding up in its
vocabulary slice (summed over the group) and all-gathers the fp32 head's
vocabulary slices, so every rank holds the same logits and picks the same
token.
"""

import torch
import torch.nn.functional as F

from ...accelerator import full_fp32_matmul
from ...models.llama import rms_norm as _rmsnorm
from ...models.llama import rope_tables as _rope_tables
from ...models.llama import torch_dtype
from ...models.mixtral import moe_apply
from ...module_inject.layers import (attention_heads, gather_logits,
                                     tp_group_of, vocab_parallel_lookup)
from ...comm.functional import reduce_from_tp_region
from ...ops._use_kernels import paged_kernels_disabled
from ...ops.kernels.paged_attention import (paged_attention,
                                            paged_attention_atoms,
                                            paged_attention_plain)
from ..quant_serving import weight


def _rotary(x, cos, sin, positions):
    """x: [T, H, Dh]; positions: [T]."""
    c = cos[positions][:, None, :]
    s = sin[positions][:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def _paged_attention(q, k_cache, v_cache, tables_t, positions, block_size,
                     window=0, layout=(0, 0), use_kernel=True):
    """q: [T, H, Dh]; caches: [num_blocks, bs, Hkv, Dh]; tables_t: [T, maxb]
    int32; positions: [T] int32; window: sliding-window size (0 → full
    causal).  Returns [T, H, Dh].

    ``use_kernel``: the paged kernel's wrappers, which launch the CUDA kernel
    on CUDA tensors and use its plain version on CPU tensors.
    ``layout=(decode_cap, atom)`` > (0, 0) means the buffer is region-split
    by the batch builder: one row per tile for the first ``decode_cap``
    rows, ``atom`` same-sequence rows per tile for the rest.
    ``use_kernel=False``, or ``DS_TPU_DISABLE_PALLAS_PAGED`` set: the gather
    path (each row gathers its own block run)."""
    if not use_kernel or paged_kernels_disabled():
        return paged_attention_plain(q, k_cache, v_cache, tables_t,
                                     positions, window)
    decode_cap, atom = layout
    if atom and q.shape[0] > decode_cap:
        out_p = paged_attention_atoms(
            q[decode_cap:], k_cache, v_cache, tables_t[decode_cap:],
            positions[decode_cap:], atom, window=window)
        if not decode_cap:
            return out_p
        out_d = paged_attention(q[:decode_cap], k_cache, v_cache,
                                tables_t[:decode_cap], positions[:decode_cap],
                                window=window)
        return torch.cat([out_d, out_p], dim=0)
    return paged_attention(q, k_cache, v_cache, tables_t, positions,
                           window=window)


def _linear(x, lin, use_kernel, rows=None):
    """``lin``'s product; ``rows``: only those rows of its weight and bias
    (a replicated kv projection's head for this rank)."""
    w, b = weight(lin.weight, use_kernel), lin.bias
    if rows is not None:
        w = w[rows[0]:rows[1]]
        b = None if b is None else b[rows[0]:rows[1]]
    return F.linear(x, w, b)


def _ragged_attention_block(attn, h, kv_layer, blk, off, tables_t, positions,
                            cos, sin, *, cfg, block_size, layout=(0, 0),
                            use_kernel=True):
    """qkv → rotary → cache scatter → paged attention → output projection.
    ``kv_layer``: [2, num_blocks, bs, Hkv, Dh], written in place."""
    T = h.shape[0]
    Dh = cfg.head_dim
    H, Hkv, rows, _ = attention_heads(attn.q_proj, attn.k_proj, cfg)
    q = _rotary(_linear(h, attn.q_proj, use_kernel).view(T, H, Dh), cos, sin,
                positions)
    k = _rotary(_linear(h, attn.k_proj, use_kernel, rows).view(T, Hkv, Dh),
                cos, sin, positions)
    v = _linear(h, attn.v_proj, use_kernel, rows).view(T, Hkv, Dh)
    # in place, where the JAX step rebuilt the donated cache (.at[].set)
    kv_layer[0, blk, off] = k.to(kv_layer.dtype)
    kv_layer[1, blk, off] = v.to(kv_layer.dtype)
    out = _paged_attention(q, kv_layer[0], kv_layer[1], tables_t, positions,
                           block_size, window=cfg.sliding_window,
                           layout=layout, use_kernel=use_kernel)
    return reduce_from_tp_region(
        _linear(out.reshape(T, H * Dh), attn.o_proj, use_kernel),
        tp_group_of(attn.o_proj))


def _dense_mlp(layer, h2, cfg, use_kernel):
    """The Llama SwiGLU MLP."""
    mlp = layer.mlp
    return reduce_from_tp_region(
        _linear(F.silu(_linear(h2, mlp.gate_proj, use_kernel))
                * _linear(h2, mlp.up_proj, use_kernel), mlp.down_proj,
                use_kernel), tp_group_of(mlp.down_proj))


def _sparse_moe(layer, h2, cfg, use_kernel):
    """The Mixtral MoE (``ragged_forward.py:320-328``): the router in full
    fp32 (TF32 off for its product), then :func:`moe_apply` over the
    stacked experts in the model dtype."""
    moe = layer.block_sparse_moe
    dtype = torch_dtype(cfg.dtype)
    with full_fp32_matmul():
        router_logits = h2.float() @ weight(moe.gate, use_kernel).float()
    out = moe_apply(h2, router_logits,
                    weight(moe.w1, use_kernel).to(dtype),
                    weight(moe.w2, use_kernel).to(dtype),
                    weight(moe.w3, use_kernel).to(dtype),
                    cfg.num_experts_per_tok, norm_topk=cfg.norm_topk_prob,
                    use_kernel=use_kernel)
    # the experts' intermediate slices give partial sums
    return reduce_from_tp_region(out, tp_group_of(moe))


def _ragged_step(mlp, model, kv_data, token_ids, positions, seq_slots,
                 block_tables, last_token_idx, *, cfg, block_size, layout,
                 use_kernel):
    """The Llama skeleton of every ragged step; ``mlp(layer, h2, cfg,
    use_kernel)`` is the layer's feed-forward part."""
    dtype = torch_dtype(cfg.dtype)
    eps = cfg.rms_norm_eps
    cos, sin = _rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                            cfg.rope_theta, cfg.rope_scaling, kv_data.device)
    body = model.model
    pos_l = positions.long()
    emb = body.embed_tokens
    x = vocab_parallel_lookup(weight(emb.weight, use_kernel), token_ids,
                              getattr(emb, "vocab_start", 0),
                              tp_group_of(emb)).to(dtype)     # [T, D]
    tables_t = block_tables[seq_slots.long()]                 # [T, maxb]
    blk = tables_t[torch.arange(token_ids.shape[0], device=pos_l.device),
                   pos_l // block_size].long()                # [T]
    off = pos_l % block_size

    for l, layer in enumerate(body.layers):
        h = _rmsnorm(x, layer.input_layernorm.weight, eps)
        x = x + _ragged_attention_block(
            layer.self_attn, h, kv_data[l], blk, off, tables_t, positions,
            cos, sin, cfg=cfg, block_size=block_size, layout=layout,
            use_kernel=use_kernel)
        h2 = _rmsnorm(x, layer.post_attention_layernorm.weight, eps)
        x = x + mlp(layer, h2, cfg, use_kernel)

    return _lm_head(model, x, last_token_idx, cfg, use_kernel), kv_data


@torch.no_grad()
def llama_ragged_step(model, kv_data, token_ids, positions, seq_slots,
                      block_tables, last_token_idx, *, cfg, block_size,
                      layout=(0, 0), use_kernel=True):
    """One ragged engine iteration for the Llama family.

    Args:
      model: ``models.llama.LlamaModel`` holding the weights.
      kv_data: [L, 2, num_blocks, bs, Hkv, Dh] paged cache, written in place.
      token_ids/positions/seq_slots: [T] int32 flat batch (padding: slot 0 =
        the reserved garbage block row, position 0).
      block_tables: [max_seqs, maxb] int32.
      last_token_idx: [max_seqs] int32 — buffer index of each slot's last
        scheduled token (logits gather; 0 for idle slots).
      use_kernel: False runs the plain versions of the kernels (paged
        attention's gather path, dequantization's plain version).

    Returns (logits [max_seqs, V] fp32, kv_data).
    """
    return _ragged_step(_dense_mlp, model, kv_data, token_ids, positions,
                        seq_slots, block_tables, last_token_idx, cfg=cfg,
                        block_size=block_size, layout=layout,
                        use_kernel=use_kernel)


@torch.no_grad()
def mixtral_ragged_step(model, kv_data, token_ids, positions, seq_slots,
                        block_tables, last_token_idx, *, cfg, block_size,
                        layout=(0, 0), use_kernel=True):
    """One ragged engine iteration for Mixtral (``ragged_forward.py:290``;
    reference ``inference/v2/model_implementations/mixtral/``): the Llama
    step with each MLP replaced by the exact top-k sparse MoE.  Arguments
    as :func:`llama_ragged_step`, with ``model`` a
    ``models.mixtral.MixtralModel``; ``use_kernel=False`` also runs the
    grouped matmul's plain version."""
    return _ragged_step(_sparse_moe, model, kv_data, token_ids, positions,
                        seq_slots, block_tables, last_token_idx, cfg=cfg,
                        block_size=block_size, layout=layout,
                        use_kernel=use_kernel)


def _lm_head(model, x, last_token_idx, cfg, use_kernel=True):
    """logits_gather analog: only each slot's last token reaches the head,
    which runs in full fp32, as the JAX head does: TF32 is off for this
    product only, and the caller's setting is restored after it."""
    xl = _rmsnorm(x[last_token_idx.long()], model.model.norm.weight,
                  cfg.rms_norm_eps)
    w = weight(model.lm_head.weight, use_kernel)
    with full_fp32_matmul():
        logits = xl.float() @ w.float().t()
    return gather_logits(logits, model.lm_head)


RAGGED_FORWARDS = {"LlamaModel": llama_ragged_step,
                   "MixtralModel": mixtral_ragged_step}


@torch.no_grad()
def decode_burst(model, kv_data, tok0, pos0, active, block_tables, *,
                 step_fn, cfg, block_size, k, use_kernel=True):
    """``k`` greedy decode iterations back to back on the device, with ONE
    host fetch for the ``[k, max_seqs]`` tokens (the JAX package runs them
    as one ``lax.scan`` program): each step's argmax stays on the device
    and is the next step's input token.

    Layout: row ``i`` of the [max_seqs]-token batch belongs to slot ``i``
    (``last_token_idx = arange``); idle rows carry ``active=False`` and are
    steered to slot 0, whose block-table row is the reserved garbage block.

    Args:
      tok0/pos0/active: [max_seqs] — each active slot's pending token and
        its position; block capacity for ``pos0 + k`` must be pre-ensured.
      step_fn: a RAGGED_FORWARDS value.

    Returns ([k, max_seqs] int32 tokens on the device, kv_data).
    """
    n = tok0.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=tok0.device)
    slots = torch.where(active, rows, 0).int()
    toks, pos = tok0.int(), pos0.int()
    out = torch.empty((k, n), dtype=torch.int32, device=tok0.device)
    for i in range(k):
        logits, kv_data = step_fn(
            model, kv_data, torch.where(active, toks, 0).int(),
            torch.where(active, pos, 0).int(), slots, block_tables, rows,
            cfg=cfg, block_size=block_size, layout=(0, 0),
            use_kernel=use_kernel)
        toks = torch.argmax(logits, dim=-1).int()
        out[i] = toks
        pos = pos + 1
    return out, kv_data
