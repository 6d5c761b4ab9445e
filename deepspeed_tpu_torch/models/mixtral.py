"""Mixtral-family model (sparse-MoE Llama; the port of
``deepspeed_tpu/models/mixtral.py``) for serving and training.

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
``inference/v2/ragged_forward.py:mixtral_ragged_step`` and training
through :meth:`MixtralModel.forward` (the Llama training forward with each
layer's MLP replaced by the MoE block; the grouped matmul's gradient is
B7's dx and dw kernels).  As in the JAX model, the loss with labels is the
LM loss alone: each layer's router logits are kept
(:meth:`MixtralModel.intermediates`, JAX's ``sow``) and
:func:`aux_loss_from_vars` is a helper a caller may add.

Training runs at ep > 1 (the engine keeps each rank's E/ep experts of each
stack, :meth:`MixtralSparseMoeBlock.localize`, and :func:`moe_apply`
exchanges the tokens over the ep group), at tp > 1 (``tp_rules``: the
stacks cut on I, the router whole) and at tp × ep.
"""

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import full_fp32_matmul
from ..comm.functional import (all_gather, copy_to_tp_region,
                               reduce_from_tp_region, reduce_scatter)
from ..module_inject.auto_tp import Spec
from ..module_inject.layers import tp_group_of
from ..ops.kernels.grouped_matmul import gmm, gmm_plain
from ..utils.not_ported import not_ported
# init_leaf: the engine draws an expert- or tp-split model leaf by leaf
from .llama import (LlamaAttention, LlamaConfig, LlamaModel, RMSNorm,  # noqa: F401
                    _flax_attention_and_norms, _flax_converter, _flax_leaf,
                    init_leaf, torch_dtype)
from .llama import tp_leaf_info as llama_tp_leaf_info
from .llama import tp_rules as llama_tp_rules


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
              use_kernel=True, ep_group=None, first=0, stats=None):
    """Exact (no-drop) top-k MoE (``mixtral.py:78``): fp32 softmax, top-k
    (renormalised), a stable sort of the token copies by expert, the grouped
    SwiGLU, then the routing weights — cast to the activation dtype first —
    scale each copy and a scatter-add in that dtype sums them per token.
    x: [T, D] → [T, D].  The group sizes never leave the device.  The
    copies are gathered through the permutation ``order`` of x repeated k
    times, so x's gradient is a permutation's (every index once: the same
    bits in every rerun) followed by a sum over the k copies.

    Expert parallelism (an ``ep_group`` of n ranks, the stacks holding the
    experts ``[first, first + E/n)``; at n = 1 the same code, its gathers
    and reduce the identity): each rank routes its own T tokens,
    all-gathers (tokens, top-k weights and ids) over the group, sorts the
    copies routed to its experts first (the others after them, past the
    group sizes, where the grouped matmul writes zeros and the weights are
    zero), scatter-adds the weighted outputs into [n·T, D] and
    reduce-scatters that over the group: its own T rows, summed over the
    ranks' experts.  Every shape is fixed for a given T; the backward is
    the exact one (a gather's is a reduce-scatter, and the reverse), the
    router's gradient flowing through the gathered weights.  ``stats``: a
    dict that receives this rank's rows per local expert (a device
    tensor)."""
    T, D = x.shape
    E = w1.shape[0]
    probs = torch.softmax(router_logits.float(), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)              # [T, k]
    if norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    split = ep_group is not None
    if split:
        x = all_gather(x, ep_group, 0)                      # [n·T, D]
        # weights and ids in one gather (ids < 2^24 are exact in fp32)
        meta = all_gather(torch.cat([topw, topi.float()], dim=1), ep_group,
                          0)
        topw, topi = meta[:, :k], meta[:, k:].long()
        T = x.shape[0]
    flat_expert = topi.reshape(-1)                          # [T·k]
    flat_w = topw.reshape(-1)
    if split:
        mine = (flat_expert >= first) & (flat_expert < first + E)
        flat_expert = torch.where(mine, flat_expert - first, E)
        flat_w = flat_w * mine
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // k                                   # source token
    counts = torch.zeros(E + split, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat_expert,
                      torch.ones_like(flat_expert, dtype=torch.int32))
    group_sizes = counts[:E]
    if stats is not None:
        stats["rows"] = group_sizes
    x_sorted = x.unsqueeze(1).expand(T, k, D).reshape(T * k, D)[order]
    y_sorted = moe_expert_ffn(x_sorted, group_sizes, w1, w2, w3,
                              use_kernel)
    w_sorted = flat_w[order].to(y_sorted.dtype)
    out = torch.zeros(T, D, dtype=y_sorted.dtype, device=x.device)
    out.index_add_(0, token_of, y_sorted * w_sorted[:, None])
    if split:
        out = reduce_scatter(out, ep_group, 0)
    return out.to(x.dtype)


def load_balance_aux_loss(router_logits, k):
    """Switch/GShard aux loss over a batch of router logits [T, E]
    (``mixtral.py:102``): E · Σ_e (share of top-k slots on e) · (mean
    router probability of e)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    E = probs.shape[-1]
    _, topi = torch.topk(probs, k, dim=-1)
    counts = F.one_hot(topi, E).sum(dim=(0, 1)).float()    # [E]
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    return (frac_tokens * probs.mean(dim=0)).sum() * E


def aux_loss_from_vars(variables, k, coef):
    """``coef`` × the mean over layers of the aux loss of each layer's kept
    router logits (``mixtral.py:234``); ``variables``: the
    ``{"intermediates": {"layers_{i}": {"moe": {"router_logits": (rl,)}}}}``
    of :meth:`MixtralModel.intermediates` (JAX's sown collection)."""
    total, n = 0.0, 0
    for layer in variables.get("intermediates", {}).values():
        moe = layer.get("moe") if isinstance(layer, dict) else None
        if moe and "router_logits" in moe:
            for rl in moe["router_logits"]:
                total = total + load_balance_aux_loss(rl, k)
                n += 1
    return coef * total / max(n, 1)


class MixtralSparseMoeBlock(nn.Module):
    """Router gate ``[D, E]`` (fp32) and stacked experts in the model
    dtype (HF ``block_sparse_moe``).  Its forward (training) keeps the
    router logits of its last call in ``router_logits`` and this rank's
    rows per local expert in ``routed_rows``.

    The engine's expert-parallel split (:meth:`localize`) keeps this
    rank's E/ep experts of each stack and the ep group to exchange over;
    tensor parallelism (``module_inject``) cuts the stacks on I (w1, w3
    column, w2 row) and gives the block its ``tp_group``."""

    EXPERT_LEAVES = ("w1", "w2", "w3")

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.config = cfg
        self.router_logits = None
        self.routed_rows = None
        self.num_experts = cfg.num_local_experts
        self.first, self.ep_group = 0, None
        E, D, I = (cfg.num_local_experts, cfg.hidden_size,
                   cfg.intermediate_size)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.gate = param(D, E, dt=torch.float32)
        self.w1 = param(E, D, I)
        self.w3 = param(E, D, I)
        self.w2 = param(E, I, D)

    def localize(self, e0, e1, ep_group=None):
        """Keep the experts ``[e0, e1)`` of each stack and exchange over
        ``ep_group`` (a no-op when already done)."""
        if self.first != e0 or self.w1.shape[0] != e1 - e0:
            for name in self.EXPERT_LEAVES:
                p = getattr(self, name)
                setattr(self, name, nn.Parameter(
                    p.data[e0:e1].clone(), requires_grad=p.requires_grad))
        self.first, self.ep_group = e0, ep_group

    def forward(self, x, use_kernel=True):
        """x: [B, S, D] → [B, S, D] (``mixtral.py:119``): the fp32 router
        (the gate promoted to fp32, full fp32 on the card), then
        :func:`moe_apply` over the stacks in the model dtype.  At tp > 1
        the tokens and the router enter the tp region (Megatron's
        copy-to-tp: the router's gradient, whose top-k weights see only
        this rank's I/tp slice of each expert, is summed over tp), and the
        block's [T, D] output is reduced from it after the weighted
        scatter-add; every tp rank routes alike, from the same input
        bits."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        B, S, D = x.shape
        group = tp_group_of(self)
        tokens = copy_to_tp_region(x.reshape(-1, D), group)
        gate = copy_to_tp_region(self.gate, group)
        with full_fp32_matmul():
            logits = tokens.float() @ gate.float()           # [T, E]
        stats = {}
        out = moe_apply(tokens, logits, self.w1.to(dt), self.w2.to(dt),
                        self.w3.to(dt), cfg.num_experts_per_tok,
                        norm_topk=cfg.norm_topk_prob, use_kernel=use_kernel,
                        ep_group=self.ep_group, first=self.first,
                        stats=stats)
        self.router_logits = logits
        self.routed_rows = stats["rows"]
        return reduce_from_tp_region(out, group).reshape(B, S, D)


class MixtralDecoderLayer(nn.Module):

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.dtype = torch_dtype(cfg.dtype)
        eps = cfg.rms_norm_eps
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.block_sparse_moe = MixtralSparseMoeBlock(cfg, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, device, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, device, eps)

    def forward(self, x, cos, sin, use_kernel=True):
        h = x + self.self_attn(self.input_layernorm(x, self.dtype), cos, sin,
                               use_kernel)
        return h + self.block_sparse_moe(
            self.post_attention_layernorm(h, self.dtype), use_kernel)


_EXPERT_SLICE = re.compile(r"(.*\.block_sparse_moe\.w[123])\.(\d+)$")


class MixtralModel(LlamaModel):
    """Causal-LM weights: the Llama model's, with each layer's MLP replaced
    by :class:`MixtralSparseMoeBlock`.  :meth:`forward` is the training
    forward (``mixtral.py:172-231``).

    :meth:`load_weights` takes whole tensors under the module's own names,
    and also one expert at a time as ``...block_sparse_moe.w1.{e}`` (the
    stack's ``[D, I]`` slice): each stack is allocated once on the target
    device and filled in place, so a streamed checkpoint never holds a
    per-expert copy of the model beside the stacks."""

    LAYER = MixtralDecoderLayer
    # the aux loss rides on the forward: Domino splits it stream by stream
    forward_microstreams = None

    def __init__(self, config: MixtralConfig, device=None):
        if config.shared_expert_intermediate_size:
            raise not_ported("the qwen2-moe shared expert "
                             "(shared_expert_intermediate_size > 0)", "S5")
        super().__init__(config, device)

    def forward(self, input_ids, labels=None, attention_mask=None,
                use_kernel=True, loss_reduction="mean"):
        """The Llama training forward (remat, dtypes, ``loss_reduction``,
        the refusals) with the MoE blocks: logits, or with ``labels`` the
        LM loss WITHOUT the aux loss, as JAX's model returns it (its
        comment says the engine adds the aux loss; its engine does not).
        Each layer's router logits stay reachable through
        :meth:`intermediates`."""
        for layer in self.model.layers:
            layer.block_sparse_moe.router_logits = None
        return super().forward(input_ids, labels, attention_mask,
                               use_kernel, loss_reduction)

    def intermediates(self):
        """The last forward's router logits in the layout of JAX's sown
        collection: ``{"intermediates": {"layers_{i}": {"moe":
        {"router_logits": (logits [T, E],)}}}}`` (:func:`aux_loss_from_vars`
        reads it)."""
        return {"intermediates": {
            f"layers_{i}": {"moe": {"router_logits": (
                layer.block_sparse_moe.router_logits, )}}
            for i, layer in enumerate(self.model.layers)
            if layer.block_sparse_moe.router_logits is not None}}

    # the JAX Mixtral has no streaming view: offload_param refuses it
    streaming_parts = None

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
        split = getattr(self, "tp_splits", {}).get(stack)
        if split is not None and tuple(t.shape) == tuple(
                self.tp_global_shapes[stack][1:]):
            # this rank's slice of one expert's whole matrix
            dim, rank, size = split
            n = t.shape[dim - 1] // size
            t = t.narrow(dim - 1, rank * n, n).contiguous()
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


def tp_rules(config: MixtralConfig):
    """Tensor-parallel rules (JAX ``mixtral.py:248-262``, the ``zero`` pin
    dropped): attention as Llama's, the router replicated, the expert
    stacks over ``ep`` on E and over ``tp`` on the intermediate dim (w1,
    w3 column, w2 row).  On a tp-only mesh the ``ep`` entries drop out."""
    rules = dict(llama_tp_rules(config))
    for key in ("gate_proj/kernel", "up_proj/kernel", "down_proj/kernel"):
        rules.pop(key)
    rules.update({
        "moe/gate/kernel": Spec(None, None),
        "moe/w1": Spec("ep", None, "tp"),
        "moe/w3": Spec("ep", None, "tp"),
        "moe/w2": Spec("ep", "tp", None),
    })
    return rules


def tp_leaf_info(name, shape, cfg):
    """As ``models/llama.py:tp_leaf_info``; the router ``[D, E]`` and the
    stacks keep the flax layout."""
    parts = name.split(".")
    if len(parts) == 5 and parts[3] == "block_sparse_moe":
        layer, leaf = f"layers_{parts[2]}", parts[4]
        path = ((layer, "moe", "gate", "kernel") if leaf == "gate"
                else (layer, "moe", leaf))
        return path, shape, tuple(range(len(shape)))
    return llama_tp_leaf_info(name, shape, cfg)


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


def params_to_flax(named, cfg: MixtralConfig):
    """The exact inverse of :func:`params_from_flax`: HF-named tensors or
    arrays (any subset; a moment of the optimizer shares the layout) →
    the JAX package's nested flax tree of fp32 numpy leaves: the Llama
    leaves as ``models/llama.py:params_to_flax`` writes them, each layer's
    router ``moe/gate/kernel`` [D, E] and ``moe/w1``/``w2``/``w3`` stacks as
    they are."""
    out = {}
    for name, value in named.items():
        a = (value.detach().float().cpu().numpy()
             if isinstance(value, torch.Tensor)
             else np.asarray(value, dtype=np.float32))
        parts = name.split(".")
        if len(parts) == 5 and parts[3] == "block_sparse_moe":
            layer, leaf = f"layers_{parts[2]}", parts[4]
            path = ((layer, "moe", "gate", "kernel") if leaf == "gate"
                    else (layer, "moe", leaf))
        else:
            path, a = _flax_leaf(name, a, cfg)
            if path is None:
                continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(a, dtype=np.float32)
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
