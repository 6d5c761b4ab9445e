"""GPT-2 family (the port of ``deepspeed_tpu/models/gpt2.py``): learned
positions, pre-LN blocks, GELU MLP, tied LM head; ``forward`` returns the
loss when given labels, like ``models/llama.py``.

The module's parameters are the flax model's leaves under the same names
and shapes (``h.{i}.q_proj.kernel`` [D, H, Dh], ``h.{i}.q_proj.bias``
[H, Dh], ``h.{i}.c_proj.kernel`` [H, Dh, D], ``c_fc``/``mlp_proj`` kernels
[in, out], ``ln_*.scale``/``bias``, ``wte.embedding``, ``wpe.embedding``):
q, k and v stay three leaves and kernels and biases stay apart, so LAMB's
per-leaf trust ratio sees the partition the JAX engine sees (16 leaves a
block, 388 for GPT-2 350M).

Numerics follow flax at ``dtype`` with fp32 parameters: every product runs
in ``dtype`` (inputs, kernels and biases cast to it, as ``DenseGeneral``
promotes them); LayerNorm takes fp32 statistics (E[x²] − E[x]², clipped at
0), normalises and scales in fp32 and returns ``dtype``; GELU is the tanh
approximation (``nn.gelu``'s default); the tied head runs in ``dtype``
although the JAX code casts x to fp32 first (``Embed.attend`` promotes both
operands to the Embed's dtype), and the cross entropy is fp32.  Attention is
``ops/attention.py:attention_core`` (kernel B1 on the card).

``use_ulysses`` (``gpt2.py:76``): the forward takes the rank's chunk of the
sequence, ``wpe`` is read at the chunk's global positions, attention is
``sequence/layer.py:DistributedAttention`` over the sp group, and the loss
is the global next-token loss (``llama.lm_loss``).

:func:`pipeline_module` lays the same model out as a ``PipelineModule``
(the embedding and the tied head, the blocks, the final norm) for
``runtime/pipe/engine.py``.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..comm.functional import (copy_to_tp_region, gather_from_tp_region,
                               reduce_from_tp_region)
from ..module_inject.auto_tp import Spec
from ..module_inject.layers import embed_rows, tp_group_of, vocab_slice
from ..ops.attention import attention_core
from ..utils.not_ported import not_ported
from .llama import (lm_loss, lm_loss_chunked, lm_loss_vocab_parallel,
                    sequence_chunk, torch_dtype)

# AutoTP pads this leaf to a multiple of tp instead of replicating it
# (module_inject/auto_tp.py:tp_splits): 50257 rows divide by no tp > 1
TP_PAD_LEAVES = ("wte.embedding", )


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"
    # > 0 → fused chunked head + loss over vocabulary chunks of this size
    # (sequence/cross_entropy.py), in fp32 as JAX's
    loss_chunk_vocab: int = 0
    # training: recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = True
    # Ulysses sequence parallelism over the mesh's sp group
    use_ulysses: bool = False
    sp_backend: str = "ulysses"

    def __post_init__(self):
        if self.sp_backend != "ulysses":
            # JAX's GPT2Config has no sp_backend: Ulysses is GPT-2's only
            # sequence-parallel backend there
            raise ValueError(f"GPT-2 runs sequence parallelism with Ulysses "
                             f"only (sp_backend {self.sp_backend!r}); ring "
                             f"attention is a Llama-family backend")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def gpt2_350m(**overrides):
    return GPT2Config(**{**dict(hidden_size=1024, num_hidden_layers=24,
                                num_attention_heads=16), **overrides})


def gpt2_tiny(**overrides):
    return GPT2Config(**{**dict(vocab_size=256, hidden_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                max_position_embeddings=128), **overrides})


def gpt3_13b(**overrides):
    """GPT-3 13B (``gpt2.py:49``; Brown et al. 2020, table 2.1): 40 layers,
    d_model 5120, 40 heads of 128, context 2048, GPT-2's vocabulary."""
    return GPT2Config(**{**dict(vocab_size=50257, hidden_size=5120,
                                num_hidden_layers=40, num_attention_heads=40,
                                max_position_embeddings=2048), **overrides})


def param_count(cfg: GPT2Config):
    D, L, V, P = (cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size,
                  cfg.max_position_embeddings)
    per_block = 4 * (D * D + D) + (D * 4 * D + 4 * D) + (4 * D * D + D) + 4 * D
    return V * D + P * D + L * per_block + 2 * D


def _param(*shape, device=None):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class Dense(nn.Module):
    """flax ``DenseGeneral``: ``kernel`` of shape ``in_shape + out_shape``,
    ``bias`` of ``out_shape``, contracted over the input's trailing
    ``len(in_shape)`` dims."""

    def __init__(self, in_shape, out_shape, device=None):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = _param(*in_shape, *out_shape, device=device)
        self.bias = _param(*out_shape, device=device)

    def forward(self, x, dtype):
        return self._apply(x, dtype, None)

    def row_parallel(self, x, dtype):
        """:meth:`forward` of a kernel sharded on its input dims: the
        product's partial sums reduced over the tp group, then the (whole)
        bias added once.  Without a group, :meth:`forward` bit for bit."""
        return self._apply(x, dtype, tp_group_of(self))

    def _apply(self, x, dtype, group):
        k = self.kernel.to(dtype)
        lead = x.shape[:x.dim() - self.n_in]
        n_in = x.shape[x.dim() - self.n_in:].numel()
        y = x.to(dtype).reshape(-1, n_in) @ k.reshape(n_in, -1)
        y = reduce_from_tp_region(y, group)
        y = y + self.bias.to(dtype).reshape(-1)
        return y.view(*lead, *self.bias.shape)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` (``use_fast_variance``): fp32 mean and
    E[x²] − E[x]² (clipped at 0), (x − mean) · (rsqrt(var + eps) · scale)
    + bias in fp32, returned in ``dtype``."""

    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    def forward(self, x, dtype):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x32 - mean) * mul + self.bias.float()).to(dtype)


class Embed(nn.Module):

    def __init__(self, num, dim, device=None):
        super().__init__()
        self.embedding = _param(num, dim, device=device)


class GPT2Block(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        eps = cfg.layer_norm_epsilon
        self.config = cfg
        self.ln_1 = LayerNorm(D, eps, device)
        self.q_proj = Dense((D, ), (H, Dh), device)
        self.k_proj = Dense((D, ), (H, Dh), device)
        self.v_proj = Dense((D, ), (H, Dh), device)
        self.c_proj = Dense((H, Dh), (D, ), device)
        self.ln_2 = LayerNorm(D, eps, device)
        self.c_fc = Dense((D, ), (4 * D, ), device)
        self.mlp_proj = Dense((4 * D, ), (D, ), device)

    def forward(self, x, use_kernel=True):
        """Under tensor parallelism (``tp_rules``) q, k, v and c_fc are this
        rank's columns (heads) and c_proj and mlp_proj its rows: h enters
        the tp region before each column-parallel product and the
        row-parallel ones reduce their partial sums."""
        dt = torch_dtype(self.config.dtype)
        h = copy_to_tp_region(self.ln_1(x, dt), tp_group_of(self.q_proj))
        q, k, v = self.q_proj(h, dt), self.k_proj(h, dt), self.v_proj(h, dt)
        if self.config.use_ulysses:
            from ..sequence.layer import DistributedAttention
            attn = DistributedAttention()(q, k, v, causal=True,
                                          use_kernel=use_kernel)
        else:
            attn = attention_core(q, k, v, causal=True,
                                  use_kernel=use_kernel)
        x = x + self.c_proj.row_parallel(attn, dt)
        h = copy_to_tp_region(self.ln_2(x, dt), tp_group_of(self.c_fc))
        h = F.gelu(self.c_fc(h, dt), approximate="tanh")
        return x + self.mlp_proj.row_parallel(h, dt)


def _init_module(module, generator, std=0.02):
    for name, p in module.named_parameters():
        init_leaf(name, p, generator, std)
    return module


GPT2Block.init_weights = torch.no_grad()(_init_module)


class GPT2Embedding(nn.Module):
    """The pipeline's first layer and, tied, its head: ``wte`` and ``wpe``
    as in :class:`GPT2Model`; ``forward(ids)`` embeds at the chunk's
    global positions, ``head(x)`` projects through ``wte``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.config = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, device)
        self.wpe = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                         device)

    def forward(self, input_ids):
        dt = torch_dtype(self.config.dtype)
        _, offset = sequence_chunk(self.config, input_ids.shape[1])
        ids = input_ids.long()
        pos = offset + torch.arange(ids.shape[1], device=ids.device)[None]
        return (embed_rows(self.wte, self.wte.embedding.to(dt), ids) +
                embed_rows(self.wpe, self.wpe.embedding.to(dt), pos))

    def head(self, x):
        """The tied head's logits; a vocabulary-sharded ``wte`` (tp)
        gives each rank its columns, gathered into the whole vocabulary."""
        w = self.wte.embedding.to(x.dtype)
        group, _, rows = vocab_slice(self.wte, w)
        if group is None and rows == self.config.vocab_size:
            return F.linear(x, w)
        logits = F.linear(copy_to_tp_region(x, group), w)
        return gather_from_tp_region(logits, group)[
            ..., :self.config.vocab_size]

    init_weights = torch.no_grad()(_init_module)


class GPT2FinalNorm(nn.Module):
    """``ln_f``, the pipeline's layer between the blocks and the head."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.config = cfg
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, device)

    def forward(self, x):
        return self.ln_f(x, torch_dtype(self.config.dtype))

    init_weights = torch.no_grad()(_init_module)


def token_cross_entropy(logits, labels):
    """The pipeline's loss: fp32 cross entropy averaged over every position
    of the batch, ``labels`` holding each position's next token (the
    feeder shifts them), so that it is a uniform per-row mean, as the
    pipeline's loss contract asks."""
    from ..sequence.cross_entropy import softmax_cross_entropy_with_logits
    return softmax_cross_entropy_with_logits(
        logits, labels.to(logits.device)).mean()


def pipeline_tp_rules(config: GPT2Config):
    """:func:`tp_rules` for :func:`pipeline_module`'s stages
    (``runtime/pipe/module.py:tp_leaf_info``): a block's rule takes the
    block stack's leading (pipeline slot) dim; the tied ``wte`` keeps
    its own."""
    return {(k if k.startswith("wte/") else f"blocks/{k}"):
            (v if k.startswith("wte/") else Spec(None, *v))
            for k, v in tp_rules(config).items()}


def pipeline_module(cfg, **kw):
    """GPT-2 (or GPT-3, :func:`gpt3_13b`) as a ``PipelineModule``: the
    embedding, tied to the head, then the blocks, ``ln_f`` and the head;
    the loss is :func:`token_cross_entropy`.  ``kw`` goes to
    ``PipelineModule`` (e.g. ``activation_checkpoint_interval=1``).  At
    tp > 1 pass :func:`pipeline_tp_rules` to ``initialize``."""
    from ..runtime.pipe.module import (LayerSpec, PipelineModule,
                                       TiedLayerSpec)
    layers = ([TiedLayerSpec("wte", GPT2Embedding, cfg)] +
              [LayerSpec(GPT2Block, cfg)] * cfg.num_hidden_layers +
              [LayerSpec(GPT2FinalNorm, cfg),
               TiedLayerSpec("wte", GPT2Embedding, cfg,
                             forward_fn=GPT2Embedding.head)])
    return PipelineModule(layers=layers, loss_fn=token_cross_entropy, **kw)


class GPT2Model(nn.Module):
    """GPT-2 causal LM with flax-named parameters, built in fp32 (the
    training engine installs them in its compute dtype and keeps the fp32
    master).  ``device="meta"`` builds it without storage."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, device)
        self.wpe = Embed(cfg.max_position_embeddings, cfg.hidden_size, device)
        self.h = nn.ModuleList(GPT2Block(cfg, device)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, device)

    def forward(self, input_ids, labels=None, attention_mask=None,
                decode=False, positions=None, use_kernel=True,
                loss_reduction="mean"):
        """Training forward (``gpt2.py:95``): logits [B, S, V] in the model
        dtype, or, with ``labels``, the shifted cross-entropy loss (fp32;
        ``attention_mask`` weights it and does not enter attention, as in
        the JAX model; ``loss_reduction``: ``llama.lm_loss``).
        ``use_kernel=False`` runs attention's plain version on any device."""
        cfg = self.config
        if decode:
            raise not_ported("GPT2Model(decode=True) (the KV-cache decode "
                             "path, models/cache.py)", 11)
        sp_group, offset = sequence_chunk(cfg, input_ids.shape[1])
        dt = torch_dtype(cfg.dtype)
        ids = input_ids.long()
        if positions is None:
            positions = offset + torch.arange(ids.shape[1],
                                              device=ids.device)[None]
        wte = self.wte.embedding.to(dt)
        x = (embed_rows(self.wte, wte, ids) +
             embed_rows(self.wpe, self.wpe.embedding.to(dt), positions))
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.h:
            if remat:
                x = checkpoint(block, x, use_kernel, use_reentrant=False)
            else:
                x = block(x, use_kernel)
        x = self.ln_f(x, dt)
        group, start, rows = vocab_slice(self.wte, wte)
        sharded = group is not None or rows != cfg.vocab_size
        if sharded:
            # the tied head over this rank's (padded) vocabulary rows
            x = copy_to_tp_region(x, group)
        tp = (group, start, cfg.vocab_size) if sharded else None
        if cfg.loss_chunk_vocab and labels is not None:
            # JAX gpt2.py:118-122: x and the tied kernel in fp32
            return lm_loss_chunked(x.float(), self.wte.embedding.float().t(),
                                   labels, attention_mask,
                                   cfg.loss_chunk_vocab, torch.float32,
                                   loss_reduction, sp_group, tp)
        logits = F.linear(x, wte)                 # tied head, in dtype
        if labels is None:
            if sharded:
                logits = gather_from_tp_region(logits, group)[
                    ..., :cfg.vocab_size]
            return logits
        if sharded:
            return lm_loss_vocab_parallel(logits, labels, start,
                                          cfg.vocab_size, group,
                                          attention_mask, loss_reduction,
                                          sp_group)
        return lm_loss(logits, labels.to(logits.device), attention_mask,
                       loss_reduction, sp_group)

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator`` (a seeded ``torch.Generator``
        on the module's device): normal(0, std) kernels and embeddings,
        zero biases, unit LayerNorm scales."""
        for name, p in self.named_parameters():
            init_leaf(name, p, generator, std)
        return self

    def streaming_parts(self):
        """ZeRO-Infinity's view of the model (JAX ``gpt2.py:135-190``):
        wte + wpe → L blocks → ln_f and the tied head."""
        return gpt2_streaming_parts(self)


def init_leaf(name, t, generator, std=0.02):
    """One leaf of :meth:`GPT2Model.init_weights`'s random init."""
    if name.endswith(".scale"):
        t.fill_(1.0)
    elif name.endswith(".bias"):
        t.zero_()
    else:
        t.normal_(0.0, std, generator=generator)


def tp_rules(config: GPT2Config):
    """Tensor-parallel rules (JAX ``gpt2.py:189``): q/k/v column-parallel
    on the head axis, c_proj and mlp_proj row-parallel, c_fc
    column-parallel, ``wte`` on its vocabulary (padded to a multiple of
    tp, :data:`TP_PAD_LEAVES`).  The column-parallel biases follow their
    kernels (``auto_tp.shard_params_for_tp``)."""
    tp = "tp"
    return {
        "q_proj/kernel": Spec(None, tp, None),
        "k_proj/kernel": Spec(None, tp, None),
        "v_proj/kernel": Spec(None, tp, None),
        "c_proj/kernel": Spec(tp, None, None),
        "c_fc/kernel": Spec(None, tp),
        "mlp_proj/kernel": Spec(tp, None),
        "wte/embedding": Spec(tp, None),
    }


def flax_path(name, block="h"):
    """A leaf name's flax path: ``{block}.{i}`` is ``{block}_{i}``."""
    parts, path = name.split("."), []
    while parts:
        part = parts.pop(0)
        if part == block and parts and parts[0].isdigit():
            part = f"{block}_{parts.pop(0)}"
        path.append(part)
    return tuple(path)


def tp_leaf_info(name, shape, cfg):
    """``(flax path, flax shape, torch dim of each flax dim)``
    (``module_inject/auto_tp.py``): the leaves are flax's, in flax's
    layout."""
    return flax_path(name), tuple(shape), tuple(range(len(shape)))


def pad_vocab(model, rows, named=None):
    """Append ``rows`` rows to ``model``'s ``wte.embedding`` (zeros; a meta
    model stays meta) and, given ``{name: tensor}`` weights, return them
    with the same zero rows: the model then runs the padded-vocabulary
    route that tensor parallelism runs when tp does not divide the
    vocabulary (its pad columns take -inf), at any tp."""
    w = model.wte.embedding
    model.wte.embedding = _param(w.shape[0] + rows, w.shape[1],
                                 device=w.device)
    if w.device.type != "meta":
        with torch.no_grad():
            model.wte.embedding[:w.shape[0]].copy_(w)
    if named is None:
        return None
    out = dict(named)
    t = out["wte.embedding"]
    out["wte.embedding"] = torch.cat(
        [t, torch.zeros((rows, t.shape[1]), dtype=t.dtype,
                        device=t.device)])
    return out


def gpt2_streaming_parts(model):
    """The :class:`~..runtime.zero.infinity.StreamingSpec` of a
    :class:`GPT2Model` (blocks take no mask, as in the monolithic
    model)."""
    from torch.func import functional_call
    from ..runtime.zero.infinity import StreamingSpec
    cfg = model.config
    dt = torch_dtype(cfg.dtype)
    block = GPT2Block(cfg, device="meta")
    ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, "meta")
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    resident = ["wte.embedding", "wpe.embedding", "ln_f.scale", "ln_f.bias"]

    def embed_apply(res, input_ids, labels=None, attention_mask=None):
        ids = input_ids.long()
        _, offset = sequence_chunk(cfg, ids.shape[1])
        pos = offset + torch.arange(ids.shape[1], device=ids.device)[None]
        return (F.embedding(ids, res["wte.embedding"].to(dt)) +
                F.embedding(pos, res["wpe.embedding"].to(dt)))

    def block_apply(w, x, use_kernel=True):
        return functional_call(block, w, (x, use_kernel))

    def head_apply(res, x, input_ids, labels=None, attention_mask=None,
                   loss_reduction="mean"):
        x = functional_call(ln_f, {"scale": res["ln_f.scale"],
                                   "bias": res["ln_f.bias"]}, (x, dt))
        logits = F.linear(x, res["wte.embedding"].to(dt))
        if labels is None:
            return logits
        return lm_loss(logits, labels.to(logits.device), attention_mask,
                       loss_reduction, sequence_chunk(cfg, x.shape[1])[0])

    L = cfg.num_hidden_layers
    return StreamingSpec(
        block_keys=tuple(f"h_{i}" for i in range(L)),
        block_prefixes=tuple(f"h.{i}." for i in range(L)),
        block_leaves=tuple((n, tuple(p.shape))
                           for n, p in block.named_parameters()),
        resident_keys=("wte", "wpe", "ln_f"),
        resident_leaves=tuple((n, shapes[n]) for n in resident),
        embed_apply=embed_apply, block_apply=block_apply,
        head_apply=head_apply, init_leaf=init_leaf)


def params_from_flax(tree, cfg: GPT2Config, dtype="float32", device="cpu"):
    """The JAX package's flax param tree (numpy leaves) → ``{name: tensor}``
    for :class:`GPT2Model`, every leaf in ``dtype`` and in the flax shape
    (``dtype="float32"`` gives the training engine's master weights).
    ``h_{i}`` becomes ``h.{i}``; the rest keeps its path."""
    dt = torch_dtype(dtype)
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = key.replace("h_", "h.", 1) if key.startswith("h_") \
                else key
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, dict):
                walk(value, path)
            else:
                out[path] = torch.from_numpy(
                    np.array(value, dtype=np.float32)).to(
                        device=device, dtype=dt).contiguous()

    walk(tree, "")
    expected = {n for n, _ in GPT2Model(cfg, device="meta").named_parameters()}
    if set(out) != expected:
        raise KeyError(f"flax tree does not fit {cfg}: missing "
                       f"{sorted(expected - set(out))[:4]}, unknown "
                       f"{sorted(set(out) - expected)[:4]}")
    return out


def params_to_flax(named, cfg: GPT2Config):
    """The exact inverse of :func:`params_from_flax`: ``{name: tensor or
    array}`` (any subset, e.g. one leaf, or a moment of the optimizer) →
    the JAX package's nested flax tree of fp32 numpy leaves (the shapes are
    flax's already; ``h.{i}`` becomes ``h_{i}``)."""
    out = {}
    for name, value in named.items():
        a = (value.detach().float().cpu().numpy()
             if isinstance(value, torch.Tensor)
             else np.asarray(value, dtype=np.float32))
        parts, path = name.split("."), []
        while parts:
            part = parts.pop(0)
            if part == "h" and parts and parts[0].isdigit():
                part = f"h_{parts.pop(0)}"
            path.append(part)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a, dtype=np.float32)
    return out
