"""HF checkpoint → model builders (reference
``inference/v2/model_implementations/*/`` policy+container classes); the
port of ``deepspeed_tpu/inference/v2/model_implementations/hf_builders.py``
for the Llama and Mixtral architectures.

Supported ``model_type``s: llama, mistral, qwen2, mixtral.  The port's
:class:`LlamaModel` keeps HF names and torch layouts, so Llama ingestion is
a name filter: no transposes or reshapes.  Mixtral's per-expert HF tensors
go into the stacked experts of :class:`MixtralModel` one expert at a time.
"""

import re
from dataclasses import asdict
from typing import Iterable, Tuple

import torch

from ....models.llama import LlamaConfig, LlamaModel
from ....models.mixtral import MixtralConfig, MixtralModel
from ....utils.logging import logger
from ....utils.not_ported import not_ported

SUPPORTED_MODEL_TYPES = ("llama", "mistral", "qwen2", "mixtral")

_SKIP_SUFFIXES = (".rotary_emb.inv_freq", ".masked_bias", ".attn.bias")


def _rope_scaling_type(cfg: dict) -> str:
    """The HF rope_scaling type, handling both key spellings ('rope_type'
    new, 'type' old); 'none' when absent."""
    rs = cfg.get("rope_scaling") or {}
    return rs.get("rope_type", rs.get("type", "none")) or "none"


def _rope_scaling_fields(cfg: dict) -> dict:
    """Map HF ``rope_scaling`` onto LlamaConfig's scalar fields.

    Supported: linear, llama3.  Anything else (longrope/yarn/dynamic)
    raises rather than silently serving with unscaled RoPE."""
    rs = cfg.get("rope_scaling") or {}
    stype = _rope_scaling_type(cfg)
    if stype in ("none", "default"):
        return {}
    if stype == "linear":
        return {"rope_scaling_type": "linear",
                "rope_scaling_factor": float(rs["factor"])}
    if stype == "llama3":
        return {
            "rope_scaling_type": "llama3",
            "rope_scaling_factor": float(rs["factor"]),
            "rope_low_freq_factor": float(rs.get("low_freq_factor", 1.0)),
            "rope_high_freq_factor": float(rs.get("high_freq_factor", 4.0)),
            "rope_original_max_position":
                int(rs.get("original_max_position_embeddings", 8192)),
        }
    raise ValueError(
        f"unsupported rope_scaling type {stype!r} "
        f"({cfg.get('model_type')}): only linear/llama3 are implemented")


def _llama_config_from_hf(cfg: dict, dtype: str) -> LlamaConfig:
    return LlamaConfig(
        **_rope_scaling_fields(cfg),
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads",
                                    cfg["num_attention_heads"]),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window") or 0,
        attention_bias=cfg.get("attention_bias",
                               cfg.get("model_type") == "qwen2"),
        dtype=dtype)


def _ingest_llama(model_cfg: LlamaConfig,
                  params_iter: Iterable[Tuple[str, torch.Tensor]]):
    """HF names → :class:`LlamaModel` names (they are the same, except that
    some checkpoints drop the ``model.`` prefix); buffers HF keeps in the
    state dict are skipped, and a tied checkpoint's ``lm_head`` is left to
    the embedding."""
    for name, arr in params_iter:
        if name.endswith(_SKIP_SUFFIXES):
            continue
        if name == "lm_head.weight":
            if not model_cfg.tie_word_embeddings:
                yield name, arr
            continue
        if not name.startswith("model."):
            name = "model." + name
        yield name, arr


def _mixtral_config_from_hf(cfg: dict, dtype: str) -> MixtralConfig:
    return MixtralConfig(
        **asdict(_llama_config_from_hf(cfg, dtype)),
        num_local_experts=cfg.get("num_local_experts", 8),
        num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        router_aux_loss_coef=cfg.get("router_aux_loss_coef", 0.02))


_HF_EXPERT = re.compile(
    r"(.*)\.block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight$")


def _ingest_mixtral(model_cfg: MixtralConfig,
                    params_iter: Iterable[Tuple[str, torch.Tensor]]):
    """The Llama mapping, plus ``block_sparse_moe``: the router
    ``gate.weight`` ``[E, D]`` becomes the ``[D, E]`` gate, and each
    ``experts.{e}.w{1,2,3}.weight`` (``[I, D]``, or ``[D, I]`` for w2)
    becomes slice ``e`` of its stack, transposed (``hf_builders.py:139``) —
    yielded one expert at a time, as the checkpoint streams them."""
    for name, arr in _ingest_llama(model_cfg, params_iter):
        m = _HF_EXPERT.match(name)
        if m is not None:
            layer, e, w = m.groups()
            yield f"{layer}.block_sparse_moe.{w}.{e}", arr.t()
        elif name.endswith(".block_sparse_moe.gate.weight"):
            yield name[:-len(".weight")], arr.t()
        else:
            yield name, arr


def build_model_and_params(checkpoint_engine, dtype: str = "bfloat16",
                           device=None, tp_size=1):
    """The loaded model (:class:`LlamaModel` or :class:`MixtralModel`) from
    a checkpoint engine with a ``model_config`` dict (HF ``config.json``),
    on ``device`` (a resolved ``torch.device``).  Returns ``(model, None)``:
    the model holds its weights.  At ``tp_size`` > 1 the meta model is cut
    to this rank's slices first (``engine_v2.shard_for_serving``), so the
    load copies only them out of each tensor (the safetensors reader maps
    the files, so only their pages are read)."""
    hf_cfg = checkpoint_engine.model_config
    model_type = hf_cfg.get("model_type", "llama")
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise not_ported(f"serving model_type {model_type!r}", "S5")
    if model_type == "mixtral":
        cfg = _mixtral_config_from_hf(hf_cfg, dtype)
        model, ingest = MixtralModel(cfg, device="meta"), _ingest_mixtral
    else:
        cfg = _llama_config_from_hf(hf_cfg, dtype)
        model, ingest = LlamaModel(cfg, device="meta"), _ingest_llama
    if tp_size > 1:
        from ..engine_v2 import shard_for_serving
        shard_for_serving(model, tp_size, device)
    model.load_weights(ingest(cfg, checkpoint_engine.parameters()),
                       device=device)
    if cfg.sliding_window:
        logger.info(f"{model_type}: sliding_window={cfg.sliding_window} "
                    "(enforced in the ragged attention path)")
    return model, None
