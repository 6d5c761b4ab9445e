"""Per-architecture injection policies (the port of
``deepspeed_tpu/module_inject/containers.py``; reference
``module_inject/containers/`` and ``replace_module.py:183``).

A policy names, for one HuggingFace ``model_type``, the port's model class
that serves or trains it, built from the HF config: kernel injection in one
step, since the port's models already run its hand-written kernels (B1 in
training attention, B4 in the ragged step, B7 in the experts).  The port
has llama (and its aliases llama2, mistral, qwen2), mixtral, gpt2 and bert;
the other types of the JAX package's table raise ``not_ported`` naming
their item (S5: a ragged serving step; 11: the model).
"""

from typing import Callable, NamedTuple, Optional

from ..utils.logging import logger
from ..utils.not_ported import not_ported


class InjectionPolicy(NamedTuple):
    model_type: str             # HF config.json model_type
    model_factory: Callable     # (HF config dict, dtype, device) → module
    supports_training: bool = True


def _llama_factory(hf_cfg, dtype="bfloat16", device="meta"):
    from ..inference.v2.model_implementations.hf_builders import (
        _llama_config_from_hf)
    from ..models.llama import LlamaModel
    return LlamaModel(_llama_config_from_hf(hf_cfg, dtype), device=device)


def _mixtral_factory(hf_cfg, dtype="bfloat16", device="meta"):
    from ..inference.v2.model_implementations.hf_builders import (
        _mixtral_config_from_hf)
    from ..models.mixtral import MixtralModel
    return MixtralModel(_mixtral_config_from_hf(hf_cfg, dtype),
                        device=device)


def _gpt2_factory(hf_cfg, dtype="bfloat16", device="meta"):
    """HF GPT2Config → the port's GPT-2 (JAX ``hf_builders.py:1009``): the
    tanh GELU only, the MLP at 4 × the width."""
    from ..models.gpt2 import GPT2Config, GPT2Model
    act = hf_cfg.get("activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(f"gpt2 activation_function {act!r} is not "
                         "supported (gelu_new only)")
    n_embd = hf_cfg.get("n_embd", hf_cfg.get("hidden_size"))
    n_inner = hf_cfg.get("n_inner")
    if n_inner is not None and n_inner != 4 * n_embd:
        raise ValueError(f"gpt2 n_inner={n_inner} != 4 * n_embd")
    return GPT2Model(GPT2Config(
        vocab_size=hf_cfg["vocab_size"], hidden_size=n_embd,
        num_hidden_layers=hf_cfg.get("n_layer",
                                     hf_cfg.get("num_hidden_layers")),
        num_attention_heads=hf_cfg.get("n_head",
                                       hf_cfg.get("num_attention_heads")),
        max_position_embeddings=hf_cfg.get("n_positions", 1024),
        layer_norm_epsilon=hf_cfg.get("layer_norm_epsilon", 1e-5),
        dtype=dtype), device=device)


def _bert_factory(hf_cfg, dtype="bfloat16", device="meta"):
    """HF BertConfig → the port's BERT (JAX ``hf_builders.py:709``): the
    erf GELU only."""
    from ..models.bert import BertConfig, BertModel
    if hf_cfg.get("hidden_act", "gelu") != "gelu":
        raise ValueError(f"bert hidden_act {hf_cfg.get('hidden_act')!r} is "
                         "not supported (erf gelu only)")
    return BertModel(BertConfig(
        vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
        num_hidden_layers=hf_cfg["num_hidden_layers"],
        num_attention_heads=hf_cfg["num_attention_heads"],
        intermediate_size=hf_cfg["intermediate_size"],
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 512),
        type_vocab_size=hf_cfg.get("type_vocab_size", 2),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        dtype=dtype), device=device)


POLICIES = {
    "llama": InjectionPolicy("llama", _llama_factory),
    "llama2": InjectionPolicy("llama", _llama_factory),
    "mistral": InjectionPolicy("mistral", _llama_factory),
    "qwen2": InjectionPolicy("qwen2", _llama_factory),
    "mixtral": InjectionPolicy("mixtral", _mixtral_factory),
    "gpt2": InjectionPolicy("gpt2", _gpt2_factory),
    "bert": InjectionPolicy("bert", _bert_factory),
}

# the JAX package's other policies, and the queue-A item each waits for
UNPORTED = {
    "qwen2_moe": "S5", "falcon": "S5", "opt": "S5", "phi": "S5",
    "qwen": 11, "phi3": 11, "bloom": 11, "gpt_neox": 11, "gpt_neo": 11,
    "gptj": 11, "distilbert": 11, "internlm": 11, "internlm2": 11,
}


def _key(arch_or_model):
    if isinstance(arch_or_model, str):
        return arch_or_model.lower()
    if isinstance(arch_or_model, dict):
        return arch_or_model.get("model_type", "").lower()
    key = type(arch_or_model).__name__.lower()
    # longest match first and underscore-insensitive (a Qwen2Moe class
    # name must hit "qwen2_moe", not "qwen2")
    for name in sorted(list(POLICIES) + list(UNPORTED), key=len,
                       reverse=True):
        if name.replace("_", "") in key.replace("_", ""):
            return name
    return key


def policy_for(arch_or_model) -> Optional[InjectionPolicy]:
    """The policy of an arch name, an HF config dict or a model (its class
    name); None for an unknown type.  A type of the JAX package's table
    that the port lacks raises ``not_ported``."""
    key = _key(arch_or_model)
    if key in UNPORTED:
        raise not_ported(f"the {key!r} injection policy", UNPORTED[key])
    return POLICIES.get(key)


def replace_transformer_layer(arch_or_model, checkpoint_dir=None,
                              dtype="bfloat16", config=None, device=None):
    """Reference-shaped injection entry (``replace_module.py:183``): the
    port's model for an architecture, with the weights of a local HF
    checkpoint when given (``build_model_and_params``; on ``device``, None
    meaning the card), else built from the HF ``config`` dict on the meta
    device.  Returns ``(model, params)``; params is None, since the model
    holds its weights."""
    policy = policy_for(arch_or_model if config is None else config)
    if policy is None:
        raise ValueError(
            f"no injection policy for {arch_or_model!r} "
            f"(have: {sorted(POLICIES)}); pass the model through unchanged "
            "or add a policy")
    if checkpoint_dir is not None:
        from ..accelerator import resolve_device
        from ..inference.v2.checkpoint import HuggingFaceCheckpointEngine
        from ..inference.v2.model_implementations import (
            build_model_and_params)
        engine = HuggingFaceCheckpointEngine(checkpoint_dir)
        return build_model_and_params(engine, dtype=dtype,
                                      device=resolve_device(device))
    if config is None:
        raise ValueError("need either checkpoint_dir or an HF config dict")
    model = policy.model_factory(config, dtype=dtype,
                                 device=device or "meta")
    logger.info(f"injected the port's {policy.model_type} implementation")
    return model, None


def revert_transformer_layer(orig_model, replaced=None, config=None):
    """Reference ``revert_transformer_layer``: injection returns a new
    model and never mutates the caller's, so reverting returns the
    original object."""
    logger.info("revert_transformer_layer: injection is non-mutating; "
                "returning the original model")
    return orig_model
