"""HuggingFace checkpoint directories served by the port's
``build_hf_engine`` and by the JAX package's: identical greedy tokens.

The directory holds ``config.json`` and either ``model.safetensors``
(written with the ``safetensors`` package, which the port does not use: its
own reader parses the format) or ``pytorch_model.bin`` (``torch.save``).
"""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import build_hf_engine as jax_build
from deepspeed_tpu_torch.inference.v2 import build_hf_engine
from deepspeed_tpu_torch.inference.v2.checkpoint.huggingface_engine import \
    read_safetensors

_HF_CONFIG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64,
                  rms_norm_eps=1e-5, rope_theta=10000.0)


def _hf_state(cfg, seed):
    """Random weights under HF names, torch ``[out, in]`` layout."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H

    def w(n_out, n_in, fan_in=None):
        return (rng.standard_normal((n_out, n_in))
                / np.sqrt(fan_in or n_in)).astype(np.float32)

    state = {"model.embed_tokens.weight": w(V, D, fan_in=1),
             "model.norm.weight": np.ones(D, np.float32)}
    if not cfg.get("tie_word_embeddings"):
        state["lm_head.weight"] = w(V, D)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        state.update({
            p + "self_attn.q_proj.weight": w(H * Dh, D),
            p + "self_attn.k_proj.weight": w(Hkv * Dh, D),
            p + "self_attn.v_proj.weight": w(Hkv * Dh, D),
            p + "self_attn.o_proj.weight": w(D, H * Dh),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I),
            p + "input_layernorm.weight": np.ones(D, np.float32),
            p + "post_attention_layernorm.weight": np.ones(D, np.float32),
        })
        if cfg.get("model_type") == "qwen2":
            for proj, n in (("q", H), ("k", Hkv), ("v", Hkv)):
                state[p + f"self_attn.{proj}_proj.bias"] = (
                    0.1 * rng.standard_normal(n * Dh)).astype(np.float32)
    return state


def _write_dir(root, cfg, fmt, seed=0):
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(cfg))
    state = _hf_state(cfg, seed)
    if fmt == "safetensors":
        st = pytest.importorskip("safetensors.numpy")
        st.save_file(state, str(root / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   root / "pytorch_model.bin")
    return str(root)


_ENGINE = dict(dtype="float32", decode_burst=16,
               state_manager=dict(max_ragged_batch_size=32, block_size=8,
                                  max_context=64, num_blocks=32,
                                  max_ragged_sequence_count=4,
                                  max_tracked_sequences=4,
                                  prefill_atom_size=0))


@pytest.mark.parametrize("fmt,model_type", [
    ("safetensors", "llama"), ("bin", "llama"), ("safetensors", "qwen2")])
def test_hf_dir_tokens_match_jax(tmp_path, fmt, model_type):
    cfg = dict(_HF_CONFIG, model_type=model_type)
    if model_type == "qwen2":       # q/k/v biases and a tied head
        cfg["tie_word_embeddings"] = True
    path = _write_dir(tmp_path / "ckpt", cfg, fmt)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (9, 4)]
    want = jax_build(path, dict(_ENGINE)).generate(prompts, max_new_tokens=5)
    eng = build_hf_engine(path, dict(_ENGINE), device="cpu")
    assert eng.device == torch.device("cpu")
    got = eng.generate(prompts, max_new_tokens=5)
    assert got == want


def test_safetensors_reader_matches_library(tmp_path):
    """The port's own parser against the ``safetensors`` package, bf16 and
    empty tensors included."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b.f32": torch.randn(7, generator=g),
        "c.f16": torch.randn(2, 2, 2, generator=g).half(),
        "d.i64": torch.arange(6).reshape(2, 3),
        "e.empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = dict(read_safetensors(path))
    want = st.load_file(path)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t), name


def test_unported_model_type_raises(tmp_path):
    cfg = dict(_HF_CONFIG, model_type="falcon")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_hf_engine(str(tmp_path), device="cpu")
