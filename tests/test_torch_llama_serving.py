"""The port's FastGen-v2 Llama serving path against the JAX package's, on
the CPU in fp32 at ``llama_tiny`` size.

Both packages get the same weights: a numpy tree in the flax layout, handed
to the JAX engine as it is and to the port through ``params_from_flax``.
One ragged step must give the same logits (1e-4: the products sum in
another order) and the same cache; ``generate`` must give identical greedy
tokens.  Each generated token's top-2 logit margin is checked to exceed
1e-3, so that a near tie shows up as a bad seed, not as a port fault.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.ragged_forward import \
    llama_ragged_step as jax_step
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              KVCacheExhausted)
from deepspeed_tpu_torch.inference.v2.ragged_forward import \
    llama_ragged_step as port_step
from deepspeed_tpu_torch.models import llama as port_llama


def _flax_tree(cfg, seed):
    """Random weights in the flax layout, scaled so logits are O(1)."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    tree = {"embed_tokens": {"embedding": w(V, D, fan_in=1)},
            "norm": {"weight": norm()},
            "lm_head": {"kernel": w(D, V, fan_in=D)}}
    for i in range(cfg.num_hidden_layers):
        attn = {"q_proj": {"kernel": w(D, H, Dh, fan_in=D)},
                "k_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                "v_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                "o_proj": {"kernel": w(H * Dh, D, fan_in=H * Dh)}}
        tree[f"layers_{i}"] = {
            "self_attn": attn,
            "mlp": {"gate_proj": {"kernel": w(D, I, fan_in=D)},
                    "up_proj": {"kernel": w(D, I, fan_in=D)},
                    "down_proj": {"kernel": w(I, D, fan_in=I)}},
            "input_layernorm": {"weight": norm()},
            "post_attention_layernorm": {"weight": norm()}}
    return tree


def _sm(budget, atom, block_size=8, max_context=64, num_blocks=64):
    return dict(max_ragged_batch_size=budget, block_size=block_size,
                max_context=max_context, num_blocks=num_blocks,
                max_ragged_sequence_count=8, max_tracked_sequences=8,
                prefill_atom_size=atom)


def _engines(budget=16, atom=0, burst=16, seed=0, **cfg_over):
    """(JAX engine, port engine) over the same weights."""
    over = dict(num_key_value_heads=2, **cfg_over)
    jcfg = jax_llama.llama_tiny(dtype="float32", remat=False, **over)
    pcfg = port_llama.llama_tiny(dtype="float32", **over)
    tree = _flax_tree(jcfg, seed)
    config = dict(dtype="float32", decode_burst=burst,
                  state_manager=_sm(budget, atom))
    jax_eng = JaxEngine(jax_llama.LlamaModel(jcfg), tree, config)
    port_eng = InferenceEngineV2(
        port_llama.LlamaModel(pcfg, device="meta"),
        port_llama.params_from_flax(tree, pcfg), config, device="cpu")
    return jax_eng, port_eng


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def _min_margin(eng, prompts, outs):
    """Re-run every generated prefix through the port engine's step and
    return the smallest top-2 logit margin; each argmax must be the token
    that was generated."""
    model, cfg = eng.module, eng.model_config
    margin = np.inf
    for prompt, gen in zip(prompts, outs):
        for i, tok in enumerate(gen):
            probe = InferenceEngineV2(
                model, config=dict(dtype="float32", decode_burst=0,
                                   state_manager=_sm(64, 0)), device="cpu")
            probe.put([0], [prompt + gen[:i]])
            toks, pos, slots, last_idx, finishing, layout = \
                probe._build_batch()
            t = [torch.from_numpy(a) for a in
                 (toks, pos, slots, probe.state_manager.block_table,
                  last_idx)]
            logits, _ = port_step(model, probe._kv, *t, cfg=cfg,
                                  block_size=8, layout=layout)
            top = torch.topk(logits[finishing[0][0].slot], 2).values
            assert int(torch.argmax(logits[finishing[0][0].slot])) == tok
            margin = min(margin, float(top[0] - top[1]))
    return margin


_CASES = {
    # name: (prompt lengths, max_new_tokens, budget)
    "three_prompts": ((5, 3, 7), 6, 16),
    "chunked_prefill": ((20, ), 6, 8),
    "atom_mix": ((23, 9, 2, 17), 6, 64),
}


@pytest.mark.parametrize("atom", [0, 16])
@pytest.mark.parametrize("burst", [0, 16])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_generate_matches_jax(case, burst, atom):
    lengths, new, budget = _CASES[case]
    jax_eng, port_eng = _engines(budget=budget, atom=atom, burst=burst)
    prompts = _prompts(sum(lengths), lengths)
    layouts = []
    build = port_eng._build_batch

    def spy():
        batch = build()
        if batch is not None:
            layouts.append(batch[-1])
        return batch

    port_eng._build_batch = spy
    want = jax_eng.generate(prompts, max_new_tokens=new)
    got = port_eng.generate(prompts, max_new_tokens=new)
    assert got == want
    assert all(len(g) == new for g in got)
    assert _min_margin(port_eng, prompts, got) > 1e-3
    if case == "atom_mix" and atom:
        assert any(layout[1] == atom for layout in layouts)
    if burst:
        assert getattr(port_eng, "burst_steps", 0) > 0
    free = port_eng.kv_cache.num_blocks - 1
    assert port_eng.state_manager.free_blocks == free


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "gather"])
@pytest.mark.parametrize("atom", [0, 8])
def test_ragged_step_matches_jax(monkeypatch, atom, use_kernel):
    """One ragged step on identical batch arrays: logits within 1e-4 and
    the same cache.  ``use_kernel`` runs the JAX Pallas kernel in interpret
    mode against the port's kernel wrappers (their plain version here)."""
    monkeypatch.setenv("DS_TPU_TEST_PAGED_INTERPRET", "1")
    jax_eng, port_eng = _engines(budget=64, atom=atom)
    prompts = _prompts(3, (20, 5, 1, 9))
    jax_eng.put(range(4), prompts)
    batch = jax_eng._build_batch()
    toks, pos, slots, last_idx, _, layout = batch
    assert layout[1] == atom
    table = jax_eng.state_manager.block_table
    cfg, bs = jax_eng.model_config, jax_eng.kv_cache.block_size
    kv0 = np.zeros(jax_eng.kv_cache.data.shape, np.float32)
    want, want_kv = jax_step(
        jax_eng.params, jnp.asarray(kv0), *map(jnp.asarray, (
            toks, pos, slots, table, last_idx)),
        cfg=cfg, block_size=bs, layout=layout, use_kernel=use_kernel)
    got, got_kv = port_step(
        port_eng.module, torch.from_numpy(kv0.copy()),
        *map(torch.from_numpy, (toks, pos, slots, table, last_idx)),
        cfg=port_eng.model_config, block_size=bs, layout=layout,
        use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv),
                               atol=1e-4, rtol=1e-4)
    jax_eng.flush(range(4))


def test_sliding_window_matches_jax():
    """A Mistral-like tiny config (GQA, sliding_window=8) with prompts
    longer than the window."""
    jax_eng, port_eng = _engines(budget=16, sliding_window=8, seed=1)
    prompts = _prompts(11, (12, 5, 19))
    want = jax_eng.generate(prompts, max_new_tokens=6)
    got = port_eng.generate(prompts, max_new_tokens=6)
    assert got == want
    assert _min_margin(port_eng, prompts, got) > 1e-3


def test_put_query_flush_returns_blocks():
    _, eng = _engines()
    eng.put([7], [[1, 2, 3]])
    st = eng.query(7)
    assert st["length"] == 3 and st["seen"] == 0
    toks = eng.schedule_step()
    assert 7 in toks
    assert eng.query(7)["seen"] == 3
    eng.flush([7])
    assert eng.query(7) is None
    assert eng.state_manager.free_blocks == eng.kv_cache.num_blocks - 1
    eng.put([3], [[1, 2]])
    eng.schedule_step()
    eng.state_manager.get_sequence(3).done = True
    with pytest.raises(ValueError, match="finished uid"):
        eng.put([3], [[4]])


def test_kv_cache_exhausted_is_typed():
    """A pool too small for one prompt raises the typed capacity error,
    which stays a RuntimeError."""
    config = dict(dtype="float32", state_manager=_sm(16, 0, num_blocks=2))
    eng = InferenceEngineV2(
        port_llama.LlamaModel(port_llama.llama_tiny(
            dtype="float32", num_key_value_heads=2)).init_weights(
                torch.Generator().manual_seed(0)), config=config,
        device="cpu")
    eng.put([0], [list(range(20))])
    eng.schedule_step()                 # the one free block: 8 tokens
    with pytest.raises(KVCacheExhausted) as ei:
        eng.schedule_step()
    assert isinstance(ei.value, RuntimeError)
    assert ei.value.wanted_blocks == 1 and ei.value.free_blocks == 0


@pytest.mark.parametrize("preset", ["llama_7b", "llama_13b", "llama_tiny",
                                    "mistral_7b", "qwen2_7b"])
def test_config_presets_match_jax(preset):
    """Presets, parameter count and RoPE tables equal the JAX package's."""
    jcfg = getattr(jax_llama, preset)()
    pcfg = getattr(port_llama, preset)()
    for f in dataclasses.fields(pcfg):
        assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert port_llama.param_count(pcfg) == jax_llama.param_count(jcfg)
    scaled = dict(rope_scaling_type="llama3", rope_scaling_factor=8.0)
    for over in ({}, scaled):
        jc, pc = jcfg.__class__(**over), pcfg.__class__(**over)
        want = jax_llama._rope_freqs(jc.head_dim, 64, jc.rope_theta,
                                     jc.rope_scaling)
        got = port_llama._rope_freqs(pc.head_dim, 64, pc.rope_theta,
                                     pc.rope_scaling)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_lm_head_turns_tf32_off_for_itself_only():
    """The fp32 head's product runs with TF32 off, as the JAX head does,
    and the caller's setting comes back unchanged."""
    from torch.overrides import TorchFunctionMode
    from deepspeed_tpu_torch.inference.v2.ragged_forward import _lm_head
    cfg = port_llama.llama_tiny(dtype="float32")
    model = port_llama.LlamaModel(cfg).init_weights(
        torch.Generator().manual_seed(0))
    seen = []

    class Probe(TorchFunctionMode):

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            return func(*args, **(kwargs or {}))

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with Probe():
            logits = _lm_head(model, torch.randn(3, cfg.hidden_size),
                              torch.tensor([0, 2]), cfg)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [False]
    assert logits.dtype == torch.float32
    assert logits.shape == (2, cfg.vocab_size)


def test_not_ported_options_raise():
    for over in (dict(kv_cache_dtype="int8"),
                 dict(decode_burst_sampling=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngineV2(
                port_llama.LlamaModel(port_llama.llama_tiny(
                    dtype="float32")), config=over, device="cpu")
    # tp_size > 1 is served (tests/test_torch_tp_serving.py); a process
    # that is one rank cannot hold a tp group of two
    with pytest.raises(ValueError, match="tp_size"):
        InferenceEngineV2(
            port_llama.LlamaModel(port_llama.llama_tiny(dtype="float32")),
            config=dict(tensor_parallel={"tp_size": 2}), device="cpu")
    # a mode the JAX engine refuses too, with its wording
    with pytest.raises(NotImplementedError, match="quantization_mode"):
        InferenceEngineV2(
            port_llama.LlamaModel(port_llama.llama_tiny(dtype="float32")),
            config=dict(quantization_mode="wf6af16"), device="cpu")
    from deepspeed_tpu_torch.profiling import cost_model
    from deepspeed_tpu_torch import serving
    for call in (cost_model.enable_capture, serving.build_serving_engine,
                 serving.ServingScheduler):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
