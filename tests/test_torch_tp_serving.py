"""Serving at ``tensor_parallel.tp_size`` > 1 (ROADMAP queue A item S1):
the port's ``InferenceEngineV2`` over four gloo ranks on the CPU, against
the JAX engine at the same tp on its 8-device CPU mesh and the port at tp
1, from the same fp32 weights (flax trees through ``params_from_flax``, or
one HF directory both packages read).

One spawn runs every leg: ``llama_tiny`` at tp 1, 2 and 4 (its 2 kv heads
replicated at tp 4), ``mixtral_tiny`` at tp 1 and 2, and ``build_hf_engine``
of a Llama, a Qwen2 (q/k/v biases, tied head) and a Mixtral directory at
tp 2.  Each runs ``generate`` (with its decode bursts), a
``put``/``schedule_step``/``query``/``flush`` loop and ``burst_decode``.
Greedy tokens must equal JAX's and tp 1's exactly, and every rank must emit
the same tokens.  A shape that tp divides neither way raises JAX's
``ValueError``; ``quantization_mode`` with tp > 1 keeps raising.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import build_hf_engine as jax_build
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama as port_llama
from test_torch_hf_ingest import _HF_CONFIG, _write_dir
from test_torch_llama_training import _flax_tree as llama_tree
from test_torch_mixtral_serving import _HF_MIXTRAL, _hf_mixtral_state
from test_torch_mixtral_serving import _flax_tree as mixtral_tree
from torch_dist_worker import spawn

WORLD, NEW = 4, 8
CFG = dict(dtype="float32")
SM = dict(max_tracked_sequences=8, max_ragged_batch_size=64,
          max_ragged_sequence_count=8, max_context=128, block_size=16,
          num_blocks=40)
PROMPTS = [np.random.default_rng(0).integers(1, 96, size=n).tolist()
           for n in (21, 7, 13)]
TREES = {"llama": llama_tree(jax_llama.llama_tiny(**CFG), seed=3),
         "mixtral": mixtral_tree(jax_mixtral.mixtral_tiny(**CFG), 2)}
JAX_MODELS = {"llama": (jax_llama.LlamaModel, jax_llama.llama_tiny),
              "mixtral": (jax_mixtral.MixtralModel,
                          jax_mixtral.mixtral_tiny)}


def _engine_config(tp):
    return dict(dtype="float32", state_manager=dict(SM),
                tensor_parallel=dict(tp_size=tp))


CASES = [("llama", 1), ("llama", 2), ("llama", 4), ("mixtral", 1),
         ("mixtral", 2)]
HF = ("llama", "qwen2", "mixtral")


def _hf_dirs(root):
    out = {}
    for kind in HF:
        path = root / kind
        if kind == "mixtral":
            st = pytest.importorskip("safetensors.numpy")
            path.mkdir(parents=True)
            (path / "config.json").write_text(json.dumps(_HF_MIXTRAL))
            st.save_file(_hf_mixtral_state(_HF_MIXTRAL, 1),
                         str(path / "model.safetensors"))
            out[kind] = str(path)
        else:
            cfg = dict(_HF_CONFIG, model_type=kind)
            if kind == "qwen2":
                cfg["tie_word_embeddings"] = True
            out[kind] = _write_dir(path, cfg, "safetensors", seed=4)
    return out


HF_PROMPTS = [np.random.default_rng(5).integers(0, 128, size=n).tolist()
              for n in (9, 4)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    dirs = _hf_dirs(tmp_path_factory.mktemp("hf"))
    legs = [dict(name=f"{m}_tp{tp}", kind="serve", model=m, cfg=CFG,
                 tree=TREES[m], prompts=PROMPTS, new=NEW,
                 config=_engine_config(tp)) for m, tp in CASES]
    legs += [dict(name=f"hf_{k}", kind="serve", hf_dir=d,
                  prompts=HF_PROMPTS, new=NEW, config=_engine_config(2))
             for k, d in dirs.items()]
    return spawn(WORLD, legs, timeout=600), dirs


def _jax_generate(model, tp):
    cls, cfg_fn = JAX_MODELS[model]
    cfg = cfg_fn(dtype="float32", remat=False)
    eng = JaxEngine(cls(cfg), params=jax.tree_util.tree_map(
        jnp.asarray, TREES[model]), config=_engine_config(tp))
    out = eng.generate(PROMPTS, max_new_tokens=NEW)
    return out, getattr(eng, "burst_steps", 0)


@pytest.mark.parametrize("model,tp", CASES)
def test_generate_matches_jax_and_tp1(served, model, tp):
    res = served[0][f"{model}_tp{tp}"]
    want, _ = _jax_generate(model, tp)
    for r in res:
        assert r["generate"] == want
        assert r["generate"] == served[0][f"{model}_tp1"][0]["generate"]


@pytest.mark.parametrize("model,tp", CASES)
def test_every_rank_emits_the_same_tokens(served, model, tp):
    res = served[0][f"{model}_tp{tp}"]
    for r in res[1:]:
        for key in ("generate", "stepped", "queried", "flushed"):
            assert r[key] == res[0][key], key
    # put/schedule_step/burst_decode give generate's tokens
    for i, uid in enumerate(sorted(res[0]["stepped"])):
        got = res[0]["stepped"][uid]
        assert got == res[0]["generate"][i][:len(got)]
        assert len(got) >= 4
    assert all(q is None for q in res[0]["flushed"])


@pytest.mark.parametrize("model,tp", [c for c in CASES if c[1] > 1])
def test_tp_ranks_hold_their_slices(served, model, tp):
    r = served[0][f"{model}_tp{tp}"][0]
    whole = served[0][f"{model}_tp1"][0]
    D, Dh = 64, 16
    q = r["shapes"]["model.layers.0.self_attn.q_proj.weight"]
    assert q == (whole["shapes"]["model.layers.0.self_attn.q_proj.weight"]
                 [0] // tp, D)
    assert r["shapes"]["model.layers.0.self_attn.o_proj.weight"][1] == \
        q[0]
    assert r["shapes"]["lm_head.weight"][0] == 256 // tp
    assert r["shapes"]["model.embed_tokens.weight"][0] == 256 // tp
    # the cache holds this rank's kv heads: 2/tp, or at tp 4 (2 kv heads
    # replicated) the one its q heads read
    assert r["kv_shape"][-2] == max(1, 2 // tp) and r["kv_shape"][-1] == Dh
    if model == "llama" and tp == 4:
        assert r["shapes"]["model.layers.0.self_attn.k_proj.weight"] == \
            (2 * Dh, D)
    if model == "mixtral":
        assert r["shapes"]["model.layers.0.block_sparse_moe.w1"] == \
            (4, D, 128 // tp)
        assert r["shapes"]["model.layers.0.block_sparse_moe.w2"] == \
            (4, 128 // tp, D)
        assert r["shapes"]["model.layers.0.block_sparse_moe.gate"] == (D, 4)


def test_decode_bursts_run_at_tp(served):
    _, jax_bursts = _jax_generate("llama", 2)
    assert jax_bursts >= 1
    for model, tp in CASES:
        for r in served[0][f"{model}_tp{tp}"]:
            assert r["burst_steps"] >= 1


@pytest.mark.parametrize("kind", HF)
def test_hf_dirs_at_tp2_match_jax(served, kind):
    res = served[0][f"hf_{kind}"]
    want = jax_build(served[1][kind], _engine_config(1)).generate(
        HF_PROMPTS, max_new_tokens=NEW)
    for r in res:
        assert r["generate"] == want
    assert res[0]["shapes"]["model.layers.0.self_attn.q_proj.weight"][0] \
        == 32 // 2


def test_indivisible_shape_raises_like_jax():
    cfg = dict(dtype="float32", num_attention_heads=6, num_key_value_heads=3)
    with pytest.raises(ValueError, match="tp_size"):
        JaxEngine(jax_llama.LlamaModel(jax_llama.llama_tiny(**cfg)),
                  params=jax.tree_util.tree_map(jnp.asarray, llama_tree(
                      jax_llama.llama_tiny(**cfg), 1)),
                  config=dict(dtype="float32",
                              tensor_parallel=dict(tp_size=2)))
    with pytest.raises(ValueError, match="tp_size"):
        InferenceEngineV2(
            port_llama.LlamaModel(port_llama.llama_tiny(**cfg),
                                  device="meta"),
            config=dict(dtype="float32", tensor_parallel=dict(tp_size=2)),
            device="cpu")


def test_quantized_serving_at_tp_keeps_raising():
    with pytest.raises(NotImplementedError, match="quantization_mode"):
        InferenceEngineV2(
            port_llama.LlamaModel(port_llama.llama_tiny(**CFG)),
            config=dict(dtype="float32", quantization_mode="int8",
                        tensor_parallel=dict(tp_size=2)), device="cpu")
