"""The port's Mixtral serving path against the JAX package's, on the CPU at
``mixtral_tiny`` size: the grouped matmul's plain version (what the CUDA
kernel B7 is held to on the card), ``moe_expert_ffn``/``moe_apply``, one
ragged step, ``generate`` and an HF ``mixtral`` directory; and the
kernel's route rule (a pure function of shapes, dtype and alignment).

Both packages get the same weights: numpy arrays in the flax layout, handed
to JAX as they are and to the port through ``params_from_flax``.
Tolerances (each stated where it is used): fp32 products sum in another
order (1e-5 for one product, 1e-4 through a layer or a step); bf16 outputs
are each one rounding of an fp32 sum, so they may differ by one bf16 ulp of
|ref| (2^-7·|ref|) where the fp32 sums straddle a rounding boundary.
Greedy tokens must be identical, and each generated token's top-2 logit
margin is checked to exceed 1e-3, so that a near tie shows up as a bad
seed, not as a port fault.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import build_hf_engine as jax_build
from deepspeed_tpu.inference.v2.ragged_forward import \
    mixtral_ragged_step as jax_step
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.ops.pallas.grouped_matmul import gmm as jax_gmm
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, build_hf_engine
from deepspeed_tpu_torch.inference.v2.ragged_forward import \
    mixtral_ragged_step as port_step
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from deepspeed_tpu_torch.ops.kernels.grouped_matmul import gmm, gmm_plain

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same values for both packages: a numpy array rounded to
    ``dtype`` once (by JAX), then handed to torch."""
    jdt, tdt = _DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, dtype, fp32_tol):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=fp32_tol, atol=fp32_tol)
    else:
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-6)


# ------------------------------------------------------------- B7 plain
@pytest.mark.parametrize("sizes", [[100, 0, 72, 128], [1, 1, 1, 1],
                                   [256, 0, 0, 0]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_jax(sizes, dtype):
    """The group sizes of ``tests/unit/ops/test_grouped_matmul.py``: the
    port (``gmm`` on CPU tensors is its plain version) against
    ``lax.ragged_dot`` and the Pallas ``gmm`` in interpret mode.  fp32
    within 1e-5; bf16 within one bf16 ulp of |ref|."""
    r = np.random.default_rng(0)
    T, K, N, E = sum(sizes), 128, 256, len(sizes)
    xj, xt = _pair(r.standard_normal((T, K)), dtype)
    wj, wt = _pair(r.standard_normal((E, K, N)) * 0.1, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = gmm(xt, wt, gs)
    assert got.dtype == xt.dtype and got.shape == (T, N)
    assert torch.equal(got, gmm_plain(xt, wt, gs))
    gsj = jnp.asarray(sizes, jnp.int32)
    _close(got, jax.lax.ragged_dot(xj, wj, gsj), dtype, 1e-5)
    _close(got, jax_gmm(xj, wj, gsj), dtype, 1e-5)


def test_gmm_checks_shapes_and_zeroes_uncovered_rows():
    x = torch.ones(6, 4)
    w = torch.ones(2, 4, 3)
    y = gmm(x, w, torch.tensor([2, 1], dtype=torch.int32))
    assert torch.equal(y[:3], torch.full((3, 3), 4.0))
    assert torch.equal(y[3:], torch.zeros(3, 3))     # lax.ragged_dot: 0
    with pytest.raises(ValueError, match="group_sizes"):
        gmm(x, w, torch.tensor([6], dtype=torch.int32))
    with pytest.raises(ValueError, match="x \\[T, K\\]"):
        gmm(x, torch.ones(2, 5, 3), torch.tensor([3, 3], dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        gmm(x, w.double(), torch.tensor([3, 3], dtype=torch.int32))


# Mixtral-8x7B's expert products: (name, K, N) of w1/w3 [E, D, I] and w2
# [E, I, D] at its published widths
_MIXTRAL_PRODUCTS = [("w1", 4096, 14336), ("w3", 4096, 14336),
                     ("w2", 14336, 4096)]


@pytest.mark.parametrize("T,want", [(16, "wgmma_tma_64"),
                                    (64, "wgmma_tma_64"), (65, "wgmma_tma"),
                                    (1536, "wgmma_tma")],
                         ids=["decode16", "T64", "T65", "prefill1536"])
@pytest.mark.parametrize("name,K,N", _MIXTRAL_PRODUCTS,
                         ids=[p[0] for p in _MIXTRAL_PRODUCTS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_gmm_route_takes_tma_at_mixtral_shapes(name, K, N, T, want, dtype):
    """The kernel route is a pure function of shapes, dtype and alignment:
    Mixtral's w1/w2/w3 products take wgmma + TMA (64-row tiles at decode
    sizes), in bf16 and fp16."""
    from deepspeed_tpu_torch.ops.kernels.grouped_matmul import gmm_route
    assert gmm_route(T, K, N, dtype, 4096, 1 << 20) == want


@pytest.mark.parametrize("K,N,x_addr,w_addr,want", [
    (4096, 14336, 4096, 8, "mma_sync"),        # w only 8-byte aligned
    (4096, 14336, 4104, 4096, "mma_sync"),     # x only 8-byte aligned
    (4000, 14336, 0, 0, "mma_sync"),           # K not a multiple of 64
    (4096 + 32, 4096, 0, 0, "mma_sync"),
    (4096, 14340, 0, 0, "mma_sync"),           # N not a multiple of 8
    (4096, 1003, 0, 0, "mma_sync"),
    (64, 8, 0, 0, "wgmma_tma"),                # the smallest TMA shape
])
def test_gmm_route_takes_mma_where_tma_cannot(K, N, x_addr, w_addr, want):
    from deepspeed_tpu_torch.ops.kernels.grouped_matmul import gmm_route
    assert gmm_route(512, K, N, torch.bfloat16, x_addr, w_addr) == want


@pytest.mark.parametrize("K,N", [(4096, 14336), (1000, 1003)])
def test_gmm_route_fp32_takes_the_cuda_cores(K, N):
    from deepspeed_tpu_torch.ops.kernels.grouped_matmul import gmm_route
    for T in (1, 16, 1536):
        assert gmm_route(T, K, N, torch.float32, 0, 0) == "fp32"


def test_gmm_on_cpu_counts_no_launch():
    """CPU tensors take the plain version: no launch, no route counted."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    before = gm.gmm.launches, dict(gm.gmm.route_launches)
    x = torch.ones(6, 64, dtype=torch.bfloat16)
    w = torch.ones(2, 64, 8, dtype=torch.bfloat16)
    gm.gmm(x, w, torch.tensor([3, 3], dtype=torch.int32))
    assert (gm.gmm.launches, gm.gmm.route_launches) == before
    assert set(gm.gmm.route_launches) == set(gm.ROUTES)


# ------------------------------------------------------------------- MoE
def _moe_inputs(dtype, T=24, D=32, I=48, E=4, seed=1):
    r = np.random.default_rng(seed)
    x = _pair(r.standard_normal((T, D)), dtype)
    w1 = _pair(r.standard_normal((E, D, I)) / np.sqrt(D), dtype)
    w3 = _pair(r.standard_normal((E, D, I)) / np.sqrt(D), dtype)
    w2 = _pair(r.standard_normal((E, I, D)) / np.sqrt(I), dtype)
    logits = r.standard_normal((T, E)).astype(np.float32)
    return x, w1, w2, w3, logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_expert_ffn_matches_jax(dtype):
    """Uneven groups with an empty one.  fp32 within 1e-5.  bf16: each
    product is one rounding of an fp32 sum in both packages, but JAX rounds
    silu(gate) and its product with up separately where torch's silu
    rounds once, so the second product's inputs may differ by an ulp:
    within 2^-6·|ref| + 2^-7·max|ref|."""
    x, w1, w2, w3, _ = _moe_inputs(dtype)
    sizes = [9, 0, 11, 4]
    want = jax_mixtral.moe_expert_ffn(
        x[0], jnp.asarray(sizes, jnp.int32), w1[0], w2[0], w3[0])
    got = port_mixtral.moe_expert_ffn(
        x[1], torch.tensor(sizes, dtype=torch.int32), w1[1], w2[1], w3[1])
    assert got.dtype == x[1].dtype
    if dtype == "float32":
        _close(got, want, dtype, 1e-5)
    else:
        g, w = _np(got), _np(want)
        assert np.all(np.abs(g - w) <= 2.0**-6 * np.abs(w)
                      + 2.0**-7 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_apply_matches_jax(dtype, k):
    """Routing (fp32 softmax, top-k, renormalised, stable sort) must pick
    the same experts; the outputs then agree as in the FFN test (fp32 1e-5;
    bf16 within 2^-6·|ref| + 2^-7·max|ref|), the routing weights cast to
    the activation dtype before the product in both."""
    x, w1, w2, w3, logits = _moe_inputs(dtype)
    want = jax_mixtral.moe_apply(x[0], jnp.asarray(logits), w1[0], w2[0],
                                 w3[0], k)
    got = port_mixtral.moe_apply(x[1], torch.from_numpy(logits), w1[1],
                                 w2[1], w3[1], k)
    assert got.dtype == x[1].dtype and got.shape == x[1].shape
    if dtype == "float32":
        _close(got, want, dtype, 1e-5)
    else:
        g, w = _np(got), _np(want)
        assert np.all(np.abs(g - w) <= 2.0**-6 * np.abs(w)
                      + 2.0**-7 * np.abs(w).max())


def test_moe_apply_group_sizes_stay_on_device(monkeypatch):
    """The routing's group sizes reach the grouped matmul as an int32
    tensor on x's device, counted without ``torch.bincount`` (whose CUDA
    version reads its input's max on the host)."""
    x, w1, w2, w3, logits = _moe_inputs("float32")
    seen = []
    real = port_mixtral.gmm

    def fake_gmm(xs, w, gs):
        seen.append((gs.dtype, gs.device, int(gs.sum())))
        return real(xs, w, gs)

    monkeypatch.setattr(port_mixtral, "gmm", fake_gmm)
    monkeypatch.setattr(torch, "bincount", None)
    port_mixtral.moe_apply(x[1], torch.from_numpy(logits), w1[1], w2[1],
                           w3[1], 2)
    assert seen == [(torch.int32, torch.device("cpu"), 48)] * 3


# ------------------------------------------------------------ ragged step
def _flax_tree(cfg, seed):
    """Random Mixtral weights in the flax layout, scaled so logits are
    O(1) and the router's choices are not near ties."""
    rng = np.random.default_rng(seed)
    D, I, V, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_local_experts)
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
        tree[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": w(D, H, Dh, fan_in=D)},
                          "k_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                          "v_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                          "o_proj": {"kernel": w(H * Dh, D, fan_in=H * Dh)}},
            "moe": {"gate": {"kernel": w(D, E, fan_in=1)},
                    "w1": w(E, D, I, fan_in=D), "w3": w(E, D, I, fan_in=D),
                    "w2": w(E, I, D, fan_in=I)},
            "input_layernorm": {"weight": norm()},
            "post_attention_layernorm": {"weight": norm()}}
    return tree


def _sm(budget, atom, block_size=8, max_context=64, num_blocks=64):
    return dict(max_ragged_batch_size=budget, block_size=block_size,
                max_context=max_context, num_blocks=num_blocks,
                max_ragged_sequence_count=8, max_tracked_sequences=8,
                prefill_atom_size=atom)


def _engines(budget=16, atom=0, burst=16, seed=0, **engine_over):
    """(JAX engine, port engine) over the same fp32 mixtral_tiny weights."""
    jcfg = jax_mixtral.mixtral_tiny(dtype="float32", remat=False)
    pcfg = port_mixtral.mixtral_tiny(dtype="float32")
    tree = _flax_tree(jcfg, seed)
    config = dict(dtype="float32", decode_burst=burst,
                  state_manager=_sm(budget, atom), **engine_over)
    jax_eng = JaxEngine(jax_mixtral.MixtralModel(jcfg), tree, dict(config))
    port_eng = InferenceEngineV2(
        port_mixtral.MixtralModel(pcfg, device="meta"),
        port_mixtral.params_from_flax(tree, pcfg), dict(config),
        device="cpu")
    return jax_eng, port_eng


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def test_params_from_flax_layouts():
    cfg = port_mixtral.mixtral_tiny(dtype="float32")
    tree = _flax_tree(jax_mixtral.mixtral_tiny(dtype="float32"), 3)
    state = port_mixtral.params_from_flax(tree, cfg)
    model = port_mixtral.MixtralModel(cfg, device="meta").load_weights(
        state.items(), device="cpu")
    moe = model.model.layers[1].block_sparse_moe
    assert moe.w1.shape == (4, 64, 128) and moe.w2.shape == (4, 128, 64)
    assert moe.gate.dtype == torch.float32 and moe.gate.shape == (64, 4)
    np.testing.assert_array_equal(moe.w2.numpy(), tree["layers_1"]["moe"]["w2"])
    assert port_mixtral.param_count(cfg) == jax_mixtral.param_count(
        jax_mixtral.mixtral_tiny()) == sum(
            p.numel() for p in model.parameters())


def test_one_ragged_step_matches_jax():
    """A mixed batch (two prefills and pads) through one step: logits and
    the written cache within 1e-4 of JAX (fp32, another summation order
    through two layers)."""
    jax_eng, port_eng = _engines(budget=24)
    prompts = _prompts(1, (9, 6))
    for eng in (jax_eng, port_eng):
        eng.put([0, 1], prompts)
    jb = jax_eng._build_batch()
    pb = port_eng._build_batch()
    for a, b in zip(jb[:4], pb[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    toks, pos, slots, last_idx, _, layout = jb
    table = jax_eng.state_manager.block_table
    jl, jkv = jax_step(jax_eng.params, jax_eng._kv, jnp.asarray(toks),
                       jnp.asarray(pos), jnp.asarray(slots),
                       jnp.asarray(table), jnp.asarray(last_idx),
                       cfg=jax_eng.model_config, block_size=8, layout=layout)
    t = [torch.from_numpy(np.asarray(a)) for a in
         (toks, pos, slots, table, last_idx)]
    pl, pkv = port_step(port_eng.module, port_eng._kv, *t,
                        cfg=port_eng.model_config, block_size=8,
                        layout=layout)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pkv.numpy(), np.asarray(jkv), rtol=1e-4,
                               atol=1e-4)


def _min_margin(eng, prompts, outs):
    """The smallest top-2 logit margin over every generated token, each
    re-run through the port's step on a fresh probe engine (the argmax
    must be the generated token)."""
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
            row = logits[finishing[0][0].slot]
            top = torch.topk(row, 2).values
            assert int(torch.argmax(row)) == tok
            margin = min(margin, float(top[0] - top[1]))
    return margin


@pytest.mark.parametrize("lengths,new,budget,atom", [
    ((5, 3, 7), 6, 16, 0),            # decode bursts after the prefills
    ((20, ), 6, 8, 0),                # chunked prefill
    ((23, 9, 2, 17), 6, 64, 16),      # atom-tiled prefill region
], ids=["three_prompts", "chunked_prefill", "atom_mix"])
def test_generate_matches_jax(lengths, new, budget, atom):
    jax_eng, port_eng = _engines(budget=budget, atom=atom)
    prompts = _prompts(2, lengths)
    want = jax_eng.generate(prompts, max_new_tokens=new)
    got = port_eng.generate(prompts, max_new_tokens=new)
    assert got == want
    assert getattr(port_eng, "burst_steps", 0) == \
        getattr(jax_eng, "burst_steps", 0)
    assert _min_margin(port_eng, prompts, got) > 1e-3


# ------------------------------------------------------------- HF dir
_HF_MIXTRAL = dict(model_type="mixtral", vocab_size=128, hidden_size=32,
                   intermediate_size=48, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=64, rms_norm_eps=1e-5,
                   rope_theta=1e6, num_local_experts=4,
                   num_experts_per_tok=2, sliding_window=None)


def _hf_mixtral_state(cfg, seed):
    """Random weights under HF ``MixtralForCausalLM`` names (torch
    ``[out, in]`` layouts, one tensor per expert)."""
    rng = np.random.default_rng(seed)
    D, I, V, E = (cfg["hidden_size"], cfg["intermediate_size"],
                  cfg["vocab_size"], cfg["num_local_experts"])
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H

    def w(n_out, n_in, fan_in=None):
        return (rng.standard_normal((n_out, n_in))
                / np.sqrt(fan_in or n_in)).astype(np.float32)

    state = {"model.embed_tokens.weight": w(V, D, fan_in=1),
             "model.norm.weight": np.ones(D, np.float32),
             "lm_head.weight": w(V, D)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        state.update({
            p + "self_attn.q_proj.weight": w(H * Dh, D),
            p + "self_attn.k_proj.weight": w(Hkv * Dh, D),
            p + "self_attn.v_proj.weight": w(Hkv * Dh, D),
            p + "self_attn.o_proj.weight": w(D, H * Dh),
            p + "block_sparse_moe.gate.weight": w(E, D, fan_in=1),
            p + "input_layernorm.weight": np.ones(D, np.float32),
            p + "post_attention_layernorm.weight": np.ones(D, np.float32),
        })
        for e in range(E):
            q = p + f"block_sparse_moe.experts.{e}."
            state.update({q + "w1.weight": w(I, D), q + "w3.weight": w(I, D),
                          q + "w2.weight": w(D, I)})
    return state


_HF_ENGINE = dict(dtype="float32", decode_burst=16,
                  state_manager=dict(max_ragged_batch_size=32, block_size=8,
                                     max_context=64, num_blocks=32,
                                     max_ragged_sequence_count=4,
                                     max_tracked_sequences=4,
                                     prefill_atom_size=0))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hf_mixtral_dir_tokens_match_jax(tmp_path, fmt):
    root = tmp_path / "ckpt"
    root.mkdir()
    (root / "config.json").write_text(json.dumps(_HF_MIXTRAL))
    state = _hf_mixtral_state(_HF_MIXTRAL, 0)
    if fmt == "safetensors":
        st = pytest.importorskip("safetensors.numpy")
        st.save_file(state, str(root / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   root / "pytorch_model.bin")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (9, 4)]
    want = jax_build(str(root), dict(_HF_ENGINE)).generate(
        prompts, max_new_tokens=5)
    eng = build_hf_engine(str(root), dict(_HF_ENGINE), device="cpu")
    assert type(eng.module).__name__ == "MixtralModel"
    moe = eng.module.model.layers[0].block_sparse_moe
    np.testing.assert_array_equal(
        moe.w2[3].numpy(),
        state["model.layers.0.block_sparse_moe.experts.3.w2.weight"].T)
    assert eng.generate(prompts, max_new_tokens=5) == want


def test_mixtral_refusals():
    cfg = port_mixtral.mixtral_tiny(dtype="float32")
    with pytest.raises(NotImplementedError, match="S5"):
        port_mixtral.MixtralModel(port_mixtral.MixtralConfig(
            **{**cfg.__dict__, "shared_expert_intermediate_size": 32}))
    state = port_mixtral.params_from_flax(
        _flax_tree(jax_mixtral.mixtral_tiny(dtype="float32"), 0), cfg)
    # loss_chunk_vocab runs through Llama's forward: the fused chunked
    # loss equals the full-logits one (fp32, 1e-5)
    ids = torch.arange(12).view(2, 6) % cfg.vocab_size
    losses = [port_mixtral.MixtralModel(port_mixtral.MixtralConfig(
        **{**cfg.__dict__, "loss_chunk_vocab": chunk}), device="meta")
        .load_weights(list(state.items()), device="cpu")(ids, ids).item()
        for chunk in (0, 64)]
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    stack = state.pop("model.layers.0.block_sparse_moe.w1")
    slices = [(f"model.layers.0.block_sparse_moe.w1.{e}", stack[e])
              for e in range(3)]             # expert 3 never arrives
    with pytest.raises(KeyError, match="lacks 1 weight"):
        port_mixtral.MixtralModel(cfg, device="meta").load_weights(
            list(state.items()) + slices, device="cpu")
