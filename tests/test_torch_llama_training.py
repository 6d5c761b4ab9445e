"""The port's training path against the JAX package's, on the CPU at
``llama_tiny`` size, from the same numpy weights (a flax tree, handed to
the port through ``params_from_flax``) and the same numpy batches.

* model loss and gradients against flax ``value_and_grad``, fp32,
  tolerance 1e-5 (absolute and relative: the same fp32 arithmetic summed in
  another order);
* a 6-step engine trajectory (every micro-step's loss, then the fp32
  master) against ``deepspeed_tpu.initialize`` on a one-device mesh.  The
  losses: fp32 1e-5 relative, bf16 1e-2 (both sides round activations and
  gradients to bf16 at other places).  The master: Adam divides each
  gradient by its own running magnitude, so an element whose gradient is
  at the level of fp32 summation noise moves by a noise-dependent fraction
  of lr; fp32 allows rtol 2e-5 plus lr/20 absolute (a wrong update is off
  by a large part of lr on most elements); bf16, per leaf, at most 1 % of
  elements over lr/2 apart and the move from the start within a fifth of
  JAX's (``_bf16_master_apart``; a planted bf16-master fault and a master
  that never moves both fail it);
* the five LR schedules, ``param_groups`` lr writes, the batch-trinity
  errors and the refused config keys.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime import lr_schedules as port_sched
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PortConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError

SEQ = 16


def _flax_tree(cfg, seed):
    """A numpy param tree in the flax layout of ``jax_llama.LlamaModel``."""
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
            "norm": {"weight": norm()}}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = {"kernel": w(D, V, fan_in=D)}
    for i in range(cfg.num_hidden_layers):
        attn = {"q_proj": {"kernel": w(D, H, Dh, fan_in=D)},
                "k_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                "v_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                "o_proj": {"kernel": w(H * Dh, D, fan_in=H * Dh)}}
        if cfg.attention_bias:
            for p, h in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
                attn[p]["bias"] = 0.1 * w(h, Dh, fan_in=1)
        tree[f"layers_{i}"] = {
            "self_attn": attn,
            "mlp": {"gate_proj": {"kernel": w(D, I, fan_in=D)},
                    "up_proj": {"kernel": w(D, I, fan_in=D)},
                    "down_proj": {"kernel": w(I, D, fan_in=I)}},
            "input_layernorm": {"weight": norm()},
            "post_attention_layernorm": {"weight": norm()}}
    return tree


def _configs(**over):
    over = dict(dict(num_key_value_heads=4), **over)
    return (jax_llama.llama_tiny(**over),
            port_llama.llama_tiny(**over))


def _batches(n, B, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, SEQ)).astype(np.int32)
            for _ in range(n)]


MODEL_CASES = {
    "plain": dict(),
    "mask": dict(),
    "remat": dict(remat=True),
    "tied": dict(tie_word_embeddings=True),
    "gqa": dict(num_key_value_heads=2),
    "window": dict(sliding_window=6),
    "qkv_bias": dict(attention_bias=True),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_loss_and_grads_match_flax(case):
    over = dict(dtype="float32", remat=False)
    over.update(MODEL_CASES[case])
    jcfg, pcfg = _configs(**over)
    tree = _flax_tree(jcfg, seed=len(case))
    ids = _batches(1, 2, seed=3)[0]
    mask = None
    if case == "mask":
        mask = (np.random.default_rng(4).random(ids.shape) > 0.3).astype(
            np.int32)

    jmodel = jax_llama.LlamaModel(jcfg)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(ids),
                               jnp.asarray(ids),
                               None if mask is None else jnp.asarray(mask))
    )(jtree)

    model = port_llama.LlamaModel(pcfg, device="meta")
    state = port_llama.params_from_flax(tree, pcfg, dtype="float32")
    model.load_weights(state.items(), device="cpu")
    model.tie_weights()
    model.requires_grad_(True)
    t = torch.from_numpy
    loss = model(t(ids), t(ids), None if mask is None else t(mask))
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want = port_llama.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jgrads), pcfg, dtype="float32")
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, g in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_model_logits_without_labels():
    jcfg, pcfg = _configs(dtype="float32", remat=False)
    tree = _flax_tree(jcfg, seed=1)
    ids = _batches(1, 1, seed=2)[0]
    want = jax_llama.LlamaModel(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
        jnp.asarray(ids))
    model = port_llama.LlamaModel(pcfg, device="meta").load_weights(
        port_llama.params_from_flax(tree, pcfg, dtype="float32").items(),
        device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (1, SEQ, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fp32_head_turns_tf32_off_for_itself_only():
    from torch.overrides import TorchFunctionMode
    _, pcfg = _configs(dtype="float32", remat=False)
    model = port_llama.LlamaModel(pcfg).init_weights(
        torch.Generator().manual_seed(0))
    seen = []

    class Probe(TorchFunctionMode):

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") == "linear" and \
                    args[1].shape[0] == pcfg.vocab_size:
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            return func(*args, **(kwargs or {}))

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with Probe(), torch.no_grad():
            model(torch.zeros(1, 4, dtype=torch.long))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [False]


@pytest.fixture
def one_device_mesh():
    """The JAX engine on one CPU device, so both sides see one data-parallel
    rank and the same batch."""
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


_OPT = {"type": "fusedadam", "params": {"lr": 2e-3}}
ENGINE_CASES = {
    "fusedadam_warmup_clip": dict(config={
        "train_micro_batch_size_per_gpu": 2, "optimizer": _OPT,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 4}},
        "gradient_clipping": 1.0}),
    "gas2": dict(config={
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adam", "params": {"lr": 2e-3}}}),
    "adamw_weight_decay": dict(config={
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 2e-3, "weight_decay": 0.1}}}),
    "param_groups_lr_write": dict(config={
        "train_micro_batch_size_per_gpu": 2, "optimizer": _OPT},
        lr_write=(3, 5e-4)),
    "bf16": dict(config={
        "train_micro_batch_size_per_gpu": 2, "optimizer": _OPT,
        "bf16": {"enabled": True}}, dtype="bfloat16"),
}


def _bf16_master_apart(got, want, start, lr):
    """Whether a bf16 run's fp32 master leaf is apart from JAX's: more than
    1 % of its elements differ by over lr/2, or the move from the start
    differs by over a fifth of JAX's move (``||Δport − Δjax|| / ||Δjax||``).
    A correct port stays under 0.7 % and 0.1 on every leaf of this case; a
    master that never moves is at 1.0, one kept in bf16 (updates under
    half a bf16 ulp are lost) over 3 % on every leaf."""
    share = ((got - want).abs() > lr / 2).float().mean().item()
    move = want - start
    rel = ((got - start - move).norm() / move.norm()).item()
    return share > 1e-2 or rel > 0.2


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_trajectory_matches_jax(case, one_device_mesh):
    spec = ENGINE_CASES[case]
    steps = 6
    bf16 = spec.get("dtype") == "bfloat16"
    jcfg, pcfg = _configs(dtype=spec.get("dtype", "float32"), remat=False)
    tree = _flax_tree(jcfg, seed=7)
    jeng, jopt, _, _ = deepspeed_tpu.initialize(
        model=jax_llama.LlamaModel(jcfg),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config=dict(spec["config"]))
    start = port_llama.params_from_flax(tree, pcfg, dtype="float32")
    # bf16 also runs a planted fault: a port whose master is overwritten
    # by the bf16 params after each step, which the master check must catch
    engines = [deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        model_parameters=start, config=dict(spec["config"]),
        device="cpu") for _ in range(2 if bf16 else 1)]
    peng, popt = engines[0][:2]
    gas = peng.gradient_accumulation_steps()
    assert gas == jeng.gradient_accumulation_steps()
    batches = _batches(steps * gas, 2, seed=11)
    jl, pl = [], []
    for i, ids in enumerate(batches):
        if "lr_write" in spec and i == spec["lr_write"][0] * gas:
            jopt.param_groups[0]["lr"] = spec["lr_write"][1]
            popt.param_groups[0].update(lr=spec["lr_write"][1])
        for eng, out in ((jeng, jl), (peng, pl)):
            loss = eng(ids, ids)
            eng.backward(loss)
            eng.step()
            out.append(float(loss))
        if bf16:
            fault = engines[1][0]
            fault.backward(fault(ids, ids))
            fault.step()
            fault.master.copy_(fault.params.float())
    assert peng.global_steps == jeng.global_steps == steps
    if "lr_write" in spec:
        assert peng.get_lr() == jeng.get_lr() == [spec["lr_write"][1]]
    np.testing.assert_allclose(pl, jl, rtol=1e-2 if bf16 else 1e-5)
    assert pl[-1] < pl[0]
    want = port_llama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jeng.get_fp32_param()), pcfg,
        dtype="float32")
    assert set(want) == set(peng.parameter_names())
    lr = spec["config"]["optimizer"]["params"]["lr"]
    if "scheduler" in spec["config"]:
        lr = max(lr, spec["config"]["scheduler"]["params"]["warmup_max_lr"])
    for name, w in want.items():
        got = peng.get_fp32_param(name)
        if bf16:
            assert not _bf16_master_apart(got, w, start[name], lr), name
            assert _bf16_master_apart(start[name], w, start[name], lr), name
            assert _bf16_master_apart(engines[1][0].get_fp32_param(name), w,
                                      start[name], lr), name
        else:
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-5,
                                       atol=lr / 20, err_msg=name)


SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                     warmup_num_steps=7),
    "WarmupLR_linear": dict(warmup_min_lr=0.0, warmup_max_lr=1e-3,
                            warmup_num_steps=5, warmup_type="linear"),
    "WarmupDecayLR": dict(warmup_max_lr=2e-3, warmup_num_steps=4,
                          total_num_steps=15),
    "WarmupCosineLR": dict(warmup_num_steps=4, total_num_steps=16,
                           warmup_max_lr=1e-3, cos_min_ratio=0.1),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                     cycle_first_step_size=4, decay_lr_rate=0.5,
                     decay_step_size=2),
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4,
                        lr_range_test_step_size=3,
                        lr_range_test_staircase=True),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedules_match_jax(case):
    name = case.split("_")[0]
    params = SCHEDULES[case]
    jax_s = jax_sched.get_lr_scheduler(name, params)
    port_s = port_sched.get_lr_scheduler(name, params)
    for step in range(20):
        want = float(jax_s.get_lr(jnp.asarray(step)))
        np.testing.assert_allclose(port_s.get_lr(step), want, rtol=1e-6,
                                   err_msg=f"{case} step {step}")
    port_s.step()
    port_s.step()
    assert port_s.get_last_lr() == [port_s.get_lr(1)]


def test_param_groups_lr_write_routes_and_scheduler_reclaims():
    _, pcfg = _configs(dtype="float32", remat=False)
    eng, opt, _, sched = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config={"train_micro_batch_size_per_gpu": 1,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "scheduler": {"type": "WarmupLR",
                              "params": {"warmup_num_steps": 2}}},
        device="cpu")
    eng.initialize_parameters(0)
    assert math.isnan(eng.opt_state.lr_override)
    opt.param_groups[0].setdefault("lr", 7e-4)   # already present: no write
    assert math.isnan(eng.opt_state.lr_override)
    opt.param_groups[0]["lr"] = 7e-4
    assert eng.opt_state.lr_override == 7e-4 and eng.get_lr() == [7e-4]
    assert eng._transform.current_lr(1, eng.opt_state) == float(
        np.float32(7e-4))
    ids = _batches(1, 1, seed=0)[0]
    eng.backward(eng(ids, ids))
    eng.step()
    # the managed scheduler stepped: the one-off write is over
    assert math.isnan(eng.opt_state.lr_override)
    assert eng.get_lr() == [sched.get_lr(1)]


TRINITY = [
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
         gradient_accumulation_steps=4),
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=8, gradient_accumulation_steps=2),
    dict(train_batch_size=8),
    dict(train_micro_batch_size_per_gpu=3, gradient_accumulation_steps=2),
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
         gradient_accumulation_steps=3),
    dict(train_batch_size=7, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=7, gradient_accumulation_steps=2),
    dict(gradient_accumulation_steps=2),
]


@pytest.mark.parametrize("i", range(len(TRINITY)))
def test_batch_trinity_matches_jax(i):
    raw = TRINITY[i]
    try:
        want = JaxConfig(dict(raw)).resolve_batch_sizes(1)
    except JaxConfigError as e:
        with pytest.raises(DeepSpeedConfigError) as got:
            PortConfig(dict(raw)).resolve_batch_sizes(1)
        assert str(got.value) == str(e)
    else:
        assert PortConfig(dict(raw)).resolve_batch_sizes(1) == want


REFUSED = [
    ({"optimizer": {"type": "muon"}}, 11),
    ({"optimizer": {"type": "adagrad"}}, 11),
    ({"resilience": {"watchdog": {"enabled": True}}}, 12),
    ({"telemetry": {"enabled": True}}, 12),
    ({"progressive_layer_drop": {"enabled": True}}, 12),
    ({"curriculum_learning": {"enabled": True}}, 12),
    ({"hybrid_engine": {"enabled": True}}, 12),
    ({"eigenvalue": {"enabled": True}}, 11),
    ({"flops_profiler": {"enabled": True}}, 12),
    ({"tensorboard": {"enabled": True}}, 12),
    ({"autotuning": {"enabled": True}}, 12),
    ({"elasticity": {"enabled": True}}, 12),
]


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_unported_keys_raise_not_ported(i):
    extra, item = REFUSED[i]
    config = {"train_micro_batch_size_per_gpu": 1, **extra}
    with pytest.raises(NotImplementedError,
                       match=rf"queue A, item {item}\)"):
        PortConfig(config)


# the configs the list above refused until queue A item 8b came
ITEM_8B_BUILDS = [
    {"mesh": {"tp": 2, "ep": 2}},
    {"mesh": {"ep": 2, "sp": 2}},
    {"moe": {"enabled": True, "quantized_dispatch": True,
             "intra_node_size": 2}},
    {"mesh": {"ep": 2, "pp": 2}},
    {"moe": {"gating_seed": 7}},
]


@pytest.mark.parametrize("i", range(len(ITEM_8B_BUILDS)))
def test_item_8b_keys_parse(i):
    """tp or pp or sp with ep, the 2-hop dispatch and the gating seed parse
    as the JAX package's config parses them."""
    raw = {"train_micro_batch_size_per_gpu": 1, **ITEM_8B_BUILDS[i]}
    got, want = PortConfig(dict(raw)), JaxConfig(dict(raw))
    mesh = want.mesh_config
    assert (got.mesh_tp, got.mesh_ep, got.mesh_sp, got.mesh_pp) == \
        (mesh.tp, mesh.ep, mesh.sp, mesh.pp)
    for key in ("intra_node_size", "gating_seed", "quantized_dispatch"):
        assert getattr(got.moe_config, key) == getattr(want.moe_config, key)


# the ZeRO++ configs the list above refused until queue A item 7a came
ZEROPP_BUILDS = [
    {"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                           "zero_quantized_gradients": True}},
    {"comm_optimizations": {"enabled": True, "quantized_gradients": True,
                            "quantized_weights": True}},
]


@pytest.mark.parametrize("i", range(len(ZEROPP_BUILDS)))
def test_zeropp_configs_build_and_step(i):
    """At one rank every quantized collective declines (a group of one),
    so the run is the plain one bit for bit."""
    _, pcfg = _configs(dtype="float32", remat=False)
    ids = torch.from_numpy(_batches(1, 1, seed=5)[0])
    losses = []
    for extra in (ZEROPP_BUILDS[i], {"zero_optimization": dict(
            ZEROPP_BUILDS[i].get("zero_optimization", {}),
            zero_quantized_gradients=False, zero_quantized_weights=False)}):
        eng = deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(pcfg, device="meta"),
            config={"train_micro_batch_size_per_gpu": 1, **extra},
            device="cpu")[0]
        eng.initialize_parameters(0)
        for _ in range(2):
            loss = eng(ids, ids)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
    assert losses[:2] == losses[2:]


# the 1-bit optimizers the list above refused until queue A item 7b came
ONEBIT_BUILDS = [
    {"type": "onebitlamb", "params": {"lr": 1e-3, "freeze_step": 1}},
    {"type": "zerooneadam", "params": {"lr": 1e-4, "var_freeze_step": 2,
                                       "var_update_scaler": 1}},
    {"type": "onebitadam", "params": {"lr": 1e-4, "freeze_step": 1}},
]


@pytest.mark.parametrize("i", range(len(ONEBIT_BUILDS)))
def test_onebit_configs_build_and_step(i):
    """At one rank the 1-bit all-reduce passes its input through; the
    optimizers step past their warmup and the loss falls."""
    _, pcfg = _configs(dtype="float32", remat=False)
    ids = torch.from_numpy(_batches(1, 1, seed=5)[0])
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config={"train_micro_batch_size_per_gpu": 1,
                "optimizer": ONEBIT_BUILDS[i]}, device="cpu")[0]
    eng.initialize_parameters(0)
    losses = []
    for _ in range(3):
        loss = eng(ids, ids)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    assert eng.opt_state.count == 3 and losses[-1] < losses[0], losses


def test_mics_at_one_rank_is_refused():
    _, pcfg = _configs(dtype="float32", remat=False)
    with pytest.raises(ValueError, match="must divide dp=1"):
        deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(pcfg, device="meta"),
            config={"train_micro_batch_size_per_gpu": 1,
                    "zero_optimization": {"stage": 3,
                                          "mics_shard_size": 2}},
            device="cpu")


# the offload configs the list above refused until queue A item 10 came
OFFLOAD_BUILDS = [
    ({"stage": 0, "offload_optimizer": {"device": "cpu"}}, "DeepSpeedEngine"),
    ({"stage": 1, "offload_param": {"device": "cpu"}}, "InfinityEngine"),
    ({"stage": 3, "offload_param": {"device": "cpu"}}, "InfinityEngine"),
]


@pytest.mark.parametrize("i", range(len(OFFLOAD_BUILDS)))
def test_offload_configs_build_and_step(i):
    zero, engine_class = OFFLOAD_BUILDS[i]
    _, pcfg = _configs(dtype="float32", remat=False)
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config={"train_micro_batch_size_per_gpu": 1,
                "zero_optimization": zero}, device="cpu")[0]
    assert type(eng).__name__ == engine_class
    eng.initialize_parameters(0)
    ids = torch.from_numpy(_batches(1, 1, seed=5)[0])
    loss = eng(ids, ids)
    eng.backward(loss)
    eng.step()
    assert eng.global_steps == 1 and np.isfinite(float(loss))


def test_inert_keys_parse():
    """Keys that configure a feature without turning it on parse, with the
    JAX package's defaults spelled out."""
    cfg = PortConfig({"train_batch_size": 2, "bf16": {"enabled": True},
                      "zero_optimization": {"stage": 0, "mics_shard_size": -1,
                                            "zero_hpz_partition_size": 1,
                                            "overlap_comm": False},
                      "fp16": {"enabled": False}, "moe": {"enabled": False},
                      "mesh": {"dp": -1, "tp": 1}, "steps_per_print": 5,
                      "checkpoint": {"tag_validation": "Warn"}})
    assert cfg.bfloat16_enabled and cfg.steps_per_print == 5
    assert cfg.resolve_batch_sizes(1) == (2, 2, 1)


def test_unported_model_and_engine_options_raise():
    """``loss_chunk_vocab`` and every remat policy of the table run
    (tests/test_torch_fused_ce.py, tests/test_torch_activation_
    checkpointing.py); a remat policy name outside the table (one of
    ``jax.checkpoint_policies``' factories too) raises; the engine's
    ``train_batch`` and dataloader stay refused."""
    ids = torch.zeros(1, SEQ, dtype=torch.long)
    for name in ("no_such_policy", "save_only_these_names"):
        _, pcfg = _configs(dtype="float32", remat=True, remat_policy=name)
        with pytest.raises(ValueError, match="remat policy"):
            port_llama.LlamaModel(pcfg, device="cpu")(ids, ids)
    _, pcfg = _configs(dtype="float32")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="cpu"),
        config={"train_batch_size": 1}, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.train_batch()
    with pytest.raises(NotImplementedError, match="item 4"):
        deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(pcfg, device="cpu"),
            config={"train_batch_size": 1}, training_data=[1],
            device="cpu")


# mesh_param=(dp, sp) and mpu=, refused here until the pipeline slice
# ported them, are held in test_torch_ulysses.py and test_torch_pipe.py
UNPORTED_ARGS = [
    (dict(collate_fn=list), 4),
    (dict(training_data=[1]), 4),
    (dict(optimizer=object()), 11),
    (dict(collate_fn=list, training_data=[1]), 4),
]


@pytest.mark.parametrize("i", range(len(UNPORTED_ARGS)))
def test_initialize_refuses_unported_arguments(i):
    kwargs, item = UNPORTED_ARGS[i]
    _, pcfg = _configs(dtype="float32")
    with pytest.raises(NotImplementedError,
                       match=rf"queue A, item {item}\)"):
        deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(pcfg, device="meta"),
            config={"train_batch_size": 1}, device="cpu", **kwargs)


def test_grad_norm_clip_and_overflow_match_jax():
    from deepspeed_tpu.runtime import loss_scaler as jax_scaler
    from deepspeed_tpu.runtime import utils as jax_utils
    from deepspeed_tpu_torch.runtime import loss_scaler as port_scaler
    from deepspeed_tpu_torch.runtime import utils as port_utils
    rng = np.random.default_rng(9)
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             ((7, 3), (11, ), (2, 2, 5))]
    jg = [jnp.asarray(g) for g in grads]
    pg = [torch.from_numpy(g.copy()) for g in grads]
    want = float(jax_utils.global_grad_norm(jg))
    assert abs(float(port_utils.global_grad_norm(pg)) - want) <= 1e-6 * want
    jclipped, _ = jax_utils.clip_grads_by_global_norm(jg, 1.0)
    coef = port_utils.clip_coefficient(port_utils.global_grad_norm(pg), 1.0)
    pg = [g * coef for g in pg]
    for a, b in zip(pg, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert float(port_utils.global_grad_norm(pg)) == pytest.approx(1.0,
                                                                  rel=1e-5)
    assert port_utils.count_parameters(pg) == jax_utils.count_parameters(jg)
    pg[1][3] = float("inf")
    jg[1] = jg[1].at[3].set(jnp.inf)
    assert bool(port_scaler.has_overflow(pg)) == bool(
        jax_scaler.has_overflow(jg)) is True
    assert not bool(port_scaler.has_overflow(pg[:1]))
    assert port_scaler.create_loss_scaler(False).init().scale == 1.0


def test_train_batch_and_eval_match_the_step_api():
    """``train_batch`` over one accumulation window equals forward /
    backward / step by hand; eval mode returns the loss without a graph."""
    _, pcfg = _configs(dtype="float32", remat=False)
    tree = _flax_tree(pcfg, seed=5)
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    batches = _batches(2, 2, seed=6)
    engines = [deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        model_parameters=port_llama.params_from_flax(tree, pcfg,
                                                     dtype="float32"),
        config=dict(config), device="cpu")[0] for _ in range(2)]
    mean = engines[0].train_batch(iter((ids, ids) for ids in batches))
    losses = []
    for ids in batches:
        loss = engines[1](ids, ids)
        engines[1].backward(loss)
        engines[1].step()
        losses.append(loss.item())
    assert mean.item() == pytest.approx(np.mean(losses), rel=1e-6)
    assert engines[0].global_steps == engines[1].global_steps == 1
    assert torch.equal(engines[0].master if engines[0].master is not None
                       else engines[0].params, engines[1].params)
    engines[0].eval()
    loss = engines[0](batches[0], batches[0])
    assert not loss.requires_grad and engines[0].micro_steps == 2
