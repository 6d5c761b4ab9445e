"""The port's ``moe/`` package against the JAX package's, on the CPU, from
the same numpy inputs and weights.

* gating on the same logits: top-1 with ``used_token``, top-2, top-k with
  k = 3, no-drop, and the capacity clamp at T; the dispatch masks and the
  counts exactly, the combine weights and the aux loss within 1e-6 (fp32
  softmax and sums in another order);
* the ``MoE`` layer (noise off), with and without PR-MoE's residual:
  output and counts (1e-5), the aux loss (1e-6), and the gradients of the
  parameters and the input, fp32 rtol 1e-4 plus 1e-5 (each a sum over
  tokens and slots taken in another order);
* the parameter-group utilities on the port's names, and per-expert files
  written by either package loading in the other;
* one gloo spawn (``torch_dist_worker.py``) against the JAX engine on the
  same mesh of the 8-device CPU mesh, the JAX tests' model (in_proj, MoE
  with 4 experts top-1, out_proj; SGD; ZeRO 2, and at world 4 ZeRO 0, 1
  and 3 too) on the same global batches: ep 2 at world 2 and dp 2 × ep 2
  at world 4, losses rtol 1e-5 and the final master 1e-5 (the gating is
  global, the exchange sums each slot's one contributor); each rank holds
  and runs only its own experts; the expert leaves' ZeRO state sharded
  over the expert-data group only (JAX's ``leaf_zero_axes``); an int8
  ``quantized_dispatch`` leg within 1e-2 of the flat run (JAX's gate,
  ``tests/unit/moe/test_moe_engine.py``), bit-equal to it at ep 1; tags
  saved at ep 2 (world 2 at ZeRO 2, world 4 at ZeRO 0) loaded at ep 1 and
  ep 2 train on as the saving run does, and the universal conversion of
  one holds the global stacks;
* item 8b's legs (world 2 and 4 in the same spawns): the qgZ micro's
  per-rank gating at ZeRO 2 and 3 (the first loss JAX's qgZ run's, rtol
  1e-5, the last within JAX's 2e-2 of the flat run's); the 2-hop int8
  dispatch at ep 4 with ``intra_node_size`` 2 (taken, and every loss and
  the master within ``tools/moe_smoke.py:run_hier_smoke``'s 1e-2 of
  JAX's 2-hop run on the same mesh); ep 2 ×
  sp 2 and the MoE layer in a 2-stage ``PipeStage`` at ep 2 (each the
  run of the same global batch without the axis, rtol 1e-5); hpZ and
  MiCS at dp 2 × ep 2 against JAX's dp 2 × ep 2 run; LAMB at ep 2
  against JAX's, pinned optimizer offload bit-equal to none, OnebitAdam
  at ep 2 and dp 2 against JAX's 1-bit run over the same two workers
  (``test_torch_onebit.py``'s rtol 1e-5 in its warmup, 5e-3 once
  compressed, over 8 steps); ``moe.gating_seed``'s three behaviours
  (``test_rsample_rng_threaded_and_deterministic``'s).
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.moe import checkpoint as jax_ckpt
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jax_gate
from deepspeed_tpu.moe import utils as jax_utils
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.moe import checkpoint as port_ckpt
from deepspeed_tpu_torch.moe import engine as port_engine
from deepspeed_tpu_torch.moe import layer as port_layer
from deepspeed_tpu_torch.moe import sharded_moe as port_gate
from deepspeed_tpu_torch.moe import utils as port_utils
from torch_dist_worker import moe_twin, spawn

HIDDEN, EXPERTS = 32, 4


class JaxMoEModel(nn.Module):
    """``tests/unit/moe/test_moe_engine.py``'s model: in_proj, a residual
    MoE (4 experts, top-1, capacity factor 2), out_proj; MSE plus 0.01 ×
    the aux loss.  Its port twin is ``torch_dist_worker.moe_twin``."""

    @nn.compact
    def __call__(self, x, y):
        h = nn.Dense(HIDDEN, name="in_proj")(x)
        moe_out, l_aux, _ = jax_layer.MoE(hidden_size=HIDDEN,
                                          num_experts=EXPERTS, k=1,
                                          capacity_factor=2.0,
                                          name="moe")(h)
        h = h + moe_out
        out = nn.Dense(HIDDEN, name="out_proj")(h)
        return jnp.mean((out - y) ** 2) + 0.01 * l_aux


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _logits(T, E, seed=0):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)


def _compare_gate(got, want):
    l_aux, combine, dispatch, counts = got
    jl, jc, jd, jn = want
    np.testing.assert_array_equal(_np(dispatch) > 0, np.asarray(jd))
    np.testing.assert_array_equal(_np(counts), _np(jn))
    np.testing.assert_allclose(_np(combine), _np(jc), atol=1e-6)
    np.testing.assert_allclose(float(l_aux), float(jl), rtol=1e-6)


GATES = {
    "top1_used_token": dict(k=1, T=24, used=True),
    "top1": dict(k=1, T=24),
    "top2": dict(k=2, T=24),
    "topk3": dict(k=3, T=24),
    "no_drop_k2": dict(k=2, T=24, drop=False),
    "capacity_clamp": dict(k=1, T=3, min_capacity=8),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_gating_matches_jax(case):
    spec = GATES[case]
    T, k, E = spec["T"], spec["k"], 6
    logits = _logits(T, E, seed=len(case))
    mc = spec.get("min_capacity", 4)
    if spec.get("used"):
        used = (np.arange(T) % 3 != 0).astype(np.float32)
        want = jax_gate.top1gating(jnp.asarray(logits), 1.0, mc,
                                   used_token=jnp.asarray(used))
        got = port_gate.top1gating(torch.from_numpy(logits), 1.0, mc,
                                   used_token=torch.from_numpy(used))
    else:
        jg = jax_gate.TopKGate(k=k, capacity_factor=1.0, min_capacity=mc,
                               drop_tokens=spec.get("drop", True))
        pg = port_gate.TopKGate(k=k, capacity_factor=1.0, min_capacity=mc,
                                drop_tokens=spec.get("drop", True))
        want = jg(jnp.asarray(logits))
        got = pg(torch.from_numpy(logits))
    _compare_gate(got, want)
    if case == "capacity_clamp":
        assert got[1].shape[-1] == T     # min_capacity 8 clamped at T = 3
    if case == "no_drop_k2":
        assert got[1].shape[-1] == T and int(_np(got[3]).sum()) == 2 * T


def _layer_pair(use_residual, k, seed=0):
    jmod = jax_layer.MoE(hidden_size=HIDDEN, num_experts=EXPERTS, k=k,
                         capacity_factor=1.5, use_residual=use_residual)
    x = np.random.default_rng(seed).standard_normal((2, 12, HIDDEN)).astype(
        np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        shapes)
    pmod = port_layer.MoE(HIDDEN, num_experts=EXPERTS, k=k,
                          capacity_factor=1.5, use_residual=use_residual)
    named = {".".join(str(p.key) for p in kp): torch.from_numpy(v.copy())
             for kp, v in jax.tree_util.tree_leaves_with_path(params)}
    missing = pmod.load_state_dict(named, strict=True)
    assert not missing.missing_keys
    return jmod, params, pmod, x


@pytest.mark.parametrize("use_residual", [False, True],
                         ids=["moe", "residual"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_forward_and_grads_match_jax(use_residual, k):
    jmod, params, pmod, x = _layer_pair(use_residual, k)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, l_aux, _ = jmod.apply({"params": p}, xx)
        return jnp.sum(out * r) + l_aux

    (jout, jl, jn) = jmod.apply({"params": params}, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, l_aux, counts = pmod(xt)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l_aux.item(), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(_np(counts), _np(jn))
    ((out * torch.from_numpy(r)).sum() + l_aux).backward()
    np.testing.assert_allclose(_np(xt.grad), _np(jgx), rtol=1e-4, atol=1e-5)
    for kp, g in jax.tree_util.tree_leaves_with_path(jgp):
        name = ".".join(str(p.key) for p in kp)
        got = dict(pmod.named_parameters())[name].grad
        np.testing.assert_allclose(_np(got), _np(g), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_noise_comes_only_from_the_callers_generator():
    """Jitter and RSample draw from the generator the caller passes, in
    training only; without one (or in eval) the layer is deterministic."""
    for policy in ("Jitter", "RSample"):
        m = port_layer.MoE(HIDDEN, num_experts=EXPERTS, k=1,
                           noisy_gate_policy=policy)
        m.reset_parameters(torch.Generator().manual_seed(0))
        x = torch.randn(40, HIDDEN, generator=torch.Generator().manual_seed(1))
        base = m(x)[0]
        assert torch.equal(m(x)[0], base)
        g1 = m(x, generator=torch.Generator().manual_seed(5))[0]
        g2 = m(x, generator=torch.Generator().manual_seed(5))[0]
        assert torch.equal(g1, g2)
        m.eval()
        assert torch.equal(m(x, generator=torch.Generator().manual_seed(5))
                           [0], m(x)[0])
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        port_layer.MoE(HIDDEN, noisy_gate_policy="Gaussian")


# ------------------------------------------------ utils and expert files
def _twin_tree(seed=0):
    """The JAX tests' MoEModel tree (``test_moe_engine.py``) as numpy."""
    model = JaxMoEModel()
    x = np.zeros((8, HIDDEN), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def leaf(s):
        # kernels [.., in, out] at 1/sqrt(fan in), biases small
        scale = 1.0 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes["params"])


def test_param_utilities_match_jax_on_the_ports_names():
    tree = _twin_tree()
    model, named = moe_twin(tree)
    jflat = {"/".join(str(p.key) for p in kp): v
             for kp, v in jax.tree_util.tree_leaves_with_path(tree)}
    for name in named:
        assert port_utils.is_moe_param(name) == \
            jax_utils.is_moe_param(name.replace(".", "/")), name
    assert port_utils.has_moe_layers(model) == \
        jax_utils.has_moe_layers(tree) == (True, 4)
    mask = port_utils.moe_param_mask(model)
    assert sorted(n for n, e in mask.items() if e) == sorted(
        n.replace("/", ".") for n in jflat if jax_utils.is_moe_param(n))
    groups_ = port_utils.split_params_into_different_moe_groups_for_optimizer(
        {"params": named, "lr": 0.1, "weight_decay": 0.0})
    assert [g["name"] for g in groups_] == ["shared", "expert"]
    assert all(g["lr"] == 0.1 for g in groups_)
    assert port_utils.is_moe_param_group(groups_[1])
    labels = groups_[0]["param_labels"]
    assert labels["moe.deepspeed_moe.experts.fc1.kernel"] == "expert"
    assert labels["moe.gate.kernel"] == "shared"
    cfg = port_utils.configure_moe_param_groups(named, expert_lr=0.5,
                                                expert_weight_decay=0.0)
    assert cfg[1]["lr"] == 0.5 and cfg[1]["weight_decay"] == 0.0
    assert port_utils.is_moe_param("model.layers.3.block_sparse_moe.w2")
    assert not port_utils.is_moe_param("model.layers.3.block_sparse_moe.gate")


def test_expert_files_cross_both_ways(tmp_path):
    tree = _twin_tree(seed=3)
    _, named = moe_twin(tree)
    files = port_ckpt.save_moe_expert_files(named, str(tmp_path), "port")
    assert sorted(os.path.basename(f) for f in files) == [
        f"layer_0_expert_{e}_model_states.npz" for e in range(EXPERTS)]
    zeros = jax.tree_util.tree_map(lambda v: jnp.zeros(v.shape), tree)
    back = dict(jax.tree_util.tree_leaves_with_path(
        jax_ckpt.load_moe_expert_files(zeros, str(tmp_path), "port")))
    for kp, v in jax.tree_util.tree_leaves_with_path(tree):
        got = np.asarray(back[kp])
        if jax_ckpt.is_expert_path("/".join(str(p.key) for p in kp)):
            np.testing.assert_array_equal(got, v)
        else:
            assert not got.any()
    jax_ckpt.save_moe_expert_files(tree, str(tmp_path), "jax")
    blank = {n: torch.zeros_like(t) for n, t in named.items()}
    loaded = port_ckpt.load_moe_expert_files(blank, str(tmp_path), "jax")
    for n, t in named.items():
        if port_utils.is_moe_param(n):
            assert torch.equal(loaded[n], t), n
        else:
            assert not loaded[n].any()
    assert port_ckpt.flax_path("model.layers.2.block_sparse_moe.w3") == \
        "layers_2/moe/w3"


def test_config_accepts_ep_and_moe_and_refuses_8b():
    """``mesh.ep`` and the ``moe`` block parse as JAX's (``gating_seed``
    and ``intra_node_size`` too, and ep with pp or sp); a mistyped wire
    fails at config load, as in JAX; what is left beside item 8 (the
    telemetry sink of the routing statistics) names item 12."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)
    base = {"train_micro_batch_size_per_gpu": 1}
    moe = {"enabled": True, "quantized_dispatch": True, "wire_dtype": "fp6",
           "intra_node_size": 2, "gating_seed": 7}
    cfg = DeepSpeedConfig(dict(base, mesh={"ep": 2}, moe=dict(moe)))
    jcfg = JaxConfig(dict(base, mesh={"ep": 2}, moe=dict(moe)))
    assert cfg.mesh_ep == 2
    for key in ("enabled", "quantized_dispatch", "wire_dtype",
                "quantization_group_size", "hierarchical_dispatch",
                "intra_node_size", "gating_seed"):
        assert getattr(cfg.moe_config, key) == getattr(jcfg.moe_config, key)
    with pytest.raises(DeepSpeedConfigError, match="moe.wire_dtype"):
        DeepSpeedConfig(dict(base, moe={"enabled": True,
                                        "wire_dtype": "int3"}))
    for mesh in ({"ep": 2, "pp": 2}, {"ep": 2, "sp": 2},
                 {"ep": 2, "tp": 2}):
        got = DeepSpeedConfig(dict(base, mesh=mesh))
        assert (got.mesh_ep, got.mesh_pp * got.mesh_sp * got.mesh_tp) == \
            (2, 2)
    with pytest.raises(NotImplementedError, match="item 12"):
        DeepSpeedConfig(dict(base, moe={"enabled": True},
                             telemetry={"enabled": True}))


def test_dispatch_options_and_wire_bytes():
    opts = port_engine.MoeOptions(enabled=True, quantized_dispatch=True,
                                  wire_dtype="int8")
    port_engine.configure(opts)
    try:
        assert port_engine.dispatch_wire(512) == "int8"
        wire, gs, split, nbytes = port_engine.exchange_plan(4, 8, 256)
        assert (wire, gs, split) == ("int8", 2048, None)
        from deepspeed_tpu.moe import engine as jax_engine
        assert nbytes == jax_engine.expert_dispatch_wire_bytes(
            4 * 8 * 256, "int8", 2048)
        assert port_engine.DISPATCH_WIRES == jax_engine.DISPATCH_WIRES
    finally:
        port_engine.reset()
    with pytest.raises(ValueError, match="moe.wire_dtype"):
        port_engine.configure(port_engine.MoeOptions(enabled=True,
                                                     wire_dtype="int3"))
    assert port_engine.active_options() is None
    # the 2-hop split of an ep group of 4 (JAX ep_hierarchy's pick) and its
    # outer-link bytes
    opts = port_engine.MoeOptions(enabled=True, quantized_dispatch=True,
                                  intra_node_size=2)
    assert port_engine.hier_split(4, opts) == (2, 2)
    assert port_engine.hier_split(2, opts) is None
    # a payload that outer × inner does not divide takes one hop (JAX
    # resolve_exchange's fallback)
    assert port_engine.hier_split(4, opts, 4 * 8 * 256) == (2, 2)
    assert port_engine.hier_split(4, opts, 6) is None
    assert port_engine.hier_split(4, port_engine.MoeOptions(
        enabled=True, quantized_dispatch=True, intra_node_size=2,
        hierarchical_dispatch=False)) is None
    _, _, split, nbytes = port_engine.exchange_plan(4, 8, 256, opts, ep=4)
    assert split == (2, 2)
    assert nbytes == jax_engine.expert_dispatch_wire_bytes(
        4 * 8 * 256, "int8", 2048, 2)
    l_aux, combine, dispatch, counts = port_gate.top1gating(
        torch.from_numpy(_logits(24, 4)), 1.0)
    stats = port_engine.record_routing(1, combine, dispatch, counts, l_aux)
    assert 0.0 <= float(stats["drop_fraction"]) <= 1.0
    assert float(stats["load_imbalance"]) >= 1.0


def test_per_rank_and_two_hop_paths_decline_at_one_rank():
    """Asked for on one rank (qgZ with the ``moe`` block, the 2-hop int8
    dispatch), the qgZ micro's per-rank gating and the 2-hop split each
    decline, counted once, and the step is the flat one's."""
    from deepspeed_tpu_torch import initialize
    tree = _twin_tree(seed=4)
    x = np.random.default_rng(2).standard_normal((16, HIDDEN)).astype(
        np.float32)
    batch = (torch.from_numpy(x), torch.from_numpy(np.tanh(x)))
    losses, declined = [], []
    for extra in ({}, dict(moe={"enabled": True, "quantized_dispatch": True,
                                "intra_node_size": 2},
                           zero_optimization={
                               "stage": 2,
                               "zero_quantized_gradients": True})):
        before = dict(port_engine.declines)
        model, start = moe_twin(tree)
        eng = initialize(model=model, model_parameters=start, config=dict(
            {"train_micro_batch_size_per_gpu": 16,
             "optimizer": {"type": "sgd", "params": {"lr": 0.1}}}, **extra),
            device="cpu")[0]
        losses.append(eng(*batch).item())
        declined.append({k: port_engine.declines[k] - before[k]
                         for k in before})
        assert not port_engine.per_rank_gating()
    port_engine.reset()
    assert declined == [{"per_rank": 0, "two_hop": 0},
                        {"per_rank": 1, "two_hop": 1}]
    assert losses[0] == losses[1]


# ------------------------------------------------- gloo: the ep axis
MB, STEPS = 4, 4


def _config(ep, stage=2, **moe):
    return {"train_micro_batch_size_per_gpu": MB,
            "optimizer": {"type": "sgd", "params": {"lr": 0.1}},
            "zero_optimization": {"stage": stage},
            "mesh": {"dp": -1, "ep": ep},
            "moe": dict({"enabled": True}, **moe)}


_INT8 = dict(quantized_dispatch=True, wire_dtype="int8",
             quantization_group_size=128)


def _batches(world, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.standard_normal((MB * world, HIDDEN)).astype(np.float32)
        out.append((x, np.tanh(x * 0.5).astype(np.float32)))
    return out


def _wide_batch(rows=64):
    """Enough tokens that every expert receives some."""
    x = np.random.default_rng(5).standard_normal((rows, HIDDEN)).astype(
        np.float32)
    return x, np.tanh(x * 0.5).astype(np.float32)


def _jax_run(world, ep, tree, batches, config=None):
    """The JAX engine on ``world`` devices of the 8-device mesh at
    ``ep`` (``config``, default ``_config(ep)``): per-step losses and the
    final master by port name."""
    groups.reset_mesh()
    jax_dist.destroy_process_group()
    groups.initialize_mesh(ep=ep, devices=jax.devices()[:world])
    try:
        eng, *_ = deepspeed_tpu.initialize(
            model=JaxMoEModel(),
            model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
            config=config or _config(ep))
        losses = []
        for x, y in batches:
            loss = eng(x, y)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        master = {".".join(str(p.key) for p in kp): np.asarray(v)
                  for kp, v in jax.tree_util.tree_leaves_with_path(
                      eng.get_fp32_param())}
        return losses, master
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()


def _leaves(res):
    return {n: res["master"][o:o + k].reshape(s)
            for n, o, k, s in res["names"]}


def _train_leg(name, world, ep, tree, batches, **moe):
    return dict(name=name, kind="train", model="moe", cfg={}, tree=tree,
                config=_config(ep, **moe), batches=batches)


QGZ = {"enabled": True, "quantized_gradients": True,
       "hierarchical_allreduce": True, "wire_dtype": "int8",
       "quantization_group_size": 128}
_LAMB = {"type": "fusedlamb", "params": {"lr": 1e-2}}
_ADAM = {"type": "fusedadam", "params": {"lr": 1e-3}}


def _with(config, **kw):
    return dict(config, **kw)


_HIER4 = _config(4, **_INT8, intra_node_size=2)


def _onebit_config(ep):
    return _with(_config(ep, stage=0), optimizer={
        "type": "onebitadam", "params": {"lr": 1e-4, "freeze_step": 4}})


def _onebit_batches():
    """8 steps of world-2 batches (freeze_step 4: 3 compressed)."""
    return _batches(2, seed=3) + _batches(2, seed=4)


def _seq_batches(rows, seq, seed):
    """Batches [rows, seq, HIDDEN] (a sequence dim for sp to cut)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.standard_normal((rows, seq, HIDDEN)).astype(np.float32)
        out.append((x, np.tanh(x * 0.5).astype(np.float32)))
    return out


def _pipe_moe_leg(name, pp, batches):
    """The MoE layer in a ``PipelineModule`` (Block, MoEBlock, Block,
    Block; MSE) at ``pp`` stages × ep 2, weights from one seed."""
    return dict(name=name, kind="pipe", init_seed=5, steps=2,
                batches=batches,
                model=([("Block", (HIDDEN, ), None),
                        ("MoEBlock", (HIDDEN, ), None),
                        ("Block", (HIDDEN, ), None),
                        ("Block", (HIDDEN, ), None)], "mse"),
                config={"train_micro_batch_size_per_gpu": 2,
                        "gradient_accumulation_steps": 2,
                        "optimizer": {"type": "sgd", "params": {"lr": 0.1}},
                        "zero_optimization": {"stage": 1},
                        "mesh": {"pp": pp, "ep": 2},
                        "moe": {"enabled": True}})


def _item_8b_legs(tree, b2, b4):
    """(world-2 legs, world-4 legs) of item 8b's MoE-layer paths."""
    seq = _seq_batches(2, 8, seed=6)
    pipe_b = _batches(1, seed=7)      # 4 micro-batches of 4 rows
    two = [dict(_train_leg(f"qgz_z{z}", 2, 2, tree, b2),
                config=_with(_config(2, stage=z),
                             comm_optimizations=QGZ))
           for z in (2, 3)]
    two.append(dict(_train_leg("ep2_z3", 2, 2, tree, b2),
                    config=_config(2, stage=3)))
    for name, moe, seed in (("gate_a", {}, None), ("gate_b", {}, None),
                            ("gate_seeded", {}, 7), ("gate_off", None,
                                                     None)):
        cfg = _config(2) if moe is not None else dict(
            _config(2), moe={"enabled": False})
        if seed is not None:
            cfg["moe"] = dict(cfg["moe"], gating_seed=seed)
        two.append(dict(_train_leg(name, 2, 2, tree, b2), config=cfg,
                        cfg={"noisy": "RSample"}))
    two += [dict(_train_leg("lamb_ep2", 2, 2, tree, b2),
                 config=_with(_config(2), optimizer=_LAMB)),
            dict(_train_leg("adam_ep2", 2, 2, tree, b2),
                 config=_with(_config(2), optimizer=_ADAM)),
            dict(_train_leg("offload_ep2", 2, 2, tree, b2),
                 config=_with(_config(2), optimizer=_ADAM,
                              zero_optimization={
                                  "stage": 2, "offload_optimizer": {
                                      "device": "cpu"}}))]
    for name, ep in (("onebit_ep2", 2), ("onebit_dp2", 1)):
        two.append(dict(_train_leg(name, 2, ep, tree, _onebit_batches()),
                        config=_onebit_config(ep)))
    one_row = {"train_micro_batch_size_per_gpu": 1}
    two.append(dict(_train_leg("seq_ep2", 2, 2, tree, seq),
                    config=_with(_config(2), **one_row)))
    two.append(_pipe_moe_leg("pipe_pp1", 1, pipe_b))
    four = [_train_leg("ep4_flat", 4, 4, tree, b4),
            dict(_train_leg("ep4_hier", 4, 4, tree, b4), config=_HIER4),
            dict(_train_leg("seq_ep2sp2", 4, 2, tree, seq),
                 config=_with(_config(2), mesh={"ep": 2, "sp": 2},
                              **one_row)),
            dict(_train_leg("seq_ep2sp2_int8", 4, 2, tree, seq),
                 config=_with(_config(2, **_INT8), mesh={"ep": 2, "sp": 2},
                              **one_row)),
            _pipe_moe_leg("pipe_pp2", 2, pipe_b)]
    for name, zp in (("hpz_dp2ep2", {"zero_hpz_partition_size": 2}),
                     ("mics_dp2ep2", {"mics_shard_size": 2})):
        # every leaf sharded (the tiny leaves sit below the persistence
        # threshold); zp 2 splits each data group {ep 0, ep 1}
        four.append(dict(_train_leg(name, 4, 2, tree, b4), config=_with(
            _config(2), zero_optimization=dict(
                stage=3, stage3_param_persistence_threshold=0, **zp))))
    return two, four


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs and both spawns (world 2 and 4), once for the module."""
    tree = _twin_tree(seed=11)
    b2, b4 = _batches(2, seed=1), _batches(4, seed=2)
    ckpt = str(tmp_path_factory.mktemp("moe_ckpt"))
    ckpt4 = str(tmp_path_factory.mktemp("moe_ckpt4"))
    two = [_train_leg("ep2", 2, 2, tree, b2),
           _train_leg("ep2_int8", 2, 2, tree, b2, **_INT8),
           _train_leg("dp2", 2, 1, tree, b2),
           _train_leg("dp2_int8", 2, 1, tree, b2, **_INT8),
           dict(name="local", kind="moe_local", tree=tree,
                config=_config(2, stage=0), batch=_wide_batch()),
           dict(name="ckpt", kind="ckpt", model="moe", cfg={}, tree=tree,
                config=_config(2), batches=b2, k=2, dir=ckpt,
                resume={"ep1": _config(1), "ep2": _config(2)}),
           ]
    four = [_train_leg("dp2ep2", 4, 2, tree, b4),
            _train_leg("dp4", 4, 1, tree, b4)]
    four += [dict(_train_leg(f"dp2ep2_z{z}", 4, 2, tree, b4),
                  config=_config(2, stage=z)) for z in (0, 1, 3)]
    four += [dict(name=f"shards_z{z}", kind="moe_shards", tree=tree,
                  config=_config(2, stage=z), batch=_wide_batch())
             for z in (1, 2, 3)]
    four.append(dict(name="ckpt4", kind="ckpt", model="moe", cfg={},
                     tree=tree, config=_config(2, stage=0), batches=b4,
                     k=2, dir=ckpt4,
                     resume={"ep1_z3": _config(1, stage=3),
                             "ep2_z1": _config(2, stage=1)}))
    more_two, more_four = _item_8b_legs(tree, b2, b4)
    out = spawn(2, two + more_two)
    out.update(spawn(4, four + more_four))
    out["ckpt_dir"] = ckpt
    out["jax_ep2"] = _jax_run(2, 2, tree, b2)
    out["jax_dp2ep2"] = _jax_run(4, 2, tree, b4)
    for z in (2, 3):
        out[f"jax_qgz_z{z}"] = _jax_run(2, 2, tree, b2, _with(
            _config(2, stage=z), comm_optimizations=QGZ))
    out["jax_lamb_ep2"] = _jax_run(2, 2, tree, b2,
                                   _with(_config(2), optimizer=_LAMB))
    # JAX's 1-bit micro counts ep as a data axis (dp_axes): its workers at
    # ep 2 are those of dp 2 on the same two devices
    out["jax_onebit"] = _jax_run(2, 1, tree, _onebit_batches(),
                                 _onebit_config(1))
    out["jax_ep4_hier"] = _jax_run(4, 4, tree, b4, _HIER4)
    return out


@pytest.mark.parametrize("leg,ref", [("ep2", "jax_ep2"),
                                     ("dp2", "jax_ep2"),
                                     ("dp2ep2", "jax_dp2ep2"),
                                     ("dp4", "jax_dp2ep2"),
                                     ("dp2ep2_z0", "jax_dp2ep2"),
                                     ("dp2ep2_z1", "jax_dp2ep2"),
                                     ("dp2ep2_z3", "jax_dp2ep2")])
def test_expert_parallel_matches_the_jax_engine(runs, leg, ref):
    """Every rank reports the global loss; the losses and the final master
    are JAX's on the same mesh (ep 1 on the same world is the same
    algebra: the gating is global either way)."""
    jl, jmaster = runs[ref]
    for r in runs[leg]:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    assert runs[leg][0]["losses"][-1] < runs[leg][0]["losses"][0]
    got = _leaves(runs[leg][0])
    assert set(got) == set(jmaster)
    for n, w in jmaster.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("leg", ["dp2ep2_z0", "dp2ep2_z1", "dp2ep2",
                                 "dp2ep2_z3"])
def test_grad_norm_counts_each_expert_once(runs, leg):
    """The global gradient norm at dp 2 × ep 2 (each rank holding half the
    experts, ZeRO 0-3) is the one at dp 4 × ep 1, step by step."""
    want = runs["dp4"][0]["gnorms"]
    for r in runs[leg]:
        np.testing.assert_allclose(r["gnorms"], want, rtol=1e-5)


def test_each_rank_runs_only_its_experts(runs):
    """At ep 2 rank j holds its own experts [2j, 2j + 2) only: its expert
    leaves' unreduced gradient has E/ep = 2 rows, each nonzero."""
    for r in runs["local"]:
        assert r["ep"] == 2
        for name, g in r["grads"].items():
            assert g.shape[0] == EXPERTS // 2, name
            for e in range(EXPERTS // 2):
                assert np.abs(g[e]).max() > 0, (name, e, r["ep_rank"])


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_expert_shards_stay_in_the_expert_data_group(runs, stage):
    """dp 2 × ep 2: a rank's master holds pieces of its own experts'
    stacks only, its slice of them (the expert-data group has dp/ep = 2
    ranks, and each holds some); the ranks of an ep coordinate tile its
    experts exactly, and the pieces are the whole master's values
    there."""
    res = runs[f"shards_z{stage}"]
    tiles = {}
    for r in res:
        assert (r["ep"], r["expert_world"], r["world"]) == (2, 2, 4)
        j = r["ep_rank"]
        assert r["unit_expert"].count(True) >= 1
        for name, (within, vals) in r["pieces"].items():
            whole = r["master"][name].reshape(-1)
            per = whole.size // EXPERTS
            lo, hi = j * 2 * per, (j + 1) * 2 * per
            assert lo <= within and within + vals.size <= hi, (name, j)
            np.testing.assert_array_equal(
                vals, whole[within:within + vals.size], err_msg=name)
            tiles.setdefault((name, j), []).append(
                (within, within + vals.size, r["expert_rank"]))
            assert r["local_shapes"][name][0] == EXPERTS // 2
    holders = {(j, d) for (_, j), spans in tiles.items()
               for *_, d in spans}
    assert holders == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for (name, j), spans in tiles.items():
        spans.sort()
        per = res[0]["master"][name].size // EXPERTS
        assert spans[0][0] == j * 2 * per and \
            spans[-1][1] == (j + 1) * 2 * per, (name, j)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), name


def test_int8_dispatch_within_its_gate(runs):
    """int8 on the ep exchange: every step's loss within 1e-2 of the flat
    run (JAX's gate); at ep 1 there is no exchange to quantize, and the
    run is the flat one bit for bit."""
    flat = runs["ep2"][0]["losses"]
    q = runs["ep2_int8"][0]["losses"]
    assert np.max(np.abs(np.asarray(q) - np.asarray(flat))) <= 1e-2
    assert q != flat
    assert runs["dp2_int8"][0]["losses"] == runs["dp2"][0]["losses"]
    np.testing.assert_array_equal(runs["dp2_int8"][0]["master"],
                                  runs["dp2"][0]["master"])


@pytest.mark.parametrize("leg,resumed", [("ckpt", ("ep1", "ep2")),
                                          ("ckpt4", ("ep1_z3", "ep2_z1"))])
def test_ep2_tag_resumes_at_ep1(runs, leg, resumed):
    """The tag holds the global stacks: saved at ep 2 (world 2 at ZeRO 2,
    world 4 at ZeRO 0) and loaded at ep 1 and ep 2 (at other stages),
    the master loaded is the one saved, and the next steps are the
    saving run's."""
    for r in runs[leg]:
        for name in resumed:
            got = r["resumed"][name]
            for n, w in r["saved"]["master"].items():
                np.testing.assert_array_equal(got["loaded"]["master"][n], w,
                                              err_msg=n)
            np.testing.assert_allclose(got["losses"], r["losses"],
                                       rtol=1e-6)
            for n, w in r["final"]["master"].items():
                np.testing.assert_allclose(got["final"]["master"][n], w,
                                           rtol=1e-6, atol=1e-7, err_msg=n)


def test_ep2_tag_converts_to_universal_with_global_stacks(runs, tmp_path):
    """The universal conversion of the ep 2 tag writes each expert stack
    whole (E experts), equal to the master the tag saved."""
    from deepspeed_tpu_torch.checkpoint.ds_to_universal import \
        convert_to_universal
    from deepspeed_tpu_torch.checkpoint.universal_checkpoint import \
        read_universal
    out = convert_to_universal(runs["ckpt_dir"], str(tmp_path / "u"),
                               tag="t")
    model, _ = moe_twin(_twin_tree(seed=11))
    _, fields = read_universal(out, model)
    saved = runs["ckpt"][0]["saved"]["master"]
    assert set(fields["fp32"]) == set(saved)
    for n, w in saved.items():
        got = fields["fp32"][n].numpy()
        if "experts" in n:
            assert got.shape[0] == EXPERTS, n
        np.testing.assert_array_equal(got, w, err_msg=n)


def test_moe_under_qgz_at_world_2_raises_8b(runs):
    """Refused until item 8b; now the qgZ micro's per-rank path (JAX
    ``_manual_dispatch_combine``): each rank gates its own tokens and the
    dispatch concatenates the ep ranks' blocks.  At ZeRO 2 and 3 the first
    loss is JAX's qgZ run's (rtol 1e-5), the last within JAX's 2e-2 of the
    flat run's (``test_qgz_manual_micro_with_moe_parity``), falling."""
    for z, flat in ((2, "ep2"), (3, "ep2_z3")):
        want = runs[f"jax_qgz_z{z}"][0]
        for r in runs[f"qgz_z{z}"]:
            assert r["per_rank_gating"]
            np.testing.assert_allclose(r["losses"][0], want[0], rtol=1e-5)
            assert abs(r["losses"][-1] - runs[flat][0]["losses"][-1]) <= \
                2e-2
            assert r["losses"][-1] < r["losses"][0]
        assert not runs[flat][0]["per_rank_gating"]


def test_hierarchical_dispatch_at_ep4(runs):
    """ep 4 with ``intra_node_size`` 2 on the int8 wire takes the 2-hop
    exchange and follows JAX's 2-hop run on the same mesh: every step's
    loss and the final master within ``run_hier_smoke``'s 1e-2 (the two
    packages round int8 groups of different fp32 sums; the port's 1-hop
    int8 run differs from JAX's by as much).  It also stays within 1e-2 of
    the flat run, falling."""
    jl, jmaster = runs["jax_ep4_hier"]
    flat = runs["ep4_flat"][0]["losses"]
    for r in runs["ep4_hier"]:
        assert r["two_hop"]
        np.testing.assert_allclose(r["losses"], jl, rtol=0, atol=1e-2)
        assert abs(r["losses"][-1] - flat[-1]) <= 1e-2
        assert r["losses"][-1] < r["losses"][0]
    got = _leaves(runs["ep4_hier"][0])
    assert set(got) == set(jmaster)
    for n, w in jmaster.items():
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-2, err_msg=n)
    assert not runs["ep4_flat"][0]["two_hop"]


@pytest.mark.parametrize("leg,ref", [("seq_ep2sp2", "seq_ep2"),
                                     ("pipe_pp2", "pipe_pp1")])
def test_moe_layer_with_sp_or_pp(runs, leg, ref):
    """The MoE layer at ep 2 × sp 2 (its token group dp × ep × sp; the
    expert gradients summed over the expert-data × sp group) and in the
    second layer of a 2-stage ``PipeStage`` at ep 2 (its exchange inside
    the stage) trains as the same global batch does without the axis."""
    want = runs[ref][0]["losses"]
    for r in runs[leg]:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
    if leg == "seq_ep2sp2":
        # the quantized dispatch is ignored on an sp mesh (JAX's warning):
        # the flat run, bit for bit
        assert runs["seq_ep2sp2_int8"][0]["losses"] == runs[leg][0]["losses"]


@pytest.mark.parametrize("leg", ["hpz_dp2ep2", "mics_dp2ep2"])
def test_hpz_and_mics_with_ep(runs, leg):
    """hpZ's secondary partition and MiCS's shard groups at dp 2 × ep 2
    (zp 2, ZeRO 3): the dense units factored over zp, the expert units
    kept on their expert-data group; the losses, the gradient norms and
    the final master are JAX's at dp 2 × ep 2 (and the norms dp 4's)."""
    jl, jmaster = runs["jax_dp2ep2"]
    for r in runs[leg]:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["gnorms"], runs["dp4"][0]["gnorms"],
                                   rtol=1e-5)
    got = _leaves(runs[leg][0])
    for n, w in jmaster.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def _assert_onebit_is_jax(runs, leg):
    """OnebitAdam with the MoE layer follows JAX's 1-bit micro-step: each
    worker gates its own tokens (the manual region's per-rank gating) and
    every leaf, the expert stacks whole, is compressed over the dp × ep
    workers (``build_local_grad_micro``'s ``dp_axes``).  So at ep 2 as at
    dp 2 the port is JAX's dp-2 run on the same two workers: the losses
    at rtol 1e-5 through the exact warmup and 5e-3 once compressed
    (``test_torch_onebit.py``'s), over 8 steps, and the final master at
    5e-3."""
    k = 5           # the warmup's steps: freeze_step 4, then one exact
    jl, jmaster = runs["jax_onebit"]
    for r in runs[leg]:
        assert len(r["losses"]) == 8
        np.testing.assert_allclose(r["losses"][:k], jl[:k], rtol=1e-5)
        np.testing.assert_allclose(r["losses"][k:], jl[k:], rtol=5e-3)
    got = _leaves(runs[leg][0])
    assert set(got) == set(jmaster)
    for n, w in jmaster.items():
        np.testing.assert_allclose(got[n], w, rtol=5e-3, atol=1e-6,
                                   err_msg=n)


def test_lamb_offload_and_onebit_at_ep2(runs):
    """LAMB at ep 2 (each expert stack's trust ratio over the whole stack)
    is JAX's on the same mesh; pinned optimizer offload is bit-equal to
    none; OnebitAdam at ep 2 is JAX's 1-bit run over the same workers
    (:func:`_assert_onebit_is_jax`).  JAX's engine at ep 2 itself fails
    that run at its first forward (its manual dispatch is handed the 1-bit
    micro's whole stacks), so its dp-2 run is the reference."""
    jl, jmaster = runs["jax_lamb_ep2"]
    for r in runs["lamb_ep2"]:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    got = _leaves(runs["lamb_ep2"][0])
    for n, w in jmaster.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    for a, b in zip(runs["offload_ep2"], runs["adam_ep2"]):
        assert a["losses"] == b["losses"]
        np.testing.assert_array_equal(a["master"], b["master"])
    assert runs["offload_ep2"][0]["placement"] != \
        runs["adam_ep2"][0]["placement"]
    _assert_onebit_is_jax(runs, "onebit_ep2")
    with pytest.raises(ValueError, match="Inconsistent batch axis"):
        _jax_run(2, 2, _twin_tree(seed=11), _onebit_batches()[:1],
                 _onebit_config(2))


def test_onebit_with_the_moe_layer_at_dp2(runs):
    """At dp 2 too the MoE layer gates per worker under OnebitAdam, and the
    run is JAX's (:func:`_assert_onebit_is_jax`)."""
    _assert_onebit_is_jax(runs, "onebit_dp2")


def test_gating_seed_threads_the_noisy_gate(runs):
    """JAX's ``test_rsample_rng_threaded_and_deterministic``: with the
    ``moe`` block on the engine threads a per-step generator into the
    RSample gate, so the same seed reproduces exactly, ``gating_seed``
    steers the noise, and the run without the thread differs."""
    a, b = runs["gate_a"][0]["losses"], runs["gate_b"][0]["losses"]
    assert a == b
    assert a != runs["gate_seeded"][0]["losses"]
    assert a != runs["gate_off"][0]["losses"]
