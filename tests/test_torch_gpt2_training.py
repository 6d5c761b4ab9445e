"""The port's GPT-2 training path against the JAX package's, on the CPU at
``gpt2_tiny`` size, from the same numpy weights (a flax tree, handed to the
port through ``models/gpt2.py:params_from_flax``) and the same numpy
batches.

* model loss and gradients against flax ``value_and_grad``, fp32,
  tolerance 1e-5 (absolute and relative: the same fp32 arithmetic summed in
  another order);
* a 6-step engine trajectory with ``fusedlamb`` and with ``lion`` against
  ``deepspeed_tpu.initialize`` on a one-device mesh: losses 1e-5 relative;
  the master with LAMB within rtol 2e-5 plus lr/20 (JAX forms 1 − β in
  float64, the kernel in fp32: 1.3e-5 relative in v), with Lion per leaf at
  most 1 % of elements more than lr/2 apart and the move from the start
  within a fifth of JAX's (a near-zero gradient whose sign differs moves an
  element by 2·lr).  The key-projection biases are left out: their gradient
  is zero in exact arithmetic (a key bias adds the same q·b to every score
  of a row, which the softmax cancels), so both engines update them from
  fp32 summation noise;
* fp16 with dynamic loss scaling from ``initial_scale_power`` 32: the same
  skip pattern, scale after every step and ``skipped_steps`` as JAX, and a
  skipped step leaves master, moments, fp16 parameters and the optimizer's
  count (so its lr) untouched;
* the finite-grad guard: a poisoned step is skipped in bf16 and fp32, a
  norm spike is skipped, and ``max_consecutive_skips`` poisoned steps in a
  row abort;
* the size of GPT-2 350M and the options that are not ported (or, as the
  ring backend, not GPT-2's).
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
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.ops.lion import FusedLion

SEQ = 16


def _flax_tree(seed):
    """A numpy param tree in the flax layout of ``jax_gpt2.GPT2Model``
    (gpt2_tiny), every leaf random (norm scales around 1)."""
    params = jax_gpt2.GPT2Model(jax_gpt2.gpt2_tiny(dtype="float32")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * noise).astype(np.float32)
        return (0.05 * noise if a.ndim == 1 else
                noise / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _configs(**over):
    return jax_gpt2.gpt2_tiny(**over), port_gpt2.gpt2_tiny(**over)


def _batches(n, B, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, SEQ)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("case", ["plain", "mask", "remat"])
def test_model_loss_and_grads_match_flax(case):
    jcfg, pcfg = _configs(dtype="float32", remat=case == "remat")
    tree = _flax_tree(len(case))
    ids = _batches(1, 2, seed=3)[0]
    mask = None
    if case == "mask":
        mask = (np.random.default_rng(4).random(ids.shape) > 0.3).astype(
            np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_gpt2.GPT2Model(jcfg).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(ids),
            None if mask is None else jnp.asarray(mask))
    )(jax.tree_util.tree_map(jnp.asarray, tree))

    model = port_gpt2.GPT2Model(pcfg)
    state = port_gpt2.params_from_flax(tree, pcfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
    model.requires_grad_(True)
    t = torch.from_numpy
    loss = model(t(ids), t(ids), None if mask is None else t(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want = port_gpt2.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, g in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_model_logits_without_labels():
    jcfg, pcfg = _configs(dtype="float32", remat=False)
    tree = _flax_tree(1)
    ids = _batches(1, 1, seed=2)[0]
    want = jax_gpt2.GPT2Model(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
        jnp.asarray(ids))
    model = port_gpt2.GPT2Model(pcfg)
    state = port_gpt2.params_from_flax(tree, pcfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (1, SEQ, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gpt2_350m_size_and_leaves():
    cfg = port_gpt2.gpt2_350m(dtype="float16")
    named = list(port_gpt2.GPT2Model(cfg, device="meta").named_parameters())
    assert len(named) == 16 * 24 + 4 == 388
    assert sum(p.numel() for _, p in named) == 354_823_168 == \
        port_gpt2.param_count(cfg)
    small = [n for n, p in named if p.numel() in (1024, 4096)]
    assert len(small) == 242


def test_unported_model_options_raise():
    """Ring attention is no GPT-2 option (JAX's GPT2Config has no
    sp_backend: Ulysses is its only GPT-2 backend); the decode path stays
    refused.  ``loss_chunk_vocab`` runs (tests/test_torch_fused_ce.py)."""
    ids = torch.zeros(1, SEQ, dtype=torch.long)
    with pytest.raises(ValueError, match="Ulysses only"):
        port_gpt2.gpt2_tiny(dtype="float32", use_ulysses=True,
                            sp_backend="ring")
    _, pcfg = _configs(dtype="float32")
    with pytest.raises(NotImplementedError, match="item 11"):
        port_gpt2.GPT2Model(pcfg)(ids, decode=True)


@pytest.fixture
def one_device_mesh():
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


def _engines(config, dtype="float32", seed=7, port_copies=1):
    jcfg, pcfg = _configs(dtype=dtype, remat=False)
    tree = _flax_tree(seed)
    jeng = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2Model(jcfg),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config=dict(config))[0]
    start = port_gpt2.params_from_flax(tree, pcfg)
    pengs = [deepspeed_tpu_torch.initialize(
        model=port_gpt2.GPT2Model(pcfg, device="meta"),
        model_parameters=start, config=dict(config), device="cpu")[0]
        for _ in range(port_copies)]
    return jeng, pengs, start, pcfg


ENGINE_CASES = {
    "fusedlamb": {"type": "fusedlamb",
                  "params": {"lr": 2e-3, "weight_decay": 0.01}},
    "lamb_clip": {"type": "lamb", "params": {"lr": 2e-3, "max_coeff": 2.0,
                                             "min_coeff": 0.5}},
    "lion": {"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1}},
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_trajectory_matches_jax(case, one_device_mesh):
    opt = ENGINE_CASES[case]
    config = {"train_micro_batch_size_per_gpu": 2, "optimizer": opt,
              "gradient_clipping": 1.0}
    jeng, (peng, ), start, pcfg = _engines(config)
    jl, pl = [], []
    for ids in _batches(6, 2, seed=11):
        for eng, out in ((jeng, jl), (peng, pl)):
            loss = eng(ids, ids)
            eng.backward(loss)
            eng.step()
            out.append(float(loss))
    assert peng.global_steps == jeng.global_steps == 6
    assert peng.opt_state.count == 6
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = port_gpt2.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jeng.get_fp32_param()), pcfg)
    lr = opt["params"]["lr"]
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            continue
        got = peng.get_fp32_param(name)
        if case == "lion":
            share = ((got - w).abs() > lr / 2).float().mean().item()
            move = w - start[name]
            rel = ((got - start[name] - move).norm() / move.norm()).item() \
                if move.norm() > 0 else 0.0
            assert share <= 1e-2 and rel <= 0.2, (name, share, rel)
        else:
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-5,
                                       atol=lr / 20, err_msg=name)


def test_client_optimizers_take_the_config_path(one_device_mesh):
    """A client FusedLamb / FusedLion gives the same trajectory as the
    config's fusedlamb / lion."""
    _, pcfg = _configs(dtype="float32", remat=False)
    start = port_gpt2.params_from_flax(_flax_tree(5), pcfg)
    for client, opt in ((FusedLamb(lr=2e-3), {"type": "fusedlamb",
                                             "params": {"lr": 2e-3}}),
                        (FusedLion(lr=1e-3), {"type": "lion",
                                              "params": {"lr": 1e-3}})):
        engines = [deepspeed_tpu_torch.initialize(
            model=port_gpt2.GPT2Model(pcfg, device="meta"),
            model_parameters=start, optimizer=o, device="cpu",
            config={"train_micro_batch_size_per_gpu": 2, **extra})[0]
            for o, extra in ((client, {}), (None, {"optimizer": opt}))]
        for ids in _batches(3, 2, seed=1):
            for eng in engines:
                eng.backward(eng(ids, ids))
                eng.step()
        assert torch.equal(engines[0].params, engines[1].params)


FP16_CASES = {
    "hysteresis1_window3": {"enabled": True, "initial_scale_power": 32,
                            "hysteresis": 1, "loss_scale_window": 3},
    "default_hysteresis": {"enabled": True, "initial_scale_power": 32},
}


@pytest.mark.parametrize("case", sorted(FP16_CASES))
def test_fp16_skip_pattern_matches_jax(case, one_device_mesh):
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "fusedlamb", "params": {"lr": 1e-3}},
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_min_lr": 1e-4,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 30}},
              "fp16": FP16_CASES[case]}
    jeng, (peng, ), _, _ = _engines(config, dtype="float16")
    assert peng.compute_dtype == torch.float16 and peng.cur_scale == 2.0**32
    jskip, pskip, jscale, pscale = [], [], [], []
    steps = 24 if case.startswith("hysteresis1") else 8
    for ids in _batches(steps, 2, seed=11):
        before = [t.clone() for t in (peng.master, peng.params,
                                      peng.opt_state.exp_avg,
                                      peng.opt_state.exp_avg_sq)]
        count, lr = peng.opt_state.count, peng._transform.current_lr(
            peng.opt_state.count + 1, peng.opt_state)
        for eng, skip, scale in ((jeng, jskip, jscale),
                                 (peng, pskip, pscale)):
            done = eng.skipped_steps
            loss = eng(ids, ids)
            eng.backward(loss)
            eng.step()
            skip.append(eng.skipped_steps - done)
            scale.append(eng.cur_scale)
        after = (peng.master, peng.params, peng.opt_state.exp_avg,
                 peng.opt_state.exp_avg_sq)
        if pskip[-1]:
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert peng.opt_state.count == count
            assert peng._transform.current_lr(count + 1,
                                              peng.opt_state) == lr
        else:
            assert peng.opt_state.count == count + 1
            assert not torch.equal(before[0], after[0])
    assert pskip == jskip and pscale == jscale
    assert peng.skipped_steps == jeng.skipped_steps == sum(jskip)
    assert peng.global_steps == jeng.global_steps == steps
    if case.startswith("hysteresis1"):
        assert 0 < sum(pskip) < steps          # it both skipped and stepped
    else:
        assert sum(pskip) == steps             # halves every second step
        assert pscale[-1] == 2.0**28


def _guarded(dtype, **guard):
    _, pcfg = _configs(dtype=dtype, remat=False)
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "resilience": {"check_finite_grads": {"enabled": True,
                                                    **guard}}}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
    return deepspeed_tpu_torch.initialize(
        model=port_gpt2.GPT2Model(pcfg, device="meta"), device="cpu",
        model_parameters=port_gpt2.params_from_flax(_flax_tree(3), pcfg),
        config=config)[0]


def _step(engine, ids, poison=False, spike=False):
    loss = engine(ids, ids)
    engine.backward(loss)
    if poison:
        engine.grad_acc[5] = float("nan")
    if spike:
        engine.grad_acc.mul_(1e4)          # 1e4x the healthy grad norm
    engine.step()
    return float(loss)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finite_grad_guard_skips_a_poisoned_step(dtype):
    engine = _guarded(dtype, max_consecutive_skips=3)
    batches = _batches(1, 2, seed=2) * 8
    losses = [_step(engine, ids) for ids in batches[:3]]
    target = engine.master if engine.master is not None else engine.params
    before = [t.clone() for t in (target, engine.params,
                                  engine.opt_state.exp_avg)]
    _step(engine, batches[3], poison=True)
    assert engine._consecutive_skips == 1 and engine._last_skipped
    assert all(torch.equal(a, b) for a, b in
               zip(before, (target, engine.params, engine.opt_state.exp_avg)))
    assert engine.global_steps == 4 and engine.opt_state.count == 3
    assert engine.skipped_steps == 0          # fp16 overflow count only
    more = [_step(engine, ids) for ids in batches[4:]]
    assert engine._consecutive_skips == 0 and engine.opt_state.count == 7
    assert np.isfinite(more).all() and more[-1] < losses[0]


def test_finite_grad_guard_aborts_and_spikes():
    engine = _guarded("float32", max_consecutive_skips=3)
    batches = _batches(6, 2, seed=4)
    _step(engine, batches[0])
    with pytest.raises(RuntimeError, match="consecutive"):
        for ids in batches[1:]:
            _step(engine, ids, poison=True)
    assert engine._consecutive_skips == 3

    engine = _guarded("float32", grad_norm_spike_factor=10.0,
                      spike_warmup_steps=3, max_consecutive_skips=5)
    for ids in _batches(5, 2, seed=5):
        _step(engine, ids)
    assert engine._consecutive_skips == 0 and engine._gnorm_ema is not None
    before = engine.params.clone()
    _step(engine, batches[0], spike=True)
    assert engine._consecutive_skips == 1
    assert torch.equal(before, engine.params)
    _step(engine, batches[1])
    assert engine._consecutive_skips == 0


def test_fp16_params_and_master_through_initialize():
    """fp16 compute with an fp32 master, the flat fp16 parameters the
    module's views, an fp16 gradient accumulator on request."""
    _, pcfg = _configs(dtype="float16", remat=True)
    engine = deepspeed_tpu_torch.initialize(
        model=port_gpt2.GPT2Model(pcfg, device="meta"), device="cpu",
        config={"train_micro_batch_size_per_gpu": 2,
                "fp16": {"enabled": True, "initial_scale_power": 8},
                "data_types": {"grad_accum_dtype": "fp16"},
                "optimizer": {"type": "sgd", "params": {"lr": 0.1}}})[0]
    engine.initialize_parameters(0)
    assert engine.params.dtype == torch.float16
    assert engine.master.dtype == torch.float32
    assert engine.module.wte.embedding.data_ptr() == engine.params.data_ptr()
    ids = _batches(1, 2, seed=0)[0]
    losses = []
    for _ in range(4):
        losses.append(_step(engine, ids))
        assert engine.grad_acc.dtype == torch.float16
    assert engine.cur_scale == 256.0 and engine.skipped_steps == 0
    assert losses[-1] < losses[0] and math.isfinite(losses[-1])
    assert torch.equal(engine.params, engine.master.half())
