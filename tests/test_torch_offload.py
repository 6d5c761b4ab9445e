"""Optimizer-state offload and ``offload_states``/``reload_states`` of the
port's engine (``runtime/offload.py``) on the CPU, at ``llama_tiny``.

* ``offload_optimizer: cpu`` at ZeRO 0-3 with Adam and LAMB, at one rank
  and at two (gloo, ``torch_dist_worker.py``): losses and master bit-equal
  to the same run without offload (on a card the state is pinned and the
  kernels read it in place; here host and device are one memory, so the
  engine's placement record is checked);
* ``offload_optimizer: nvme`` at stage 2 against the JAX engine with the
  same config, the host optimizer step engaged (with clipping and a
  schedule), and with ``DS_TPU_HOST_OFFLOAD_STEP=0``: losses rtol 1e-5,
  master rtol 2e-5 plus lr/20 (``test_torch_zero.py``'s rule); the host
  step is not taken where JAX does not take it;
* ``offload_states``/``reload_states`` after JAX ``test_engine.py:219-340``
  (round trip bit-equal, optimizer-only offload survives a forward,
  checkpoint after offload, ``lp_grads`` mid-accumulation, the names);
* save and resume with offloaded state, bit-equal; an NVMe tag loads into
  an engine without offload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PortConfig
from test_torch_llama_training import _flax_tree
from torch_dist_worker import spawn

SEQ, MB, WORLD = 16, 2, 2
LLAMA = dict(dtype="float32", remat=False, num_key_value_heads=4)
LLAMA_BF16 = dict(LLAMA, dtype="bfloat16")
Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}
ADAM = {"type": "fusedadam", "params": {"lr": 2e-3}}
LAMB = {"type": "fusedlamb", "params": {"lr": 2e-3, "weight_decay": 0.01}}


def _zero(stage, **extra):
    base = dict(Z3) if stage == 3 else {"stage": stage}
    return dict(base, **extra)


def _config(stage, opt=ADAM, offload=None, gas=1, **extra):
    zero = _zero(stage)
    if offload is not None:
        zero["offload_optimizer"] = offload
    return {"train_micro_batch_size_per_gpu": MB,
            "gradient_accumulation_steps": gas, "optimizer": opt,
            "zero_optimization": zero, **extra}


def _ids(n, seed, rows=MB):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(rows, SEQ)).astype(np.int32)
            for _ in range(n)]


def _engine(cfg_kw, config, tree, device="cpu"):
    pcfg = port_llama.llama_tiny(**cfg_kw)
    return deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        model_parameters=port_llama.params_from_flax(tree, pcfg,
                                                     dtype="float32"),
        config=config, device=device)[0]


def _train(engine, batches, hook=None):
    losses = []
    for i, ids in enumerate(batches):
        t = torch.from_numpy(ids)
        loss = engine(t, t)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
        if hook is not None:
            hook(i, engine)
    return losses


def _state(engine):
    """The whole fp32 master and moments, on the host."""
    opt = engine.opt_state
    out = {"master": engine.fp32_params().clone(), "count": opt.count}
    for k in engine._transform.MOMENTS:
        out[k] = getattr(opt, k).clone()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def tree():
    return _flax_tree(jax_llama.llama_tiny(**LLAMA), seed=7)


# ------------------------------------------------------- cpu, one rank
@pytest.mark.parametrize("opt", ("adam", "lamb"))
@pytest.mark.parametrize("stage", (0, 1, 2, 3))
def test_offload_cpu_is_bit_equal_at_one_rank(tree, stage, opt):
    o = {"adam": ADAM, "lamb": LAMB}[opt]
    batches = _ids(4, 11)
    runs = []
    for offload in (None, {"device": "cpu", "pin_memory": True}):
        eng = _engine(LLAMA_BF16, _config(stage, o, offload, gas=2,
                                          bf16={"enabled": True}), tree)
        runs.append((_train(eng, batches), _state(eng), eng))
    (l0, s0, e0), (l1, s1, e1) = runs
    assert l0 == l1
    _assert_same(s0, s1)
    where = e1.state_placement()
    assert [where[k] for k in ("params", "grad_acc", "master", "exp_avg",
                               "exp_avg_sq")] == ["device"] * 2 + ["host"] * 3
    assert e0.state_placement()["master"] == "device"
    assert e1.zero_plan.describe()["offload_optimizer"]


# ------------------------------------------------------- gloo, two ranks
def _legs(tree, swap_dir):
    batches = [(ids, ids) for ids in _ids(3, 21, rows=WORLD * MB)]
    legs = {}
    for stage in (0, 1, 2, 3):
        for off in (None, {"device": "cpu"}):
            legs[f"adam_z{stage}{'_off' if off else ''}"] = _config(
                stage, ADAM, off)
    for stage in (1, 3):
        for off in (None, {"device": "cpu"}):
            legs[f"lamb_z{stage}{'_off' if off else ''}"] = _config(
                stage, LAMB, off)
    out = [dict(name=n, kind="train", model="llama", cfg=LLAMA, tree=tree,
                config=c, batches=batches) for n, c in legs.items()]
    out.append(dict(out[0], name="adam_z2_nvme", config=_config(
        2, ADAM, {"device": "nvme", "nvme_path": swap_dir})))
    out.append(dict(out[0], name="adam_z3_states", offload_at=1,
                    config=_config(3, ADAM)))
    return out


@pytest.fixture(scope="module")
def world2(tree, tmp_path_factory):
    return spawn(WORLD, _legs(tree, str(tmp_path_factory.mktemp("swap"))),
                 timeout=300)


@pytest.mark.parametrize("got,want", [
    ("adam_z0_off", "adam_z0"), ("adam_z1_off", "adam_z1"),
    ("adam_z2_off", "adam_z2"), ("adam_z3_off", "adam_z3"),
    ("lamb_z1_off", "lamb_z1"), ("lamb_z3_off", "lamb_z3"),
    ("adam_z2_nvme", "adam_z2"), ("adam_z3_states", "adam_z3")])
def test_offload_is_bit_equal_at_two_ranks(world2, got, want):
    for rank in range(WORLD):
        g, w = world2[got][rank], world2[want][rank]
        assert g["losses"] == w["losses"]
        np.testing.assert_array_equal(g["master"], w["master"])
        np.testing.assert_array_equal(g["params"], w["params"])
    where = world2[got][0]["placement"]
    if got.endswith("_off"):      # fp32: no master beside the parameters
        assert "master" not in where and where["exp_avg"] == "host"
    elif got.endswith("_nvme"):
        assert where["exp_avg"] == where["exp_avg_sq"] == "nvme"
    else:
        assert set(world2[got][0]["offloaded"].values()) == {"host"}
        assert set(where.values()) == {"device"}


# ---------------------------------------------------- NVMe against JAX
NVME_CASES = {
    "host_step": dict(),
    "clip_schedule": dict(gradient_clipping=0.05, scheduler={
        "type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                       "warmup_max_lr": 2e-3,
                                       "warmup_num_steps": 3}}),
    "device_step": dict(),
}


@pytest.fixture
def one_device_mesh():
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


@pytest.mark.parametrize("case", sorted(NVME_CASES))
def test_nvme_offload_matches_jax(tree, tmp_path, monkeypatch,
                                  one_device_mesh, case):
    if case == "device_step":
        monkeypatch.setenv("DS_TPU_HOST_OFFLOAD_STEP", "0")
    config = _config(2, {"type": "adam", "params": {"lr": 2e-3}},
                     **NVME_CASES[case])
    batches = _ids(4, 31)
    jconf = dict(config, zero_optimization=dict(
        config["zero_optimization"], offload_optimizer={
            "device": "nvme", "nvme_path": str(tmp_path / "jax")}))
    jeng = deepspeed_tpu.initialize(
        model=jax_llama.LlamaModel(jax_llama.llama_tiny(**LLAMA)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config=jconf)[0]
    want = []
    for ids in batches:
        loss = jeng(ids, ids)
        jeng.backward(loss)
        jeng.step()
        want.append(float(loss))
    jmaster = port_llama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jeng.get_fp32_param()),
        port_llama.llama_tiny(**LLAMA), dtype="float32")
    pconf = dict(config, zero_optimization=dict(
        config["zero_optimization"], offload_optimizer={
            "device": "nvme", "nvme_path": str(tmp_path / "port")}))
    eng = _engine(LLAMA, pconf, tree)
    assert eng.state_placement()["exp_avg"] == "nvme"
    assert not eng.opt_state.exp_avg.untyped_storage().size()
    got = _train(eng, batches)
    host = 0 if case == "device_step" else len(batches)
    assert eng.host_offload_steps == host
    assert getattr(jeng, "host_offload_steps", 0) == host
    assert list((tmp_path / "port").rglob("*.swp"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, o, n, shape in eng._layout:
        np.testing.assert_allclose(
            eng.get_fp32_param(name).numpy(), jmaster[name].numpy(),
            rtol=2e-5, atol=2e-3 / 20, err_msg=name)


@pytest.mark.parametrize("why", ("fp16", "guard", "client_optimizer",
                                 "lamb"))
def test_host_step_not_taken_where_jax_keeps_the_device(tree, tmp_path,
                                                       why):
    extra, opt, kw = {}, ADAM, {}
    if why == "fp16":
        extra = {"fp16": {"enabled": True, "initial_scale_power": 8}}
    elif why == "guard":
        extra = {"resilience": {"check_finite_grads": {"enabled": True}}}
    elif why == "lamb":
        opt = LAMB
    config = _config(2, opt, {"device": "nvme",
                              "nvme_path": str(tmp_path)}, **extra)
    cfg_kw = dict(LLAMA, dtype="float16") if why == "fp16" else LLAMA
    pcfg = port_llama.llama_tiny(**cfg_kw)
    if why == "client_optimizer":
        from deepspeed_tpu_torch.ops.adam import FusedAdam
        kw["optimizer"] = FusedAdam(lr=2e-3)
        config.pop("optimizer")
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        model_parameters=port_llama.params_from_flax(tree, pcfg,
                                                     dtype="float32"),
        config=config, device="cpu", **kw)[0]
    losses = _train(eng, _ids(3, 41))
    assert eng.host_offload_steps == 0 and np.isfinite(losses).all()
    assert eng.state_placement()["exp_avg"] == "nvme"


# ------------------------------------------- offload_states on demand
def _round_trip_runs(tree, hook):
    """(losses, state) of a bf16 stage-2 run without and with ``hook``."""
    out = []
    for h in (None, hook):
        eng = _engine(LLAMA_BF16, _config(2, bf16={"enabled": True}), tree)
        out.append((_train(eng, _ids(3, 51), h), _state(eng), eng))
    return out


def test_offload_reload_states_round_trip_is_bit_equal(tree):
    seen = {}

    def hook(i, eng):
        if i != 0:
            return
        eng.offload_states()
        seen["keys"] = set(eng._host_offloaded)
        seen["freed"] = [t.untyped_storage().size() for t in
                         (eng.params, eng.master, eng.opt_state.exp_avg)]
        seen["where"] = eng.state_placement()
        eng.reload_states()
        seen["after"] = eng.state_placement()

    (l0, s0, _), (l1, s1, _) = _round_trip_runs(tree, hook)
    assert seen["keys"] == {"params", "master", "opt_state", "grad_acc"}
    assert seen["freed"] == [0, 0, 0]
    assert set(seen["where"].values()) == {"host"}
    assert set(seen["after"].values()) == {"device"}
    assert l0 == l1
    _assert_same(s0, s1)


def test_forward_reloads_only_the_parameters(tree):
    """The RLHF case: a generation forward with the optimizer state on the
    host does not bring it back; step() does."""
    seen = {}

    def hook(i, eng):
        if i == 0:
            eng.offload_states(include=["optim_states", "hp_params",
                                        "lp_params"])
            eng.eval()
            with torch.no_grad():
                eng(torch.from_numpy(_ids(1, 3)[0]))
            eng.train()
            seen["after_forward"] = set(eng._host_offloaded)

    (l0, s0, _), (l1, s1, _) = _round_trip_runs(tree, hook)
    assert seen["after_forward"] == {"master", "opt_state"}
    assert l0 == l1
    _assert_same(s0, s1)


def test_offload_lp_grads_mid_accumulation(tree):
    """Gradients offloaded between two micro-steps come back before the
    second folds in (JAX ``test_offload_lp_grads_mid_accumulation``)."""
    runs = []
    for offload in (False, True):
        eng = _engine(LLAMA, _config(1, gas=2), tree)

        def hook(i, e, offload=offload):
            if offload and i == 0:
                e.offload_states(include=["lp_grads"])
                assert set(e._host_offloaded) == {"grad_acc"}
                assert not e.grad_acc.untyped_storage().size()

        runs.append((_train(eng, _ids(4, 61), hook), _state(eng)))
    assert runs[0][0] == runs[1][0]
    _assert_same(runs[0][1], runs[1][1])


def test_offload_states_names_and_refusals(tree, tmp_path):
    eng = _engine(LLAMA, _config(2), tree)
    _train(eng, _ids(1, 71))
    eng.offload_states(include=["OffloadStateTypeEnum.optim_states"])
    assert set(eng._host_offloaded) == {"opt_state"}
    eng.reload_states()
    assert not eng._host_offloaded
    with pytest.raises(ValueError, match="unknown state"):
        eng.offload_states(include=["bogus"])
    with pytest.raises(ValueError, match="only host offload"):
        eng.offload_states(device="nvme")
    nv = _engine(LLAMA, _config(2, offload={
        "device": "nvme", "nvme_path": str(tmp_path)}), tree)
    with pytest.raises(RuntimeError, match="already offloaded to NVMe"):
        nv.offload_states()


def test_checkpoint_after_offload_saves_live_state(tree, tmp_path):
    eng = _engine(LLAMA, _config(2), tree)
    _train(eng, _ids(2, 81))
    before = _state(eng)
    eng.offload_states()
    eng.save_checkpoint(str(tmp_path), tag="t")
    assert not eng._host_offloaded
    fresh = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                    device="meta"),
        config=_config(2), device="cpu")[0]
    fresh.load_checkpoint(str(tmp_path), tag="t")
    _assert_same(before, _state(fresh))


# ------------------------------------------------ save / resume offloaded
@pytest.mark.parametrize("device", ("cpu", "nvme"))
def test_save_and_resume_with_offloaded_state(tree, tmp_path, device):
    off = {"device": device, "nvme_path": str(tmp_path / "swap")}
    config = _config(3, offload=off, bf16={"enabled": True})
    batches = _ids(4, 91)
    eng = _engine(LLAMA_BF16, config, tree)
    _train(eng, batches[:2])
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    if device == "nvme":
        assert eng.state_placement()["master"] == "nvme"
    cont = _train(eng, batches[2:])
    final = _state(eng)
    fresh = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA_BF16),
                                    device="meta"),
        config=dict(config, zero_optimization=dict(
            config["zero_optimization"], offload_optimizer=dict(
                off, nvme_path=str(tmp_path / "swap2")))),
        device="cpu")[0]
    fresh.load_checkpoint(str(tmp_path / "ckpt"))
    if device == "nvme":
        assert fresh.state_placement()["master"] == "nvme"
    assert _train(fresh, batches[2:]) == cont
    _assert_same(final, _state(fresh))


def test_nvme_tag_loads_without_offload(tree, tmp_path):
    config = _config(2, offload={"device": "nvme",
                                 "nvme_path": str(tmp_path / "swap")})
    eng = _engine(LLAMA, config, tree)
    _train(eng, _ids(2, 95))
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    saved = _state(eng)
    plain = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                    device="meta"),
        config=_config(2), device="cpu")[0]
    plain.load_checkpoint(str(tmp_path / "ckpt"))
    _assert_same(saved, _state(plain))


# ----------------------------------------------------------------- config
def test_offload_sections_parse_as_jax():
    zc = PortConfig({"train_batch_size": 1, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "nvme", "nvme_path": "/x",
                                      "buffer_count": 6},
        "offload_optimizer": {"device": "cpu", "pin_memory": True,
                              "ratio": 0.5}}}).zero_config
    assert zc.offload_param.device == "nvme" and \
        zc.offload_param.buffer_count == 6 and \
        zc.offload_param.max_in_cpu == int(1e9)
    assert zc.offload_optimizer.pin_memory and \
        zc.offload_optimizer.ratio == 0.5
    assert zc.offload_optimizer_device == "cpu"
    # the deprecated keys, as upstream DeepSpeed maps them
    zc = PortConfig({"train_batch_size": 1, "zero_optimization": {
        "stage": 2, "cpu_offload": True,
        "cpu_offload_use_pin_memory": True}}).zero_config
    assert zc.offload_optimizer.device == "cpu" and \
        zc.offload_optimizer.pin_memory
    zc = PortConfig({"train_batch_size": 1, "zero_optimization": {
        "stage": 3, "cpu_offload_param": True}}).zero_config
    assert zc.offload_param_device == "cpu"
    assert PortConfig({"train_batch_size": 1}).zero_config \
        .offload_optimizer_device == "none"
    for bad in ({"offload_param": {"device": "tape"}},
                {"offload_optimizer": {"device": "cpu", "ratio": 2.0}}):
        with pytest.raises(ValueError):
            PortConfig({"train_batch_size": 1,
                        "zero_optimization": dict(stage=2, **bad)})
