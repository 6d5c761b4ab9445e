"""Checkpointing of the port's engine (``runtime/checkpoint_engine.py``) on
the CPU, at ``llama_tiny`` and ``gpt2_tiny`` widths from numpy weights
(``params_from_flax``) and numpy batches.

* Round trip: save after k steps, load into a fresh engine (built on the
  meta device, nothing drawn), continue: the losses, and the master, the
  moments, the optimizer's count, the loss scale and the counters after
  the same steps, are bit-equal to the uninterrupted run's.  Stages 0, 1,
  2 (one buffer and bucketed) and 3; fp16 with a changed scale and a
  skipped step; bf16 with accumulation 2; Adam, LAMB and Lion; an lr
  scheduler; ``async_save`` then ``wait_for_checkpoint``; and at world 2
  (two gloo processes, ``torch_dist_worker.py``) at every stage, bucketed
  stage 2 (``overlap_comm``) included.
* Elastic resume: a tag saved at world 2, stage 3 loads at world 1, stage
  0 (here) and at world 2, stage 1 (in the workers) with the master and
  moments bit-equal to the saver's gathered state.
* ``load_module_only``, ``load_optimizer_states=False``,
  ``load_lr_scheduler_states=False``, ``load_module_strict`` and
  ``client_state``.
* The checkpoint half of ``tests/unit/checkpoint/test_resilience.py``
  (``:71-290``) on the port's engine, under the same names: manifest,
  truncated and partial tags, retries and their exhaustion, a missing
  ``latest``, an explicit tag that never rolls forward, ``keep_n``, an
  async commit and an async failure surfaced.
"""

import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
from deepspeed_tpu_torch.utils import fault_injection as fi
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import gathered_state, spawn

SEQ = 16
LLAMA = dict(dtype="float32", remat=False, num_key_value_heads=2)
GPT2 = dict(dtype="float32", remat=False)
Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}
ADAM = {"type": "fusedadam", "params": {"lr": 2e-3}}


@pytest.fixture(autouse=True)
def _clear_faults():
    fi.clear()
    yield
    fi.clear()


def _config(zero=0, opt=ADAM, mb=2, **extra):
    return {"train_micro_batch_size_per_gpu": mb, "optimizer": opt,
            "zero_optimization": zero if isinstance(zero, dict)
            else {"stage": zero}, **extra}


def _ids(n, seed, rows=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(rows, SEQ)).astype(np.int32)
            for _ in range(n)]


def _model(kind, over):
    if kind == "llama":
        cfg = port_llama.llama_tiny(**{**LLAMA, **over})
        tree = llama_tree(jax_llama.llama_tiny(**{**LLAMA, **over}), seed=5)
        return (port_llama.LlamaModel(cfg, device="meta"),
                port_llama.params_from_flax(tree, cfg, dtype="float32"))
    cfg = port_gpt2.gpt2_tiny(**{**GPT2, **over})
    return (port_gpt2.GPT2Model(cfg, device="meta"),
            port_gpt2.params_from_flax(gpt2_tree(5), cfg))


def _engine(kind, over, config, weights=True):
    model, start = _model(kind, over)
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start if weights else None,
        config=dict(config), device="cpu")[0]


def _train(engine, batches):
    out = []
    for ids in batches:
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        out.append(float(loss))
    return out


def _assert_same_state(got, want):
    for key in ("count", "scale", "skipped", "steps", "micro"):
        assert got[key] == want[key], key
    for field in ("master", "exp_avg", "exp_avg_sq", "params"):
        if want[field] is None:
            assert got[field] is None, field
            continue
        assert set(got[field]) == set(want[field])
        for name, w in want[field].items():
            np.testing.assert_array_equal(got[field][name], w,
                                          err_msg=f"{field} {name}")


# ------------------------------------------------------------- round trip
LAMB = {"type": "fusedlamb", "params": {"lr": 2e-3, "weight_decay": 0.01}}
LION = {"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1}}
FP16 = {"enabled": True, "initial_scale_power": 32, "hysteresis": 1,
        "loss_scale_window": 3}
ROUND_TRIP = {
    "llama_z0": ("llama", {}, _config(0), 3, 3),
    "llama_z1": ("llama", {}, _config(1), 3, 3),
    "llama_z2": ("llama", {}, _config(2), 3, 3),
    "llama_z2_bucketed": ("llama", {}, _config(
        {"stage": 2, "overlap_comm": True}), 3, 3),
    "llama_z3": ("llama", {}, _config(Z3), 3, 3),
    "llama_z3_async": ("llama", {}, _config(Z3), 3, 3),
    "gpt2_fp16_z1": ("gpt2", dict(dtype="float16"), _config(
        1, {"type": "fusedadam", "params": {"lr": 1e-3}}, fp16=FP16), 16, 4),
    "gpt2_fp16_z3": ("gpt2", dict(dtype="float16"), _config(
        Z3, {"type": "fusedadam", "params": {"lr": 1e-3}}, fp16=FP16), 16, 4),
    "llama_bf16_gas2_z0": ("llama", dict(dtype="bfloat16"), _config(
        0, gradient_accumulation_steps=2, bf16={"enabled": True}), 4, 4),
    "llama_bf16_gas2_z3": ("llama", dict(dtype="bfloat16"), _config(
        Z3, gradient_accumulation_steps=2, bf16={"enabled": True}), 4, 4),
    "gpt2_lamb_z2": ("gpt2", {}, _config(2, LAMB, gradient_clipping=1.0),
                     3, 3),
    "llama_lion_z1": ("llama", {}, _config(1, LION), 3, 3),
    "llama_warmup_z0": ("llama", {}, _config(0, scheduler={
        "type": "WarmupLR", "params": {"warmup_max_lr": 3e-3,
                                       "warmup_num_steps": 5}}), 3, 3),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_resume_is_bit_equal_to_the_uninterrupted_run(case, tmp_path):
    kind, over, config, k, j = ROUND_TRIP[case]
    batches = _ids(k + j, seed=21)
    a = _engine(kind, over, config)
    _train(a, batches[:k])
    saved = gathered_state(a)
    if case.startswith("gpt2_fp16"):
        # the tag holds a scale the scaler changed and a skipped step
        assert a.skipped_steps > 0 and a.cur_scale != 2.0**32
    handle = a.save_checkpoint(str(tmp_path), tag="t", async_save="async"
                               in case, client_state={"epoch": 7})
    want = _train(a, batches[k:])
    if "async" in case:
        assert not handle.done
        a.wait_for_checkpoint()
        assert handle.done
    b = _engine(kind, over, config, weights=False)
    root, client = b.load_checkpoint(str(tmp_path))
    assert root.endswith("t") and client == {"epoch": 7}
    _assert_same_state(gathered_state(b), saved)
    if "warmup" in case:
        assert b.lr_scheduler.state_dict() == \
            {"last_batch_iteration": k - 1}
    assert _train(b, batches[k:]) == want
    _assert_same_state(gathered_state(b), gathered_state(a))
    assert b.get_lr() == a.get_lr()


def test_load_module_only_rederives_the_master(tmp_path):
    config = _config(1, bf16={"enabled": True})
    a = _engine("llama", dict(dtype="bfloat16"), config)
    _train(a, _ids(3, 22))
    a.save_checkpoint(str(tmp_path))
    b = _engine("llama", dict(dtype="bfloat16"), config, weights=False)
    b.load_checkpoint(str(tmp_path), load_module_only=True)
    got, want = gathered_state(b), gathered_state(a)
    assert got["count"] == 0 and got["steps"] == want["steps"] == 3
    for name, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][name], p)
        # the master is the bf16 weights, not the saved fp32 master
        np.testing.assert_array_equal(got["master"][name], p)
        assert not np.any(got["exp_avg"][name])
    assert any(not np.array_equal(want["master"][n], want["params"][n])
               for n in want["master"])


def test_load_without_optimizer_or_scheduler_states(tmp_path):
    config = _config(2, scheduler={"type": "WarmupLR", "params": {
        "warmup_max_lr": 3e-3, "warmup_num_steps": 5}})
    a = _engine("llama", {}, config)
    _train(a, _ids(3, 23))
    a.save_checkpoint(str(tmp_path))
    b = _engine("llama", {}, config, weights=False)
    b.load_checkpoint(str(tmp_path), load_optimizer_states=False,
                      load_lr_scheduler_states=False)
    got, want = gathered_state(b), gathered_state(a)
    assert got["count"] == 0 and got["steps"] == 3
    assert b.lr_scheduler.last_batch_iteration == -1
    for name, m in want["master"].items():
        np.testing.assert_array_equal(got["master"][name], m)
        assert not np.any(got["exp_avg"][name])


def test_module_strict_names_the_missing_leaf(tmp_path):
    bf16 = dict(bf16={"enabled": True},
                resilience={"checkpoint_integrity": {"enabled": False}})
    a = _engine("llama", dict(dtype="bfloat16"), _config(0, **bf16))
    a.save_checkpoint(str(tmp_path), tag="t")
    path = tmp_path / "t" / "mp_rank_00_model_states.pt"
    sd = torch.load(path, weights_only=False)
    gone = "model.layers.1.mlp.up_proj.weight"
    del sd["module"][gone]
    torch.save(sd, path)
    b = _engine("llama", dict(dtype="bfloat16"), _config(0, **bf16),
                weights=False)
    with pytest.raises(KeyError, match=gone):
        b.load_checkpoint(str(tmp_path), tag="t")
    b.load_checkpoint(str(tmp_path), tag="t", load_module_strict=False)
    # the master comes from the optim file, the bf16 parameters from the
    # model file: the missing leaf keeps the fresh engine's zeros
    got, want = gathered_state(b), gathered_state(a)
    assert not np.any(got["params"][gone])
    np.testing.assert_array_equal(got["master"][gone], want["master"][gone])
    name = "model.layers.0.mlp.up_proj.weight"
    np.testing.assert_array_equal(got["params"][name], want["params"][name])


def test_custom_load_fn_replaces_the_module_load(tmp_path):
    config = _config(1, bf16={"enabled": True})
    a = _engine("llama", dict(dtype="bfloat16"), config)
    _train(a, _ids(2, 25))
    a.save_checkpoint(str(tmp_path))
    b = _engine("llama", dict(dtype="bfloat16"), config, weights=False)
    seen = []

    def load(src, dst):
        seen.append(sorted(src))
        with torch.no_grad():
            for name, p in dst.named_parameters():
                p.copy_(2 * src[name])

    b.load_checkpoint(str(tmp_path), custom_load_fn=load)
    assert seen == [sorted(gathered_state(a)["params"])]
    got, want = gathered_state(b), gathered_state(a)
    for name, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][name], 2 * p)
        np.testing.assert_array_equal(got["master"][name],
                                      want["master"][name])
    z3 = _engine("llama", dict(dtype="bfloat16"),
                 _config(Z3, bf16={"enabled": True}), weights=False)
    with pytest.raises(ValueError, match="stages 0-2"):
        z3.load_checkpoint(str(tmp_path), custom_load_fn=load)


def test_upstream_names_and_the_recovery_script(tmp_path):
    a = _engine("gpt2", {}, _config(1))
    _train(a, _ids(2, 24))
    a.save_checkpoint(str(tmp_path), tag="global_step2")
    files = sorted(os.listdir(tmp_path / "global_step2"))
    assert files == ["engine_state.json", "manifest.json",
                     "mp_rank_00_model_states.pt",
                     "zero_pp_rank_0_mp_rank_00_optim_states.pt"]
    assert (tmp_path / "latest").read_text() == "global_step2"
    assert (tmp_path / "zero_to_fp32.py").exists()
    with open(tmp_path / "global_step2" / "engine_state.json") as f:
        state = json.load(f)
    for key in ("global_steps", "global_samples", "micro_steps",
                "skipped_steps", "loss_scale", "zero_stage",
                "dp_world_size", "client_state"):
        assert key in state
    assert state["module"]["module"] == "deepspeed_tpu_torch.models.gpt2"


# ---------------------------------------------------------------- world 2
def _world2_legs(root):
    lt = llama_tree(jax_llama.llama_tiny(**LLAMA), seed=5)
    legs = []
    zeros = {0: 0, 1: 1, 2: 2, "2b": {"stage": 2, "overlap_comm": True},
             3: Z3}
    for stage, zero in zeros.items():
        legs.append(dict(kind="ckpt", name=f"z{stage}", model="llama",
                         cfg=LLAMA, tree=lt, k=2,
                         config=_config(zero),
                         batches=[(i, i) for i in _ids(4, 31, rows=4)],
                         dir=os.path.join(root, f"z{stage}"),
                         **{"async": stage == 2}))
    legs.append(dict(legs[-1], name="elastic",
                     dir=os.path.join(root, "elastic"),
                     resume={"z1": _config(1)}))
    return legs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world2"))
    legs = _world2_legs(root)
    return spawn(2, legs, timeout=300), {leg["name"]: leg for leg in legs}


@pytest.mark.parametrize("stage", (0, 1, 2, "2b", 3))
def test_world2_resume_is_bit_equal(world2, stage):
    res, _ = world2
    for rank in res[f"z{stage}"]:
        resumed = rank["resumed"]["same"]
        _assert_same_state(resumed["loaded"], rank["saved"])
        assert resumed["losses"] == rank["losses"]
        _assert_same_state(resumed["final"], rank["final"])


def test_elastic_world2_z3_to_world2_z1(world2):
    res, _ = world2
    for rank in res["elastic"]:
        got = rank["resumed"]["z1"]
        for field in ("master", "exp_avg", "exp_avg_sq", "params"):
            for name, w in rank["saved"][field].items():
                np.testing.assert_array_equal(got["loaded"][field][name], w)
        assert got["loaded"]["count"] == rank["saved"]["count"]
        # stage 1 and stage 3 train the same steps bit for bit at world 2
        assert got["losses"] == rank["losses"]


def test_elastic_world2_z3_to_world1_z0(world2):
    res, legs = world2
    leg = legs["elastic"]
    saved = res["elastic"][0]["saved"]
    eng = _engine("llama", {}, _config(0, mb=4), weights=False)
    eng.load_checkpoint(leg["dir"], tag="t")
    got = gathered_state(eng)
    for field in ("master", "exp_avg", "exp_avg_sq", "params"):
        for name, w in saved[field].items():
            np.testing.assert_array_equal(got[field][name], w,
                                          err_msg=f"{field} {name}")
    assert got["count"] == saved["count"] and got["steps"] == saved["steps"]


# ----------------------------------------------------------- resilience
class MLP(torch.nn.Module):
    """The resilience tests' model (``tests/unit/simple_model.py``'s MLP):
    two dense layers and a squared error."""

    def __init__(self, hidden=16, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.fc1 = torch.nn.Linear(hidden, hidden)
        self.fc2 = torch.nn.Linear(hidden, hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))

    def forward(self, x, y):
        return ((self.fc2(torch.relu(self.fc1(x))) - y) ** 2).mean()


HIDDEN = 16


def _make_engine(resilience=None, seed=0, **extra):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "optimizer": {"type": "adam", "params": {"lr": 0.02}}}
    if resilience is not None:
        cfg["resilience"] = resilience
    cfg.update(extra)
    return deepspeed_tpu_torch.initialize(model=MLP(HIDDEN, seed),
                                          config=cfg, device="cpu")[0]


def _data(engine):
    rng = np.random.default_rng(0)
    while True:
        x = rng.standard_normal((4, HIDDEN)).astype(np.float32)
        yield x, np.tanh(x)


def _step(engine, it):
    x, y = next(it)
    loss = engine(x, y)
    engine.backward(loss)
    engine.step()
    return loss


def test_manifest_written_and_verifies(tmp_path):
    engine = _make_engine()
    it = _data(engine)
    _step(engine, it)
    engine.save_checkpoint(str(tmp_path), tag="t1")
    root = str(tmp_path / "t1")
    status, detail = ce.verify_checkpoint_tag(root)
    assert status == "valid", detail
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["tag"] == "t1"
    assert manifest["config_hash"] == engine._config.config_hash()
    assert "engine_state.json" in manifest["files"]
    assert any(rel.startswith("mp_rank") for rel in manifest["files"])
    for meta in manifest["files"].values():
        assert meta["size"] > 0


def test_truncated_tag_falls_back_to_newest_valid(tmp_path):
    engine = _make_engine()
    it = _data(engine)
    for _ in range(3):
        _step(engine, it)
    engine.save_checkpoint(str(tmp_path), tag="t1")
    p_t1 = engine.params.clone()
    for _ in range(2):
        _step(engine, it)
    fi.inject("ckpt.committed",
              lambda ctx: (fi.truncate_file_in_tag(ctx["root"],
                                                   "engine_state.json")
                           if ctx["tag"] == "t2" else None))
    engine.save_checkpoint(str(tmp_path), tag="t2")
    assert ce.verify_checkpoint_tag(str(tmp_path / "t2"))[0] == "corrupt"

    fresh = _make_engine(seed=1)
    root, _ = fresh.load_checkpoint(str(tmp_path))   # latest → corrupt t2
    assert root is not None and root.endswith("t1")
    assert fresh.global_steps == 3
    assert torch.equal(fresh.params, p_t1)


def test_partial_tag_without_manifest_prefers_verified(tmp_path):
    engine = _make_engine(
        resilience={"checkpoint_integrity": {"save_retries": 0}})
    it = _data(engine)
    _step(engine, it)
    engine.save_checkpoint(str(tmp_path), tag="good")

    def die(ctx):
        raise fi.FaultError("injected: save dies mid-write")
    fi.inject("ckpt.save_tree", die)
    with pytest.raises(OSError):
        engine.save_checkpoint(str(tmp_path), tag="partial")
    fi.clear()
    assert os.path.isdir(tmp_path / "partial")
    assert not os.path.exists(tmp_path / "partial" / "manifest.json")
    assert (tmp_path / "latest").read_text() == "good"

    fresh = _make_engine(seed=1)
    root, _ = fresh.load_checkpoint(str(tmp_path), tag="partial")
    assert root is not None and root.endswith("good")


def test_save_retries_transient_failures(tmp_path):
    engine = _make_engine(
        resilience={"checkpoint_integrity": {"save_retries": 3,
                                             "retry_backoff": 0.0}})
    it = _data(engine)
    _step(engine, it)

    def flaky(ctx):
        if ctx["call"] <= 2:
            raise fi.FaultError(f"injected transient failure {ctx['call']}")
    fi.inject("ckpt.save_tree", flaky)
    engine.save_checkpoint(str(tmp_path), tag="t1")
    assert fi.fire_count("ckpt.save_tree") > 2
    assert ce.verify_checkpoint_tag(str(tmp_path / "t1"))[0] == "valid"


def test_retry_exhaustion_raises(tmp_path):
    engine = _make_engine(
        resilience={"checkpoint_integrity": {"save_retries": 1,
                                             "retry_backoff": 0.0}})
    it = _data(engine)
    _step(engine, it)

    def always(ctx):
        raise fi.FaultError("injected permanent failure")
    fi.inject("ckpt.save_tree", always)
    with pytest.raises(OSError):
        engine.save_checkpoint(str(tmp_path), tag="t1")
    assert fi.fire_count("ckpt.save_tree") == 2


def test_latest_missing_loads_nothing_but_hints(tmp_path):
    engine = _make_engine()
    it = _data(engine)
    _step(engine, it)
    engine.save_checkpoint(str(tmp_path), tag="t1", save_latest=False)
    assert not os.path.exists(tmp_path / "latest")

    fresh = _make_engine(seed=1)
    root, _ = fresh.load_checkpoint(str(tmp_path))
    assert root is None and fresh.global_steps == 0
    assert ce.find_latest_valid_tag(str(tmp_path)) == ("t1", "valid")
    root, _ = fresh.load_checkpoint(str(tmp_path), tag="t1")
    assert root is not None and root.endswith("t1")


def test_explicit_tag_never_rolls_forward(tmp_path):
    engine = _make_engine()
    it = _data(engine)
    _step(engine, it)
    engine.save_checkpoint(str(tmp_path), tag="t1")
    _step(engine, it)
    engine.save_checkpoint(str(tmp_path), tag="t2")
    fi.truncate_file_in_tag(str(tmp_path / "t1"), "engine_state.json")

    fresh = _make_engine(seed=1)
    root, _ = fresh.load_checkpoint(str(tmp_path), tag="t1")
    assert root is None           # t2 is newer: NOT an acceptable stand-in
    assert fresh.global_steps == 0
    root, _ = fresh.load_checkpoint(str(tmp_path))
    assert root is not None and root.endswith("t2")


def test_latest_missing_with_only_partial_tag_loads_nothing(tmp_path):
    engine = _make_engine(
        resilience={"checkpoint_integrity": {"save_retries": 0}})
    it = _data(engine)
    _step(engine, it)

    def die(ctx):
        raise fi.FaultError("injected: save dies mid-write")
    fi.inject("ckpt.save_tree", die)
    with pytest.raises(OSError):
        engine.save_checkpoint(str(tmp_path), tag="partial")
    fi.clear()
    assert not os.path.exists(tmp_path / "latest")

    fresh = _make_engine(seed=1)
    root, _ = fresh.load_checkpoint(str(tmp_path))
    assert root is None and fresh.global_steps == 0


def test_keep_n_retention_never_gcs_last_valid(tmp_path):
    engine = _make_engine(
        resilience={"checkpoint_integrity": {"keep_n": 2}})
    it = _data(engine)
    for i in range(4):
        _step(engine, it)
        engine.save_checkpoint(str(tmp_path), tag=f"t{i}")
    remaining = sorted(t for t in os.listdir(tmp_path)
                       if (tmp_path / t).is_dir())
    assert remaining == ["t2", "t3"]
    fresh = _make_engine(seed=1)
    root, _ = fresh.load_checkpoint(str(tmp_path))
    assert root.endswith("t3") and fresh.global_steps == 4
    removed = ce.prune_checkpoint_tags(str(tmp_path), keep_n=1)
    assert removed == ["t2"]
    assert ce.verify_checkpoint_tag(str(tmp_path / "t3"))[0] == "valid"


def test_async_save_commits_manifest_and_latest(tmp_path):
    engine = _make_engine()
    it = _data(engine)
    _step(engine, it)
    handle = engine.save_checkpoint(str(tmp_path), tag="a", async_save=True)
    handle.wait()
    assert (tmp_path / "latest").read_text() == "a"
    assert ce.verify_checkpoint_tag(str(tmp_path / "a"))[0] == "valid"


def test_async_wait_surfaces_background_failure(tmp_path):
    class FailingCkptr:
        def wait_until_finished(self):
            raise RuntimeError("injected background write failure")

        def close(self):
            pass

    latest = str(tmp_path / "latest")
    handle = ce._AsyncSaveHandle([FailingCkptr()], latest_path=latest,
                                 tag="x", root=str(tmp_path / "x"),
                                 integrity=True)
    with pytest.raises(RuntimeError, match="injected background"):
        handle.wait()
    assert not os.path.exists(latest)
    assert handle.done
    handle.wait()


def test_async_write_failure_surfaces_at_wait(tmp_path):
    """A write that fails on the writer's thread raises from
    ``wait_for_checkpoint`` and commits nothing."""
    engine = _make_engine(
        resilience={"checkpoint_integrity": {"save_retries": 0}})
    it = _data(engine)
    _step(engine, it)

    def die(ctx):
        raise fi.FaultError("injected: background write fails")
    fi.inject("ckpt.save_tree", die)
    engine.save_checkpoint(str(tmp_path), tag="a", async_save=True)
    with pytest.raises(OSError, match="background write fails"):
        engine.wait_for_checkpoint()
    assert not os.path.exists(tmp_path / "latest")
    assert not os.path.exists(tmp_path / "a" / "manifest.json")
    engine.wait_for_checkpoint()    # nothing pending any more


def test_a_jax_tag_and_data_state_are_refused(tmp_path):
    engine = _make_engine()
    os.makedirs(tmp_path / "j" / "model")
    with open(tmp_path / "j" / "engine_state.json", "w") as f:
        json.dump({"global_steps": 1}, f)
    with pytest.raises(ValueError, match="orbax"):
        engine.load_checkpoint(str(tmp_path), tag="j")
    engine.save_checkpoint(str(tmp_path), tag="d")
    with open(tmp_path / "d" / "engine_state.json") as f:
        state = json.load(f)
    state["data_sampler"] = {"epoch": 1}
    with open(tmp_path / "d" / "engine_state.json", "w") as f:
        json.dump(state, f)
    integrity = {"checkpoint_integrity": {"enabled": False}}
    with pytest.raises(NotImplementedError, match=r"item 4\)"):
        _make_engine(resilience=integrity).load_checkpoint(str(tmp_path),
                                                           tag="d")


def test_checkpoint_keys_and_the_config_hash_match_jax():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)
    d = {"train_batch_size": 4, "bf16": {"enabled": True},
         "checkpoint": {"load_universal": True,
                        "use_node_local_storage": True},
         "resilience": {"checkpoint_integrity": {"keep_n": 2,
                                                 "save_retries": 1}},
         "zero_optimization": {
             "stage": 2, "stage3_gather_16bit_weights_on_model_save": True}}
    port, jax_cfg = DeepSpeedConfig(d), JaxConfig(dict(d))
    assert port.config_hash() == jax_cfg.config_hash()
    assert port.load_universal_checkpoint and port.use_node_local_storage
    ic, jic = (port.checkpoint_integrity,
               jax_cfg.resilience_config.checkpoint_integrity)
    for key in ("enabled", "keep_n", "save_retries", "retry_backoff"):
        assert getattr(ic, key) == getattr(jic, key), key
    # below stage 3 the 16-bit gather knob is listed as ignored
    assert port.zero_config.ignored() == {
        "gather_16bit_weights_on_model_save": True}
    with pytest.raises(DeepSpeedConfigError, match="keep_n"):
        DeepSpeedConfig({"train_batch_size": 1, "resilience": {
            "checkpoint_integrity": {"keep_n": -1}}})
