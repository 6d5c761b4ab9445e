"""ZeRO++ (qwZ, qgZ, hpZ) and MiCS in the port's engine, on gloo worlds of
2 and 4 processes (``torch_dist_worker.py``, one spawn a world for the
module), beside the JAX engine on a dp-2 / dp-4 mesh of the 8-device CPU
mesh, from the same weights and global batches.

The port quantizes each unit's flat slice, JAX each leaf's tile: their
scale groups fall on different elements, so a quantized run is held to
``tests/unit/runtime/test_zeropp.py``'s own criteria (the final loss below
0.8 × the first, within 0.25 × |first plain loss| of the plain run), not
to JAX's losses; ``tools/comm_smoke.py``'s model and config keep its 1e-2
on the final loss against the port's unquantized run.  What is exact:

* hpZ (the parameters over ``zp`` = 2 of 4 ranks, the state over all 4)
  is the port's ZeRO 3 bit for bit (the same reduce-scatters and updates;
  the gathers only move the same bits);
* MiCS (all state over shard groups of 2, replicated) is within 2e-4 of
  JAX's MiCS engine and of ZeRO 3 (another order of the same sums);
* the ``"fp32"`` ladder rung and stage 0 (where JAX reduces flat too) are
  the flat path bit for bit; at one rank every quantized collective
  declines (``test_torch_llama_training.py``);
* the prefetch and overlap schedulers, and remat's regather in backward,
  leave a quantized run bit-equal to the unscheduled one (the same codes
  dequantized at the wait);
* the 2-hop qgZ runs where a hierarchy exists (hpZ's ``zp_outer × zp``,
  ``intra_node_size``) and the dispatch counters say so;
* the micro-step's name is JAX's ``_micro_variant``; the refusals are
  JAX's; an engine's teardown frees every buffer it made (fault C3);
* checkpoints and optimizer offload with hpZ and MiCS at world 4: a tag
  resumes bit for bit; an hpZ or MiCS tag loads into plain ZeRO 3 (at 4
  ranks, and at one rank in this process) and a ZeRO-3 tag into both,
  the loaded state bit for bit (the next losses within 2e-4: MiCS sums
  in another order); ``offload_optimizer: cpu`` with Adam, LAMB and Lion
  is bit-equal to the same run without it (here host and device are one
  memory; on a card the state is pinned and B2, B3 or B8 update it).
"""

import gc
import weakref

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
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn
from unit.simple_model import (batches, make_simple_mlp_params,
                               random_dataset, simple_mlp_apply)

HIDDEN, SEQ, MB = 16, 16, 2
LLAMA = dict(dtype="float32", remat=False, num_key_value_heads=4)
Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}
QW = {"zero_quantized_weights": True}
QG = {"zero_quantized_gradients": True}
KNOBS = dict(overlap_comm=True, stage3_prefetch_bucket_size=3000)
SMOKE_OPTS = {"enabled": True, "quantized_gradients": True,
              "hierarchical_allreduce": True, "wire_dtype": "int8",
              "quantization_group_size": 128}


# ------------------------------------------------------------------- legs
def _llama_config(zero, lr=2e-3, **extra):
    return {"train_micro_batch_size_per_gpu": MB,
            "optimizer": {"type": "fusedadam", "params": {"lr": lr}},
            "zero_optimization": zero, "comms_logger": {"enabled": True},
            **extra}


def _llama_batches(n, seed, world):
    rng = np.random.default_rng(seed)
    return [(ids, ids) for ids in (
        rng.integers(0, 256, size=(world * MB, SEQ)).astype(np.int32)
        for _ in range(n))]


def _mlp_config(zero, log=False):
    out = {"train_micro_batch_size_per_gpu": 4,
           "optimizer": {"type": "adam", "params": {"lr": 0.02}},
           "zero_optimization": zero}
    if log:
        out["comms_logger"] = {"enabled": True}
    return out


def _mlp_batches(world, steps=15):
    data = batches(random_dataset(64, HIDDEN), 4 * world)
    return [data[i % len(data)] for i in range(steps)]


def _smoke_tree():
    rng = np.random.default_rng(0)
    tree = {"w1": rng.standard_normal((HIDDEN, HIDDEN)).astype("float32")
            * 0.3,
            "w2": rng.standard_normal((HIDDEN, HIDDEN)).astype("float32")
            * 0.3,
            "b": np.zeros((HIDDEN, ), "float32")}
    return tree, rng


def _smoke_leg(world, comm_optimizations):
    """``tools/comm_smoke.py:_one_run``: SGD lr 0.2, ZeRO 2, 8 steps on one
    batch of ``4 × world`` rows."""
    tree, rng = _smoke_tree()
    xs = rng.standard_normal((4 * world, HIDDEN)).astype("float32")
    ys = np.tanh(xs * 0.5).astype("float32")
    config = {"train_micro_batch_size_per_gpu": 4,
              "optimizer": {"type": "sgd", "params": {"lr": 0.2}},
              "zero_optimization": {"stage": 2,
                                    "stage3_param_persistence_threshold": 0}}
    if comm_optimizations:
        config["comm_optimizations"] = comm_optimizations
    return dict(model="smoke", cfg={}, tree=tree, config=config,
                batches=[(xs, ys)] * 8)


def _legs2():
    lt = llama_tree(jax_llama.llama_tiny(**LLAMA), seed=7)
    b = _llama_batches(4, 31, 2)
    leg = lambda zero, **kw: dict(model="llama", cfg=LLAMA, tree=lt,  # noqa
                                  config=_llama_config(zero, **kw),
                                  batches=b)
    legs = {
        "llama_z3": leg(Z3),
        "llama_qwz_qgz_z3": leg(dict(Z3, **QW, **QG)),
        "llama_qwz_qgz_knobs_z3": leg(dict(Z3, **QW, **QG, **KNOBS)),
        "llama_qwz_fp6_z3": leg(dict(Z3, **QW,
                                     zero_quantized_weights_format="fp6")),
        "llama_z2": leg({"stage": 2}),
        "llama_qgz_z2": leg(dict({"stage": 2}, **QG)),
        "llama_z1": leg({"stage": 1}),
        "llama_qgz_z1": leg(dict({"stage": 1}, **QG)),
        "llama_z0": leg({"stage": 0}),
        "llama_qgz_z0": leg(dict({"stage": 0}, **QG)),
        "llama_fp32_rung_z3": leg(Z3, comm_optimizations={
            "enabled": True, "quantized_weights": True,
            "quantized_gradients": True,
            "wire_dtype_by_size": [[None, "fp32"]]}),
    }
    legs["llama_qwz_qgz_remat_z3"] = dict(
        legs["llama_qwz_qgz_z3"], cfg=dict(LLAMA, remat=True))
    # zero_multicard.py --zeropp's fp6 leg at a small width: 8 layers, one
    # batch taken 4 times
    deep = dict(LLAMA, num_hidden_layers=8)
    deep_tree = llama_tree(jax_llama.llama_tiny(**deep), seed=7)
    for name, zero in (("llama_z3_8l", Z3), ("llama_qwz_fp6_8l", dict(
            Z3, **QW, zero_quantized_weights_format="fp6"))):
        legs[name] = dict(model="llama", cfg=deep, tree=deep_tree,
                          config=_llama_config(zero), batches=b[:1] * 4)
    for name, leg_ in legs.items():
        leg_.update(name=name, kind="train")
    return legs


# the optimizers of the offload legs: B2, B3 and B8 on a card
OFFLOAD_OPTS = {
    "adam": {"type": "adam", "params": {"lr": 0.02}},
    "lamb": {"type": "fusedlamb", "params": {"lr": 0.02,
                                             "weight_decay": 0.01}},
    "lion": {"type": "lion", "params": {"lr": 1e-3}},
}


def _legs4():
    tree = {k: {p: np.asarray(v) for p, v in d.items()}
            for k, d in make_simple_mlp_params(HIDDEN).items()}
    b = _mlp_batches(4)
    leg = lambda zero, **kw: dict(  # noqa: E731
        model="mlp", cfg={}, tree=tree,
        config=dict(_mlp_config(zero, log=True), **kw), batches=b)
    hpz, mics = {"zero_hpz_partition_size": 2}, {"mics_shard_size": 2}
    hier = {"enabled": True, "quantized_gradients": True,
            "quantization_group_size": 128}
    legs = {
        "mlp_z3": leg(Z3),
        "mlp_z2": leg({"stage": 2}),
        "mlp_qwz_z3": leg(dict(Z3, **QW)),
        "mlp_qgz_z2": leg(dict({"stage": 2}, **QG)),
        "mlp_qwz_qgz_z3": leg(dict(Z3, **QW, **QG)),
        "mlp_hpz_z3": leg(dict(Z3, **hpz)),
        "mlp_mics_z3": leg(dict(Z3, **mics)),
        "mlp_zeropp_hpz_z3": leg(dict(Z3, **QW, **QG, **hpz)),
        "mlp_qgz_mics_z3": leg(dict(Z3, **QG, **mics)),
        "mlp_hier_qgz_hpz_z3": leg(dict(Z3, **hpz),
                                   comm_optimizations=hier),
        "mlp_hier_qgz_intra2_z3": leg(
            Z3, comm_optimizations=dict(hier, intra_node_size=2)),
        "smoke_flat": _smoke_leg(4, None),
        "smoke_qgz": _smoke_leg(4, SMOKE_OPTS),
    }
    cpu = {"offload_optimizer": {"device": "cpu"}}
    for opt in OFFLOAD_OPTS:
        for kind, zp in (("mics", mics), ("hpz", hpz)):
            for off in ("", "_offload"):
                legs[f"mlp_{kind}_{opt}{off}_z3"] = leg(
                    dict(Z3, **zp, **(cpu if off else {})),
                    optimizer=OFFLOAD_OPTS[opt])
    for name, leg_ in legs.items():
        leg_.update(name=name, kind="train")
    for kind, zp in (("mics", mics), ("hpz", hpz), ("z3", {})):
        legs[f"ckpt_{kind}"] = dict(
            name=f"ckpt_{kind}", kind="ckpt", model="mlp", cfg={},
            tree=tree, config=_mlp_config(dict(Z3, **zp)), batches=b[:8],
            k=4, resume={name: _mlp_config(dict(Z3, **z))
                         for name, z in (("same", zp), ("z3", {}),
                                         ("mics", mics), ("hpz", hpz))})
    legs["refuse_premade"] = dict(
        name="refuse_premade", kind="refuse", model="mlp", cfg={},
        tree=tree, mesh={"dp": 4},
        config=_mlp_config(dict(Z3, **mics)))
    legs["refuse_mismatch"] = dict(
        name="refuse_mismatch", kind="refuse", model="mlp", cfg={},
        tree=tree, mesh=None,
        config=_mlp_config(dict(Z3, zero_hpz_partition_size=2,
                                mics_shard_size=4)))
    return legs


# ------------------------------------------------------------- JAX's runs
def _jax_llama(leg):
    groups.initialize_mesh(dp=2, devices=jax.devices()[:2])
    try:
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(jax_llama.llama_tiny(**leg["cfg"])),
            model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                    leg["tree"]),
            config=dict(leg["config"]))[0]
        losses = []
        for batch in leg["batches"]:
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        master = eng.master if eng.master is not None else eng.params
        return dict(losses=losses, variant=eng._micro_variant(),
                    master=np.concatenate([
                        np.asarray(a, np.float32).reshape(-1)
                        for a in jax.tree_util.tree_leaves(master)]))
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()


def _jax_mlp(zero, world=4, zp=None):
    groups.initialize_mesh(dp=world, devices=jax.devices()[:world],
                           zero_partition_size=zp)
    try:
        eng = deepspeed_tpu.initialize(
            model=simple_mlp_apply,
            model_parameters=make_simple_mlp_params(HIDDEN),
            config=_mlp_config(zero))[0]
        losses = []
        for x, y in _mlp_batches(world):
            loss = eng(x, y)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        return dict(losses=losses, variant=eng._micro_variant())
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()


def _jax_refusal(zero):
    groups.initialize_mesh(dp=4, devices=jax.devices()[:4])
    try:
        deepspeed_tpu.initialize(
            model=simple_mlp_apply,
            model_parameters=make_simple_mlp_params(HIDDEN),
            config=_mlp_config(zero))
    except ValueError as e:
        return str(e)
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    legs2, legs4 = _legs2(), _legs4()
    for name, leg in legs4.items():
        if leg["kind"] == "ckpt":
            leg["dir"] = str(tmp_path_factory.mktemp(name))
    got = spawn(2, list(legs2.values()), timeout=420)
    got.update(spawn(4, list(legs4.values()), timeout=420))
    jax_runs = {
        "llama_z3": _jax_llama(legs2["llama_z3"]),
        "llama_qwz_qgz_z3": _jax_llama(legs2["llama_qwz_qgz_z3"]),
        "llama_qwz_fp6_z3": _jax_llama(legs2["llama_qwz_fp6_z3"]),
        "llama_z3_8l": _jax_llama(legs2["llama_z3_8l"]),
        "llama_qwz_fp6_8l": _jax_llama(legs2["llama_qwz_fp6_8l"]),
        "mlp_z3": _jax_mlp(Z3),
        "mlp_mics_z3": _jax_mlp(dict(Z3, mics_shard_size=2), zp=2),
    }
    dirs = {n: leg["dir"] for n, leg in legs4.items() if "dir" in leg}
    return got, jax_runs, dirs


def _ranks_agree(res):
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_array_equal(r["master"], res[0]["master"])


def _tracks(q, ref):
    """``test_zeropp.py``'s criteria."""
    assert q[-1] < q[0] * 0.8, f"diverged: {q}"
    assert abs(q[-1] - ref[-1]) < 0.25 * abs(ref[0]), (ref, q)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("leg", ("mlp_qwz_z3", "mlp_qgz_z2",
                                 "mlp_qwz_qgz_z3", "mlp_zeropp_hpz_z3",
                                 "mlp_qgz_mics_z3"))
def test_quantized_runs_track_plain(runs, leg):
    got = runs[0]
    ref = got["mlp_z2" if "z2" in leg else "mlp_z3"][0]["losses"]
    _ranks_agree(got[leg])
    _tracks(got[leg][0]["losses"], ref)
    counts = got[leg][0]["dispatch"]
    assert counts and not any(k.endswith("flat_fallback") for k in counts)


def test_plain_mlp_matches_jax(runs):
    got, jax_runs = runs[:2]
    np.testing.assert_allclose(got["mlp_z3"][0]["losses"],
                               jax_runs["mlp_z3"]["losses"], rtol=2e-5)


def test_hpz_is_zero3_bit_for_bit(runs):
    got = runs[0]
    hpz, z3 = got["mlp_hpz_z3"], got["mlp_z3"]
    _ranks_agree(hpz)
    for r in range(4):
        assert hpz[r]["losses"] == z3[r]["losses"]
        np.testing.assert_array_equal(hpz[r]["master"], z3[r]["master"])
        np.testing.assert_array_equal(hpz[r]["params"], z3[r]["params"])
    plan = hpz[0]["plan"]
    assert plan["param_world"] == 2 and plan["param_axes"] == ["zp"]
    # a rank holds 1/zp of the parameters (+ its 1/dp primary slice)
    assert hpz[0]["param_numel"] == 2 * z3[0]["param_numel"]
    assert hpz[0]["variant"] == "flat"


def test_mics_matches_jax_and_zero3(runs):
    got, jax_runs = runs[:2]
    mics = got["mlp_mics_z3"]
    _ranks_agree(mics)
    for ref in (jax_runs["mlp_mics_z3"]["losses"],
                jax_runs["mlp_z3"]["losses"], got["mlp_z3"][0]["losses"]):
        np.testing.assert_allclose(mics[0]["losses"], ref, rtol=2e-4,
                                   atol=2e-4)
    plan = mics[0]["plan"]
    assert plan["mics"] and plan["world_size"] == 2
    assert plan["state_axes"] == ["zp"]


@pytest.mark.parametrize("leg", ("mlp_hier_qgz_hpz_z3",
                                 "mlp_hier_qgz_intra2_z3"))
def test_hierarchical_qgz_runs_the_two_hops(runs, leg):
    got = runs[0]
    _ranks_agree(got[leg])
    _tracks(got[leg][0]["losses"], got["mlp_z3"][0]["losses"])
    counts = got[leg][0]["dispatch"]
    assert counts.get("reduce_scatter/hier_q_int8", 0) > 0, counts
    assert not any(k.startswith("reduce_scatter/q_") for k in counts)
    logged = got[leg][0]["counts"]
    assert "reduce_scatter_fn[hier_q_int8]" in logged


def test_comm_smoke_parity(runs):
    """``tools/comm_smoke.py``: the quantized run converges and ends within
    1e-2 of the flat one."""
    got = runs[0]
    flat, quant = got["smoke_flat"][0]["losses"], got["smoke_qgz"][0][
        "losses"]
    assert quant[-1] < quant[0] * 0.8
    assert abs(flat[-1] - quant[-1]) <= 1e-2, (flat, quant)
    assert flat != quant      # it did quantize


def test_llama_zeropp_tracks_plain_and_jax(runs):
    got, jax_runs = runs[:2]
    q, plain = got["llama_qwz_qgz_z3"], got["llama_z3"]
    _ranks_agree(q)
    np.testing.assert_allclose(plain[0]["losses"],
                               jax_runs["llama_z3"]["losses"], rtol=1e-5)
    jq = jax_runs["llama_qwz_qgz_z3"]["losses"]
    for losses in (q[0]["losses"], jq):
        assert abs(losses[-1] - plain[0]["losses"][-1]) < \
            0.25 * abs(plain[0]["losses"][0])
    assert q[0]["losses"] != plain[0]["losses"]
    assert q[0]["variant"] == jax_runs["llama_qwz_qgz_z3"]["variant"] == \
        "qgZ_islands+qwZ"
    assert q[0]["dispatch"]["all_gather/q_int8"] > 0
    assert q[0]["dispatch"]["reduce_scatter/q_int8"] > 0
    assert "allgather_fn[q_int8]" in q[0]["counts"]


@pytest.mark.parametrize("leg", ("llama_qwz_qgz_knobs_z3",
                                 "llama_qwz_qgz_remat_z3"))
def test_schedulers_and_remat_leave_quantized_runs_bit_equal(runs, leg):
    got = runs[0]
    base, other = got["llama_qwz_qgz_z3"], got[leg]
    for r in range(2):
        assert other[r]["losses"] == base[r]["losses"]
        np.testing.assert_array_equal(other[r]["master"], base[r]["master"])


def test_fp6_weights_wire(runs):
    got = runs[0]
    q, plain = got["llama_qwz_fp6_z3"], got["llama_z3"]
    _ranks_agree(q)
    assert abs(q[0]["losses"][-1] - plain[0]["losses"][-1]) < \
        0.25 * abs(plain[0]["losses"][0])
    assert q[0]["dispatch"]["all_gather/q_fp6"] > 0
    assert q[0]["variant"] == "qwZ"


def _fp6_gaps(q_losses, p_losses, q_master, p_master):
    """(final loss, master) of an fp6 run relative to its plain run."""
    return (abs(q_losses[-1] - p_losses[-1]) / abs(p_losses[-1]),
            float(np.linalg.norm(q_master - p_master) /
                  np.linalg.norm(p_master)))


@pytest.mark.parametrize("fp6, plain", [
    ("llama_qwz_fp6_z3", "llama_z3"), ("llama_qwz_fp6_8l", "llama_z3_8l")],
    ids=["2_layers", "8_layers_one_batch"])
def test_fp6_gap_to_plain_matches_jax(runs, fp6, plain):
    """The fp6 qwZ wire against plain ZeRO 3, in each package from the same
    weights and batches: the port's gap (final loss and master, relative)
    is at most twice JAX's, plus 1e-6.  The two packages quantize
    different groups (a unit's flat slice, a leaf's tile), so the gaps
    differ; a port gap above twice JAX's would be a fault of the port's
    fp6 wire, not of fp6's 2-bit mantissa.  Held at the tiny model's 2
    layers over 4 batches, and at the depth and steps of
    ``zero_multicard.py --zeropp``'s fp6 leg (8 layers, one batch 4
    times), where a fault growing with depth or steps would show."""
    got, jax_runs = runs[:2]
    q, plain_run = got[fp6][0], got[plain][0]
    jq, jplain = jax_runs[fp6], jax_runs[plain]
    assert jq["losses"] != jplain["losses"]      # JAX did quantize
    port = _fp6_gaps(q["losses"], plain_run["losses"], q["master"],
                     plain_run["master"])
    ref = _fp6_gaps(jq["losses"], jplain["losses"], jq["master"],
                    jplain["master"])
    for what, p, j in zip(("final loss", "master"), port, ref):
        assert p <= 2 * j + 1e-6, (what, port, ref)


@pytest.mark.parametrize("stage", (0, 1, 2))
def test_qgz_below_stage3(runs, stage):
    """Stage 0 reduces flat (JAX's micro has no sharded dim there): bit
    for bit; stages 1-2 quantize their reduce-scatters."""
    got = runs[0]
    q, plain = got[f"llama_qgz_z{stage}"], got[f"llama_z{stage}"]
    _ranks_agree(q)
    if stage == 0:
        assert q[0]["losses"] == plain[0]["losses"]
        np.testing.assert_array_equal(q[0]["master"], plain[0]["master"])
        assert q[0]["dispatch"] == {}
        return
    assert q[0]["losses"] != plain[0]["losses"]
    assert abs(q[0]["losses"][-1] - plain[0]["losses"][-1]) < \
        0.25 * abs(plain[0]["losses"][0])
    assert q[0]["dispatch"] == {"reduce_scatter/q_int8": 4 if stage == 1
                                else 4}


def test_fp32_rung_is_the_flat_path(runs):
    got = runs[0]
    rung, plain = got["llama_fp32_rung_z3"], got["llama_z3"]
    for r in range(2):
        assert rung[r]["losses"] == plain[r]["losses"]
        np.testing.assert_array_equal(rung[r]["master"], plain[r]["master"])
    assert set(rung[0]["dispatch"]) == {"all_gather/flat_fallback",
                                        "reduce_scatter/flat_fallback"}


def test_refusals_match_jax(runs):
    got = runs[0]
    want = _jax_refusal(dict(Z3, zero_hpz_partition_size=2,
                             mics_shard_size=4))
    for r in got["refuse_mismatch"]:
        assert r["error"] == "ValueError" and r["message"] == want
    for r in got["refuse_premade"]:
        assert r["error"] == "ValueError"
        assert "zero_partition_size" in r["message"]


def test_qgz_with_sequence_parallelism_is_refused():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    for extra in ({"sequence_parallel_size": 2}, {"mesh": {"sp": 2}},
                  {"pipeline": {"stages": 2}}):
        with pytest.raises(ValueError, match="dp/ep"):
            DeepSpeedConfig(dict(_llama_config(dict({"stage": 2}, **QG)),
                                 **extra))


MICRO_VARIANTS = [
    ({"stage": 3}, None),
    (dict(Z3, overlap_comm=True), None),
    (dict(Z3, stage3_prefetch_bucket_size=100, **QW), None),
    (dict({"stage": 2}, **QG), None),
    (dict(Z3, **QW, **QG), None),
    (dict({"stage": 2}, **QG), {"zero_mode": "flat_manual"}),
]


@pytest.mark.parametrize("i", range(len(MICRO_VARIANTS)))
def test_micro_variant_is_jax_s(i):
    zero, co = MICRO_VARIANTS[i]
    config = {"train_micro_batch_size_per_gpu": 4,
              "optimizer": {"type": "adam", "params": {"lr": 0.02}},
              "zero_optimization": zero}
    if co:
        config["comm_optimizations"] = co
    groups.initialize_mesh(dp=2, devices=jax.devices()[:2])
    try:
        want = deepspeed_tpu.initialize(
            model=simple_mlp_apply,
            model_parameters=make_simple_mlp_params(HIDDEN),
            config=dict(config))[0]._micro_variant()
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
    tree = {k: {p: np.asarray(v) for p, v in d.items()}
            for k, d in make_simple_mlp_params(HIDDEN).items()}
    from torch_dist_worker import _mlp
    model, start = _mlp(tree, "mlp")
    eng = deepspeed_tpu_torch.initialize(model=model, model_parameters=start,
                                         config=config, device="cpu")[0]
    assert eng._micro_variant() == want
    assert eng.zero_plan.describe()["zero_mode"] == \
        (co or {}).get("zero_mode", "gspmd")


def test_teardown_frees_every_buffer():
    """Fault C3: nothing an engine made outlives it.  Stage 3 with qwZ,
    qgZ, overlap and prefetch at one rank: weakrefs on the units' buffers,
    the flat buffers, the coordinator and every collective's handle are
    dead after ``del`` and ``gc.collect()`` (the parameters' gradient
    hooks, which autograd holds where the collector cannot see, used to
    keep the coordinator and its shard alive)."""
    cfg = port_llama.llama_tiny(**LLAMA)
    tree = llama_tree(jax_llama.llama_tiny(**LLAMA), seed=7)
    ids = _llama_batches(1, 3, 1)[0][0]
    for _ in range(2):      # a second engine after the first
        eng = deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(cfg, device="meta"),
            model_parameters=port_llama.params_from_flax(tree, cfg),
            config=_llama_config(dict(Z3, **QW, **QG, **KNOBS)),
            device="cpu")[0]
        handles = []
        comm = eng._zcomm
        gather, reduce = comm.gather_params, comm.reduce_scatter

        def spy(fn):
            def wrapped(*a, **kw):
                h = fn(*a, **kw)
                handles.append(weakref.ref(h))
                return h
            return wrapped

        comm.gather_params, comm.reduce_scatter = spy(gather), spy(reduce)
        for _ in range(2):
            eng.backward(eng(ids, ids))
            eng.step()
        refs = [weakref.ref(t) for t in (
            [u.buffer for u in eng._coord.units] +
            [eng.params, eng.master, eng.grad_acc, eng._coord])
            if t is not None]
        assert handles and len(refs) > 3
        del eng, comm, gather, reduce
        gc.collect()
        assert [r for r in refs if r() is not None] == []
        assert [h for h in handles if h() is not None] == []


# ------------------------------------------------ checkpoints and offload
@pytest.mark.parametrize("kind", ("mics", "hpz"))
def test_shard_group_tag_resumes_bit_for_bit(runs, kind):
    got = runs[0]
    for r in got[f"ckpt_{kind}"]:
        again = r["resumed"]["same"]
        assert again["losses"] == r["losses"]
        for key in ("master", "exp_avg", "exp_avg_sq"):
            for name, a in r["saved"][key].items():
                np.testing.assert_array_equal(again["loaded"][key][name], a)
                np.testing.assert_array_equal(again["final"][key][name],
                                              r["final"][key][name])


@pytest.mark.parametrize("src,dst", [("mics", "z3"), ("hpz", "z3"),
                                     ("z3", "mics"), ("z3", "hpz")])
def test_tags_cross_between_shard_groups_and_zero3(runs, src, dst):
    """The loaded master and moments bit for bit; the next losses within
    2e-4 (MiCS's reduce sums in another order than ZeRO 3's)."""
    got = runs[0]
    for r in got[f"ckpt_{src}"]:
        res = r["resumed"][dst]
        for key in ("master", "exp_avg", "exp_avg_sq"):
            for name, a in r["saved"][key].items():
                np.testing.assert_array_equal(res["loaded"][key][name], a)
        np.testing.assert_allclose(res["losses"], r["losses"], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("kind", ("mics", "hpz"))
def test_shard_group_tag_loads_at_one_rank(runs, kind):
    """MiCS writes one partition a shard (its first group's), hpZ the
    world's; either loads into a one-rank ZeRO-3 engine."""
    import glob
    import os
    got = runs[0]
    r = got[f"ckpt_{kind}"][0]
    legs = _legs4()
    root = os.path.join(runs[2][f"ckpt_{kind}"], "t")
    parts = glob.glob(os.path.join(root, "*optim_states.pt"))
    assert len(parts) == (2 if kind == "mics" else 4)
    from torch_dist_worker import _model, gathered_state
    model, _ = _model("mlp", {}, legs[f"ckpt_{kind}"]["tree"])
    eng = deepspeed_tpu_torch.initialize(
        model=model, config=_mlp_config(Z3), device="cpu")[0]
    eng.load_checkpoint(runs[2][f"ckpt_{kind}"])
    loaded = gathered_state(eng)
    for key in ("master", "exp_avg", "exp_avg_sq"):
        for name, a in r["saved"][key].items():
            np.testing.assert_array_equal(loaded[key][name], a)
    assert loaded["steps"] == r["saved"]["steps"]


@pytest.mark.parametrize("opt", tuple(OFFLOAD_OPTS))
@pytest.mark.parametrize("kind", ("mics", "hpz"))
def test_offload_under_shard_groups_is_bit_equal(runs, kind, opt):
    got = runs[0]
    off, ref = (got[f"mlp_{kind}_{opt}_offload_z3"],
                got[f"mlp_{kind}_{opt}_z3"])
    _ranks_agree(off)
    for r in range(4):
        assert off[r]["losses"] == ref[r]["losses"]
        np.testing.assert_array_equal(off[r]["master"], ref[r]["master"])
    assert off[0]["losses"][-1] < off[0]["losses"][0]
