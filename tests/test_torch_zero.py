"""ZeRO stages 1, 2 and 3 of the port's engine at world size 2 (two gloo
processes on the CPU, ``torch_dist_worker.py``) against the JAX engine at
the same stage on a dp-2 mesh of the 8-device CPU mesh, from the same
numpy weights and the same global batches (rank r feeds rows
``[r·B, (r+1)·B)`` through ``engine.shard_batch``).  Every leg of the
module runs in ONE spawn of the two processes.

* fp32 ``fusedadam`` on ``llama_tiny`` and GPT-2 tiny (and at stage 0,
  whose accumulator is all-reduced): per-step losses rtol
  1e-5, the final master rtol 2e-5 plus lr/20 (GPT-2's key biases left out:
  their gradient is rounding noise, ``test_torch_gpt2_training.py``);
* bf16 with ``gradient_accumulation_steps`` 2: losses rtol 1e-2;
* the loss over the global batch: an attention mask (Llama) and -100
  labels (BERT) that count a different number of tokens on each rank; a
  model without ``loss_reduction`` (so a mean of the ranks' means) misses
  JAX's losses, which shows the case can tell the two apart;
* ``gradient_clipping`` far below the norm (the norm over every shard);
* fp16 from a scale of 2^32: JAX's skip pattern and scales; and a
  non-finite gradient on one rank only: both ranks skip, their scales stay
  equal, their parameters equal;
* Lion at stage 1 (``test_torch_gpt2_training.py``'s Lion rule);
* the world-2 runs against the port's own world-1 ZeRO-0 run at the same
  global batch; the plan's shard sizes and the collectives a step;
* LAMB at stages 1, 2 and 3 (each leaf's sums over the ranks);
* stage 3 (``Z3``: blocks sharded, nothing persistent) in fp32, bf16 with
  accumulation, under remat (the recompute re-enters the gather), with
  clipping, with fp16 and a non-finite gradient on one rank, with LAMB;
  ``overlap_comm``, several prefetch buckets, a live window of 1 and a
  persistence threshold that keeps the norms whole give the same master
  bit for bit (every element's sum is a + b whatever the bucketing), and
  the gathered elements stay within the window; bucketed stage 2
  (``overlap_comm``) is stage 2 bit for bit;
* the ported bucket functions against the JAX file's on the same items;
* the configs that used to raise item 6 build and step, and the engine
  methods the port lacks name their item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from test_torch_bert import flax_tree as bert_tree
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

SEQ, WORLD, MB = 16, 2, 2
LLAMA = dict(dtype="float32", remat=False, num_key_value_heads=4)
GPT2 = dict(dtype="float32", remat=False)
# stage 3 with every leaf sharded: the tiny models' leaves all sit below
# the default persistence threshold (1e5 // 8 elements)
Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}
# overlap_comm, prefetch buckets of 3000 bf16-or-fp32 elements (one block
# each), a live budget below two blocks (window 1) and the norms whole
KNOBS = dict(Z3, overlap_comm=True, stage3_prefetch_bucket_size=3000,
             stage3_max_live_parameters=40000,
             stage3_param_persistence_threshold=8 * 100)


def _config(stage, lr=2e-3, opt="fusedadam", **extra):
    zero = stage if isinstance(stage, dict) else {"stage": stage}
    return {"train_micro_batch_size_per_gpu": MB,
            "optimizer": {"type": opt, "params": {"lr": lr}},
            "zero_optimization": zero,
            "comms_logger": {"enabled": True}, **extra}


def _ids(n, seed, rows=WORLD * MB):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(rows, SEQ)).astype(np.int32)
            for _ in range(n)]


def _lm_batches(n, seed, mask=False):
    out = []
    for i, ids in enumerate(_ids(n, seed)):
        if not mask:
            out.append((ids, ids))
            continue
        # rank 0's rows keep almost every token, rank 1's about a quarter
        rng = np.random.default_rng(seed + 100 + i)
        m = np.ones_like(ids)
        m[MB:] = rng.random((MB, SEQ)) < 0.25
        m[MB:, :2] = 1
        out.append((ids, ids, m))
    return out


def _bert_batches(n, seed):
    out = []
    for i, ids in enumerate(_ids(n, seed)):
        rng = np.random.default_rng(seed + 200 + i)
        rate = np.where(np.arange(WORLD * MB)[:, None] < MB, 0.4, 0.1)
        labels = np.where(rng.random(ids.shape) < rate, ids, -100)
        labels[:, 0] = ids[:, 0]
        out.append((ids, labels.astype(np.int32)))
    return out


def _legs():
    """{name: leg}: each is run by the JAX engine (unless ``port_only``)
    and by the port's two ranks."""
    lt = llama_tree(jax_llama.llama_tiny(**LLAMA), seed=7)
    gt = gpt2_tree(7)
    bt = bert_tree(jax_bert.bert_tiny(), seed=9)
    legs = {}
    zero = {0: 0, 1: 1, 2: 2, 3: Z3}
    for stage in (0, 1, 2, 3):
        legs[f"llama_fp32_z{stage}"] = dict(
            model="llama", cfg=LLAMA, tree=lt, config=_config(zero[stage]),
            batches=_lm_batches(3, 11))
        legs[f"gpt2_fp32_z{stage}"] = dict(
            model="gpt2", cfg=GPT2, tree=gt, config=_config(zero[stage]),
            batches=_lm_batches(3, 12))
    legs["llama_knobs_z3"] = dict(legs["llama_fp32_z3"],
                                  config=_config(KNOBS), port_only=True)
    # the default live budget: a window of two buckets
    legs["llama_prefetch2_z3"] = dict(legs["llama_fp32_z3"], port_only=True,
                                      config=_config(dict(
                                          Z3, stage3_prefetch_bucket_size=1)))
    legs["llama_z2_overlap"] = dict(
        legs["llama_fp32_z2"], port_only=True,
        config=_config({"stage": 2, "overlap_comm": True}))
    legs["llama_remat_z3"] = dict(
        model="llama", cfg=dict(LLAMA, remat=True), tree=lt,
        config=_config(Z3), batches=_lm_batches(3, 11))
    for stage in (1, 2, 3):
        legs[f"llama_bf16_gas2_z{stage}"] = dict(
            model="llama", cfg=dict(LLAMA, dtype="bfloat16"), tree=lt,
            config=_config(zero[stage], gradient_accumulation_steps=2,
                           bf16={"enabled": True}),
            batches=_lm_batches(6, 13))
    legs["llama_counts_z2"] = dict(
        model="llama", cfg=LLAMA, tree=lt, config=_config(2),
        batches=_lm_batches(3, 14, mask=True))
    legs["llama_counts_mean_only_z2"] = dict(
        legs["llama_counts_z2"], mean_only=True, port_only=True)
    legs["bert_counts_z1"] = dict(
        model="bert", cfg={}, tree=bt, config=_config(1),
        batches=_bert_batches(3, 15))
    for stage in (0, 2, 3):
        legs[f"llama_clip_z{stage}"] = dict(
            model="llama", cfg=LLAMA, tree=lt,
            config=_config(zero[stage], gradient_clipping=0.05),
            batches=_lm_batches(3, 16))
    legs["gpt2_fp16_z1"] = dict(
        model="gpt2", cfg=dict(GPT2, dtype="float16"), tree=gt,
        config=_config(1, lr=1e-3, fp16={
            "enabled": True, "initial_scale_power": 32, "hysteresis": 1,
            "loss_scale_window": 3}),
        batches=_lm_batches(24, 17))
    for stage in (1, 2, 3):
        legs[f"gpt2_fp16_poison_z{stage}"] = dict(
            model="gpt2", cfg=dict(GPT2, dtype="float16"), tree=gt,
            config=_config(zero[stage], lr=1e-3, fp16={
                "enabled": True, "initial_scale_power": 8}),
            batches=_lm_batches(3, 18), poison={1: 1}, port_only=True)
    lamb = {"type": "fusedlamb", "params": {"lr": 2e-3,
                                            "weight_decay": 0.01}}
    for stage in (1, 2, 3):
        legs[f"gpt2_lamb_z{stage}"] = dict(
            model="gpt2", cfg=GPT2, tree=gt,
            config=dict(_config(zero[stage]), optimizer=lamb,
                        gradient_clipping=1.0),
            batches=_lm_batches(4, 20))
    legs["llama_lion_z1"] = dict(
        model="llama", cfg=LLAMA, tree=lt, config=_config(1, 1e-3, "lion"),
        batches=_lm_batches(4, 19))
    for name, leg in legs.items():
        leg.update(name=name, kind="train")
    return legs


def _jax_model(kind, cfg):
    if kind == "llama":
        return jax_llama.LlamaModel(jax_llama.llama_tiny(**cfg))
    if kind == "gpt2":
        return jax_gpt2.GPT2Model(jax_gpt2.gpt2_tiny(**cfg))
    return jax_bert.BertModel(jax_bert.bert_tiny(**cfg))


def _port_names(kind, cfg, tree):
    mod = {"llama": (port_llama, "llama_tiny"), "gpt2": (port_gpt2,
                                                         "gpt2_tiny"),
           "bert": (port_bert, "bert_tiny")}[kind]
    return mod[0].params_from_flax(tree, getattr(mod[0], mod[1])(**cfg),
                                   dtype="float32")


def _jax_run(leg):
    groups.initialize_mesh(dp=WORLD, devices=jax.devices()[:WORLD])
    try:
        eng = deepspeed_tpu.initialize(
            model=_jax_model(leg["model"], leg["cfg"]),
            model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                    leg["tree"]),
            config=dict(leg["config"]))[0]
        losses, scales, skips, gnorms = [], [], [], []
        report = eng._report_step_metrics     # sees each boundary's norm

        def record(gnorm):
            gnorms.append(float(gnorm))
            report(gnorm)

        eng._report_step_metrics = record
        for batch in leg["batches"]:
            done = eng.skipped_steps
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
            if eng.micro_steps % eng.gradient_accumulation_steps() == 0:
                scales.append(float(eng.cur_scale))
                skips.append(eng.skipped_steps != done)
        master = _port_names(leg["model"], leg["cfg"], jax.tree_util.tree_map(
            np.asarray, eng.get_fp32_param()))
        return dict(losses=losses, scales=scales, skips=skips,
                    gnorms=gnorms, master=master)
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """{leg: (JAX's result or None, [rank 0's, rank 1's])}."""
    legs = _legs()
    want = {n: None if leg.get("port_only") else _jax_run(leg)
            for n, leg in legs.items()}
    got = spawn(WORLD, list(legs.values()), timeout=420)
    return {n: (want[n], got[n]) for n in legs}, legs


def _leaves(res):
    return {n: torch.from_numpy(res["master"][o:o + k].reshape(s))
            for n, o, k, s in res["names"]}


def _check_master(got, want, lr, skip_key_bias=True):
    assert set(got) == set(want)
    for name, w in want.items():
        if skip_key_bias and name.endswith("k_proj.bias"):
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-5,
                                   atol=lr / 20, err_msg=name)


def _ranks_agree(res):
    """Every rank reports the same losses and holds the same parameters."""
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_array_equal(r["params"], res[0]["params"])
        np.testing.assert_array_equal(r["master"], res[0]["master"])


@pytest.mark.parametrize("stage", (0, 1, 2, 3))
@pytest.mark.parametrize("model", ("llama", "gpt2"))
def test_fp32_fusedadam_matches_jax(runs, model, stage):
    """Stage 0 at world 2 all-reduces the whole accumulator instead."""
    (want, got), legs = runs[0][f"{model}_fp32_z{stage}"], runs[1]
    _ranks_agree(got)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
    _check_master(_leaves(got[0]), want["master"], 2e-3)


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_bf16_grad_accumulation_matches_jax(runs, stage):
    want, got = runs[0][f"llama_bf16_gas2_z{stage}"]
    _ranks_agree(got)
    assert len(got[0]["losses"]) == 6 and len(got[0]["scales"]) == 3
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-2)


@pytest.mark.parametrize("leg", ("llama_counts_z2", "bert_counts_z1"))
def test_loss_over_the_global_batch_matches_jax(runs, leg):
    (want, got), legs = runs[0][leg], runs[1]
    batches = legs[leg]["batches"]
    # the ranks count different numbers of tokens in every batch
    for b in batches:
        counted = (b[2][:, 1:] if len(b) == 3 else b[1] >= 0)
        assert counted[:MB].sum() != counted[MB:].sum()
    _ranks_agree(got)
    assert got[0]["global_loss"]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
    leaves = _leaves(got[0])
    if leg.startswith("bert"):
        # BERT's key biases: rounding-noise gradients (test_torch_bert.py)
        want = {n: w for n, w in want["master"].items()
                if not n.endswith("key.bias")}
        leaves = {n: leaves[n] for n in want}
        for name, w in want.items():
            diff = (leaves[name] - w).abs()
            apart = diff > 2e-5 * w.abs() + 2e-3 / 20
            assert apart.float().mean().item() <= 1e-3, name
        return
    _check_master(leaves, want["master"], 2e-3)
    if leg == "llama_counts_z2":
        # the mean of the ranks' means is another number
        mean_only = runs[0]["llama_counts_mean_only_z2"][1][0]
        assert not mean_only["global_loss"]
        gap = np.abs(np.array(mean_only["losses"]) - want["losses"])
        assert gap.max() > 1e-3


@pytest.mark.parametrize("leg", ("llama_clip_z0", "llama_clip_z2",
                                 "llama_clip_z3"))
def test_clipping_takes_the_norm_over_every_shard(runs, leg):
    """The global norm (over the shards at stage 2; of the all-reduced
    gradient at stage 0) is JAX's at every step, and clips as JAX's."""
    want, got = runs[0][leg]
    _ranks_agree(got)
    assert got[0]["gnorms"] == got[1]["gnorms"]
    assert len(want["gnorms"]) == 3 and min(want["gnorms"]) > 20 * 0.05
    np.testing.assert_allclose(got[0]["gnorms"], want["gnorms"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
    _check_master(_leaves(got[0]), want["master"], 2e-3)


def test_fp16_skip_pattern_matches_jax(runs):
    want, got = runs[0]["gpt2_fp16_z1"]
    _ranks_agree(got)
    for r in got:
        assert r["skips"] == want["skips"] and r["scales"] == want["scales"]
    assert 0 < sum(want["skips"]) < len(want["skips"])


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_fp16_nonfinite_on_one_rank_skips_on_both(runs, stage):
    _, got = runs[0][f"gpt2_fp16_poison_z{stage}"]
    for r in got:
        assert r["skips"] == [False, True, False]
        assert r["skipped_steps"] == 1
    assert got[0]["scales"] == got[1]["scales"]
    _ranks_agree(got)


def test_lion_stage1_matches_jax(runs):
    want, got = runs[0]["llama_lion_z1"]
    _ranks_agree(got)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
    start = _port_names("llama", LLAMA, runs[1]["llama_lion_z1"]["tree"])
    lr = 1e-3
    for name, w in want["master"].items():
        p = _leaves(got[0])[name]
        share = ((p - w).abs() > lr / 2).float().mean().item()
        move = w - start[name]
        rel = ((p - start[name] - move).norm() / move.norm()).item()
        assert share <= 1e-2 and rel <= 0.2, (name, share, rel)


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_world2_equals_world1_zero0(runs, stage):
    """The port's own world-size-1 ZeRO-0 run at the same global batch."""
    leg = runs[1][f"llama_fp32_z{stage}"]
    config = dict(leg["config"], train_micro_batch_size_per_gpu=WORLD * MB,
                  zero_optimization={"stage": 0})
    model, start = (port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                          device="meta"),
                    _port_names("llama", LLAMA, leg["tree"]))
    eng = deepspeed_tpu_torch.initialize(model=model, model_parameters=start,
                                         config=config, device="cpu")[0]
    assert eng.dp_world_size == 1
    losses = []
    for batch in leg["batches"]:
        loss = eng(*batch)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    got = runs[0][f"llama_fp32_z{stage}"][1][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _check_master(_leaves(got), {n: eng.get_fp32_param(n) for n in start},
                  2e-3)


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_plan_shards_and_collectives(runs, stage):
    got = runs[0][f"llama_bf16_gas2_z{stage}"][1]
    plan = got[0]["plan"]
    assert plan["stage"] == stage and plan["world_size"] == WORLD
    assert plan["padded_numel"] % (WORLD * 16) == 0
    assert plan["shard_numel"] * WORLD == plan["padded_numel"]
    assert plan["ignored"] == {}     # the config sets no bucket knob
    # 3 boundaries of 2 micro-steps: the loss and the norm are
    # all-reduced; the gathers and reduce-scatters are the plan's
    counts = got[0]["counts"]
    assert counts["all_reduce"] == 6 + 3
    assert {k: counts[k] for k in got[0]["per_step"]} == {
        k: 3 * n for k, n in got[0]["per_step"].items()}
    if stage == 3:
        # 1 outer + 2 blocks; gathered: outer and blocks forward, blocks
        # backward; every unit reduce-scattered each micro-step
        assert plan["unit_kinds"] == {"outer": 1, "block": 2,
                                      "persistent": 0}
        assert plan["param_axes"] == ["dp", "ep"]
        assert plan["shard_range"] is None
        assert got[0]["per_step"] == {"allgather_fn": 2 * (1 + 2 * 2),
                                      "reduce_scatter_fn": 2 * 3}
        assert got[0]["grad_acc_numel"] == plan["shard_numel"]
        assert plan["replicated_bytes"] == 0
        return
    assert [r["plan"]["shard_range"] for r in got] == [
        [0, plan["shard_numel"]], [plan["shard_numel"],
                                   plan["padded_numel"]]]
    # stage 2 keeps a shard-sized accumulator, stage 1 a full one
    want_acc = plan["shard_numel"] if stage == 2 else plan["padded_numel"]
    assert got[0]["grad_acc_numel"] == want_acc
    # stage 1 reduce-scatters once a boundary, stage 2 once a micro-step;
    # one in-place gather a step
    assert counts["reduce_scatter_fn"] == (3 if stage == 1 else 6)
    assert counts["allgather_fn"] == 3


@pytest.mark.parametrize("world", (1, 2, 3, 4))
def test_partition_plan_covers_every_leaf_once(world):
    """Rank r's slice of the padded buffer: equal, 16-element aligned
    shards whose leaf pieces, over every rank, cover each leaf once."""
    from deepspeed_tpu_torch.runtime.engine import flat_layout
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartitionPlan
    model = port_gpt2.GPT2Model(port_gpt2.gpt2_tiny(), device="meta")
    layout, n = flat_layout((k, p.shape) for k, p in
                            model.named_parameters())
    covered = {}
    for rank in range(world):
        plan = ZeroPartitionPlan(1, world, rank, n)
        lo, hi = plan.shard_range()
        assert plan.padded_numel % (16 * world) == 0
        assert plan.padded_numel >= n and hi - lo == plan.shard_numel
        assert lo % 16 == 0
        for off, k, within in plan.leaf_pieces(layout):
            assert 0 <= off and off + k <= plan.shard_numel
            for name, o, numel, _ in layout:
                if o <= lo + off < o + numel:
                    assert lo + off - o == within
                    covered[name] = covered.get(name, 0) + k
    assert covered == {name: numel for name, _, numel, _ in layout}
    z0 = ZeroPartitionPlan(0, world, 0, n)
    assert z0.shard_range() == (0, z0.padded_numel) and not z0.sharded
    d = ZeroPartitionPlan(2, world, 0, n).describe(param_bytes=2)
    full, shard = d["padded_numel"], d["shard_numel"]
    assert d["sharded_bytes"] == shard * 4 * 3 + shard * 4
    assert d["replicated_bytes"] == full * 2


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_lamb_sums_each_leaf_over_the_ranks(runs, stage):
    """LAMB's trust ratio is per leaf; a leaf straddles the two ranks'
    shards (at stage 3: the two ranks' slices of a unit), so its pieces'
    sums are summed over the ranks (``test_torch_gpt2_training.py``'s LAMB
    rule for the master)."""
    want, got = runs[0][f"gpt2_lamb_z{stage}"]
    names = got[0]["names"]
    if stage == 3:
        sizes = got[0]["live"]["unit_numel"]
        bounds = [sum(sizes[:u]) + sizes[u] // 2 for u in range(len(sizes))]
    else:
        bounds = [got[0]["plan"]["shard_numel"]]
    assert any(o < b < o + k for _, o, k, _ in names
               for b in bounds)  # one straddles
    _ranks_agree(got)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
    _check_master(_leaves(got[0]), want["master"], 2e-3)


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_lamb_at_world1_equals_zero0(stage):
    """At one rank the pieces are the whole leaves: ZeRO-1/2/3 LAMB takes
    the fused two-phase call and equals ZeRO-0 bit for bit, leaf by leaf
    (stage 3 lays the leaves out unit by unit)."""
    tree = gpt2_tree(3)
    cfg = port_gpt2.gpt2_tiny(**GPT2)
    params = []
    for st in (0, stage):
        eng = deepspeed_tpu_torch.initialize(
            model=port_gpt2.GPT2Model(cfg, device="meta"),
            model_parameters=port_gpt2.params_from_flax(tree, cfg),
            config=dict(_config(Z3 if st == 3 else st),
                        optimizer={"type": "fusedlamb",
                                   "params": {"lr": 2e-3}}),
            device="cpu")[0]
        assert eng.opt_state.reduce_sums is None   # the fused call
        for ids in _ids(3, 4, rows=MB):
            eng.backward(eng(ids, ids))
            eng.step()
        params.append({n: eng.get_fp32_param(n) for n in
                       eng.parameter_names()})
    assert params[0].keys() == params[1].keys()
    for name, p in params[0].items():
        assert torch.equal(p, params[1][name]), name


def test_lamb_piece_sums_stay_on_the_device():
    """The kernel route's per-piece sums of phase 1's chunk partials: each
    piece's rows summed in order in float64 on the partials' device, as a
    host ``np.add.reduceat`` over the same rows gives them."""
    from deepspeed_tpu_torch.ops.kernels.optimizers import LambTable
    from deepspeed_tpu_torch.ops.lamb import piece_sums
    table = LambTable([(0, 20), (20, 4), (24, 36), (60, 8)], chunk=8)
    assert table.n_chunks == 3 + 1 + 5 + 1
    rng = np.random.default_rng(5)
    partials = torch.from_numpy(rng.standard_normal(
        (table.n_chunks + 2, 2)).astype(np.float32))   # rows past the table
    got = piece_sums(partials, table)
    firsts = table.leaf_chunks.numpy()[:-1]
    want = np.add.reduceat(partials[:table.n_chunks].double().numpy(),
                           firsts, axis=0).astype(np.float32)
    assert got.dtype == torch.float32 and got.device == partials.device
    np.testing.assert_array_equal(got.numpy(), want)
    assert piece_sums(partials, LambTable([])).shape == (0, 2)


@pytest.mark.parametrize("stage", (0, 2))
def test_one_rank_engine_brings_up_no_world(monkeypatch, stage):
    """Without a world asked for, described by the environment or already
    up, an engine is one rank on a local group: no process-wide backend is
    pinned (a CUDA engine could follow a CPU one), and it steps.  Once a
    gloo world is up, an engine on the CPU joins it."""
    from deepspeed_tpu_torch import comm as port_dist
    for var in ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    port_dist.destroy_process_group()

    def engine():
        return deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                        device="meta"),
            config=_config(stage), device="cpu")[0]

    eng = engine()
    eng.initialize_parameters(0)
    ids = _ids(1, 6, rows=MB)[0]
    eng.backward(eng(ids, ids))
    eng.step()
    assert eng._dp_group.local and eng.dp_world_size == 1
    assert eng.grad_acc.numel() == eng.zero_plan.shard_numel
    assert not torch.distributed.is_initialized()
    assert not port_dist.is_initialized()
    port_dist.init_distributed(dist_backend="gloo", verbose=False)
    assert not port_dist.world_is_up("nccl")    # one gloo rank: not NCCL's
    assert not engine()._dp_group.local


# the configs that raised ROADMAP item 6 before stage 3 was ported
ITEM6_ZERO = {
    "stage3": {"stage": 3},
    "overlap_comm": {"stage": 2, "overlap_comm": True},
    "stage3_knob": {"stage": 2, "stage3_max_live_parameters": 10},
    "overlap_comm_stage0": {"overlap_comm": True},
    "stage3_knobs": dict(KNOBS),
    "stage3_remat": dict(Z3),
    "stage3_bf16": {"stage": 3, "stage3_prefetch_bucket_size": 0},
}


@pytest.mark.parametrize("case", sorted(ITEM6_ZERO))
def test_item6_configs_build_and_step(case):
    """Each builds an engine on the CPU and takes one step; what the stage
    does not act on is listed as ignored."""
    zero = ITEM6_ZERO[case]
    cfg = dict(LLAMA, remat=case == "stage3_remat",
               dtype="bfloat16" if case == "stage3_bf16" else "float32")
    extra = {"bf16": {"enabled": True}} if case == "stage3_bf16" else {}
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**cfg),
                                    device="meta"),
        config=_config(zero, **extra), device="cpu")[0]
    eng.initialize_parameters(0)
    before = eng.fp32_params().clone()
    ids = _ids(1, 5, rows=MB)[0]
    loss = eng(ids, ids)
    eng.backward(loss)
    eng.step()
    assert np.isfinite(float(loss)) and eng.global_steps == 1
    assert not torch.equal(before, eng.fp32_params())
    desc = eng.zero_plan.describe()
    stage = zero.get("stage", 0)
    assert desc["stage"] == stage
    if stage < 2 and zero.get("overlap_comm"):
        assert desc["ignored"]["overlap_comm"] is True
    if stage < 3 and "stage3_max_live_parameters" in zero:
        assert desc["ignored"] == {"max_live_parameters": 10}
    # a prefetch bucket size of 0 does not arm the prefetch
    assert desc["prefetch_enabled"] == (case == "stage3_knobs")


def test_empty_partition_cache_releases_every_unit():
    """Every unit but the persistent one is left with a storage of size 0,
    and the next step gathers what it needs again."""
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                    device="meta"),
        config=_config(KNOBS), device="cpu")[0]
    eng.initialize_parameters(0)
    ids = _ids(1, 6, rows=MB)[0]
    eng.backward(eng(ids, ids))
    eng.step()
    coord = eng._coord
    for u in coord.units:
        coord.gather(u)
        assert u.buffer.untyped_storage().size() > 0
    eng.empty_partition_cache()
    kinds = set()
    for u in coord.units:
        kinds.add(u.kind)
        size = u.buffer.untyped_storage().size()
        if u.kind == "persistent":
            assert size == u.buffer.numel() * u.buffer.element_size()
        else:
            assert size == 0, u.kind
    assert kinds == {"outer", "block", "persistent"}
    assert coord.live_elems == sum(u.buffer.numel() for u in coord.units
                                   if u.kind == "persistent")
    loss = eng(ids, ids)
    eng.backward(loss)
    eng.step()
    assert np.isfinite(float(loss))


def test_zero_knobs_parse_and_shard_batch_checks_rows():
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                    device="meta"),
        config=dict(_config(2), zero_optimization={
            "stage": 2, "reduce_bucket_size": 2e8,
            "allgather_bucket_size": 2e8, "contiguous_gradients": True,
            "overlap_comm": False}, wall_clock_breakdown=True,
            mesh={"dp": 1}),
        dist_init_required=True, device="cpu")[0]
    assert eng.zero_optimization_stage() == 2 and eng.zero_optimization()
    eng.initialize_parameters(0)
    desc = eng.zero_plan.describe()
    assert desc["ignored"] == {"reduce_bucket_size": 2e8,
                               "allgather_bucket_size": 2e8,
                               "contiguous_gradients": True}
    assert "one collective" in desc["ignored_because"]
    ids = _ids(1, 3, rows=2)[0]
    (mine, ) = eng.shard_batch(ids)
    assert torch.equal(mine, torch.from_numpy(ids))
    loss = eng(ids, ids)
    eng.backward(loss)
    eng.step()
    assert eng.timers("fwd").mean() > 0 and eng.timers("step").mean() > 0
    eng.dp_world_size = 3     # as a world of 3 would see it
    with pytest.raises(ValueError, match="not divisible by the data-parallel"
                                         " degree 3"):
        eng.shard_batch(ids)
    with pytest.raises(ValueError, match="mesh dp=2"):
        deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                        device="meta"),
            config=_config(1), mesh_param=(2, 1), device="cpu")


STUBS = {
    "register_param_transform": ((lambda p: p, ), 4),
    "register_post_step_hook": ((lambda e: None, ), 4),
    "compile": ((), 4),
    "is_compiled": ((), 4),
    "start_device_trace": (("trace_dir", ), 12),
    "stop_device_trace": ((), 12),
    "compute_block_eigenvalues": ((), 11),
}


@pytest.fixture(scope="module")
def small_engine():
    return deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(port_llama.llama_tiny(**LLAMA),
                                    device="meta"),
        config=_config(0), device="cpu")[0]


@pytest.mark.parametrize("method", sorted(STUBS))
def test_unported_engine_methods_name_their_item(small_engine, method):
    import deepspeed_tpu.runtime.engine as jax_engine
    assert hasattr(jax_engine.DeepSpeedEngine, method)
    args, item = STUBS[method]
    with pytest.raises(NotImplementedError, match=rf"queue A, item {item}\)"):
        getattr(small_engine, method)(*args)


def test_stage3_knobs_and_bucketed_stage2_are_bit_equal(runs):
    """At world 2 every element's gradient is a + b whatever the units,
    buckets, window or persistent leaves: ``overlap_comm``, prefetch and a
    persistence threshold give stage 3's master bit for bit, and bucketed
    stage 2 (``overlap_comm``) gives stage 2's."""
    for leg, ref in (("llama_knobs_z3", "llama_fp32_z3"),
                     ("llama_prefetch2_z3", "llama_fp32_z3"),
                     ("llama_z2_overlap", "llama_fp32_z2")):
        got, want = runs[0][leg][1], runs[0][ref][1]
        _ranks_agree(got)
        assert got[0]["losses"] == want[0]["losses"], leg
        a, b = _leaves(got[0]), _leaves(want[0])
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), (leg, name)
    knobs = runs[0]["llama_knobs_z3"][1][0]
    assert knobs["plan"]["unit_kinds"] == {"outer": 1, "block": 2,
                                           "persistent": 1}
    assert knobs["plan"]["overlap_enabled"] and \
        knobs["plan"]["prefetch_enabled"]
    assert knobs["plan"]["min_partition_size"] == 100
    assert runs[0]["llama_z2_overlap"][1][0]["plan"]["units"] == 3


@pytest.mark.parametrize("leg, window", (("llama_knobs_z3", 1),
                                         ("llama_prefetch2_z3", 2)))
def test_gathered_elements_stay_within_the_window(runs, leg, window):
    """The coordinator's peak of gathered (or in-flight) elements: at most
    the outer unit, the persistent unit and ``window`` consecutive
    prefetch buckets."""
    for r in runs[0][leg][1]:
        live = r["live"]
        assert live["window"] == window
        assert len(live["bucket_elems"]) == 2          # one block each
        fixed = sum(n for n, k in zip(live["unit_numel"], live["unit_kinds"])
                    if k in ("outer", "persistent"))
        elems = live["bucket_elems"]
        widest = max(sum(elems[k:k + window])
                     for k in range(len(elems) - window + 1))
        # the window of 2 holds both blocks at once, that of 1 one block
        assert live["peak"] == fixed + widest


def test_bucket_functions_match_jax():
    """The port's partitioner, live window and persistence split against
    ``deepspeed_tpu.runtime.zero.overlap``'s on the same items."""
    from jax.sharding import Mesh
    from deepspeed_tpu.runtime.zero import overlap as jax_overlap
    from deepspeed_tpu.runtime.zero.partition import \
        ZeroPartitionPlan as JaxPlan
    from deepspeed_tpu_torch.runtime.zero import overlap as port_overlap
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 400, size=23) * 2
    items = [(f"l{i}", np.zeros((int(n), ), np.float32))
             for i, n in enumerate(sizes)]
    items.append(("big", np.zeros((4096, ), np.float32)))
    skip = {"l3", "l7", "big"}
    for bucket_bytes in (1, 600, 1500, 4096, 10 ** 6):
        for skipped in ((), skip):
            want = jax_overlap.partition_prefetch_buckets(items, bucket_bytes,
                                                          skip=skipped)
            got = port_overlap.partition_prefetch_buckets(
                items, bucket_bytes, skip=skipped)
            assert [(b.index, b.indices, b.paths, b.nbytes, b.elems)
                    for b in got] == [(b.index, b.indices, b.paths,
                                       b.nbytes, b.elems) for b in want]
            for budget in (0, -1, 1, 300, 900, 2500, 10 ** 9):
                for inflight in (1, 2, 3, 8):
                    assert port_overlap.live_window(got, budget, inflight) \
                        == jax_overlap.live_window(want, budget, inflight)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD), ("dp", ))
    for min_size in (1, 100, 500, 10 ** 6):
        plan = JaxPlan(stage=3, mesh=mesh, zero_axes=("dp", ),
                       min_partition_size=min_size)
        tree = {p: x for p, x in items}
        want_items, want = jax_overlap.gather_items(tree, plan)
        got_items, got = port_overlap.gather_items(
            [(p, x) for p, x in want_items], min_size)
        assert got == want and len(got_items) == len(want_items)


@pytest.mark.parametrize("world", (1, 2, 3, 4))
def test_stage3_plan_covers_every_leaf_once(world):
    """The stage-3 plan of GPT-2 tiny (outer, blocks, persistent unit):
    every element of every leaf lies in exactly one rank's slice, each
    slice 16-element aligned, and the persistent leaves are whole in their
    unit on every rank."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = dict(_config({"stage": 3,
                        "stage3_param_persistence_threshold": 8 * 200}),
               train_micro_batch_size_per_gpu=1)
    covered, persistent = {}, None
    for rank in range(world):
        eng = deepspeed_tpu_torch.initialize(
            model=port_gpt2.GPT2Model(port_gpt2.gpt2_tiny(**GPT2),
                                      device="meta"),
            config=DeepSpeedConfig(cfg), device="cpu")[0]
        eng.dp_world_size, eng.dp_rank = world, rank
        eng._install_parameters()
        plan, layout = eng.zero_plan, eng._layout
        assert plan.padded_numel % (16 * world) == 0
        assert plan.shard_numel * world == plan.padded_numel
        for u in range(plan.n_units):
            lo, hi = plan.unit_slice(u)
            assert lo % 16 == 0 and hi - lo == plan.slice_numel[u]
        for off, k, within, i in plan.pieces(layout):
            name, o, numel, _ = layout[i]
            assert 0 <= off and off + k <= plan.shard_numel
            assert within + k <= numel
            covered[name] = covered.get(name, 0) + k
        (unit, ) = [u for u in eng._coord.units if u.kind == "persistent"]
        whole = {n for n, *_ in unit.leaves}
        assert whole and all(eng.module.get_parameter(n).numel() < 200
                             for n in whole)
        assert persistent in (None, whole)
        persistent = whole
        assert unit.buffer.untyped_storage().size() == \
            unit.buffer.numel() * unit.buffer.element_size()
    assert covered == {name: numel for name, _, numel, _ in layout}
