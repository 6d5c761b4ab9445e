"""Tensor parallelism composed with the other axes in the port (the tp
axis of ``utils/groups.py`` with sp, pp and hpZ; ``runtime/pipe`` at tp),
against the JAX package on its CPU mesh; one gloo spawn of four ranks.

* Groups: at (tp 2, sp 2), (tp 2, pp 2) and (tp 2, dp 2, hpZ 2) each
  rank's coordinates and its tp, data, sp, pp and zp groups are the
  device ids along the same axes of JAX's mesh (JAX's hpZ mesh for zp):
  tp innermost, an sp or pp group striding over the tp groups.
* tp 2 × sp 2 (Ulysses): ``llama_tiny`` and an uneven-head config (h 6,
  kv 2, so 3 q heads and 1 kv head a tp rank, which Ulysses pads and
  routes) against JAX's engine on the same mesh (``test_ulysses.py``'s
  dp × sp × tp setting): per-step losses at rtol 2e-4 / atol 1e-5, the
  final master at rtol 2e-5 + lr/20.
* pp 2 × tp 2: ``test_pipe_engine.py:test_pp_tp_dp_composition``'s model
  and rules (its ``TPBlock``, ``up`` column- and ``down`` row-parallel,
  on JAX's stacked-block rule keys) against JAX's ``PipelineEngine`` on
  the same mesh from JAX's initial weights: losses at rtol 1e-5, every
  stage's master (its tp slices gathered) at rtol 2e-5 + lr/20.
* hpZ and MiCS at tp 2 × dp 2 (ZeRO 3, ``zero_hpz_partition_size`` or
  ``mics_shard_size`` 2) against JAX's engine on the same mesh, by the
  training rule above; hpZ's groups over a device subset as JAX's
  (ranks outside it hold local groups).
* GPT-2's ``pipeline_module`` at pp 2 × tp 2 (``pipeline_tp_rules``, the
  tied ``wte`` sharded on both stages) against pp 2 × dp 2 from the same
  seed (no JAX twin): losses at 1e-5, the masters by the training rule.
* Facts of the reference kept as refusals: the 1-bit optimizers refuse
  tp (JAX's ``check_compatible``, at its first forward; the same
  ``ValueError`` on both sides); parameter streaming places every
  fetched block replicated over the mesh in JAX (``_rep_sharding`` is
  ``P()`` on a tp 2 mesh), so the port refuses streaming at tp > 1.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.pipe import module as jax_module
from deepspeed_tpu.utils import groups as jax_groups
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime.pipe.module import params_from_flax
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import pipe_module, spawn
from unit.runtime.pipe import test_pipe_engine as jpe

WORLD, SEQ, ROWS, LR = 4, 16, 8, 1e-3
CFG = dict(dtype="float32", remat=False)
UNEVEN = dict(vocab_size=64, hidden_size=48, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=6,
              num_key_value_heads=2, max_position_embeddings=64,
              dtype="float32", remat=False, tie_word_embeddings=False)
Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}


def _cfgs(kind):
    over = dict(CFG if kind == "tiny" else UNEVEN, use_ulysses=True)
    return jax_llama.llama_tiny(**over), port_llama.llama_tiny(**over)


def _batches(n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [(x, x) for x in (rng.integers(0, vocab, size=(ROWS, SEQ))
                             .astype(np.int32) for _ in range(n))]


def _config(mesh, zero=1, **extra):
    dp = WORLD // (mesh.get("tp", 1) * mesh.get("sp", 1) *
                   mesh.get("pp", 1))
    return {"train_micro_batch_size_per_gpu": ROWS // dp,
            "optimizer": {"type": "adam", "params": {"lr": LR}},
            "zero_optimization": zero if isinstance(zero, dict)
            else {"stage": zero}, "mesh": dict(mesh), **extra}


# ------------------------------------------------------------------ legs
def _train_legs():
    """{name: (leg, JAX mesh)} of the engine legs."""
    out = {}
    for kind in ("tiny", "uneven"):
        jcfg, pcfg = _cfgs(kind)
        tree = llama_tree(jcfg, seed=41)
        vocab = pcfg.vocab_size
        out[f"tp2_sp2_{kind}"] = (
            dict(name=f"tp2_sp2_{kind}", kind="train", model="llama",
                 cfg=dict(CFG, use_ulysses=True) if kind == "tiny" else
                 dict(UNEVEN, use_ulysses=True), tree=tree,
                 config=_config({"tp": 2, "sp": 2}),
                 batches=_batches(3, 43, vocab),
                 tp_rules=port_llama.tp_rules(pcfg)),
            dict(tp=2, sp=2, dp=1))
    jcfg, pcfg = jax_llama.llama_tiny(**CFG), port_llama.llama_tiny(**CFG)
    out["hpz_tp2_dp2"] = (
        dict(name="hpz_tp2_dp2", kind="train", model="llama",
             cfg=dict(CFG), tree=llama_tree(jcfg, seed=47),
             config=_config({"tp": 2}, zero=dict(
                 Z3, zero_hpz_partition_size=2)),
             batches=_batches(3, 53, 256),
             tp_rules=port_llama.tp_rules(pcfg)),
        dict(tp=2, dp=2, zero_partition_size=2))
    out["mics_tp2_dp2"] = (
        dict(out["hpz_tp2_dp2"][0], name="mics_tp2_dp2",
             config=_config({"tp": 2}, zero=dict(Z3, mics_shard_size=2))),
        dict(tp=2, dp=2, zero_partition_size=2))
    return out


def _jax_train(leg, mesh):
    jcfg = jax_llama.llama_tiny(**leg["cfg"])
    pcfg = port_llama.llama_tiny(**leg["cfg"])
    jax_groups.initialize_mesh(devices=jax.devices()[:WORLD], **mesh)
    try:
        config = dict(leg["config"], mesh={
            k: v for k, v in mesh.items() if k != "zero_partition_size"})
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(jcfg),
            model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                    leg["tree"]),
            tp_rules=jax_llama.tp_rules(jcfg), config=config)[0]
        losses = []
        for batch in leg["batches"]:
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        master = port_llama.params_from_flax(jax.tree_util.tree_map(
            np.asarray, eng.get_fp32_param()), pcfg, dtype="float32")
        return dict(losses=losses, master=master)
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()
        gc.collect()


PIPE_RULES = {"blocks/up/kernel": ("pp", None, "tp"),
              "blocks/up/bias": ("pp", "tp"),
              "blocks/down/kernel": ("pp", "tp", None)}
D = jpe.D


def _pipe_data():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((D, D)).astype(np.float32) * 0.3
    r = np.random.default_rng(42)
    xs = [r.standard_normal((8, D)).astype(np.float32) for _ in range(8)]
    return [(x, x @ W) for x in xs]


def _jax_pipe():
    """JAX's ``test_pp_tp_dp_composition`` engine at pp 2 × tp 2 on four
    devices: its initial tree, losses and master."""
    import flax.linen as nn
    from jax.sharding import PartitionSpec as P

    class TPBlock(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.Dense(4 * D, name="up")(x)
            return x + nn.Dense(D, name="down")(jnp.tanh(h))

    batches = _pipe_data()
    jax_groups.initialize_mesh(pp=2, tp=2, dp=1,
                               devices=jax.devices()[:WORLD])
    try:
        model = jax_module.PipelineModule(
            layers=[jax_module.LayerSpec(TPBlock) for _ in range(4)],
            loss_fn=jpe.mse_loss)
        eng = deepspeed_tpu.initialize(
            model=model, tp_rules={k: P(*v) for k, v in PIPE_RULES.items()},
            config=_pipe_config())[0]
        x0, y0 = batches[0]
        eng.initialize_parameters(0, x0, y0)
        fp32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, np.float32), t)
        tree = fp32(eng.master if eng.master is not None else eng.params)
        it = iter(batches)
        losses = [float(eng.train_batch(it)) for _ in range(4)]
        master = fp32(eng.master if eng.master is not None else eng.params)
        return dict(tree=tree, losses=losses, master=master)
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()
        gc.collect()


def _pipe_config():
    return {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adam", "params": {"lr": 5e-3}},
            "zero_optimization": {"stage": 1},
            "mesh": {"pp": 2, "tp": 2, "dp": 1}}


GPT2P = dict(dtype="float32", remat=False)


def _gpt2_pipe_legs():
    """``models/gpt2.pipeline_module`` at pp 2 × tp 2 (its
    ``pipeline_tp_rules``: the tied ``wte`` tp-sharded on every stage
    that holds it) and at pp 2 × dp 2, from ``initialize_parameters``'
    seed on the same global batches (no JAX twin)."""
    from deepspeed_tpu_torch.models import gpt2 as port_gpt2
    rng = np.random.default_rng(61)
    batches = [(x, np.roll(x, -1, axis=1)) for x in (
        rng.integers(0, 256, size=(4, SEQ)).astype(np.int64)
        for _ in range(4))]

    def leg(name, mesh, micro, rules=None):
        return dict(name=name, kind="pipe", model=("gpt2", GPT2P),
                    config={"train_micro_batch_size_per_gpu": micro,
                            "gradient_accumulation_steps": 2,
                            "optimizer": {"type": "adam",
                                          "params": {"lr": 5e-3}},
                            "zero_optimization": {"stage": 1},
                            "gradient_clipping": 0.5, "mesh": mesh},
                    init_seed=11, batches=batches, steps=2, tp_rules=rules)

    rules = port_gpt2.pipeline_tp_rules(port_gpt2.gpt2_tiny(**GPT2P))
    return [leg("gpt2_pp2_tp2", {"pp": 2, "tp": 2}, 4, rules),
            leg("gpt2_pp2_dp2", {"pp": 2, "dp": 2}, 2)]


MESHES = [dict(tp=2, sp=2), dict(tp=2, pp=2),
          dict(tp=2, dp=2, zero_partition_size=2),
          dict(dp=2, zero_partition_size=2, devices=[2, 3])]


@pytest.fixture(scope="module")
def runs():
    """(JAX results by leg, the port's results by leg)."""
    from deepspeed_tpu_torch.module_inject.auto_tp import Spec
    train = _train_legs()
    want = {n: _jax_train(leg, mesh) for n, (leg, mesh) in train.items()}
    want["pp2_tp2"] = _jax_pipe()
    n_stages = 2
    pipe = dict(name="pp2_tp2", kind="pipe",
                model=([("TPBlock", (D, ), None)] * 4, "mse"),
                config=_pipe_config(), tree=want["pp2_tp2"]["tree"],
                batches=_pipe_data(), steps=4,
                tp_rules={k: Spec(*v) for k, v in PIPE_RULES.items()})
    legs = [leg for leg, _ in train.values()] + [pipe] + _gpt2_pipe_legs()
    legs.append(dict(name="groups", kind="groups", meshes=MESHES,
                     more=True))
    legs.append(dict(name="onebit_tp2", kind="refuse", model="llama",
                     cfg=dict(CFG), tree=llama_tree(
                         jax_llama.llama_tiny(**CFG), seed=3),
                     config={"train_micro_batch_size_per_gpu": 2,
                             "optimizer": {"type": "onebitadam",
                                           "params": {"lr": LR}},
                             "mesh": {"tp": 2}}))
    got = spawn(WORLD, legs, timeout=600)
    assert n_stages == pipe["config"]["mesh"]["pp"]
    return want, got


# ------------------------------------------------------------------ groups
def _jax_groups(kw):
    """{world rank: {coord, tp, data, sp, pp, zp members}} of JAX's mesh
    (and hpZ mesh) over the first four devices."""
    kw = dict(kw)
    devs = jax.devices()[:WORLD]
    sub = kw.pop("devices", None)
    jax_groups.initialize_mesh(
        devices=[devs[r] for r in sub] if sub else devs, **kw)
    try:
        st = jax_groups.get_mesh_state()
        grid = st.mesh.devices
        names = ("pp", "dp", "ep", "sp", "tp")
        out = {}
        for idx in np.ndindex(grid.shape):
            coord = dict(zip(names, idx))

            def members(g, gnames, axes, at):
                sl = tuple(slice(None) if n in axes else i
                           for n, i in zip(gnames, at))
                return sorted(d.id for d in np.ravel(g[sl]))

            rank = grid[idx].id
            got = dict(coord=coord)
            for key, axes in (("tp", ("tp", )), ("data", ("dp", "ep")),
                              ("sp", ("sp", )), ("pp", ("pp", ))):
                got[key] = members(grid, names, axes, idx)
            if st.hpz_mesh is not None:
                zg = st.hpz_mesh.devices
                znames = st.hpz_mesh.axis_names
                zat = [i[0] for i in np.where(zg == grid[idx])]
                got["zp"] = members(zg, znames, ("zp", ), zat)
            out[rank] = got
        return out
    finally:
        jax_groups.reset_mesh()


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_groups_match_jax(runs, i):
    want = _jax_groups(MESHES[i])
    for rank in range(WORLD):
        mine = runs[1]["groups"][rank][i]
        if rank not in want:
            # outside a device subset: local groups only
            assert not mine["member"] and mine["zp"]["size"] == 1, rank
            continue
        w = want[rank]
        assert {k: int(v) for k, v in mine["coord"].items()} == \
            {k: int(v) for k, v in w["coord"].items()}, rank
        for key in ("tp", "data", "sp", "pp", "zp"):
            if key in w or key in mine:
                assert mine[key]["members"] == w[key], (key, rank)


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("leg", ("tp2_sp2_tiny", "tp2_sp2_uneven",
                                 "hpz_tp2_dp2", "mics_tp2_dp2"))
def test_training_matches_jax(runs, leg):
    want, got = runs
    w = want[leg]
    for r in got[leg]:
        np.testing.assert_allclose(r["losses"], w["losses"], rtol=2e-4,
                                   atol=1e-5)
    rank0 = got[leg][0]
    leaves = {n: rank0["master"][o:o + k].reshape(s)
              for n, o, k, s in rank0["names"]}
    assert set(leaves) == set(w["master"])
    for name, t in w["master"].items():
        np.testing.assert_allclose(leaves[name], t.numpy(), rtol=2e-5,
                                   atol=LR / 20, err_msg=name)
    for r in got[leg][1:]:
        np.testing.assert_array_equal(r["master"], rank0["master"])


def test_pipeline_at_tp2_matches_jax(runs):
    """pp 2 × tp 2 from JAX's initial weights: the losses, and each
    stage's master (its blocks, the tp slices gathered) against JAX's."""
    want, got = runs
    w = want["pp2_tp2"]
    pm = pipe_module(([("TPBlock", (D, ), None)] * 4, "mse"))
    whole = {n: t.numpy() for n, t in params_from_flax(w["master"], pm,
                                                         2).items()}
    for r in got["pp2_tp2"]:
        np.testing.assert_allclose(r["losses"], w["losses"], rtol=1e-5)
        for name, a in r["master"].items():
            np.testing.assert_allclose(a, whole[name], rtol=2e-5,
                                       atol=5e-3 / 20, err_msg=name)


def test_gpt2_pipeline_at_tp2_trains_as_at_dp2(runs):
    """GPT-2's pipeline at pp 2 × tp 2 (the tied ``wte`` sharded on its
    vocabulary on both stages, its spans reduced over the stage pair of
    each tp rank, clipping below the norm, which sums the tp slices once)
    against pp 2 × dp 2 from the same seed: losses at rtol 1e-5, and each
    stage's gathered master at rtol 2e-5 + lr/20."""
    got = runs[1]
    tp, dp = got["gpt2_pp2_tp2"], got["gpt2_pp2_dp2"]
    for r in tp:
        np.testing.assert_allclose(r["losses"], dp[0]["losses"], rtol=1e-5)
    for t, d in ((tp[0], dp[0]), (tp[2], dp[2])):
        assert t["stage"] == d["stage"]
        assert set(t["master"]) == set(d["master"])
        for name, a in d["master"].items():
            np.testing.assert_allclose(t["master"][name], a, rtol=2e-5,
                                       atol=5e-3 / 20, err_msg=name)


# ------------------------------------------------------------------ facts
def test_onebit_at_tp_refused_as_in_jax(runs):
    for r in runs[1]["onebit_tp2"]:
        assert r["error"] == "ValueError"
        assert "pure data-parallel mesh" in r["message"]
    jax_groups.initialize_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    try:
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(jax_llama.llama_tiny(**CFG)),
            model_parameters=jax.tree_util.tree_map(
                jnp.asarray, llama_tree(jax_llama.llama_tiny(**CFG), 3)),
            tp_rules=jax_llama.tp_rules(jax_llama.llama_tiny(**CFG)),
            config={"train_micro_batch_size_per_gpu": 2,
                    "optimizer": {"type": "onebitadam",
                                  "params": {"lr": LR}},
                    "mesh": {"tp": 2, "dp": 1}})[0]
        ids = np.zeros((2, SEQ), np.int32)
        # JAX checks when it builds the micro-step, at the first forward
        with pytest.raises(ValueError, match="pure data-parallel mesh"):
            eng(ids, ids)
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()


def test_streaming_at_tp_refused_since_jax_replicates_the_blocks():
    cfg = dict(CFG, vocab_size=128, hidden_size=32, intermediate_size=64,
               num_attention_heads=4, num_key_value_heads=4,
               max_position_embeddings=64, tie_word_embeddings=False)
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "adam", "params": {"lr": LR}},
              "zero_optimization": {"stage": 3,
                                    "offload_param": {"device": "cpu"}}}
    jax_groups.initialize_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    try:
        jcfg = jax_llama.LlamaConfig(**cfg)
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(jcfg),
            model_parameters=jax.tree_util.tree_map(
                jnp.asarray, llama_tree(jcfg, 5)),
            config=dict(config, mesh={"tp": 2, "dp": 1}))[0]
        from jax.sharding import PartitionSpec as P
        assert eng.mesh.shape["tp"] == 2
        assert eng._rep_sharding.spec == P()
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()
    with pytest.raises(ValueError, match="replicates the streamed blocks"):
        deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(port_llama.LlamaConfig(**cfg),
                                        device="meta"),
            config=dict(config, mesh={"tp": 2}), device="cpu")
