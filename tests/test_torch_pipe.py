"""Pipeline parallelism of the port (``runtime/pipe/``, the pp axis of
``utils/groups.py``) against the JAX package on the 8-device CPU mesh.

Pure Python, exactly equal to JAX's:

* the instruction streams of ``TrainSchedule`` and ``InferenceSchedule``
  for pp 1-4 and M 1-8 on every stage, ``DataParallelSchedule``, and the
  buffer counts;
* ``ProcessTopology`` and its subclasses, ``PipelineParallelGrid``;
* ``partition_layers`` (uniform, parameters, type:regex; profile by the
  JAX test's property), ``stage_layers``, ``stage_owner``,
  ``tied_groups``, ``partition_uniform``/``partition_balanced``;
* the mesh's rank order: every group's ranks are the device ids along
  the same axes of JAX's mesh.

Multi-process (gloo), fp32 unless said, weights carried from the JAX
engine's tree (``params_from_flax``), the same global batches; losses,
scales, skips, the final master and ``eval_batch``'s logits at 1e-5
relative (the master plus lr/20 absolute, the ZeRO legs' Adam rule; the
logits plus 1e-5 absolute, for those near 0):

* world 2, pp 2 against JAX's ``PipelineEngine`` at pp 2 on two devices:
  ``test_pipe_engine.py``'s Block model at ZeRO 1 and 2, with 5 blocks
  (uneven stages), a tied embed/head with clipping below the norm (the
  norm counts the tied table once), fp16 from a scale of 2^20 (three
  overflows skipped, a step, then an overflow at the scale it grew to;
  from 2^18 JAX's third step overflows
  where the port's does not: its fused program sums the two microbatches'
  fp16 gradients in fp16, the port each micro-step's into the fp32
  accumulator), ``eval_batch`` with logits;
* world 4: pp 2 × dp 2 (and a ragged eval batch refused), the tied
  model at ZeRO 2 over pp 2 × dp 2 (the tied spans held back from each
  micro-step's reduce-scatter), and pp 2 × sp 2 on ``test_pipe_sp.py``'s
  Ulysses model, each against JAX on four devices;
* ``comm/functional.py``'s ring shifts at world 4 against JAX's
  ``send_next_recv_prev``/``send_prev_recv_next`` (``ppermute``) on four
  devices;
* ``models/gpt2.pipeline_module`` (no JAX twin): its logits are
  ``GPT2Model``'s; at pp 2 × sp 2 with Ulysses (world 4), from
  ``initialize_parameters(seed)``, against the base engine on its
  ``to_module()`` in this process (one rank, sp 1), same seed and
  batches: each layer draws from its own seed whatever the split, the
  tied table's copies stay equal, and the chunks' positions are global.

In this process, JAX's ``PipelineEngine`` at pp 4 on 10 blocks writes a
universal directory, which loads into the port's module block for block
(its stage count read from the block stack, where pp 3 and 6 give the
same slot count).

Each world is spawned once.
"""

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.runtime import utils as jax_rt_utils
from deepspeed_tpu.runtime.pipe import module as jax_module
from deepspeed_tpu.runtime.pipe import schedule as jax_schedule
from deepspeed_tpu.runtime.pipe import topology as jax_topology
from deepspeed_tpu.utils import groups as jax_groups
from deepspeed_tpu_torch.runtime import utils as port_rt_utils
from deepspeed_tpu_torch.runtime.pipe import module as port_module
from deepspeed_tpu_torch.runtime.pipe import schedule as port_schedule
from deepspeed_tpu_torch.runtime.pipe import topology as port_topology
from deepspeed_tpu_torch.utils import groups as port_groups
from deepspeed_tpu.checkpoint import convert_to_universal as jax_convert
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_universal_checkpoint import _npy
from test_torch_universal_checkpoint import jax_llama_tree as flax_tree
from torch_dist_worker import pipe_module, spawn
from unit.runtime.pipe import test_pipe_engine as jpe
from unit.runtime.pipe import test_pipe_sp as jps

# ------------------------------------------------------------ pure Python


def _streams(mod, cls, M, pp, s):
    sched = getattr(mod, cls)(micro_batches=M, stages=pp, stage_id=s)
    return ([[repr(c) for c in tick] for tick in sched.steps()],
            sched.num_pipe_buffers())


@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_schedule_streams_equal_jax(pp):
    for M in range(1, 9):
        for s in range(pp):
            for cls in ("TrainSchedule", "InferenceSchedule"):
                assert _streams(port_schedule, cls, M, pp, s) == \
                    _streams(jax_schedule, cls, M, pp, s), (cls, M, pp, s)
        assert _streams(port_schedule, "DataParallelSchedule", M, 1, 0) == \
            _streams(jax_schedule, "DataParallelSchedule", M, 1, 0)


def _topology_view(mod):
    out = []
    for topo in (mod.ProcessTopology(["pipe", "data", "model"], [2, 3, 2]),
                 mod.PipeDataParallelTopology(num_pp=4, num_dp=2),
                 mod.PipeModelDataParallelTopology(num_pp=2, num_mp=2,
                                                   num_dp=2)):
        n = topo.world_size()
        out.append([str(topo), n, topo.get_axis_names(),
                    [tuple(topo.get_coord(r)) for r in range(n)],
                    [topo.get_rank_repr(r) for r in range(n)],
                    {a: topo.get_axis_comm_lists(a)
                     for a in ("pipe", "data", "model", "none")},
                    topo.filter_match(pipe=1), topo.get_axis_list("data", 0),
                    topo.get_dim("model")])
        for r in range(n):
            g = mod.PipelineParallelGrid(topology=topo, process_id=r)
            out.append([g.get_stage_id(), g.get_data_parallel_id(),
                        g.get_pipe_parallel_world_size(),
                        g.get_data_parallel_world_size(),
                        g.get_model_parallel_world_size(),
                        g.is_first_stage(), g.is_last_stage(),
                        g.stage_to_global(0)])
    return out


def test_topology_equal_jax():
    assert _topology_view(port_topology) == _topology_view(jax_topology)


def _sized(lib, name, shapes):
    """A layer class named ``name`` with these parameter shapes: a torch
    module (taking ``device=``) or, for JAX, a class with
    ``param_shapes()``."""
    if lib == "jax":
        return type(name, (), {"param_shapes": lambda self: shapes})

    def init(self, device=None):
        torch.nn.Module.__init__(self)
        for i, s in enumerate(shapes):
            setattr(self, f"p{i}", torch.nn.Parameter(
                torch.empty(s, device=device)))
    return type(name, (torch.nn.Module, ), {"__init__": init})


def _layer_list(lib):
    mod = jax_module if lib == "jax" else port_module
    small = _sized(lib, "SmallBlk", [(8, 8), (8, )])
    big = _sized(lib, "BigBlk", [(64, 64), (64, )])
    emb = _sized(lib, "EmbedLayer", [(100, 8)])
    layers = ([mod.TiedLayerSpec("e", emb)] +
              [mod.LayerSpec(small if i % 3 else big) for i in range(9)] +
              [mod.TiedLayerSpec("e", emb)])
    return mod.PipelineModule(layers=layers,
                              activation_checkpoint_interval=2)


@pytest.mark.parametrize("method", ["uniform", "parameters", "type:blk",
                                    "type:^big"])
def test_partition_methods_equal_jax(method):
    for stages in (1, 2, 3, 4):
        got, want = _layer_list("port"), _layer_list("jax")
        assert got.partition_layers(stages, method=method) == \
            want.partition_layers(stages, method=method), (method, stages)
        for s in range(stages):
            assert [x.name for x in got.stage_layers(s)] == \
                [x.name for x in want.stage_layers(s)]
        assert [got.stage_owner(i) for i in range(len(got))] == \
            [want.stage_owner(i) for i in range(len(want))]
        assert got.tied_groups() == want.tied_groups() == {"e": [0, 10]}
        assert got.activation_checkpoint_interval == 2


def test_profile_partition_balances_measured_latency():
    """JAX's ``test_profile_partitioning`` property on the port's timing:
    the heavy last layer does not drag the three small ones with it."""

    class Small(torch.nn.Module):
        def __init__(self, device=None):
            super().__init__()
            self.fc = torch.nn.Linear(8, 8, device=device)

        def forward(self, x):
            return self.fc(x)

    class Big(torch.nn.Module):
        def __init__(self, device=None):
            super().__init__()
            self.fcs = torch.nn.Sequential(
                torch.nn.Linear(8, 256, device=device),
                *[torch.nn.Linear(256, 256, device=device)
                  for _ in range(5)],
                torch.nn.Linear(256, 8, device=device))

        def forward(self, x):
            return self.fcs(x)

    mod = port_module.PipelineModule(
        layers=[port_module.LayerSpec(Small) for _ in range(3)] +
        [port_module.LayerSpec(Big)], partition_method="profile")
    with pytest.raises(ValueError, match="example_input"):
        mod.partition_layers(2)
    parts = mod.partition_layers(2, example_input=torch.ones(64, 8))
    assert parts[0] == 0 and parts[-1] == 4 and parts[1] >= 2, parts


def test_partition_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for n in (1, 3, 8, 17):
        for parts in (1, 2, 3, 4, 5):
            assert port_rt_utils.partition_uniform(n, parts) == \
                jax_rt_utils.partition_uniform(n, parts)
            w = [int(x) for x in rng.integers(1, 50, size=n)]
            assert port_rt_utils.partition_balanced(w, parts) == \
                jax_rt_utils.partition_balanced(w, parts)


@pytest.mark.parametrize("pp,dp,sp", [(2, 2, 2), (4, 1, 2), (2, 4, 1),
                                      (1, 2, 4), (8, 1, 1)])
def test_mesh_rank_order_equal_jax(pp, dp, sp):
    """Rank r of the port holds device r's coordinates in JAX's mesh: each
    group's ranks are the device ids along its axes."""
    jax_groups.reset_mesh()
    mesh = jax_groups.initialize_mesh(pp=pp, dp=dp, sp=sp,
                                      devices=jax.devices()[:8]).mesh
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    jax_groups.reset_mesh()
    names = list(mesh.axis_names)
    state = port_groups.MeshState(
        mesh=port_groups.Mesh(pp=pp, dp=dp, ep=1, sp=sp, tp=1), pp=pp,
        dp=dp, sp=sp, tp=1)
    try:
        port_groups._mesh_state = state
        for axes in port_groups._GROUP_AXES:
            keep = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in keep]
            grid = ids.transpose(rest + keep).reshape(-1, int(np.prod(
                [ids.shape[i] for i in keep])))
            assert port_groups.axis_rank_lists(axes) == grid.tolist(), axes
        assert (port_groups._get_pipe_parallel_world_size(),
                port_groups._get_data_parallel_world_size(),
                port_groups._get_sequence_parallel_world_size()) == \
            (pp, dp, sp)
        for on in (False, True):
            assert port_groups.zero_sharding_axes(on) == \
                jax_groups.zero_sharding_axes(on)
    finally:
        port_groups.reset_mesh()


def test_refusals_and_the_engine_interface():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
    model = pipe_module(([("Block", (16, ), None)] * 2, "mse"))
    base = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}
    engine = deepspeed_tpu_torch.initialize(model=model, config=base,
                                            device="cpu")[0]
    assert isinstance(engine, PipelineEngine)
    for call in (engine.forward, engine.backward, engine.step):
        with pytest.raises(RuntimeError, match="train_batch"):
            call()
    # ZeRO 3, bucketed ZeRO 2 and optimizer offload compose with the
    # pipeline; ZeRO++'s quantized collectives stay refused, as in JAX
    for zero in ({"stage": 3}, {"stage": 2, "overlap_comm": True},
                 {"stage": 1, "offload_optimizer": {"device": "cpu"}}):
        assert isinstance(deepspeed_tpu_torch.initialize(
            model=model, config=dict(base, zero_optimization=zero),
            device="cpu")[0], PipelineEngine)
    with pytest.raises(NotImplementedError, match="quantized"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(base, zero_optimization={
                "stage": 3, "zero_quantized_weights": True}),
            device="cpu")
    with pytest.raises(ValueError, match="offload_param"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(base, zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}),
            device="cpu")
    # pp × tp (refused until item 9b's last part) needs its world of
    # pp · tp ranks, which one process does not have
    with pytest.raises(ValueError, match="needs a world"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(base, mesh={"pp": 2, "tp": 2}),
            device="cpu")
    # pp from mesh.pp, pipeline.stages or PipelineModule(num_stages): at
    # one rank pp = 2 has no world to split over
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)
    assert DeepSpeedConfig({"pipeline": {"stages": 4}}).mesh_pp == 4
    with pytest.raises(DeepSpeedConfigError, match="disagree"):
        DeepSpeedConfig({"pipeline": {"stages": 4}, "mesh": {"pp": 2}})
    staged = pipe_module(([("Block", (16, ), None)] * 2, "mse"))
    staged.num_stages = 2
    for m, extra in ((model, {"mesh": {"pp": 2}}),
                     (model, {"pipeline": {"stages": 2}}), (staged, {})):
        with pytest.raises(ValueError, match="pp=2"):
            deepspeed_tpu_torch.initialize(model=m, config=dict(base, **extra),
                                           device="cpu")
    # mpu is accepted (and unused), as in JAX
    deepspeed_tpu_torch.initialize(model=model, config=base, mpu=object(),
                                   device="cpu")
    if not torch.cuda.is_available():      # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deepspeed_tpu_torch.initialize(model=model, config=base)


def test_pp1_equals_the_base_engine_on_the_same_module():
    """One stage: the pipeline's steps are the base engine's micro-steps on
    ``to_module()`` bit for bit (losses and master)."""
    import deepspeed_tpu_torch
    spec = ([("TiedEmbed", (jpe.VOCAB, jpe.D), "e")] +
            [("Block", (jpe.D, ), None)] * 3 +
            [("TiedEmbed", (jpe.VOCAB, jpe.D), "e")], "xent")
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2, "gradient_clipping": 0.1,
           "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}
    pipe = deepspeed_tpu_torch.initialize(model=pipe_module(spec),
                                          config=cfg, device="cpu")[0]
    pipe.initialize_parameters(3)
    base = deepspeed_tpu_torch.initialize(
        model=pipe_module(spec).to_module(device="meta"), config=cfg,
        device="cpu")[0]
    base.initialize_parameters(3)
    rng = np.random.default_rng(1)
    data = [(rng.integers(0, jpe.VOCAB, (4, 8)),) * 2 for _ in range(6)]
    got = [float(pipe.train_batch(iter(data[2 * i:2 * i + 2])))
           for i in range(3)]
    want = []
    for i in range(3):
        ls = []
        for x, y in data[2 * i:2 * i + 2]:
            loss = base(torch.as_tensor(x), torch.as_tensor(y))
            base.backward(loss)
            base.step()
            ls.append(loss.detach().float())
        want.append(float(torch.stack(ls).mean()))
    assert got == want
    assert torch.equal(pipe.fp32_params(), base.fp32_params())


# ------------------------------------------------------- multi-process legs
D, V = jpe.D, jpe.VOCAB
JAX_LAYERS = {"Block": jpe.Block, "Embed": jpe._Embed, "Head": jpe._Head,
              "TiedEmbed": jpe._TiedEmbed, "UEmbed": jps.Embed,
              "UlyssesBlock": jps.UlyssesBlock, "UHead": jps.Head}
JAX_LOSSES = {"mse": jpe.mse_loss, "xent": jpe._xent}
LR = 5e-3


def _mse_model(n=4):
    return ([("Block", (D, ), None)] * n, "mse")


def _tied_model():
    return ([("TiedEmbed", (V, D), "e")] + [("Block", (D, ), None)] * 4 +
            [("TiedEmbed", (V, D), "e")], "xent")


def _sp_model():
    return ([("UEmbed", (jps.VOCAB, jps.D), None)] +
            [("UlyssesBlock", (jps.D, jps.H), None)] * 2 +
            [("UHead", (jps.VOCAB, jps.D), None)], "xent")


def _config(mesh, micro, gas=4, zero=1, **extra):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adam", "params": {"lr": LR}},
            "zero_optimization": (zero if isinstance(zero, dict)
                                  else {"stage": zero}),
            "mesh": mesh, **extra}


def _float_batches(rows, n, seed=42):
    rng = np.random.default_rng(0)
    W = rng.standard_normal((D, D)).astype(np.float32) * 0.3
    r = np.random.default_rng(seed)
    xs = [r.standard_normal((rows, D)).astype(np.float32) for _ in range(n)]
    return [(x, x @ W) for x in xs]


def _id_batches(rows, n, vocab=V, seq=8, seed=42):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.integers(0, vocab, size=(rows, seq)).astype(np.int32)
        out.append((x, x))
    return out


Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}


def _legs2(tmp):
    legs = {}
    for zero in (1, 2, 3):
        legs[f"mse_z{zero}"] = dict(
            offload_states_at=1 if zero == 3 else None,
            model=_mse_model(), config=_config(
                {"pp": 2}, 4, zero=dict(Z3) if zero == 3 else zero),
            batches=_float_batches(4, 12), steps=3,
            eval=_float_batches(8, 1, seed=7)[0])
    # optimizer offload: bit-equal to mse_z1, so held to its JAX run
    for device in ("cpu", "nvme"):
        off = {"device": device}
        if device == "nvme":
            off["nvme_path"] = str(tmp / "nvme")
        legs[f"offload_{device}"] = dict(
            legs["mse_z1"], same_as="mse_z1",
            config=_config({"pp": 2}, 4, zero_optimization={
                "stage": 1, "offload_optimizer": off}))
    legs["uneven"] = dict(model=_mse_model(5),
                          config=_config({"pp": 2}, 4),
                          batches=_float_batches(4, 12), steps=3)
    legs["tied_clip"] = dict(
        model=_tied_model(),
        config=_config({"pp": 2}, 4, gas=2, gradient_clipping=0.05),
        batches=_id_batches(4, 6), steps=3, eval=_id_batches(8, 1, seed=5)[0])
    legs["fp16"] = dict(
        model=_mse_model(), batches=_float_batches(4, 10), steps=5,
        config=_config({"pp": 2}, 4, gas=2, fp16={
            "enabled": True, "initial_scale_power": 20,
            "loss_scale_window": 2, "hysteresis": 1}))
    return legs


GPT2_TINY = dict(dtype="float32", remat=False)


def _gpt2_leg(mesh, micro, sp=1):
    return dict(model=("gpt2", dict(GPT2_TINY, use_ulysses=sp > 1)),
                config=_config(mesh, micro, gas=2), init_seed=11,
                batches=[(x, np.roll(x, -1, axis=1)) for x, _ in
                         _id_batches(4, 6, vocab=256, seq=16, seed=9)],
                steps=3, port_only=True)


SAVE_AT = 2     # the tag of tied_z3_dp2 is written before its third step


def _tied_dp2(zero, **extra):
    return dict(model=_tied_model(), batches=_id_batches(4, 6), steps=3,
                config=_config({"pp": 2, "dp": 2}, 2, gas=2, zero=zero,
                               gradient_clipping=0.05, **extra),
                jax_mesh=dict(pp=2, dp=2))


def _legs4(tmp):
    ragged = _float_batches(7, 1)[0]
    tied_z3 = _tied_dp2(dict(Z3, stage3_gather_16bit_weights_on_model_save=(
        True)))
    tied_z3.update(save_at=SAVE_AT, dir=str(tmp / "stage_tag"),
                   jax_dir=str(tmp / "jax_tag"), jax_uni=str(tmp / "jax_uni"),
                   save16=str(tmp / "fp16_model"))
    return {
        "gpt2_pp2_sp2": _gpt2_leg({"pp": 2, "sp": 2}, 4, sp=2),
        "tied_z2_dp2": _tied_dp2(2),
        "tied_z3_dp2": tied_z3,
        "tied_z2_overlap_dp2": _tied_dp2({"stage": 2, "overlap_comm": True}),
        # hpZ's and MiCS's groups of 2 inside each stage's data group
        **{f"{kind}_pp2_dp2": dict(
            model=_mse_model(), batches=_float_batches(4, 12), steps=3,
            config=_config({"pp": 2, "dp": 2}, 2, zero=dict(Z3, **{key: 2})),
            jax_mesh=dict(pp=2, dp=2, zero_partition_size=2),
            save_at=SAVE_AT, dir=str(tmp / f"{kind}_tag"))
           for kind, key in (("hpz", "zero_hpz_partition_size"),
                             ("mics", "mics_shard_size"))},
        "pp2_sp2_z3": dict(model=_sp_model(),
                           config=_config({"pp": 2, "sp": 2}, 8, gas=2,
                                          zero=dict(Z3)),
                           batches=_id_batches(8, 6, vocab=jps.VOCAB,
                                               seq=jps.S), steps=3,
                           jax_mesh=dict(pp=2, dp=1, sp=2)),
        "pp2_dp2": dict(model=_mse_model(),
                        config=_config({"pp": 2, "dp": 2}, 2),
                        batches=_float_batches(4, 12), steps=3,
                        eval=_float_batches(8, 1, seed=7)[0], ragged=ragged,
                        jax_mesh=dict(pp=2, dp=2)),
        "pp2_sp2": dict(model=_sp_model(),
                        config=_config({"pp": 2, "sp": 2}, 8, gas=2),
                        batches=_id_batches(8, 6, vocab=jps.VOCAB,
                                            seq=jps.S), steps=3,
                        jax_mesh=dict(pp=2, dp=1, sp=2)),
    }


def _jax_leg(leg, world):
    mesh = leg.get("jax_mesh", dict(pp=2, dp=1))
    jax_groups.reset_mesh()
    jax_groups.initialize_mesh(devices=jax.devices()[:world], **mesh)
    try:
        layers, loss = leg["model"]
        specs = [jax_module.TiedLayerSpec(key, JAX_LAYERS[name]) if key
                 else jax_module.LayerSpec(JAX_LAYERS[name])
                 for name, _, key in layers]
        eng = deepspeed_tpu.initialize(
            model=jax_module.PipelineModule(layers=specs,
                                            loss_fn=JAX_LOSSES[loss]),
            config=dict(leg["config"]))[0]
        x, y = leg["batches"][0]
        eng.initialize_parameters(0, x, y)
        fp32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, np.float32), t)
        tree = fp32(eng.master if eng.master is not None else eng.params)
        it = iter(leg["batches"])
        losses, scales, skips = [], [], []
        saved = None
        for step in range(leg["steps"]):
            if step == leg.get("save_at") and "jax_dir" in leg:
                saved = fp32(eng.master if eng.master is not None
                             else eng.params)
                eng.save_checkpoint(leg["jax_dir"], tag="t")
                jax_convert(leg["jax_dir"], leg["jax_uni"], tag="t")
            done = eng.skipped_steps
            losses.append(float(eng.train_batch(it)))
            scales.append(float(np.asarray(eng.scale_state.scale)))
            skips.append(eng.skipped_steps != done)
        out = dict(tree=tree, losses=losses, scales=scales, skips=skips,
                   saved=saved, master=fp32(eng.master if eng.master
                                            is not None else eng.params))
        if leg.get("eval") is not None:
            loss, logits = eng.eval_batch(iter([leg["eval"]]),
                                          return_logits=True)
            out["eval"] = (float(loss), np.asarray(logits, np.float32))
        if leg.get("ragged") is not None:
            with pytest.raises(ValueError, match="data-parallel degree") \
                    as e:
                eng.eval_batch(iter([leg["ragged"]]))
            out["ragged"] = str(e.value)
        return out
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()
        gc.collect()   # the engine's cycles: no JAX garbage for later tests


def _base_leg(leg):
    """The port's base engine, one rank, on the leg's module (sp 1)."""
    import deepspeed_tpu_torch
    _, cfg = leg["model"]
    pm = pipe_module(("gpt2", dict(cfg, use_ulysses=False)))
    config = dict(leg["config"], mesh={"pp": 1})
    micro = sum(x.shape[0] for x, _ in leg["batches"][:1])
    config["train_micro_batch_size_per_gpu"] = micro
    eng = deepspeed_tpu_torch.initialize(model=pm.to_module(device="meta"),
                                         config=config, device="cpu")[0]
    eng.initialize_parameters(leg["init_seed"])
    gas, losses = eng.gradient_accumulation_steps(), []
    for i in range(leg["steps"]):
        micro = []
        for x, y in leg["batches"][i * gas:(i + 1) * gas]:
            loss = eng(torch.as_tensor(x), torch.as_tensor(y))
            eng.backward(loss)
            eng.step()
            micro.append(loss.detach().float())
        losses.append(float(torch.stack(micro).mean()))
    flat = eng.fp32_params()
    return dict(losses=losses, scales=[1.0] * leg["steps"],
                skips=[False] * leg["steps"], tree=None,
                named={n: flat[o:o + k].view(s).numpy().copy()
                       for n, o, k, s in eng._layout})


RING = np.arange(4 * 3 * 2, dtype=np.float32).reshape(8, 3)


def _jax_ring():
    from jax.sharding import Mesh, PartitionSpec as P
    from deepspeed_tpu.comm import functional
    mesh = Mesh(np.array(jax.devices()[:4]), ("x", ))
    out = {}
    for key, fn in (("next", functional.send_next_recv_prev),
                    ("prev", functional.send_prev_recv_next)):
        out[key] = np.asarray(jax.shard_map(
            lambda x, fn=fn: fn(x, "x", 4), mesh=mesh, in_specs=P("x"),
            out_specs=P("x"))(jnp.asarray(RING)))
    return out


def _run_world(legs, world, extra=(), want=None):
    want = dict(want or {})
    for n, leg in legs.items():
        if n not in want and not leg.get("same_as"):
            want[n] = (_base_leg(leg) if leg.get("port_only") else
                       _jax_leg(leg, world))
    for n, leg in legs.items():
        if leg.get("same_as"):
            want[n] = want[leg["same_as"]]
    spec = [dict(leg, name=n, kind="pipe", tree=want[n]["tree"])
            for n, leg in legs.items()] + list(extra)
    got = spawn(world, spec, timeout=300)
    out = {n: (legs[n], want[n], got[n]) for n in legs}
    out.update({leg["name"]: (leg, None, got[leg["name"]]) for leg in extra})
    return out


def _after_save(want):
    """The JAX run of tied_z3_dp2 from its tag on: the steps after it."""
    return dict(want, losses=want["losses"][SAVE_AT:],
                scales=want["scales"][SAVE_AT:],
                skips=want["skips"][SAVE_AT:])


def _cross_legs(saved_leg, tmp):
    """Loads of tied_z3_dp2's tags at world 2: the stage tag at pp 1 × dp 2
    and pp 2 × dp 1, JAX's universal directory at pp 2 × dp 1; and a base
    engine's tag at dp 1 × sp 2 (GPT-2 with Ulysses, ZeRO 3), resumed."""
    rest = saved_leg["batches"][SAVE_AT * 2:]
    load = dict(model=_tied_model(), batches=rest, steps=1, jax_pp=2,
                load=saved_leg["dir"])
    legs = {
        "load_pp1_dp2": dict(load, config=_config(
            {"pp": 1, "dp": 2}, 2, gas=2, zero=dict(Z3),
            gradient_clipping=0.05)),
        "load_pp2_dp1": dict(load, config=_config(
            {"pp": 2}, 4, gas=2, zero=dict(Z3), gradient_clipping=0.05)),
        "uni_pp2": dict(load, load=saved_leg["jax_uni"], config=_config(
            {"pp": 2}, 4, gas=2, zero=1, gradient_clipping=0.05,
            checkpoint={"load_universal": True})),
        # the port's stage tag through its own universal directory
        "port_uni_pp1_dp2": dict(load, load=saved_leg["port_uni"],
                                 config=_config(
            {"pp": 1, "dp": 2}, 2, gas=2, zero=dict(Z3),
            gradient_clipping=0.05, checkpoint={"load_universal": True})),
    }
    gpt2 = dict(dtype="float32", remat=False, use_ulysses=True)
    sp = dict(name="sp2_base", kind="ckpt", model="gpt2", cfg=gpt2,
              tree=gpt2_tree(5), k=2, batches=[
                  (x, x) for x, _ in _id_batches(2, 4, vocab=256, seq=16,
                                                 seed=3)],
              dir=str(tmp / "sp_tag"),
              config={"train_micro_batch_size_per_gpu": 2,
                      "optimizer": {"type": "adam", "params": {"lr": LR}},
                      "zero_optimization": dict(Z3),
                      "sequence_parallel_size": 2})
    return legs, sp


def _sp_shard_group_legs():
    """The base engine at dp 2 × sp 2 (GPT-2 with Ulysses, world 4) at
    ZeRO 3, and with hpZ's and MiCS's groups of 2 inside the data group of
    4."""
    gpt2 = dict(dtype="float32", remat=False, use_ulysses=True)
    batches = [(x, x) for x, _ in _id_batches(4, 3, vocab=256, seq=16,
                                              seed=4)]
    legs = []
    for name, extra in (("sp_z3", {}), ("sp_hpz", {
            "zero_hpz_partition_size": 2}), ("sp_mics", {
                "mics_shard_size": 2})):
        legs.append(dict(
            name=name, kind="train", model="gpt2", cfg=gpt2,
            tree=gpt2_tree(6), batches=batches,
            config={"train_micro_batch_size_per_gpu": 2,
                    "optimizer": {"type": "adam", "params": {"lr": LR}},
                    "zero_optimization": dict(Z3, **extra),
                    "sequence_parallel_size": 2}))
    return legs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    out = _run_world(_legs2(tmp), 2)
    out.update(_run_world(_legs4(tmp), 4, extra=[
        dict(name="ring", kind="ring", x=RING), *_sp_shard_group_legs()]))
    saved_leg, saved_want, _ = out["tied_z3_dp2"]
    saved_leg["port_uni"] = str(tmp / "port_uni")
    from deepspeed_tpu_torch.checkpoint import convert_to_universal
    convert_to_universal(saved_leg["dir"], saved_leg["port_uni"], tag="t")
    legs, sp = _cross_legs(saved_leg, tmp)
    out.update(_run_world(legs, 2, extra=[sp], want={
        n: _after_save(saved_want) for n in legs}))
    return out


def test_ring_shifts_match_jax(runs):
    _, _, got = runs["ring"]
    want = _jax_ring()
    for key in ("next", "prev"):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in got]), want[key], err_msg=key)


def _master_by_name(leg, got):
    merged = {}
    for r in got:
        for n, a in r["master"].items():
            if n in merged:   # a tied copy: equal on every stage
                np.testing.assert_array_equal(merged[n], a, err_msg=n)
            merged[n] = a
    return merged


@pytest.mark.parametrize("leg", ["mse_z1", "mse_z2", "uneven", "tied_clip",
                                 "fp16", "pp2_dp2", "pp2_sp2", "tied_z2_dp2",
                                 "gpt2_pp2_sp2", "mse_z3", "offload_cpu",
                                 "offload_nvme", "tied_z3_dp2",
                                 "tied_z2_overlap_dp2", "pp2_sp2_z3",
                                 "hpz_pp2_dp2", "mics_pp2_dp2",
                                 "load_pp1_dp2", "load_pp2_dp1", "uni_pp2",
                                 "port_uni_pp1_dp2"])
def test_pipeline_matches_jax(runs, leg):
    """The JAX engine's run (the port's base engine for the GPT-2 legs)."""
    spec, want, got = runs[leg]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        assert r["skips"] == want["skips"] and r["scales"] == want["scales"]
    pm = pipe_module(spec["model"])
    ref = want.get("named") or {
        n: t.numpy() for n, t in port_module.params_from_flax(
            want["master"], pm, spec.get(
                "jax_pp", spec["config"]["mesh"]["pp"])).items()}
    port = _master_by_name(spec, got)
    assert set(port) == set(ref)
    for n in ref:
        np.testing.assert_allclose(port[n], ref[n], rtol=1e-5,
                                   atol=LR / 20, err_msg=n)
    if "eval" in want:
        loss, logits = want["eval"]
        dp = spec["config"]["mesh"].get("dp", 1)
        rows = np.concatenate([got[r]["eval"][1] for r in range(dp)], 0)
        # logits near 0 take an absolute floor of 1e-5
        np.testing.assert_allclose(rows, logits, rtol=1e-5, atol=1e-5)
        for r in got:
            np.testing.assert_allclose(r["eval"][0], loss, rtol=1e-5)
    if "ragged" in want:
        assert all("data-parallel degree" in r["ragged"] for r in got)


def test_fp16_skips_then_steps(runs):
    _, want, got = runs["fp16"]
    assert want["skips"] == [True, True, True, False, True]
    assert all(r["skips"] == want["skips"] for r in got)


def test_stage_split_matches_jax(runs):
    """Stage 0 runs the pre layers and its blocks, the last stage the rest
    (5 blocks: 3 + 2, JAX's geometry without its pad slot)."""
    _, _, got = runs["uneven"]
    assert [r["layers"] for r in got] == [[0, 1, 2], [3, 4]]
    _, _, got = runs["tied_clip"]
    assert [r["layers"] for r in got] == [[0, 1, 2], [3, 4, 5]]
    assert all(r["stats"]["p2p_bytes"] > 0 for r in got)
    # rank r's (pp, dp, sp) coordinates: JAX's mesh order, most-major first
    for leg, (dp, sp) in (("pp2_dp2", (2, 1)), ("pp2_sp2", (1, 2))):
        _, _, got = runs[leg]
        assert [r["coords"] for r in got] == [
            (r // (dp * sp), r // sp % dp, r % sp) for r in range(4)]
        assert [r["stage"] for r in got] == [r // (dp * sp)
                                             for r in range(4)]


# ------------------------------------------------- offload and checkpoints
@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_is_bit_equal_to_the_run_without(runs, device):
    """``offload_optimizer`` under the pipeline: the same run as without
    it, bit for bit; the state where the offload puts it."""
    _, _, got = runs[f"offload_{device}"]
    _, _, plain = runs["mse_z1"]
    for r, p in zip(got, plain):
        assert r["losses"] == p["losses"]
        for n in p["master"]:
            np.testing.assert_array_equal(r["master"][n], p["master"][n])
        assert "master" not in r["placement"]      # fp32: no master
        assert r["placement"]["exp_avg"] == (
            "host" if device == "cpu" else "nvme")


def test_offload_states_on_a_pipeline_stage(runs):
    """``offload_states`` between two steps of the ZeRO-3 pipeline moves
    every state to the host; the next step brings them back (the run
    matches JAX in ``test_pipeline_matches_jax``)."""
    _, _, got = runs["mse_z3"]
    for r in got:
        assert set(r["offloaded"].values()) == {"host"}, r["offloaded"]


@pytest.mark.parametrize("leg", ["tied_z3_dp2", "hpz_pp2_dp2",
                                 "mics_pp2_dp2"])
def test_stage_tag_resumes_bit_for_bit(runs, leg):
    """A pp 2 × dp 2 ZeRO-3 tag (plain, hpZ, MiCS): a fresh engine that
    loads it runs the next step as the unbroken run did."""
    _, _, got = runs[leg]
    for r in got:
        assert r["resumed"]["losses"] == r["losses"][SAVE_AT:]
        for n, a in r["master"].items():
            np.testing.assert_array_equal(r["resumed"]["master"][n], a,
                                          err_msg=n)


def test_stage_tag_holds_upstream_names(runs):
    """One ``layer_{idx}`` file a layer (the tied key's once), one
    ``mp_rank_{s}`` file a stage, one optim file a partition of a stage;
    the 16-bit model one file a stage, the tied leaf in the first."""
    leg, _, _ = runs["tied_z3_dp2"]
    files = set(os.listdir(os.path.join(leg["dir"], "t")))
    assert files == {
        "engine_state.json", "manifest.json",
        "mp_rank_00_model_states.pt", "mp_rank_01_model_states.pt",
        *(f"layer_{i:02d}-model_states.pt" for i in range(5)),
        *(f"zero_pp_rank_{d}_mp_rank_{s:02d}_optim_states.pt"
          for d in range(2) for s in range(2))}
    sd = [torch.load(os.path.join(leg["save16"],
                                  f"pytorch_model_stage_{s:02d}.bin"))
          for s in range(2)]
    assert [sorted({n.split(".")[0] for n in d}) for d in sd] == [
        ["blocks", "tied"], ["blocks"]]


def _saved_by_name(runs):
    _, _, got = runs["tied_z3_dp2"]
    return _master_by_name(None, [dict(master=r["saved"]) for r in got])


@pytest.mark.parametrize("leg", ["load_pp1_dp2", "load_pp2_dp1"])
def test_stage_tag_loads_at_another_split(runs, leg):
    """The tag fills each rank's shard at another pp and dp: the loaded
    master is the saved one by name (stepped against JAX in
    ``test_pipeline_matches_jax``)."""
    saved = _saved_by_name(runs)
    _, _, got = runs[leg]
    loaded = _master_by_name(None, [dict(master=r["loaded"]) for r in got])
    assert set(loaded) == set(saved)
    for n, a in saved.items():
        np.testing.assert_array_equal(loaded[n], a, err_msg=n)
    assert all(r["count"] == SAVE_AT for r in got)


def test_stage_tag_loads_into_the_base_engine(runs):
    """The base engine on ``to_module()`` (one rank, ZeRO 3) loads the
    pipeline's tag and steps as JAX's pipeline does."""
    import deepspeed_tpu_torch
    leg, want, _ = runs["tied_z3_dp2"]
    pm = pipe_module(leg["model"])
    config = dict(leg["config"], mesh={"pp": 1},
                  train_micro_batch_size_per_gpu=4)
    eng = deepspeed_tpu_torch.initialize(model=pm.to_module(device="meta"),
                                         config=config, device="cpu")[0]
    eng.load_checkpoint(leg["dir"])
    flat = eng.fp32_params()
    saved = _saved_by_name(runs)
    for n, o, k, s in eng._layout:
        np.testing.assert_array_equal(flat[o:o + k].view(s).numpy(),
                                      saved[n], err_msg=n)
    micro = []
    for x, y in leg["batches"][SAVE_AT * 2:]:
        loss = eng(torch.as_tensor(x), torch.as_tensor(y))
        eng.backward(loss)
        eng.step()
        micro.append(loss.detach().float())
    np.testing.assert_allclose(float(torch.stack(micro).mean()),
                               want["losses"][SAVE_AT], rtol=1e-5)
    ref = port_module.params_from_flax(want["master"], pm, 2)
    flat = eng.fp32_params()
    for n, o, k, s in eng._layout:
        np.testing.assert_allclose(flat[o:o + k].view(s).numpy(),
                                   ref[n].numpy(), rtol=1e-5, atol=LR / 20,
                                   err_msg=n)


def test_stage_tag_to_universal_matches_jax(runs):
    """The port's stage tag through its universal converter holds the JAX
    ``PipelineEngine``'s names and shapes (its padded block stack) and, leaf
    by leaf, JAX's universal directory from its own tag after the same
    steps: the master at the master's tolerance, the moments at 1e-4
    relative plus 1e-6 of each leaf's largest value."""
    leg, _, _ = runs["tied_z3_dp2"]
    for field in ("fp32", "exp_avg", "exp_avg_sq"):
        port, ref = (_npy(leg["port_uni"], field),
                     _npy(leg["jax_uni"], field))
        assert set(port) == set(ref), field
        for path, a in ref.items():
            assert port[path].shape == a.shape, (field, path)
            if field == "fp32":
                tol = dict(rtol=1e-5, atol=LR / 20)
            else:
                tol = dict(rtol=1e-4, atol=1e-6 * float(np.abs(a).max()))
            np.testing.assert_allclose(port[path], a, err_msg=field + path,
                                       **tol)


@pytest.mark.parametrize("leg", ["uni_pp2", "port_uni_pp1_dp2"])
def test_universal_loads_into_a_pipeline(runs, leg):
    """A universal directory into the port's pipeline at another split:
    JAX's at pp 2 × dp 1, the port's own (from its pp 2 × dp 2 stage tag)
    at pp 1 × dp 2.  Every stage's master is the directory's fp32, bit for
    bit (stepped against JAX in ``test_pipeline_matches_jax``)."""
    leg, _, got = runs[leg]
    want = port_module.params_from_flax(flax_tree(_npy(leg["load"], "fp32")),
                                        pipe_module(leg["model"]), 2)
    loaded = _master_by_name(None, [dict(master=r["loaded"]) for r in got])
    assert set(loaded) == set(want)
    for n, t in want.items():
        np.testing.assert_array_equal(loaded[n], t.numpy(), err_msg=n)


def test_jax_directory_at_pp4_loads_block_for_block(tmp_path):
    """A JAX universal directory records no stage count.  Ten blocks make
    12 slots at pp 3, 4 and 6, laid out differently; a directory written
    by JAX's ``PipelineEngine`` at pp 4 after a step loads into the port's
    module with every block its own, read at pp 4 from the pad slots'
    zero moments (at pp 3 slot 8 would be block 7, and block 7 taken as
    pad)."""
    from types import SimpleNamespace
    from deepspeed_tpu_torch.checkpoint.universal_checkpoint import \
        read_universal
    leg = dict(model=_mse_model(10), config=_config({"pp": 4}, 4),
               batches=_float_batches(4, 8), steps=2, save_at=1,
               jax_dir=str(tmp_path / "tag"), jax_uni=str(tmp_path / "uni"),
               jax_mesh=dict(pp=4, dp=1))
    want = _jax_leg(leg, 4)
    pm = pipe_module(leg["model"])
    _, fields = read_universal(leg["jax_uni"], SimpleNamespace(pipe=pm))
    at4 = port_module.params_from_flax(want["saved"], pm, 4)
    at3 = port_module.params_from_flax(want["saved"], pm, 3)
    assert set(fields["fp32"]) == set(at4)
    for n, t in at4.items():
        torch.testing.assert_close(fields["fp32"][n], t, rtol=0, atol=0,
                                   msg=n)
    assert any(not torch.equal(at3[n], t) for n, t in at4.items())


def test_an_unreadable_stage_count_asks_for_it():
    """Where the block stack leaves more than one layout (a JAX directory
    before its first step: every moment zero), the load raises and says
    where to record the stage count; where one layout's pads alone are
    zero (the port's converter writes them so), that one is taken."""
    geo = port_module.geometry(pipe_module(_mse_model(10)))
    rng = np.random.default_rng(0)
    fp32 = {"w": rng.standard_normal((12, 3)).astype(np.float32)}
    zeros = {"w": np.zeros((12, 3), np.float32)}
    with pytest.raises(ValueError, match="num_stages"):
        port_module.stages_of_block_stack(geo, [fp32, zeros, zeros])
    for pp, pads in ((3, [7, 11]), (4, [8, 11]), (6, [9, 11])):
        padded = {"w": fp32["w"].copy()}
        padded["w"][pads] = 0
        assert port_module.stages_of_block_stack(geo, [padded]) == pp


def test_zero_to_fp32_of_a_stage_tag(runs):
    """``zero_to_fp32`` puts every stage's pieces together: the whole fp32
    model, each leaf the saved master (a tied leaf once)."""
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    leg, _, _ = runs["tied_z3_dp2"]
    sd = get_fp32_state_dict_from_zero_checkpoint(leg["dir"], tag="t")
    saved = _saved_by_name(runs)
    assert set(sd) == set(saved)
    for n, a in saved.items():
        np.testing.assert_array_equal(sd[n].numpy(), a, err_msg=n)


def test_shard_groups_with_sequence_parallelism(runs):
    """hpZ over groups of 2 inside the data group of dp 2 × sp 2 is ZeRO 3
    bit for bit (the gathers move the same bits); MiCS's losses within
    2e-4 and its master within the Adam rule's LR / 20 (its sums in
    another order)."""
    _, _, z3 = runs["sp_z3"]
    _, _, hpz = runs["sp_hpz"]
    _, _, mics = runs["sp_mics"]
    for r, p in zip(hpz, z3):
        assert r["losses"] == p["losses"]
        np.testing.assert_array_equal(r["master"], p["master"])
    for r, p in zip(mics, z3):
        np.testing.assert_allclose(r["losses"], p["losses"], rtol=2e-4)
        np.testing.assert_allclose(r["master"], p["master"], rtol=2e-4,
                                   atol=LR / 20)


def test_sp2_base_tag_resumes_bit_for_bit(runs):
    """The base engine at dp 1 × sp 2 (ZeRO 3 over the data group of both
    sp ranks): the loaded state is the saved one and the resumed run the
    unbroken one, bit for bit."""
    _, _, got = runs["sp2_base"]
    for r in got:
        res = r["resumed"]["same"]
        assert res["losses"] == r["losses"]
        for key in ("master", "exp_avg", "exp_avg_sq"):
            for n, a in r["saved"][key].items():
                np.testing.assert_array_equal(res["loaded"][key][n], a)
            for n, a in r["final"][key].items():
                np.testing.assert_array_equal(res["final"][key][n], a)


def test_gpt2_pipeline_logits_are_gpt2_models():
    """``pipeline_module(cfg).to_module()`` computes ``GPT2Model``'s logits
    from the same weights (wte, wpe tied into the first layer, ln_f, the
    head through wte)."""
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.gpt2_tiny(**GPT2_TINY)
    ref = gpt2.GPT2Model(cfg)
    ref.init_weights(torch.Generator().manual_seed(0))
    src = dict(ref.named_parameters())
    stage = gpt2.pipeline_module(cfg).to_module()
    with torch.no_grad():
        for n, p in stage.named_parameters():
            region, idx, rest = n.split(".", 2)
            name = (f"h.{int(idx) - 1}.{rest}" if region == "blocks"
                    else rest)
            p.copy_(src[name])
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                             (2, 16)))
    assert torch.equal(stage(ids), ref(ids))


def test_params_round_trip_through_flax(runs):
    spec, want, _ = runs["mse_z1"]
    pm = pipe_module(spec["model"])
    named = port_module.params_from_flax(want["tree"], pm, 2)
    back = port_module.params_to_flax(named, pm, 2)
    flat = lambda t: jax.tree_util.tree_leaves(t)  # noqa: E731
    for a, b in zip(flat(back), flat(want["tree"])):
        np.testing.assert_array_equal(a, b)
