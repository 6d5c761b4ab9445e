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

Each world is spawned once.
"""

import gc

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
    for zero, what in (({"stage": 3}, "9a's remainder"),
                       ({"stage": 2, "overlap_comm": True}, "9a's remainder"),
                       ({"stage": 3, "zero_quantized_weights": True},
                        "quantized"),
                       ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
                        "9a's remainder")):
        with pytest.raises(NotImplementedError, match=what):
            deepspeed_tpu_torch.initialize(
                model=model, config=dict(base, zero_optimization=zero),
                device="cpu")
    with pytest.raises(ValueError, match="offload_param"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(base, zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}),
            device="cpu")
    with pytest.raises(NotImplementedError, match="9b"):
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
            "zero_optimization": {"stage": zero}, "mesh": mesh, **extra}


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


def _legs2():
    legs = {}
    for zero in (1, 2):
        legs[f"mse_z{zero}"] = dict(
            model=_mse_model(), config=_config({"pp": 2}, 4, zero=zero),
            batches=_float_batches(4, 12), steps=3,
            eval=_float_batches(8, 1, seed=7)[0])
    legs["uneven"] = dict(model=_mse_model(5),
                          config=_config({"pp": 2}, 4),
                          batches=_float_batches(4, 12), steps=3)
    legs["tied_clip"] = dict(
        model=_tied_model(),
        config=_config({"pp": 2}, 4, gas=2, gradient_clipping=0.05),
        batches=_id_batches(4, 6), steps=3, eval=_id_batches(8, 1, seed=5)[0],
        ckpt_refusal=True)
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


def _legs4():
    ragged = _float_batches(7, 1)[0]
    return {
        "gpt2_pp2_sp2": _gpt2_leg({"pp": 2, "sp": 2}, 4, sp=2),
        "tied_z2_dp2": dict(
            model=_tied_model(), batches=_id_batches(4, 6), steps=3,
            config=_config({"pp": 2, "dp": 2}, 2, gas=2, zero=2,
                           gradient_clipping=0.05),
            jax_mesh=dict(pp=2, dp=2)),
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
        for _ in range(leg["steps"]):
            done = eng.skipped_steps
            losses.append(float(eng.train_batch(it)))
            scales.append(float(np.asarray(eng.scale_state.scale)))
            skips.append(eng.skipped_steps != done)
        out = dict(tree=tree, losses=losses, scales=scales, skips=skips,
                   master=fp32(eng.master if eng.master is not None
                               else eng.params))
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


def _run_world(legs, world, extra=()):
    want = {n: (_base_leg(leg) if leg.get("port_only") else
                _jax_leg(leg, world)) for n, leg in legs.items()}
    spec = [dict(leg, name=n, kind="pipe", tree=want[n]["tree"])
            for n, leg in legs.items()] + list(extra)
    got = spawn(world, spec, timeout=300)
    out = {n: (legs[n], want[n], got[n]) for n in legs}
    out.update({leg["name"]: (leg, None, got[leg["name"]]) for leg in extra})
    return out


@pytest.fixture(scope="module")
def runs():
    out = _run_world(_legs2(), 2)
    out.update(_run_world(_legs4(), 4, extra=[dict(name="ring", kind="ring",
                                                   x=RING)]))
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
                                 "gpt2_pp2_sp2"])
def test_pipeline_matches_jax(runs, leg):
    """The JAX engine's run (the port's base engine for the GPT-2 legs)."""
    spec, want, got = runs[leg]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        assert r["skips"] == want["skips"] and r["scales"] == want["scales"]
    pm = pipe_module(spec["model"])
    ref = want.get("named") or {
        n: t.numpy() for n, t in port_module.params_from_flax(
            want["master"], pm, spec["config"]["mesh"]["pp"]).items()}
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


def test_stage_checkpoints_name_their_item(runs):
    _, _, got = runs["tied_clip"]
    assert all("9b" in r["ckpt_refusal"] for r in got)


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
