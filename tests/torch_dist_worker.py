"""One rank of the port's multi-process tests: a gloo world on the CPU.

    python tests/torch_dist_worker.py SPEC OUT_DIR

``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` come from the
environment (:func:`spawn` sets them).  ``SPEC`` is a pickle of a list of
legs, run one after another in this one process (one interpreter start
serves every leg); each leg writes ``OUT_DIR/<name>.r<rank>.pkl``.  The
worker imports torch and the port only, never JAX.

Leg kinds:

* ``comm``: collectives of ``deepspeed_tpu_torch.comm`` on blocks of
  global numpy arrays (rank r takes block r, as the JAX facade's sharded
  inputs), every result as numpy (the ``async_*`` ops run with
  ``async_op=True`` and check the result against the synchronous call);
* ``comm_log``: async collectives with the comms logger on, and its counts;
* ``train``: a model (``moe``: the MoE twin) trained through ``deepspeed_tpu_torch.initialize()``
  on this rank's rows of each global batch (``engine.shard_batch``); the
  losses, scales, skips and gradient norms, the whole fp32 master and the
  comm counts (and, at ZeRO 3, the coordinator's peak of gathered
  elements beside what bounds it), and where the engine keeps each state
  (``state_placement``); ``offload_at`` (a batch index) sends every state
  to the host with ``offload_states`` after that batch's step (and records
  the placement then); ``per_step_master``: the fp32 master after each
  batch; ``init_seed`` (a Llama leg without a tree): the weights
  ``engine.initialize_parameters`` draws from that seed;
* ``coll``: the quantized primitives of ``comm/collectives`` on rank r's
  row of each array (``quantized_all_gather``, ``all_to_all_quant_reduce``,
  ``hierarchical_quant_reduce_scatter``, ``quantized_all_to_all``, the
  straight-through gather's gradient), and the facade's collectives with a
  collectives engine installed (results, the engine's counts and the comms
  logger's summary);
* ``refuse``: an engine built on a mesh the leg builds first; the error's
  type and message;
* ``ckpt``: the same training, a ``save_checkpoint`` into the leg's
  directory after ``k`` batches and the rest of the batches; then, for each
  of the leg's ``resume`` configs, a fresh engine that loads the tag and
  trains on the same batches: every run's losses and its gathered state
  (master, moments, count, counters) by leaf name;
* ``pipe``: a ``PipelineModule`` of the JAX pipeline tests' toy layers
  (:func:`pipe_twins`, the flax layers' torch twins) or GPT-2's, trained
  with ``train_batch`` from the leg's flax tree (or ``initialize_
  parameters(init_seed)``, or from the tag or universal directory at
  ``load``): each step's loss, scale and skip, this stage's fp32 master by
  name and where the engine keeps each state, and ``eval_batch``'s loss
  and logits, a ragged batch's refusal; with ``save_at`` (a step index) a
  tag in ``dir`` before that step, and a fresh engine that loads it and
  runs the steps after it (its losses and master); with
  ``offload_states_at`` every state sent to the host before that step
  (the placement then);
* ``ulysses``: ``DistributedAttention`` on rank r's sequence chunk of the
  leg's q, k, v over an sp group of the whole world: the output chunk and
  the gradients of ``sum(out ** 2)``;
* ``ring``: ``comm/functional.py``'s ring shifts of rank r's block of the
  leg's array over the world;
* ``codec``: ``runtime/comm/compressed.py``'s 1-bit all-reduce of rank r's
  row of each of the leg's arrays, its error buffers fed back from one
  call to the next: each call's mean and both error buffers (and the same
  through ``compressed_allreduce_many`` and ``CompressedBackend``);
* ``moe_local``: one micro-step of the MoE twin (:func:`moe_twin`) at
  ZeRO 0: each expert leaf's unreduced gradient on this rank;
* ``moe_shards``: the MoE twin at the leg's ZeRO stage, one step: where
  this rank's master holds each expert leaf (the pieces in the whole
  stack, and their values), its coordinates, the plan's groups and the
  whole master;
* ``groups``: for each of the leg's meshes (``initialize_mesh`` keyword
  arguments, ``devices`` a list of world ranks), this rank's coordinates,
  whether it is in the mesh, and the world ranks of its tp and data
  groups (with ``more``: its sp, pp and hpZ groups too; their sizes and
  ranks, and a sum over each as a check);
* ``functional``: ``comm/functional.py``'s differentiable collectives and
  ``module_inject``'s parallel layers over the world: outputs and input
  gradients;
* ``serve``: ``InferenceEngineV2`` (Llama or Mixtral from the leg's flax
  tree, or ``build_hf_engine`` of the leg's ``hf_dir``) at the leg's
  ``tensor_parallel.tp_size`` over the world: the
  greedy tokens of ``generate`` (with its decode bursts), of a
  ``put``/``query``/``flush`` loop and of ``burst_decode``, the KV cache's
  shape and the local weight shapes;
* ``ring_attn``: ring attention (``sequence/ring_attention.py``) over an
  sp group of the leg's size on rank r's sequence block: the output block
  and the gradients of ``sum(out ** 2)``; rank 0 also the one-device ring
  over the whole inputs;
* ``fpdt_attn``: ``FPDT_Attention`` over an sp group of the world, as
  ``ulysses``;
* ``ac_partition``: ``partition_activations`` over a tp group of the
  world: a two-block model's loss and gradients with the flag on and off,
  and one saved activation's packed slice and unpacked whole;
* ``domino_overlap``: an engine built from the leg's config (its
  ``mesh.tp``), then ``runtime/domino``'s ``domino_ab`` on its model's
  loss of the leg's ids, without gradients: the plain and
  µ-stream overlap reports and the winner;
* ``mixtral_grads``: one micro-step of Mixtral at ZeRO 0 on the leg's
  mesh: every leaf's gradient whole, the local leaf shapes, the weight
  shapes B7's plain version saw, each layer's top-k ids;
* ``stream``: ZeRO-Infinity parameter streaming (``InfinityEngine``) from
  the leg's flax tree, or from the tag at ``load`` (the universal
  directory at ``universal``): each batch's loss, then the whole fp32
  master by name; with ``save_at`` (a batch index) a tag in ``dir`` after
  that batch, and a fresh engine loading it that trains on the batches
  after it (its losses, and its master right after the load).
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world, legs, timeout=240):
    """Run ``legs`` on ``world`` gloo ranks (one process each); returns
    {leg name: [rank 0's result, rank 1's, ...]}."""
    with tempfile.TemporaryDirectory(prefix="ds_torch_dist_") as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(legs, f)
        port = str(free_port())
        procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port, OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO)
            env.pop("DS_ACCELERATOR", None)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec, tmp],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(
                o[-4000:] for o in outs))
        results = {}
        for leg in legs:
            results[leg["name"]] = []
            for rank in range(world):
                with open(os.path.join(tmp, f"{leg['name']}.r{rank}.pkl"),
                          "rb") as f:
                    results[leg["name"]].append(pickle.load(f))
        return results


# ------------------------------------------------------------------ legs
def _block(a, axis, rank, world):
    n = a.shape[axis] // world
    return a.take(range(rank * n, (rank + 1) * n), axis=axis)


def run_comm(leg, rank, world):
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.comm import ReduceOp
    out = {}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for key, op in leg["ops"]:
        g = leg["arrays"][key]
        if op[0] == "all_reduce":
            out[key] = dist.all_reduce(t(_block(g, 0, rank, world)),
                                       op=ReduceOp[op[1]]).numpy()
        elif op[0] == "all_gather":
            axis = op[1]
            out[key] = dist.all_gather(t(_block(g, axis, rank, world)),
                                       axis=axis).numpy()
        elif op[0] == "reduce_scatter":
            x = g * (rank + 1) if op[1] == "distinct" else g
            out[key] = dist.reduce_scatter(t(x)).numpy()
        elif op[0] == "broadcast":
            out[key] = dist.broadcast(t(_block(g, 0, rank, world)),
                                      src=op[1]).numpy()
        elif op[0] == "all_to_all":
            split, concat = op[1], op[2]
            out[key] = dist.all_to_all_single(
                t(_block(g, concat, rank, world)), split_axis=split,
                concat_axis=concat).numpy()
        elif op[0] == "all_gather_stacked":
            out[key] = dist.all_gather(t(_block(g, 0, rank, world)),
                                       tiled=False).numpy()
        elif op[0] == "allgather_fn":
            # rank r's block written in place of a flat buffer, gathered
            flat = torch.zeros(g.size, dtype=torch.float32)
            n = g.size // world
            flat[rank * n:(rank + 1) * n] = t(_block(g, 0, rank, world))
            got = dist.allgather_fn(flat, flat[rank * n:(rank + 1) * n])
            assert got.data_ptr() == flat.data_ptr()
            out[key] = flat.numpy()
        elif op[0] == "reduce_scatter_fn":
            shard = torch.empty(g.size // world)
            out[key] = dist.reduce_scatter_fn(shard, t(g)).numpy()
        elif op[0].startswith("async_"):
            out[key] = _async_op(op[0][len("async_"):], g, rank, world)
        elif op[0] == "barrier":
            dist.barrier()
            out[key] = np.array(dist.get_world_size())
        elif op[0] == "ranks":
            out[key] = np.array([dist.get_rank(), dist.get_world_size(),
                                 dist.get_global_rank(None, world - 1),
                                 *dist.get_all_ranks_from_group()])
        else:
            raise ValueError(op)
    return out


def _async_op(name, g, rank, world):
    """One collective with ``async_op=True``: the handle's ``wait()`` gives
    the result, which must equal the synchronous call's."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm as dist
    n = g.size // world
    mine = torch.from_numpy(np.ascontiguousarray(g[rank * n:(rank + 1) * n]))
    if name == "allgather_fn":
        args = lambda: (torch.empty(g.size), mine.clone())  # noqa: E731
    elif name == "reduce_scatter_fn":
        args = lambda: (torch.empty(n),  # noqa: E731
                        torch.from_numpy(g * (rank + 1)))
    else:
        args = lambda: (mine.clone(), )  # noqa: E731
    fn = getattr(dist, name)
    sync = fn(*args())
    handle = fn(*args(), async_op=True)
    assert isinstance(handle, dist.AsyncHandle)
    got = handle.wait()
    assert handle.is_completed() and handle.wait() is got
    assert torch.equal(got, sync), name
    return got.numpy()


def run_comm_log(leg, rank, world):
    """Each async op is recorded once by the comms logger."""
    import torch
    from deepspeed_tpu_torch import comm as dist
    dist.comms_logger.reset()
    dist.configure(enabled=True, prof_all=True)
    try:
        x = torch.ones(8 * world)
        handles = [dist.allgather_fn(torch.empty(8 * world * world), x,
                                     async_op=True),
                   dist.reduce_scatter_fn(torch.empty(8), x,
                                          async_op=True),
                   dist.all_reduce(x.clone(), async_op=True),
                   dist.all_reduce(x.clone(), async_op=True)]
        for h in handles:
            h.wait()
        handles[0].wait()
        return dict(counts=dist.comms_logger.counts())
    finally:
        dist.configure(enabled=False)
        dist.comms_logger.reset()


def run_coll(leg, rank, world):
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.comm import ReduceOp
    from deepspeed_tpu_torch.comm import collectives as C
    from deepspeed_tpu_torch.comm.collectives import quantized as Q
    from deepspeed_tpu_torch.utils import groups
    g = dist.get_world_group()
    out = {}
    for key, op in leg["ops"]:
        x = torch.from_numpy(np.ascontiguousarray(leg["arrays"][key][rank]))
        kind, args = op[0], op[1:]
        if kind == "qag":
            fmt, gs, dim = args
            res = Q.quantized_all_gather(x, g, dim, fmt, gs)
        elif kind == "a2a_reduce":
            fmt, gs, mean = args
            res = Q.all_to_all_quant_reduce(x, g, 0, world, wire_format=fmt,
                                            group_size=gs, mean=mean)
        elif kind == "hier":
            fmt, gs, n_in, mean = args
            inner, outer = groups.factor_groups(n_in)
            res = Q.hierarchical_quant_reduce_scatter(
                x, inner, outer, 0, n_in, world // n_in, wire_format=fmt,
                group_size=gs, mean=mean)
        elif kind == "qa2a":
            split, concat, fmt, gs = args
            res = Q.quantized_all_to_all(x, g, split, concat, world, fmt, gs)
        elif kind == "st_grad":
            fmt, gs = args
            x.requires_grad_(True)
            y = Q.qdq_all_gather_st(x, g, 0, fmt, gs)
            (y.float() ** 2).sum().backward()
            res = x.grad
        elif kind == "facade":
            opts, fn, extra = args
            eng = C.CollectivesEngine(C.CommOptimizations(
                **dict({"enabled": True}, **opts)))
            dist.set_collectives_engine(eng)
            dist.comms_logger.reset()
            dist.configure(enabled=True, prof_all=True)
            try:
                if fn == "all_reduce":
                    res = dist.all_reduce(x.clone(), op=ReduceOp[extra])
                elif fn == "all_gather":
                    res = dist.all_gather(x)
                elif fn == "reduce_scatter":
                    res = dist.reduce_scatter(x)
                elif fn == "all_gather_coalesced":
                    res = torch.stack(dist.all_gather_coalesced([x, 2 * x]))
                elif fn == "allgather_fn":
                    buf = torch.empty(world * x.numel(), dtype=x.dtype)
                    res = dist.allgather_fn(buf, x, async_op=True).wait()
                elif fn == "reduce_scatter_fn":
                    res = dist.reduce_scatter_fn(
                        torch.empty(x.numel() // world, dtype=x.dtype), x)
                else:
                    raise ValueError(fn)
                summary = dist.comms_logger.get_summary_dict()
            finally:
                dist.configure(enabled=False)
                dist.comms_logger.reset()
                dist.set_collectives_engine(None)
            out[key] = dict(result=res.detach().float().numpy(),
                            counts=dict(eng.counts), summary=summary)
            continue
        else:
            raise ValueError(op)
        out[key] = res.detach().float().numpy()
    return out


def run_refuse(leg, rank, world):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    if leg.get("mesh") is not None:
        groups.initialize_mesh(**leg["mesh"])
    model, start = _model(leg["model"], leg["cfg"], leg["tree"])
    try:
        deepspeed_tpu_torch.initialize(model=model, model_parameters=start,
                                       config=dict(leg["config"]),
                                       device="cpu")
    except Exception as e:         # the refusal under test
        return dict(error=type(e).__name__, message=str(e))
    finally:
        groups.reset_mesh()
    return dict(error=None, message="")


def _mlp(tree, kind):
    """The JAX tests' small models in torch: ``mlp`` is
    ``tests/unit/simple_model.py:simple_mlp_apply`` (``layer_i`` w, b;
    relu between; MSE), ``smoke`` is ``tools/comm_smoke.py``'s (tanh(x w1
    + b) w2; MSE)."""
    import torch

    class Layer(torch.nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.w = torch.nn.Parameter(torch.empty(w.shape, device="meta"))
            self.b = torch.nn.Parameter(torch.empty(b.shape, device="meta"))

        def forward(self, h):
            return h @ self.w + self.b

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            keys = sorted(tree)
            self.layers = torch.nn.ModuleList(
                Layer(tree[k]["w"], tree[k]["b"]) for k in keys)

        def forward(self, x, y):
            # fp16 runs take the inputs in the parameters' dtype
            h = x.to(self.layers[0].w.dtype)
            y = y.to(h.dtype)
            for i, layer in enumerate(self.layers):
                h = layer(h)
                if i < len(self.layers) - 1:
                    h = torch.relu(h)
            return torch.mean((h - y) ** 2)

    class Smoke(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in tree.items():
                setattr(self, k, torch.nn.Parameter(
                    torch.empty(v.shape, device="meta")))

        def forward(self, x, y):
            h = torch.tanh(x @ self.w1 + self.b)
            return torch.mean((h @ self.w2 - y) ** 2)

    if kind == "mlp":
        start = {f"layers.{i}.{p}": torch.from_numpy(tree[k][p])
                 for i, k in enumerate(sorted(tree)) for p in ("w", "b")}
        return MLP(), start
    return Smoke(), {k: torch.from_numpy(v) for k, v in tree.items()}


def _model(kind, cfg_kw, tree, mean_only=False):
    """The port's model and its fp32 weights from a flax tree.
    ``mean_only``: a subclass whose ``forward`` has no ``loss_reduction``,
    so the engine can only average the ranks' means."""
    if kind in ("mlp", "smoke"):
        return _mlp(tree, kind)
    if kind == "moe":
        return moe_twin(tree, **cfg_kw)
    from deepspeed_tpu_torch.models import bert, gpt2, llama, mixtral
    mod = {"llama": llama, "gpt2": gpt2, "bert": bert,
           "mixtral": mixtral}[kind]
    make = {"llama": "llama_tiny", "gpt2": "gpt2_tiny", "bert": "bert_tiny",
            "mixtral": "mixtral_tiny"}
    cfg = getattr(mod, make[kind])(**cfg_kw)
    cls = getattr(mod, {"llama": "LlamaModel", "gpt2": "GPT2Model",
                        "bert": "BertModel",
                        "mixtral": "MixtralModel"}[kind])
    if mean_only:
        base = cls

        class MeanOnly(base):
            def forward(self, input_ids, labels=None, attention_mask=None):
                return base.forward(self, input_ids, labels, attention_mask)

        cls = MeanOnly
    model = cls(cfg, device="meta")
    return model, mod.params_from_flax(tree, cfg, dtype="float32")


def moe_twin(tree, noisy=None):
    """The port's twin of the JAX MoE tests' model
    (``tests/unit/moe/test_moe_engine.py:MoEModel``): in_proj, a residual
    ``MoE`` (4 experts, top-1, capacity factor 2, ``noisy`` its
    ``noisy_gate_policy``), out_proj; MSE plus 0.01 × the aux loss.  Its
    parameters carry flax's paths joined by dots.  Returns (model, {name:
    fp32 tensor}) from the flax tree."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.moe import MoE
    from deepspeed_tpu_torch.moe.experts import Dense

    hidden = np.asarray(tree["in_proj"]["kernel"]).shape[1]
    experts = np.asarray(tree["moe"]["gate"]["kernel"]).shape[1]

    class MoEModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.in_proj = Dense(hidden, hidden)
            self.moe = MoE(hidden, num_experts=experts, k=1,
                           capacity_factor=2.0, noisy_gate_policy=noisy)
            self.out_proj = Dense(hidden, hidden)

        def forward(self, x, y):
            h = self.in_proj(x)
            moe_out, l_aux, _ = self.moe(h)
            out = self.out_proj(h + moe_out)
            return torch.mean((out - y) ** 2) + 0.01 * l_aux

    named = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                named[prefix + k] = torch.from_numpy(
                    np.array(v, dtype=np.float32))

    walk(tree, "")
    return MoEModel(), named


def run_train(leg, rank, world):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm as dist
    if leg.get("init_seed") is None:
        model, start = _model(leg["model"], leg["cfg"], leg["tree"],
                              leg.get("mean_only", False))
    else:
        from deepspeed_tpu_torch.models import llama
        model = llama.LlamaModel(llama.llama_tiny(**leg["cfg"]),
                                 device="meta")
        start = None
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start, config=dict(leg["config"]),
        device="cpu", tp_rules=leg.get("tp_rules"))
    if start is None:
        engine.initialize_parameters(leg["init_seed"])
    dist.comms_logger.reset()
    losses, scales, skips, gnorms = [], [], [], []
    offloaded = None
    step_masters = []
    for i, batch in enumerate(leg["batches"]):
        inputs = engine.shard_batch(*batch)
        loss = engine(*inputs)
        engine.backward(loss)
        poison = leg.get("poison", {})
        if poison.get(i) == rank:
            engine.grad_acc[0] = float("nan")
        engine.step()
        losses.append(float(loss))
        if engine.micro_steps % engine.gradient_accumulation_steps() == 0:
            scales.append(float(engine.cur_scale))
            skips.append(bool(engine._last_skipped))
            gnorms.append(float(engine._last_gnorm))
        if leg.get("per_step_master"):
            step_masters.append(
                engine.fp32_params().float().clone().numpy())
        if leg.get("offload_at") == i:
            engine.offload_states()
            offloaded = engine.state_placement()
    placement = engine.state_placement()
    counts = dist.comms_logger.counts()
    layout, numel = engine.global_layout()
    master = engine.fp32_params()[:numel].clone()
    plan = engine.zero_plan
    coord = engine._coord
    live = {}
    if coord is not None and coord.sharded_params:
        live = dict(peak=coord.peak_live_elems, window=coord.window,
                    bucket_elems=[b.elems for b in coord.buckets],
                    unit_numel=list(plan.unit_numel),
                    unit_kinds=list(plan.unit_kinds))
    from deepspeed_tpu_torch.moe import engine as moe_engine
    return dict(losses=losses, scales=scales, skips=skips, gnorms=gnorms,
                master=master.numpy(), variant=engine._micro_variant(),
                two_hop=moe_engine.ep_hierarchy() is not None,
                per_rank_gating=moe_engine.per_rank_gating(),
                dispatch=engine.zeropp_dispatch_counts(),
                param_numel=int(engine.params.numel()),
                params=engine.gathered_params().float().numpy(),
                names=[(n, o, k, s) for n, o, k, s in layout],
                counts=counts, plan=plan.describe(),
                per_step=plan.collectives_per_step(
                    engine.gradient_accumulation_steps()),
                live=live, grad_acc_numel=int(engine.grad_acc.numel()),
                skipped_steps=engine.skipped_steps,
                global_loss=engine._global_loss, placement=placement,
                offloaded=offloaded, step_masters=step_masters)


def gathered_state(engine):
    """The engine's whole fp32 master and moments, by leaf name (a
    collective when sharded), with its counters."""
    import numpy as np
    opt = engine.opt_state

    def leaves(flat):
        return {n: flat[o:o + k].reshape(s).numpy().copy()
                for n, o, k, s in engine.global_layout()[0]}

    def whole(t):
        return None if t is None else leaves(engine._whole(t))

    return dict(master=leaves(engine.fp32_params().float()),
                exp_avg=whole(opt.exp_avg),
                exp_avg_sq=whole(getattr(opt, "exp_avg_sq", None)),
                params=leaves(engine.gathered_params().float()),
                count=opt.count, scale=float(engine.cur_scale),
                skipped=engine.skipped_steps, steps=engine.global_steps,
                micro=engine.micro_steps)


def run_ckpt(leg, rank, world):
    import deepspeed_tpu_torch

    def train(engine, batches):
        out = []
        for batch in batches:
            loss = engine(*engine.shard_batch(*batch))
            engine.backward(loss)
            engine.step()
            out.append(float(loss))
        return out

    model, start = _model(leg["model"], leg["cfg"], leg["tree"])
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start, config=dict(leg["config"]),
        device="cpu", tp_rules=leg.get("tp_rules"))[0]
    k = leg["k"]
    train(engine, leg["batches"][:k])
    saved = gathered_state(engine)
    engine.save_checkpoint(leg["dir"], tag="t",
                           async_save=leg.get("async", False))
    losses = train(engine, leg["batches"][k:])
    engine.wait_for_checkpoint()
    out = dict(saved=saved, losses=losses, final=gathered_state(engine),
               resumed={})
    for name, config in leg.get("resume", {"same": leg["config"]}).items():
        fresh, _ = _model(leg["model"], leg["cfg"], leg["tree"])
        eng = deepspeed_tpu_torch.initialize(
            model=fresh, config=dict(config), device="cpu",
            tp_rules=leg.get("tp_rules"))[0]
        eng.load_checkpoint(leg["dir"])
        loaded = gathered_state(eng)
        out["resumed"][name] = dict(
            loaded=loaded, losses=train(eng, leg["batches"][k:]),
            final=gathered_state(eng))
    return out


def run_moe_local(leg, rank, world):
    """One micro-step of the MoE twin at ZeRO 0 (whose accumulator holds
    this rank's own, unreduced gradient until the step): the expert
    leaves' gradient, by name, and the rank's ep coordinate."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.moe.utils import is_moe_param
    from deepspeed_tpu_torch.utils import groups
    model, start = moe_twin(leg["tree"])
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start, config=dict(leg["config"]),
        device="cpu")[0]
    x, y = leg["batch"]
    engine.backward(engine(*engine.shard_batch(x, y)))
    grads = {n: engine.grad_acc[o:o + k].reshape(s).float().numpy().copy()
             for n, o, k, s in engine._layout if is_moe_param(n)}
    return dict(grads=grads, ep_rank=groups._get_expert_parallel_rank(),
                ep=groups._get_expert_parallel_world_size())


def run_moe_shards(leg, rank, world):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    model, start = moe_twin(leg["tree"])
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start, config=dict(leg["config"]),
        device="cpu")[0]
    x, y = leg["batch"]
    engine.backward(engine(*engine.shard_batch(x, y)))
    engine.step()
    plan = engine.zero_plan
    target = engine._target()
    pieces = {name: (within, target[off:off + k].numpy().copy())
              for name, (k, off, within) in
              plan.fragment_map(engine._layout, dense=False).items()}
    layout, numel = engine.global_layout()
    master = engine.fp32_params()
    return dict(
        pieces=pieces, ep_rank=groups._get_expert_parallel_rank(),
        ep=groups._get_expert_parallel_world_size(),
        expert_rank=plan.expert_rank, expert_world=plan.expert_world,
        world=plan.world_size, shard_numel=plan.shard_numel,
        unit_expert=list(plan.unit_expert),
        slice_numel=list(plan.slice_numel),
        local_shapes={n: s for n, _, _, s in engine._layout},
        master={n: master[o:o + k].reshape(s).numpy().copy()
                for n, o, k, s in layout})


def run_mixtral_grads(leg, rank, world):
    """``mixtral_grads``: Mixtral from the leg's flax tree at the leg's
    config (ZeRO 0), one micro-step on the leg's global batch: every
    leaf's gradient whole (the expert stacks gathered over ep, the tp
    slices over tp: a collective), the rank's local leaf shapes, the
    weight shapes B7's plain version was called with, and each layer's
    top-k expert ids."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    model, start = _model("mixtral", leg["cfg"], leg["tree"])
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start, config=dict(leg["config"]),
        device="cpu", tp_rules=leg.get("tp_rules"))[0]
    seen, plain = set(), gm.gmm_plain

    def spy(x, w, group_sizes):
        seen.add(tuple(w.shape))
        return plain(x, w, group_sizes)

    gm.gmm_plain = spy
    try:
        engine.backward(engine(*engine.shard_batch(*leg["batch"])))
    finally:
        gm.gmm_plain = plain
    layout, _ = engine.global_layout()
    whole = engine._globalize(engine.grad_acc.float())
    k = model.config.num_experts_per_tok
    return dict(
        grads={n: whole[o:o + m].reshape(s).numpy().copy()
               for n, o, m, s in layout},
        local_shapes={n: tuple(s) for n, _, _, s in engine._layout},
        gmm_w_shapes=sorted(seen),
        topi=[torch.topk(layer.block_sparse_moe.router_logits, k,
                         dim=-1).indices.numpy()
              for layer in model.model.layers])


def pipe_twins():
    """The JAX pipeline tests' flax layers as torch modules that take
    ``device=``, with the flax parameter names and shapes (a Dense kernel
    is [in, out...], products in the promoted dtype, as flax computes
    them): ``Block``, ``TPBlock``, ``Embed``, ``Head``, ``TiedEmbed``
    (``tests/unit/runtime/pipe/test_pipe_engine.py``) and ``UEmbed``,
    ``UlyssesBlock``, ``UHead`` (``test_pipe_sp.py``); and their losses."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    def param(*shape, device=None):
        return nn.Parameter(torch.zeros(shape, device=device))

    class Dense(nn.Module):
        def __init__(self, n_in, out, device=None):
            super().__init__()
            self.kernel = param(n_in, *out, device=device)
            self.bias = param(*out, device=device)

        def forward(self, x):
            dt = torch.promote_types(x.dtype, self.kernel.dtype)
            k = self.kernel.to(dt).reshape(self.kernel.shape[0], -1)
            y = x.to(dt) @ k + self.bias.to(dt).reshape(-1)
            return y.view(*x.shape[:-1], *self.bias.shape)

    class Table(nn.Module):
        def __init__(self, n, d, device=None):
            super().__init__()
            self.embedding = param(n, d, device=device)

    class Block(nn.Module):
        def __init__(self, d, device=None):
            super().__init__()
            self.fc = Dense(d, (d, ), device)

        def forward(self, x):
            return x + torch.tanh(self.fc(x))

    class TPBlock(nn.Module):
        """``test_pipe_engine.py:test_pp_tp_dp_composition``'s block (x +
        down(tanh(up(x)))), its products tensor-parallel: ``up``
        column-parallel, ``down`` row-parallel, once ``tp_rules`` cut
        them."""

        def __init__(self, d, device=None):
            super().__init__()
            self.up = Dense(d, (4 * d, ), device)
            self.down = Dense(4 * d, (d, ), device)

        def forward(self, x):
            from deepspeed_tpu_torch.comm.functional import (
                copy_to_tp_region, reduce_from_tp_region)
            from deepspeed_tpu_torch.module_inject.layers import tp_group_of
            h = torch.tanh(self.up(copy_to_tp_region(
                x, tp_group_of(self.up))))
            y = reduce_from_tp_region(h @ self.down.kernel,
                                      tp_group_of(self.down))
            return x + y + self.down.bias

    class Embed(nn.Module):
        def __init__(self, vocab, d, device=None):
            super().__init__()
            self.wte = Table(vocab, d, device)

        def forward(self, ids):
            return F.embedding(ids.long(), self.wte.embedding)

    class Head(nn.Module):
        def __init__(self, vocab, d, device=None):
            super().__init__()
            self.lm_head = Dense(d, (vocab, ), device)

        def forward(self, x):
            return self.lm_head(x)

    class TiedEmbed(Embed):
        """Embeds int inputs, projects float hiddens through the same
        table (flax ``Embed.attend``)."""

        def forward(self, x):
            if not x.is_floating_point():
                return super().forward(x)
            return x @ self.wte.embedding.to(x.dtype).t()

    class UEmbed(nn.Module):
        def __init__(self, vocab, d, device=None):
            super().__init__()
            self.Embed_0 = Table(vocab, d, device)

        def forward(self, ids):
            return F.embedding(ids.long(), self.Embed_0.embedding)

    class UlyssesBlock(nn.Module):
        def __init__(self, d, heads, device=None):
            super().__init__()
            self.heads = heads
            self.DenseGeneral_0 = Dense(d, (3, heads, d // heads), device)
            self.Dense_0 = Dense(d, (4 * d, ), device)
            self.Dense_1 = Dense(4 * d, (d, ), device)

        def forward(self, x):
            from deepspeed_tpu_torch.sequence.layer import \
                DistributedAttention
            B, S, D = x.shape
            qkv = self.DenseGeneral_0(x)
            out = DistributedAttention()(qkv[:, :, 0], qkv[:, :, 1],
                                         qkv[:, :, 2], causal=True)
            h = self.Dense_0(out.reshape(B, S, D) + x)
            return x + self.Dense_1(torch.tanh(h))

    class UHead(nn.Module):
        def __init__(self, vocab, d, device=None):
            super().__init__()
            self.Dense_0 = Dense(d, (vocab, ), device)

        def forward(self, x):
            return self.Dense_0(x)

    class MoEBlock(nn.Module):
        """x + a ``MoE`` layer's output (4 experts, top-1, capacity factor
        2; the aux loss dropped: a pipeline layer hands on one tensor)."""

        def __init__(self, d, device=None):
            super().__init__()
            from deepspeed_tpu_torch.moe import MoE
            self.moe = MoE(d, num_experts=4, k=1, capacity_factor=2.0,
                           device=device)

        def forward(self, x):
            return x + self.moe(x)[0]

    def mse(out, labels):
        return torch.mean((out - labels) ** 2)

    def xent(logits, labels):
        lp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(lp, -1, labels.long()[..., None]).mean()

    return dict(Block=Block, TPBlock=TPBlock, MoEBlock=MoEBlock,
                Embed=Embed, Head=Head,
                TiedEmbed=TiedEmbed,
                UEmbed=UEmbed, UlyssesBlock=UlyssesBlock, UHead=UHead,
                mse=mse, xent=xent)


def pipe_module(spec):
    """The ``PipelineModule`` of a leg's ``model``: (layers, loss name)
    with layers [(class name, args, tie key or None)], or ("gpt2",
    ``gpt2_tiny`` overrides): ``models/gpt2.pipeline_module``, a block a
    checkpointed run."""
    from deepspeed_tpu_torch.runtime.pipe import (LayerSpec, PipelineModule,
                                                  TiedLayerSpec)
    if spec[0] == "gpt2":
        from deepspeed_tpu_torch.models import gpt2
        return gpt2.pipeline_module(gpt2.gpt2_tiny(**spec[1]),
                                    activation_checkpoint_interval=1)
    tw = pipe_twins()
    layers = [TiedLayerSpec(key, tw[name], *args) if key else
              LayerSpec(tw[name], *args) for name, args, key in spec[0]]
    return PipelineModule(layers=layers, loss_fn=tw[spec[1]])


def _stage_master(engine):
    """This stage's fp32 master by leaf name, each leaf whole (a collective
    when sharded, or at tp > 1)."""
    flat = engine.fp32_params()
    return {n: flat[o:o + k].view(s).numpy().copy()
            for n, o, k, s in engine.global_layout()[0]}


def run_pipe(leg, rank, world):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.pipe.module import params_from_flax
    pm = pipe_module(leg["model"])
    stages = leg["config"]["mesh"]["pp"]
    start = (None if leg.get("tree") is None or leg.get("load") else
             params_from_flax(leg["tree"], pm, stages))
    engine = deepspeed_tpu_torch.initialize(
        model=pm, model_parameters=start, config=dict(leg["config"]),
        device="cpu", tp_rules=leg.get("tp_rules"))[0]
    out = {}
    if leg.get("load"):
        engine.load_checkpoint(leg["load"])
        out["loaded"] = _stage_master(engine)
        out["count"] = engine.opt_state.count
    elif start is None:
        engine.initialize_parameters(leg["init_seed"])
    it = iter(leg["batches"])
    losses, scales, skips = [], [], []
    for step in range(leg["steps"]):
        if step == leg.get("save_at"):
            out["saved"] = _stage_master(engine)
            engine.save_checkpoint(leg["dir"], tag="t")
        if step == leg.get("offload_states_at"):
            engine.offload_states()
            out["offloaded"] = engine.state_placement()
        losses.append(float(engine.train_batch(it)))
        scales.append(float(engine.cur_scale))
        skips.append(bool(engine._last_skipped))
    from deepspeed_tpu_torch.utils import groups
    out["placement"] = engine.state_placement()   # before the gathers
    out.update(losses=losses, scales=scales, skips=skips,
               stage=engine.stage_id, layers=list(engine.stage_layers),
               coords=(groups._get_pipe_parallel_rank(),
                       groups._get_data_parallel_rank(),
                       groups._get_sequence_parallel_rank()),
               master=_stage_master(engine),
               stats=dict(engine.last_step_stats))
    if leg.get("save16"):
        engine.save_16bit_model(leg["save16"])
    if leg.get("save_at") is not None:
        # a fresh engine resumes from the tag
        fresh = deepspeed_tpu_torch.initialize(
            model=pipe_module(leg["model"]), config=dict(leg["config"]),
            device="cpu")[0]
        fresh.load_checkpoint(leg["dir"])
        it = iter(leg["batches"][leg["save_at"] *
                                 engine.gradient_accumulation_steps():])
        out["resumed"] = dict(
            losses=[float(fresh.train_batch(it))
                    for _ in range(leg["steps"] - leg["save_at"])],
            master=_stage_master(fresh))
    if leg.get("eval") is not None:
        loss, logits = engine.eval_batch(iter([leg["eval"]]),
                                         return_logits=True)
        out["eval"] = (float(loss), logits.float().numpy())
    if leg.get("ragged") is not None:
        try:
            engine.eval_batch(iter([leg["ragged"]]))
            out["ragged"] = None
        except ValueError as e:          # the refusal under test
            out["ragged"] = str(e)
    return out


def run_ulysses(leg, rank, world):
    import torch
    from deepspeed_tpu_torch.sequence.layer import DistributedAttention
    from deepspeed_tpu_torch.utils import groups
    groups.initialize_mesh(sp=world)
    try:
        q, k, v = (torch.from_numpy(_block(a, 1, rank, world)).requires_grad_()
                   for a in (leg["q"], leg["k"], leg["v"]))
        out = DistributedAttention()(q, k, v, causal=leg["causal"])
        (out ** 2).sum().backward()
        return dict(out=out.detach().numpy(), dq=q.grad.numpy(),
                    dk=k.grad.numpy(), dv=v.grad.numpy())
    finally:
        groups.reset_mesh()


def run_ring(leg, rank, world):
    import torch
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.comm import functional
    x = torch.from_numpy(_block(leg["x"], 0, rank, world))
    group = dist.get_world_group()
    return dict(next=functional.send_next_recv_prev(x, group).numpy(),
                prev=functional.send_prev_recv_next(x, group).numpy())


def _qkv_grads(q, k, v, out):
    (out ** 2).sum().backward()
    return dict(out=out.detach().numpy(), dq=q.grad.numpy(),
                dk=k.grad.numpy(), dv=v.grad.numpy())


def _leaves(leg, names, rank, sp):
    import torch
    return [torch.from_numpy(_block(leg[x], 1, rank, sp)).requires_grad_()
            for x in names]


def run_ring_attn(leg, rank, world):
    """Ring attention over an sp group of ``leg["sp"]`` ranks (the mesh's sp
    axis; dp the rest): this rank's sequence block of q, k, v, its output
    block and the gradients of ``sum(out ** 2)``; rank 0 also runs the
    one-device ring of the same sp over the whole inputs
    (``ring_attention_blocks``, the exchange replaced by indexing)."""
    import torch
    from deepspeed_tpu_torch.sequence import ring_attention as ra
    from deepspeed_tpu_torch.utils import groups
    sp = leg["sp"]
    groups.initialize_mesh(sp=sp)
    try:
        group = groups._get_sequence_parallel_group()
        q, k, v = _leaves(leg, "qkv", group.rank(), sp)
        got = _qkv_grads(q, k, v, ra.ring_attention_local(
            q, k, v, group, causal=leg["causal"]))
        if rank == 0:
            q, k, v = _leaves(leg, "qkv", 0, 1)
            got["one_device"] = _qkv_grads(q, k, v, ra.ring_attention_blocks(
                q, k, v, sp, causal=leg["causal"]))
        return got
    finally:
        groups.reset_mesh()


def run_fpdt_attn(leg, rank, world):
    """``FPDT_Attention`` (Ulysses + chunked local attention) over an sp
    group of the whole world: this rank's output block and the gradients
    of ``sum(out ** 2)``."""
    from deepspeed_tpu_torch.sequence.fpdt_layer import FPDT_Attention
    from deepspeed_tpu_torch.utils import groups
    groups.initialize_mesh(sp=world)
    try:
        q, k, v = _leaves(leg, "qkv", rank, world)
        attn = FPDT_Attention(q_chunk=leg["chunk"], kv_chunk=leg["chunk"],
                              causal=True)
        return _qkv_grads(q, k, v, attn(q, k, v))
    finally:
        groups.reset_mesh()


def run_ac_partition(leg, rank, world):
    """``partition_activations`` over a tp group of the whole world: a
    two-block model (the leg's weights, replicated) through
    ``checkpointing.checkpoint`` with the flag on and off; the loss and the
    gradients of x and the weights each time, and what one saved
    activation packs to (this rank's slice) and unpacks to."""
    import torch
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as ac
    from deepspeed_tpu_torch.utils import groups
    groups.initialize_mesh(tp=world)
    try:
        out = {}
        for flag in (False, True):
            ac.configure(partition_activations=flag)
            x = torch.from_numpy(leg["x"]).requires_grad_()
            ws = [torch.from_numpy(w).requires_grad_() for w in leg["ws"]]
            h = x
            for w in ws:
                h = ac.checkpoint(lambda a, b: torch.tanh(a @ b), h, w)
            loss = (h ** 2).sum()
            loss.backward()
            out[flag] = dict(loss=float(loss), dx=x.grad.numpy(),
                             dws=[w.grad.numpy() for w in ws])
        hooks = ac._SavedActivations(groups._get_tensor_parallel_group(),
                                     False)
        packed = hooks.pack_hook(torch.from_numpy(leg["x"]))
        out["packed_shape"] = tuple(packed[0].shape)
        out["unpacked"] = hooks.unpack_hook(packed).numpy()
        return out
    finally:
        ac.reset()
        groups.reset_mesh()


def run_codec(leg, rank, world):
    import torch
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.runtime.comm import compressed as c
    group = dist.get_world_group()
    xs = [torch.from_numpy(a[rank]) for a in leg["inputs"]]
    sizes = [c.error_shapes(x.numel(), world) for x in xs]
    we = [torch.zeros(a) for a, _ in sizes]
    se = [torch.zeros(b) for _, b in sizes]
    single = []
    for _ in range(leg["calls"]):
        out, w, s = c.compressed_allreduce(xs[0], we[0], se[0], group)
        we[0], se[0] = w, s
        single.append((out.numpy(), w.numpy(), s.numpy()))
    we = [torch.zeros(a) for a, _ in sizes]
    se = [torch.zeros(b) for _, b in sizes]
    many = []
    for _ in range(leg["calls"]):
        outs, we, se = c.compressed_allreduce_many(xs, we, se, group)
        many.append([o.numpy() for o in outs])
    backend = c.CompressedBackend(group)
    shim = [backend.compressed_allreduce(xs[0]).numpy()
            for _ in range(leg["calls"])]
    return dict(single=single, many=many, shim=shim)


def run_stream(leg, rank, world):
    import deepspeed_tpu_torch

    def build(config, tree=True):
        model, start = _model(leg["model"], leg["cfg"], leg["tree"])
        return deepspeed_tpu_torch.initialize(
            model=model, model_parameters=start if tree else None,
            config=dict(config), device="cpu")[0]

    def master(engine):
        return {n: t.numpy().copy()
                for n, t in engine.get_fp32_param().items()}

    def train(engine, batches):
        out = []
        for batch in batches:
            loss = engine(*engine.shard_batch(*batch))
            engine.backward(loss)
            engine.step()
            out.append(float(loss))
        return out

    config = dict(leg["config"])
    if leg.get("universal"):
        config["checkpoint"] = {"load_universal": True}
    engine = build(config, tree=not (leg.get("load") or
                                     leg.get("universal")))
    loaded = None
    if leg.get("load") or leg.get("universal"):
        engine.load_checkpoint(leg.get("load") or leg["universal"])
        loaded = master(engine)
    k = leg.get("save_at")
    batches = leg["batches"]
    losses = train(engine, batches if k is None else batches[:k + 1])
    out = dict(loaded=loaded, steps=engine.global_steps,
               store_numel={key: engine._store.shard_numel(key)
                            for key in engine._store.keys()},
               threads=engine._store.threads)
    if k is None:
        return dict(out, losses=losses, master=master(engine))
    saved = master(engine)
    engine.save_checkpoint(leg["dir"], tag="t")
    rest = train(engine, batches[k + 1:])
    fresh = build(leg["config"], tree=False)
    fresh.load_checkpoint(leg["dir"])
    return dict(out, losses=losses + rest, master=master(engine),
                saved=saved, resumed_master=master(fresh),
                resumed=train(fresh, batches[k + 1:]))


def run_domino_overlap(leg, rank, world):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.domino import domino_ab
    model, start = _model(leg["model"], leg["cfg"], leg["tree"])
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=start, config=dict(leg["config"]),
        device="cpu", tp_rules=leg.get("tp_rules"))
    ids = torch.from_numpy(leg["ids"]).long()
    with torch.no_grad():
        return domino_ab(engine.module, ids, labels=ids, n_streams=2)


def run_groups(leg, rank, world):
    import torch
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.utils import groups
    out = []
    for kw in leg["meshes"]:
        if leg.get("expect_error"):
            try:
                groups.initialize_mesh(**kw)
            except Exception as e:       # the refusal under test
                out.append(dict(error=type(e).__name__, message=str(e)))
            else:
                out.append(dict(error=None, message=""))
            continue
        st = groups.initialize_mesh(**kw)
        got = dict(member=st.member, coord=dict(st.coord))
        named = [("tp", groups._get_tensor_parallel_group()),
                 ("data", groups._get_data_parallel_group())]
        if leg.get("more"):
            named += [("sp", groups._get_sequence_parallel_group()),
                      ("pp", groups._get_pipe_parallel_group())]
            zp = groups._get_zero_param_partition_group()
            if zp is not None:
                named.append(("zp", zp))
        for key, g in named:
            g = g.as_flat()
            ranks = torch.zeros(world)
            ranks[rank] = 1.0
            got[key] = dict(size=g.size(), rank=g.rank(), members=[
                i for i, v in enumerate(
                    dist.all_reduce(ranks, group=g).tolist()) if v])
        out.append(got)
    groups.reset_mesh()
    return out


def run_functional(leg, rank, world):
    """``comm/functional.py``'s collectives and ``module_inject``'s
    parallel layers over the world: each op's output and the gradient of
    ``sum(out * c)`` in its input, ``c`` rank r's row of the leg's
    cotangents."""
    import torch
    from deepspeed_tpu_torch.comm import functional as fn
    from deepspeed_tpu_torch.comm.backend import ProcessGroup
    from deepspeed_tpu_torch.module_inject import layers
    g = ProcessGroup(("tp", ))
    ops = {"psum": fn.psum, "pmean": fn.pmean, "pmax": fn.pmax,
           "pmin": fn.pmin, "all_gather": fn.all_gather,
           "reduce_scatter": fn.reduce_scatter,
           "copy_to": fn.copy_to_tp_region,
           "reduce_from": fn.reduce_from_tp_region,
           "gather_from": fn.gather_from_tp_region}
    out = {}
    for name, op in ops.items():
        x = torch.from_numpy(leg["x"][rank]).requires_grad_()
        y = op(x, g)
        c = torch.from_numpy(leg["c"][rank][:y.numel()])
        (y * c).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    # a column-parallel then a row-parallel linear, and the vocabulary-
    # parallel embedding, each cut from the whole layer
    full1 = torch.nn.Linear(8, 4 * world, bias=True, dtype=torch.float64)
    full2 = torch.nn.Linear(4 * world, 8, bias=True, dtype=torch.float64)
    emb = torch.nn.Embedding(4 * world, 8, dtype=torch.float64)
    with torch.no_grad():
        for m, key in ((full1, "w1"), (full2, "w2")):
            m.weight.copy_(torch.from_numpy(leg[key]))
            m.bias.copy_(torch.from_numpy(leg[key + "_b"]))
        emb.weight.copy_(torch.from_numpy(leg["table"]))
    col = layers.ColumnParallelLinear.from_linear(full1, g, rank, world)
    row = layers.RowParallelLinear.from_linear(full2, g, rank, world)
    vocab = layers.VocabParallelEmbedding.from_embedding(emb, g, rank,
                                                         world)
    X = torch.from_numpy(leg["X"]).requires_grad_()
    Y = row(torch.tanh(col(X)))
    (Y * torch.from_numpy(leg["C"])).sum().backward()
    out["mlp"] = (Y.detach().numpy(), X.grad.numpy())
    out["embedding"] = vocab(torch.from_numpy(leg["ids"])).numpy()
    out["vocab_start"] = vocab.vocab_start
    return out


def run_serve(leg, rank, world):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  build_hf_engine)
    from deepspeed_tpu_torch.models import llama, mixtral
    if leg.get("hf_dir"):
        eng = build_hf_engine(leg["hf_dir"], dict(leg["config"]),
                              device="cpu")
    else:
        mod = {"llama": llama, "mixtral": mixtral}[leg["model"]]
        cfg = getattr(mod, leg["model"] + "_tiny")(**leg["cfg"])
        cls = (mod.MixtralModel if leg["model"] == "mixtral"
               else mod.LlamaModel)
        model = cls(cfg, device="meta")
        params = mod.params_from_flax(leg["tree"], cfg, dtype=cfg.dtype)
        eng = InferenceEngineV2(model, params, config=dict(leg["config"]),
                                device="cpu")
    new = leg["new"]
    out = dict(generate=eng.generate(leg["prompts"], max_new_tokens=new),
               burst_steps=getattr(eng, "burst_steps", 0),
               kv_shape=tuple(eng.kv_cache.data.shape),
               shapes={n: tuple(p.shape)
                       for n, p in eng.module.named_parameters()})
    eng.burst_steps = 0
    # put / query / flush, one step at a time, then a decode burst
    uids = [100 + i for i in range(len(leg["prompts"]))]
    eng.put(uids, leg["prompts"])
    got = {u: [] for u in uids}
    while any(len(got[u]) < 2 for u in uids):
        for uid, tok in eng.schedule_step().items():
            got[uid].append(tok)
            eng.state_manager.get_sequence(uid).tokens.append(tok)
    burst = eng.burst_decode(uids, max_tokens=new - 2)
    out["stepped"] = {u: got[u] + burst.get(u, [])[:-1] for u in uids}
    out["queried"] = {u: eng.query(u)["length"] for u in uids}
    eng.flush(uids)
    out["flushed"] = [eng.query(u) for u in uids]
    return out


def main():
    spec, out_dir = sys.argv[1], sys.argv[2]
    import torch
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm as dist
    dist.init_distributed(dist_backend="gloo", verbose=False)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(spec, "rb") as f:
        legs = pickle.load(f)
    for leg in legs:
        fn = {"comm": run_comm, "comm_log": run_comm_log,
              "train": run_train, "ckpt": run_ckpt, "coll": run_coll,
              "refuse": run_refuse, "pipe": run_pipe,
              "ulysses": run_ulysses, "ring": run_ring,
              "codec": run_codec, "stream": run_stream,
              "moe_local": run_moe_local, "groups": run_groups,
              "serve": run_serve, "functional": run_functional,
              "moe_shards": run_moe_shards, "ring_attn": run_ring_attn,
              "fpdt_attn": run_fpdt_attn,
              "ac_partition": run_ac_partition,
              "domino_overlap": run_domino_overlap,
              "mixtral_grads": run_mixtral_grads}[leg["kind"]]
        out = fn(leg, rank, world)
        with open(os.path.join(out_dir, f"{leg['name']}.r{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
