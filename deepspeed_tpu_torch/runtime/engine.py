"""DeepSpeedEngine, ZeRO stages 0-3 (the port of
``deepspeed_tpu/runtime/engine.py``; reference ``runtime/engine.py:183``).

The JAX engine owns a jitted train step over a mesh; this one owns a torch
module on one CUDA card (or, asked by name, the CPU) in each rank of a
``torch.distributed`` world (``comm/``; NCCL on the card, gloo on the CPU),
or, when no world is asked for, described or up, in one rank on a local
group (:meth:`DeepSpeedEngine._init_comm`):

* parameters (``_install_parameters``, ``engine.py:494-528``): every leaf
  in the compute dtype (bf16, fp16 or fp32; norm weights and the LM head
  too), laid out in ONE flat buffer whose slices become the module's
  parameters; with bf16 or fp16 an fp32 master of the same layout is kept.
  The gradient accumulator and the optimizer's state share that layout, so
  the boundary update is one launch of an optimizer kernel over all leaves
  (B2 Adam, B8 Lion) or one per phase (B3 LAMB).
* ``forward`` runs the model and keeps the graph; ``backward`` runs
  autograd on the loss times the loss scale and folds the micro-step's
  gradients, cast to ``grad_accum_dtype``, into the accumulator
  (``engine.py:1302-1305``, ``:1444-1448``).  The JAX engine computes the
  gradients inside ``forward`` (one ``value_and_grad`` program) and only
  folds them in ``backward``; here the backward pass itself runs in
  ``backward``.
* ``step`` at the accumulation boundary, in ``engine.py:1469-1535``'s
  order: unscale by 1/scale, the overflow check on the unscaled gradient
  (fp16 or the finite-grad guard), global norm, the guard's spike test,
  clip, optimizer, skip, scaler update.  The unscale and the clip
  coefficient ride into the optimizer kernel as one device scalar, so they
  cost no pass of their own.  On a skipped step the JAX engine computes the
  update and selects the old state (``:1496-1501``); here the flag is read
  on the host once per boundary (only when fp16 or the guard is on, as the
  JAX guard syncs at ``:1584``) and nothing is launched: the master, the
  moments, the optimizer's count and so its lr stay as they were.
* ZeRO (``runtime/zero/partition.py``, the design of the reference's
  ``stage_1_and_2.py``): the flat buffers are padded to a multiple of
  ``world × 16`` elements and rank r owns the r-th slice.  Stage 1 keeps
  the fp32 master and the moments as that shard; the full accumulator is
  reduce-scattered (SUM) into it at the boundary.  Stage 2 reduce-scatters
  each micro-step's gradients as soon as ``backward`` has folded them and
  adds them into a shard-sized accumulator; no full-size one lives across
  micro-steps.  The norm is the all-reduced sum of the shards' squares,
  the overflow and spike flags are all-reduced (MAX) so every rank skips
  the same steps, the optimizer kernel runs on the shard, and the updated
  compute-dtype shard is all-gathered in place into the flat parameters
  the module's parameters view.  At world size > 1 without ZeRO the
  accumulator is all-reduced instead.
* ZeRO 3, and stage 2 with ``overlap_comm`` (``runtime/zero/overlap.py``,
  the design of the reference's ``stage3.py``): the layout is one unit a
  block of the model, an outer unit and (stage 3) a persistent unit, each
  padded and sliced over the ranks; the shard is the rank's slices.  Each
  unit's gradients are reduce-scattered into the shard accumulator as soon
  as backward has produced them.  At stage 3 ``self.params`` is the
  compute-dtype shard: a block's parameters are gathered into its buffer
  just before it runs, forward and backward, and released after; the step
  gathers no parameters but the persistent unit's.  Bucketed stage 2 keeps
  the parameters whole and gathers them unit by unit after the step.
* Checkpoints (``runtime/checkpoint_engine.py``): every rank writes its
  shard in upstream DeepSpeed's per-rank files and loads at any world size
  and stage; the JAX package's manifest, rollback and async commit.
* ZeRO++ and MiCS (``runtime/zero/zeropp.py``): qwZ gathers and qgZ
  reduce-scatters on quantized wires (B5, B6), the 2-hop reduce where a
  hierarchy exists, hpZ's parameters sharded over the ``zp`` group and
  MiCS's state over the shard group; one ``ZeroComm`` chooses each
  collective's group and wire, and the collectives engine it holds counts
  each pick (``zeropp_dispatch_counts``).
* Offload (``runtime/offload.py``): ``offload_optimizer`` cpu keeps the
  fp32 master and moments in pinned host memory, which the optimizer
  kernels update in place; nvme keeps them in files between steps, with
  the host optimizer step; ``offload_states``/``reload_states``.
  ``offload_param`` (parameter streaming) is ``runtime/infinity_engine.py``.
* Sequence parallelism (``sequence_parallel_size``, ``mesh.sp`` or
  ``mesh_param=(dp, sp)``): ``shard_batch`` gives each rank its dp rows
  and its sp chunk of the sequence (JAX ``engine.py:1058-1064``), the model
  runs Ulysses over the sp group (``use_ulysses``), and the gradients and
  the ZeRO shards span the sequence-data-parallel group, dp × sp (JAX
  ``:281``): the engine's data group below.  The pipeline engine
  (``runtime/pipe/engine.py``) trains one stage a rank over its own data
  group.
* The loss over the global batch: the JAX engine runs one program on the
  global batch, whose loss is the masked mean over every rank's rows.  A
  model whose ``forward`` takes ``loss_reduction`` hands back the masked
  sum and its count; the engine divides by the all-reduced count, so the
  loss and the gradients (summed over the ranks) are JAX's whatever each
  rank's count.  Other modules' per-rank means are averaged: their
  gradients are summed, then × 1/world, which rides into the optimizer's
  gradient scale.
"""

import atexit
import inspect
import os
import sys
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import comm as dist
from ..accelerator import accelerator_for, resolve_device
from ..comm import ReduceOp
from ..module_inject.auto_tp import tp_local, tp_trim
from ..ops.adam import FlatTransform, fused_adam
from ..ops.lamb import FusedLambTransform, fused_lamb
from ..ops.lion import fused_lion, sgd
from ..utils import groups
from ..utils.logging import log_dist, logger
from ..utils.not_ported import not_ported
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER, NoopTimer,
                           SynchronizedWallClockTimer)
from .config import (ADAM_OPTIMIZERS, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER,
                     FUSED_LAMB_OPTIMIZER, LAMB_OPTIMIZER, LION_OPTIMIZER,
                     ONEBIT_OPTIMIZERS, SGD_OPTIMIZER, DeepSpeedConfig)
from .loss_scaler import create_loss_scaler, has_overflow
from .lr_schedules import get_lr_scheduler
from .offload import OffloadMixin
from .utils import (clip_coefficient, count_parameters, global_grad_norm,
                    make_scaled_loss_fn)
from .zero.overlap import (MB, Unit, ZeroCoordinator, block_modules,
                           gather_items)
from .zero.partition import (ALIGN as _ALIGN, BLOCK, OUTER, PERSISTENT,
                             ZeroPartitionPlan, min_partition_size)
from .zero.zeropp import ZeroComm, check_shard_sizes

# _ALIGN (16 elements): every leaf starts 64-byte aligned in fp32 buffers
_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32,
                 "bf16": torch.bfloat16, "fp16": torch.float16}


def flat_layout(named_shapes):
    """[(name, offset, numel, shape)] of leaves packed into one flat buffer,
    each starting at a multiple of ``_ALIGN`` elements, and the buffer's
    length.  ``named_shapes``: (name, shape) pairs."""
    layout, off = [], 0
    for name, shape in named_shapes:
        n = int(np.prod(shape, dtype=np.int64))
        layout.append((name, off, n, tuple(shape)))
        off += -(-n // _ALIGN) * _ALIGN
    return layout, off


def _optimizer_from_config(name, p, lr_fn):
    """The JAX engine's config → optimizer dispatch (``engine.py:598-634``),
    with its defaults; keys it does not read are not read here either."""
    lr = p.pop("lr", 1e-3)
    if name in ADAM_OPTIMIZERS:
        adam_w = p.pop("adam_w_mode", name in (ADAMW_OPTIMIZER,
                                               FUSED_ADAM_OPTIMIZER))
        return fused_adam(
            lr=lr, betas=tuple(p.pop("betas", (0.9, 0.999))),
            eps=p.pop("eps", 1e-8), weight_decay=p.pop("weight_decay", 0.0),
            adam_w_mode=adam_w, bias_correction=p.pop("bias_correction", True),
            lr_fn=lr_fn)
    if name in (LAMB_OPTIMIZER, FUSED_LAMB_OPTIMIZER):
        return fused_lamb(
            lr=lr, betas=tuple(p.pop("betas", (0.9, 0.999))),
            eps=p.pop("eps", 1e-8), weight_decay=p.pop("weight_decay", 0.0),
            max_coeff=p.pop("max_coeff", 10.0),
            min_coeff=p.pop("min_coeff", 0.01), lr_fn=lr_fn)
    if name == LION_OPTIMIZER:
        return fused_lion(lr=lr, betas=tuple(p.pop("betas", (0.9, 0.99))),
                          weight_decay=p.pop("weight_decay", 0.0),
                          lr_fn=lr_fn)
    if name == SGD_OPTIMIZER:
        return sgd(lr=lr, momentum=p.pop("momentum", 0.0),
                   weight_decay=p.pop("weight_decay", 0.0), lr_fn=lr_fn)
    if name in ONEBIT_OPTIMIZERS:
        from .fp16 import onebit
        cls = {"onebitadam": onebit.OnebitAdam,
               "onebitlamb": onebit.OnebitLamb,
               "zerooneadam": onebit.ZeroOneAdam}[name]
        return cls(lr=lr, lr_fn=lr_fn, **p)
    raise ValueError(f"unsupported optimizer {name!r}")


class _ParamGroup(dict):
    """torch-style param group whose ``["lr"] = x`` writes reach the
    optimizer's ``lr_override`` (``engine.py:70``)."""

    def __init__(self, engine, **kw):
        super().__init__(**kw)
        self._engine = engine

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "lr" and value is not None:
            self._engine._set_client_lr(float(value))

    # dict.update/setdefault bypass __setitem__ on subclasses
    def update(self, *args, **kw):
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


class _OptimizerFacade:
    """torch-optimizer-shaped view of the engine's optimizer state
    (``engine.py:98``): ``param_groups`` writes take effect."""

    def __init__(self, engine):
        self._engine = engine
        self.param_groups = [_ParamGroup(engine, lr=None)]

    def state_dict(self):
        return {"opt_state": self._engine.opt_state}

    def load_state_dict(self, sd):
        self._engine.opt_state = sd["opt_state"]

    def zero_grad(self, set_to_none=True):
        pass  # the accumulator restarts at each boundary

    def step(self):
        self._engine.step()

    @property
    def loss_scale(self):
        return self._engine.cur_scale


class DeepSpeedEngine(OffloadMixin):

    # the mesh's other axes (set by _init_comm)
    pp_world_size, stage_id = 1, 0
    tp_world_size, tp_rank = 1, 0
    # {leaf name: (dim, tp rank, tp size)} of the tp-sharded leaves
    _tp_splits = {}
    # ZeRO 3's gather prefetch in forward order (the pipeline turns it off)
    _gather_prefetch = True
    seq_parallel_world_size, seq_parallel_rank = 1, 0

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, collate_fn=None, config=None, mpu=None,
                 device=None, mesh_param=None, dist_init_required=None,
                 distributed_port=29500, tp_rules=None):
        if not isinstance(config, DeepSpeedConfig):
            config = DeepSpeedConfig(config)
        # mpu (reference model-parallel unit): accepted and unused, as in
        # JAX (engine.py:194-242); the mesh carries the topology
        if training_data is not None or collate_fn is not None:
            raise not_ported("initialize(training_data=..., collate_fn=...) "
                             "(the dataloader)", 4)
        self._config = config
        self.device = resolve_device(device)
        self.training = True
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._init_comm(mesh_param, dist_init_required, distributed_port,
                        model)
        if self.device.type == "cuda" and torch.device(
                device or "cuda").index is None:
            # NCCL's init bound this process to its LOCAL_RANK card
            self.device = resolve_device(device)
        self.module = model = self._build_module(model)
        self._shard_for_tp(model, tp_rules)
        config.resolve_batch_sizes(self.dp_world_size)
        # a 1-bit optimizer reduces the gradients itself, from each rank's
        # own (runtime/fp16/onebit/common.py)
        self._onebit = optimizer is None and \
            config.optimizer_name in ONEBIT_OPTIMIZERS
        self._configure_moe(model)

        self.compute_dtype = (torch.bfloat16 if config.bfloat16_enabled
                              else torch.float16 if config.fp16_enabled
                              else torch.float32)
        self.loss_scaler = create_loss_scaler(config.fp16_enabled,
                                              config.loss_scale,
                                              config.dynamic_loss_scale_args)
        self.scale_state = self.loss_scaler.init()
        self.skipped_steps = 0
        self._finite_guard = config.finite_grads_config
        self._consecutive_skips = 0
        self._gnorm_ema = None   # host-side running mean for spike detection
        self.grad_accum_dtype = _ACCUM_DTYPES[
            config.gradient_accumulation_dtype]
        self.zero_stage = config.zero_optimization_stage
        self.zero_plan = None
        if self._onebit:
            from .fp16.onebit.common import check_compatible
            check_compatible(self, config.optimizer_name)
        # the loss-returning call of a micro-step: the model, or its
        # µ-streams under Domino (JAX engine.py:1230-1240)
        self._apply = model
        dc = config.domino_config
        if dc.enabled:
            from .domino.transformer import split_microstreams
            self._apply = split_microstreams(model, dc.n_streams)
        self._loss_fn = make_scaled_loss_fn(self._apply,
                                            self.gradient_accumulation_steps())
        # the loss over the global batch (module docstring); a 1-bit
        # optimizer takes each rank's mean, as JAX's 1-bit micro-step does
        self._global_loss = self._data_world > 1 and not self._onebit and \
            "loss_reduction" in inspect.signature(model.forward).parameters
        self.timers = (SynchronizedWallClockTimer(accelerator_for(
            self.device)) if config.wall_clock_breakdown else NoopTimer())
        ac = config.activation_checkpointing_config
        if (ac.partition_activations or ac.cpu_checkpointing or
                ac.contiguous_memory_optimization or ac.number_checkpoints):
            # JAX engine.py:335-339: what checkpointing.checkpoint runs
            from .activation_checkpointing import configure
            configure(deepspeed_config=config)

        self.params = None        # flat, compute dtype; module params view it
        self._pshard = None       # bucketed stage 2: the update's output
        self._coord = None        # bucketed plans: ZeroCoordinator
        self.master = None        # flat fp32 (mixed precision only)
        self.grad_acc = None
        self.opt_state = None
        self._layout = None       # [(name, offset, numel, shape)]
        self._pending_loss = None
        self._acc_fresh = True
        self._pending_client_lr = None
        self._last_gnorm = None
        self._last_skipped = False
        self.last_checkpoint = None   # the last save's handle (its stats())
        self._configure_offload()
        self._split_experts(model)
        if model_parameters is not None or not any(
                p.is_meta for p in model.parameters()):
            self._install_parameters(model_parameters)

        self.optimizer = None
        self._transform = None
        self._configure_optimizer(optimizer)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.training_dataloader = None
        if self.params is not None:
            log_dist(f"DeepSpeedEngine ready: zero_stage={self.zero_stage} "
                     f"dtype={self.compute_dtype} device={self.device} "
                     f"params={count_parameters(self.module):,}", ranks=[0])

    # ------------------------------------------------------------------ setup
    def _build_module(self, model):
        """The ``nn.Module`` this engine trains (the pipeline engine: its
        stage's layers)."""
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module")
        if self.pp_world_size > 1:
            raise ValueError(
                f"mesh pp={self.pp_world_size} trains a PipelineModule: "
                "initialize(model=PipelineModule(...))")
        return model

    def _requested_mesh(self, mesh_param, model):
        """(pp, sp) the config and ``mesh_param=(dp, sp)`` ask for."""
        sp = self._config.mesh_sp
        if mesh_param is not None and len(tuple(mesh_param)) > 1:
            want = tuple(mesh_param)[1]
            if want not in (None, 1):
                if sp not in (1, want):
                    raise ValueError(f"mesh_param sp={want} but the config "
                                     f"asks for sp={sp}")
                sp = int(want)
        return self._config.mesh_pp, sp

    def _init_comm(self, mesh_param, dist_init_required, distributed_port,
                   model=None):
        """The comm world (``engine.py:225-246``), the mesh and this
        engine's groups.  The world (on the backend the engine's device
        needs) comes up when the caller asks for it
        (``dist_init_required``), when the environment describes more than
        one rank, or when one on that backend is already up.  Otherwise the
        engine is one rank on a local group: no process-wide backend is
        pinned, and its collectives are the one-rank identities.  The mesh
        takes the config's pp and sp (and hpZ/MiCS's shard groups); a mesh
        built before with other sizes is rebuilt (every rank builds it)."""
        dp_want = [self._config.mesh_dp]
        if mesh_param is not None:
            dp_want.append(tuple(mesh_param)[0])
        pp, sp = self._requested_mesh(mesh_param, model)
        ep, tp = self._config.mesh_ep, self._config.mesh_tp
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        zp = check_shard_sizes(self._config.zero_config)
        if (dist_init_required is None and dist.env_world_size() == 1
                and not dist.world_is_up(backend)):
            if pp * sp * ep * tp > 1:
                raise ValueError(f"pp={pp} × sp={sp} × ep={ep} × tp={tp} "
                                 "needs a world of that many ranks; this "
                                 "process has none (pass "
                                 "dist_init_required=True or launch ranks)")
            dist.configure(config=self._config)
            self.dp_world_size, self.dp_rank = 1, 0
            if zp is not None:
                raise ValueError(
                    f"zero_partition_size={zp} must divide dp=1")
            local = dist.ProcessGroup(groups.dp_axes(), local=True)
            self._dp_group = local
            self._sp_group = self._pp_group = self._tp_group = local
        else:
            premade = groups.mesh_is_initialized() and \
                groups.get_mesh_state().user_built
            dist.init_distributed(
                dist_backend=backend, distributed_port=distributed_port,
                dist_init_required=dist_init_required, config=self._config)
            st = groups.get_mesh_state()
            if st.ranks is not None:
                raise ValueError("the engine trains over the whole world; "
                                 "the mesh was built over the device subset "
                                 f"{list(st.ranks)}")
            if premade:
                # sizes the config leaves at 1 merge from the user's mesh
                pp = pp if pp > 1 else st.pp
                sp = sp if sp > 1 else st.sp
                ep = ep if ep > 1 else st.ep
                tp = tp if tp > 1 else st.tp
            if dist.get_world_size() % (pp * sp * tp):
                raise ValueError(f"pp={pp} × sp={sp} × tp={tp} does not "
                                 "divide the world of "
                                 f"{dist.get_world_size()} ranks")
            if zp is not None and st.zero_partition_size != zp and premade:
                # a pre-built mesh without the matching factoring would
                # silently drop hpZ/MiCS (JAX engine.py:230-238)
                raise ValueError(
                    f"config requests zero partition groups of {zp} but "
                    f"the mesh was pre-initialized with "
                    f"zero_partition_size={st.zero_partition_size}; pass "
                    "zero_partition_size to groups.initialize_mesh()")
            sizes = (pp, sp, ep, tp)
            if (st.zero_partition_size != zp and zp is not None) or \
                    (st.pp, st.sp, st.ep, st.tp) != sizes:
                if (st.pp, st.sp, st.ep, st.tp) != sizes and premade:
                    logger.warning(
                        f"mesh built as pp={st.pp} sp={st.sp} ep={st.ep} "
                        f"tp={st.tp}; the config asks for pp={pp} sp={sp} "
                        f"ep={ep} tp={tp}: rebuilding it")
                groups.initialize_mesh(pp=pp, sp=sp, ep=ep, tp=tp,
                                       zero_partition_size=zp,
                                       user_built=False)
                dist.configure(config=self._config)
            self.dp_world_size = groups._get_data_parallel_world_size()
            self.dp_rank = groups._get_data_parallel_rank()
            # the engine's own collectives take the wires its plan chooses;
            # gradients reduce and ZeRO shards over dp × sp
            self._dp_group = \
                groups._get_sequence_data_parallel_group().as_flat()
            self._sp_group = groups._get_sequence_parallel_group()
            self._pp_group = groups._get_pipe_parallel_group()
            self._tp_group = groups._get_tensor_parallel_group().as_flat()
        for want in dp_want:
            if want not in (None, -1) and want != self.dp_world_size:
                raise ValueError(f"mesh dp={want} but the world has "
                                 f"{self.dp_world_size} ranks")
        self.seq_parallel_world_size = self._sp_group.size()
        self.seq_parallel_rank = self._sp_group.rank()
        self.pp_world_size = self._pp_group.size()
        self.stage_id = self._pp_group.rank()
        self.tp_world_size = self._tp_group.size()
        self.tp_rank = self._tp_group.rank()
        self._zcomm = ZeroComm(self._config, self._config.zero_config.stage,
                               self._dp_group)
        self._shard_group = self._zcomm.shard_group

    def _shard_for_tp(self, model, tp_rules):
        """At tp > 1 (JAX ``engine.py:284-310``, ``:539-546``): the rules
        (``tp_rules``, else ``model.tp_sharding_rules``, else derived from
        the model's dataflow, ``module_inject/tp_parser.py``) cut the model
        to this rank's slices over the tp group
        (``module_inject/auto_tp.py:shard_params_for_tp``).  ``_tp_splits``:
        {leaf name: (dim, tp rank, tp size)} of the sharded leaves; empty
        at tp 1.  The Llama family (Mixtral with ``mixtral.tp_rules``:
        the expert stacks cut on I), GPT-2 and BERT train at tp (their
        forwards make the tp collectives); the 1-bit optimizers and
        parameter streaming refuse tp as the reference does
        (``fp16/onebit/common.py:check_compatible``, ``__init__.py``)."""
        self._tp_splits = {}
        if self.tp_world_size == 1:
            return
        from ..models.bert import BertModel
        from ..models.gpt2 import GPT2Model
        from ..models.llama import LlamaModel
        from ..module_inject.auto_tp import shard_params_for_tp
        from .pipe.module import PipeStage
        if isinstance(model, PipeStage) and tp_rules is None:
            raise ValueError("a pipeline at tp > 1 takes its tp_rules from "
                             "the caller (initialize(tp_rules=...)): its "
                             "stage layers name their own leaves")
        if not isinstance(model, (LlamaModel, GPT2Model, BertModel,
                                  PipeStage)):
            # a model whose forward makes no tp collectives would train on
            # slices as if they were whole
            raise ValueError(f"{type(model).__name__} has no tensor-"
                             "parallel forward: the Llama family, GPT-2 "
                             "and BERT train at tp > 1")
        if tp_rules is None:
            tp_rules = getattr(model, "tp_sharding_rules", None)
        if tp_rules is None:
            from ..module_inject.tp_parser import \
                derive_tp_rules_from_dataflow
            twin = type(model)(model.config, device="meta")
            tp_rules = derive_tp_rules_from_dataflow(
                twin, torch.zeros((1, 8), dtype=torch.long, device="meta"))
            log_dist(f"AutoTP derived {len(tp_rules)} sharding rules from "
                     "dataflow", ranks=[0])
        self.tp_rules = tp_rules
        shard_params_for_tp(model, tp_rules, group=self._tp_group)
        self._tp_splits = dict(model.tp_splits)

    def _configure_moe(self, model):
        """The ``moe`` block's dispatch options (JAX ``engine.py:287-307``;
        disabled: the flat exchange), the 2-hop dispatch's subgroups, and
        the noisy gates' generator (JAX's per-step gating key: seeded from
        ``moe.gating_seed``, else the config's ``seed``, and reseeded at
        each micro-step).  The MoE layer gates over the global batch, or
        per rank where JAX's micro-step is a manual region: the qgZ micro
        (``zero/gspmd.py:manual_micro_reasons``: the ``moe`` block on, or a
        ZeRO group over both dp and ep) and the 1-bit optimizers' micro
        (``fp16/onebit/common.py:build_local_grad_micro``)."""
        from ..moe import engine as moe_engine
        from ..moe.layer import MoE
        moe_cfg = self._config.moe_config
        moe_engine.configure(moe_cfg if moe_cfg.enabled else None,
                             comm_opts=self._config.comm_optimizations_config)
        moe_engine.prepare_hierarchy()
        layers = [m for m in model.modules() if isinstance(m, MoE)]
        st = groups.get_mesh_state() if self._data_world > 1 else None
        moe_engine.set_per_rank_gating(
            bool(layers) and (self._onebit or self._zcomm.qgz and (
                moe_cfg.enabled or (st is not None and st.ep > 1 and
                                    st.dp > st.ep))), self._data_world)
        self._gating = None
        if moe_cfg.enabled and layers:
            seed = moe_cfg.gating_seed if moe_cfg.gating_seed is not None \
                else self._config.seed
            self._gating = (int(seed), torch.Generator(device=self.device))
            for m in layers:
                m.gating_generator = self._gating[1]

    def _reseed_gating(self):
        """The gating generator at this micro-step's seed (the config's
        gating seed and the micro-step count, as JAX folds the step into
        its key)."""
        if self._gating is not None:
            seed, gen = self._gating
            gen.manual_seed(seed * 1_000_003 + self.micro_steps)

    def _split_experts(self, model):
        """The expert-parallel split (JAX ``leaf_zero_axes``, ``partition.py
        :345-376``): at ep > 1 each ``Experts`` stack, and each Mixtral
        block's ``w1``/``w2``/``w3``, keeps this rank's ``E / ep`` experts,
        and the plan shards their leaves over the expert-data group (× sp:
        the ranks that hold the same experts).  ``_experts``: {leaf name:
        (first expert, the rank's count, E)}; empty without the split."""
        from ..models.mixtral import MixtralSparseMoeBlock
        from ..moe.experts import Experts
        self._experts, self._global = {}, None
        self._ep_group = None
        ep = (groups._get_expert_parallel_world_size()
              if self._data_world > 1 else 1)
        stacks = [(p, m) for p, m in model.named_modules()
                  if isinstance(m, (Experts, MixtralSparseMoeBlock))]
        if ep <= 1 or not stacks or self._onebit:
            # the 1-bit optimizers count ep as a data axis (JAX's 1-bit
            # micro-step holds every leaf whole on each of the dp × ep
            # workers, ``fp16/onebit/common.py:build_local_grad_micro``)
            return
        j = groups._get_expert_parallel_rank()
        self._ep_group = groups._get_expert_parallel_group().as_flat()
        for prefix, m in stacks:
            if m.num_experts % ep:
                raise ValueError(
                    f"num_experts={m.num_experts} must be divisible by "
                    f"ep={ep} (expert stacks split their leading dim over "
                    "the ep axis)")
            n = m.num_experts // ep
            mixtral = isinstance(m, MixtralSparseMoeBlock)
            if mixtral:
                m.localize(j * n, (j + 1) * n, self._ep_group)
            else:
                m.localize(j * n, (j + 1) * n)
            for name, _ in m.named_parameters():
                if mixtral and name not in m.EXPERT_LEAVES:
                    continue
                full = f"{prefix}.{name}" if prefix else name
                self._experts[full] = (j * n, n, m.num_experts)
        self._zcomm.expert_group = \
            groups._get_expert_data_sequence_group().as_flat()

    def _local_value(self, name, t):
        """``t``, a value of leaf ``name``, as this rank holds it: an
        expert stack given whole is cut to this rank's experts, a leaf
        sharded over tp to this rank's slice (contiguous)."""
        if name in self._tp_splits:
            t = tp_local(self.module, name, t)
        split = self._experts.get(name)
        if split is not None and t.shape[0] == split[2]:
            return t[split[0]:split[0] + split[1]]
        return t

    def _tp_whole_shape(self, name):
        return self.module.tp_global_shapes[name]

    @property
    def _split_leaves(self):
        """Whether some leaf is held in part (an expert split or tp)."""
        return bool(self._experts or self._tp_splits)

    def _whole_leaf(self, name, t):
        """Leaf ``name``'s whole value from this rank's ``t``: an expert
        stack all-gathered over ep, a tp-sharded leaf over tp along its
        split dim (collectives), else ``t``."""
        tp = self._tp_splits.get(name)
        if tp is not None:
            # a padded leaf (auto_tp.tp_splits) loses its pad rows
            t = tp_trim(dist.all_gather(t.contiguous(), group=self._tp_group,
                                        axis=tp[0]),
                        tp[0], self._tp_whole_shape(name)[tp[0]])
        if name not in self._experts:
            return t
        n = self._ep_group.size()
        out = torch.empty((n * t.shape[0], ) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.allgather_fn(out, t.contiguous(), group=self._ep_group)
        return out

    def global_layout(self):
        """``(layout, numel)`` of the whole model, each leaf at its global
        shape (the layout's order; :meth:`fp32_params` returns a buffer of
        it): the engine's own layout but with the expert split and the tp
        slices whole."""
        if not self._split_leaves:
            return self._layout, self.zero_plan.numel
        if self._global is None:
            shapes = []
            for name, _, _, shape in self._layout:
                split = self._experts.get(name)
                if name in self._tp_splits:
                    shape = self._tp_whole_shape(name)
                elif split is not None:
                    shape = (split[2], ) + tuple(shape[1:])
                shapes.append((name, shape))
            layout, _ = flat_layout(shapes)
            self._global = layout, layout[-1][1] + layout[-1][2]
        return self._global

    def _globalize(self, flat):
        """A buffer of :meth:`global_layout` from one of this rank's
        layout (every rank calls it together at ep > 1 or tp > 1)."""
        if not self._split_leaves:
            return flat
        layout, numel = self.global_layout()
        out = torch.zeros(numel, dtype=flat.dtype, device=flat.device)
        for (name, off, n, shape), (_, go, gn, _) in zip(self._layout,
                                                          layout):
            out[go:go + gn].copy_(self._whole_leaf(
                name, flat[off:off + n].view(shape)).reshape(-1))
        return out

    @property
    def _data_world(self):
        """The size of the data group, the ranks whose gradients sum and
        over which ZeRO shards (dp × sp; ``_dp_group``)."""
        return self.dp_world_size * self.seq_parallel_world_size

    @property
    def _data_rank(self):
        """This rank's place in the data group: its (dp, sp) coordinates,
        most-major first."""
        return self.dp_rank * self.seq_parallel_world_size + \
            self.seq_parallel_rank

    def _tie(self):
        """Let the module share what it shares (``tie_weights``: a tied LM
        head is the embedding), so each shared leaf is trained once."""
        tie = getattr(self.module, "tie_weights", None)
        if tie is not None:
            tie()

    def _bind(self, flat):
        """Make the module's parameters views into ``flat`` (a buffer of
        the whole layout)."""
        for name, off, n, shape in self._layout:
            self._set_param(name, flat[off:off + n].view(shape))
        self._tie()

    def _set_param(self, name, view):
        *path, leaf = name.split(".")
        mod = self.module.get_submodule(".".join(path))
        setattr(mod, leaf, torch.nn.Parameter(view, requires_grad=True))

    def _bind_units(self):
        """Stage 3: the module's parameters, views into their units'
        buffers (made while each buffer is allocated)."""
        for u in self._coord.units:
            with self._coord.allocated(u):
                for name, off, n, shape in u.leaves:
                    self._set_param(name, u.buffer[off:off + n].view(shape))
        self._tie()

    def _units(self, named):
        """[(kind, block module or None, [(name, shape)], expert)]: the
        outer unit, one unit a block (``block_modules``) and, at stage 3,
        the persistent unit of the leaves below the persistence threshold;
        with the expert split each of them twice, its expert leaves apart
        (``expert``); empty units left out."""
        blocks = block_modules(self.module)
        _, whole = gather_items(named, min_partition_size(
            self._config.zero_config) if self.zero_stage == 3 else 0)
        outer, persistent = [], []
        inner = [[] for _ in blocks]
        for name, p in named:
            if name in whole:
                persistent.append((name, p.shape))
                continue
            for (prefix, _), leaves in zip(blocks, inner):
                if name.startswith(prefix + "."):
                    leaves.append((name, p.shape))
                    break
            else:
                outer.append((name, p.shape))
        units = [(OUTER, None, outer)] + [
            (BLOCK, m, leaves) for (_, m), leaves in zip(blocks, inner)]
        units.append((PERSISTENT, None, persistent))
        return [(kind, m, [leaf for leaf in leaves
                           if (leaf[0] in self._experts) == expert], expert)
                for kind, m, leaves in units for expert in (False, True)
                if any((leaf[0] in self._experts) == expert
                       for leaf in leaves)]

    def _plan_units(self, named):
        """The bucketed plan, the flat layout (unit after unit) and the
        coordinator's units."""
        spec, local = self._units(named), []
        for kind, _, leaves, _ in spec:
            local.append(flat_layout(leaves))
        zc = self._config.zero_config
        cfg = self._config
        plan = self._new_plan(
            None, units=[(kind, n, expert) for (kind, _, _, expert), (_, n)
                         in zip(spec, local)],
            schedule=dict(
                min_partition_size=(min_partition_size(zc)
                                    if self.zero_stage == 3 else 1),
                overlap_enabled=cfg.overlap_comm_enabled,
                overlap_max_inflight=cfg.overlap_max_inflight,
                prefetch_enabled=cfg.prefetch_enabled,
                prefetch_bucket_mb=cfg.prefetch_bucket_mb,
                prefetch_max_inflight=cfg.prefetch_max_inflight))
        layout, units = [], []
        for u, ((kind, module, _, _), (leaves, _)) in enumerate(zip(spec,
                                                                     local)):
            base = plan.unit_offset[u]
            layout += [(name, base + off, n, shape)
                       for name, off, n, shape in leaves]
            units.append(Unit(u, kind, module, leaves))
        return plan, layout, units

    def _new_plan(self, numel, **kw):
        """The ZeRO plan over the shard group (the world; MiCS: the rank's
        shard group), with hpZ's parameter partition and the wires of
        ``comm_optimizations``."""
        zc, zcomm = self._config.zero_config, self._zcomm
        # the data group's rank: its coordinates (dp, sp), most-major first
        world, rank = self._data_world, self._data_rank
        if zcomm.mics:
            world, rank = self._shard_group.size(), self._shard_group.rank()
        ed = zcomm.expert_group if self._experts else None
        plan = ZeroPartitionPlan(
            self.zero_stage, world, rank, numel, zc,
            param_world=(zcomm.param_group.size() if zcomm.hpz else None),
            comm_opts=self._config.comm_optimizations_config,
            mics=zcomm.mics, expert_world=ed and ed.size(),
            expert_rank=ed.rank() if ed else 0, **kw)
        zcomm.bind(plan)
        return plan

    def _install_parameters(self, model_parameters=None):
        """Lay every trainable leaf out in flat buffers of the compute
        dtype (and an fp32 master when mixed), from ``model_parameters``
        (name → tensor, e.g. fp32 weights) or the module's own values: one
        buffer of the whole layout, or at stage 3 this rank's shard and the
        persistent unit's buffer."""
        self._tie()
        named = list(self.module.named_parameters())
        zc = self._config.zero_config
        if zc.bucketed:
            plan, layout, units = self._plan_units(named)
        elif self._experts:
            # two units: the dense leaves, the expert leaves
            parts = [flat_layout((n, p.shape) for n, p in named
                                 if (n in self._experts) == expert)
                     for expert in (False, True)]
            plan = self._new_plan(None, units=[
                (OUTER, parts[0][1], False), (OUTER, parts[1][1], True)])
            layout = parts[0][0] + [
                (name, plan.unit_offset[1] + off, n, shape)
                for name, off, n, shape in parts[1][0]]
        else:
            layout, off = flat_layout((n, p.shape) for n, p in named)
            plan = self._new_plan(off)
        plan.leaf_base = {name: self._experts[name][0] * (n // shape[0])
                          for name, _, n, shape in layout
                          if name in self._experts}
        self._layout = layout
        self._global = None
        self.zero_plan = plan
        source = (dict(model_parameters) if model_parameters is not None
                  else {n: p for n, p in named})
        missing = [n for n, *_ in layout if n not in source]
        unknown = sorted(set(source) - {n for n, *_ in layout})
        if missing or unknown:
            raise KeyError(f"model_parameters: missing {missing[:4]}, "
                           f"unknown {unknown[:4]}")
        mixed = self.compute_dtype != torch.float32
        whole = self.zero_stage < 3
        S = plan.shard_numel
        # stage 3: the parameter shard (hpZ: the secondary slices)
        self.params = torch.zeros(plan.padded_numel if whole
                                  else plan.param_numel,
                                  dtype=self.compute_dtype,
                                  device=self.device)
        self._pshard = (torch.zeros(S, dtype=self.compute_dtype,
                                    device=self.device)
                        if (plan.bucketed and whole and plan.sharded)
                        or plan.hpz else None)
        self.master = self._fp32_zeros(S) if mixed else None
        if zc.bucketed:
            self._make_coordinator(units)
        shard = self._param_shard() if plan.bucketed else None
        pieces = {}
        for off, k, within, i in plan.pieces(layout):
            pieces.setdefault(i, []).append((off, k, within))
        with torch.no_grad():
            for i, (name, o, n, shape) in enumerate(layout):
                t = self._local_value(name, torch.as_tensor(source[name]))
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                     f"{shape}")
                if t.is_meta:
                    continue
                t = t.detach().to(self.device).reshape(-1)
                if whole:
                    self.params[o:o + n].copy_(t)
                for off, k, within in pieces.get(i, ()):
                    if mixed:
                        self.master[off:off + k].copy_(t[within:within + k])
                    if shard is not None:
                        shard[off:off + k].copy_(t[within:within + k])
            if not whole:
                self._fill_persistent(lambda name, o, n: self._local_value(
                    name, torch.as_tensor(source[name])))
            if plan.hpz:
                self._refresh_secondary()
        self._bind_module()
        self.grad_acc = None
        self._acc_fresh = True

    def _make_coordinator(self, units):
        if self._coord is not None:
            self._coord.close()
        cfg = self._config
        prefetch = None
        if cfg.prefetch_enabled and self._gather_prefetch:
            prefetch = dict(
                bucket_bytes=max(1, int(cfg.prefetch_bucket_mb * MB)),
                max_inflight=cfg.prefetch_max_inflight,
                max_live_params=int(cfg.zero_config.max_live_parameters
                                    or 0))
        stage3 = self.zero_stage == 3
        self._coord = ZeroCoordinator(
            self.zero_plan, units, self._zcomm, self.device,
            self.compute_dtype, self.grad_accum_dtype,
            shard=self.params if stage3 else None,
            overlap=cfg.overlap_comm_enabled,
            max_inflight=cfg.overlap_max_inflight, prefetch=prefetch,
            primary=self._pshard if stage3 else None)

    def _refresh_secondary(self):
        """hpZ: every sharded unit's updated world slices into the
        secondary slices (over the ``zp_outer`` group)."""
        plan = self.zero_plan
        for u in self._coord.units:
            if u.kind == PERSISTENT:
                continue
            lo, hi = plan.param_slice(u.index)
            a, b = plan.shard_slice(u.index)
            if plan.secondary(u.index):
                self._zcomm.refresh_secondary(self.params[lo:hi],
                                              self._pshard[a:b])
            else:
                # an expert unit's parameters are its primary slices
                self.params[lo:hi].copy_(self._pshard[a:b])

    def _fill_persistent(self, value):
        """Stage 3: the persistent unit's buffer from ``value(name, flat
        offset, numel)``, each leaf's whole values."""
        for u in self._coord.units:
            if u.kind != PERSISTENT:
                continue
            base = self.zero_plan.unit_offset[u.index]
            for name, off, n, _ in u.leaves:
                t = value(name, base + off, n)
                if not t.is_meta:
                    u.buffer[off:off + n].copy_(t.detach().reshape(-1))

    def _bind_module(self):
        """The module's parameters onto the installed buffers, with the
        coordinator's gradient hooks on them."""
        if self.zero_stage == 3:
            self._bind_units()
        else:
            self._bind(self.params)
        if self._coord is not None:
            self._coord.attach(dict(self.module.named_parameters()))

    def initialize_parameters(self, seed, *sample_inputs, **kw):
        """Random weights from the module's ``init_weights`` with a
        ``torch.Generator`` seeded on the engine's device, drawn in fp32
        (into the master when mixed) and cast to the compute dtype.  A
        sharded or bucketed layout draws the whole model in fp32 once (so
        every stage starts from the same weights), keeps this rank's shard
        and frees the rest."""
        if self._layout is None:
            self._install_parameters()
        self._ensure_state_resident()
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        plan = self.zero_plan
        if self.master is None and not plan.bucketed and \
                not self._split_leaves:
            self._bind_module()
            self.module.init_weights(gen)
        else:
            # drawn in fp32 over the whole layout (every rank draws the
            # same weights), then this rank's shard kept as the master
            full = torch.zeros(plan.padded_numel, dtype=torch.float32,
                               device=self.device)
            if self._split_leaves:
                self._draw_global(full, gen)
            else:
                self._bind(full)
                self.module.init_weights(gen)
            with torch.no_grad():
                if self.master is not None:
                    plan.take_shard(full, out=self.master)
                if self.zero_stage < 3:
                    self.params.copy_(full)
                if plan.bucketed:
                    plan.take_shard(full, out=self._param_shard())
                if self.zero_stage == 3:
                    self._fill_persistent(lambda _, o, n: full[o:o + n])
                    self._coord.release_all()
                if plan.hpz:
                    self._refresh_secondary()
            del full
            self._bind_module()
        if self.opt_state is None:
            self._init_opt_state()
        elif self._nvme_swapper is not None:
            self._nvme_swap_out()
        return self.module

    def _draw_global(self, full, gen):
        """``init_weights`` over the whole model at its global shapes (so
        every ep and tp degree starts from the same weights), this rank's
        part of each leaf into ``full`` (a buffer of the layout)."""
        layout, numel = self.global_layout()
        init_leaf = getattr(sys.modules[type(self.module).__module__],
                            "init_leaf", None)
        if init_leaf is not None:
            # leaf by leaf in the module's order, as ``init_weights`` draws
            # them: no rank holds the whole model at once
            where = {name: (off, n, gshape) for (name, off, n, _),
                     (_, _, _, gshape) in zip(self._layout, layout)}
            with torch.no_grad():
                for name, _ in self.module.named_parameters():
                    off, n, gshape = where[name]
                    t = torch.empty(gshape, dtype=torch.float32,
                                    device=self.device)
                    init_leaf(name, t, gen)
                    full[off:off + n].copy_(
                        self._local_value(name, t).reshape(-1))
            return
        drawn = torch.zeros(numel, dtype=torch.float32, device=self.device)
        for name, off, n, shape in layout:
            self._set_param(name, drawn[off:off + n].view(shape))
        self._tie()
        self.module.init_weights(gen)
        with torch.no_grad():
            for (name, off, n, _), (_, go, gn, gshape) in zip(self._layout,
                                                              layout):
                full[off:off + n].copy_(self._local_value(
                    name, drawn[go:go + gn].view(gshape)).reshape(-1))

    def _configure_optimizer(self, client_optimizer):
        """Reference ``_configure_optimizer`` (``engine.py:559``; the JAX
        dispatch ``:595-634``): the config's adam/adamw/fusedadam,
        lamb/fusedlamb, lion or sgd, or a client transform of
        ``ops.adam``/``ops.lamb``/``ops.lion``."""
        cfg = self._config
        lr_fn = None
        self._client_optimizer = client_optimizer is not None
        if cfg.scheduler_name is not None:
            self._sched_for_lr = get_lr_scheduler(cfg.scheduler_name,
                                                  cfg.scheduler_params)
            lr_fn = self._sched_for_lr.get_lr
        if client_optimizer is not None:
            if not isinstance(client_optimizer, FlatTransform):
                raise not_ported("a client optimizer other than the port's "
                                 "FusedAdam, FusedLamb, FusedLion or sgd", 11)
            self._transform = client_optimizer
        elif cfg.optimizer_name is not None:
            self._transform = _optimizer_from_config(
                cfg.optimizer_name, dict(cfg.optimizer_params or {}), lr_fn)
        else:
            self._transform = fused_adam(lr=1e-3, lr_fn=lr_fn)
        if self._transform.lr_fn is None and lr_fn is not None:
            self._transform.lr_fn = lr_fn
        self.optimizer = _OptimizerFacade(self)
        if self.params is not None:
            self._init_opt_state()

    def _init_opt_state(self):
        pieces = [(o, n) for o, n, _ in
                  self.zero_plan.leaf_pieces(self._layout)]
        if self._onebit:
            self.opt_state = self._transform.init(
                self._target(), pieces, world=self._data_world)
            return
        self.opt_state = self._transform.init(
            self._target(), pieces, device=self.device, pin=self._pin_state)
        if isinstance(self._transform, FusedLambTransform) and (
                (self.zero_plan.sharded and self.zero_plan.world_size > 1)
                or self._tp_splits or self._experts):
            self._sum_lamb_leaves_over_ranks()
        if self._pending_client_lr is not None:
            self._set_client_lr(self._pending_client_lr)
        self._after_opt_state_init()

    def _sum_lamb_leaves_over_ranks(self):
        """LAMB's trust ratio is per leaf, and a leaf may straddle two
        ranks' shards: its pieces' sums are summed over the ranks.  (At one
        rank the pieces are whole leaves and the fused call runs.)"""
        self._piece_leaf = torch.tensor(
            [p[3] for p in self.zero_plan.pieces(self._layout)],
            device=self.device)
        self.opt_state.reduce_sums = self._leaf_sums

    def _leaf_sums(self, piece_sums):
        """[pieces, 2] sums of this rank's leaf pieces → the whole leaves'
        sums (all-reduced, SUM), one row a piece.  An expert leaf's sums
        are over the whole stack, as JAX's logically whole array gives its
        trust ratio: sharded, the data group's pieces are every expert's;
        unsharded, summed over ep."""
        leaves = torch.zeros(len(self._layout), 2, dtype=torch.float32,
                             device=self.device)
        leaves[self._piece_leaf] = piece_sums.to(self.device)
        plan = self.zero_plan
        if plan.sharded and plan.world_size > 1 and self._experts and \
                plan.mics:
            # MiCS: a shard group holds every dense piece, an expert
            # leaf's pieces lie over its expert-data group and ep
            rows = self._expert_leaf_rows()
            e = dist.all_reduce(leaves[rows].contiguous(),
                                group=self._zcomm.expert_group)
            dist.all_reduce(leaves, group=self._shard_group)
            leaves[rows] = dist.all_reduce(e, group=self._ep_group)
        elif plan.sharded and plan.world_size > 1:
            dist.all_reduce(leaves, group=self._shard_group)
        elif self._experts:
            rows = self._expert_leaf_rows()
            leaves[rows] = dist.all_reduce(leaves[rows].contiguous(),
                                           group=self._ep_group)
        if self._tp_splits:
            # a tp-sharded leaf's sums are over every tp rank's slice
            split = self._tp_leaf_rows()
            leaves[split] = dist.all_reduce(leaves[split].contiguous(),
                                            group=self._tp_group)
        return leaves[self._piece_leaf]

    def _expert_leaf_rows(self):
        """Indices in the layout of the expert leaves."""
        if getattr(self, "_expert_rows", None) is None:
            self._expert_rows = torch.tensor(
                [i for i, (name, *_) in enumerate(self._layout)
                 if name in self._experts], dtype=torch.long,
                device=self.device)
        return self._expert_rows

    def _tp_leaf_rows(self):
        """Indices in the layout of the tp-sharded leaves."""
        if getattr(self, "_tp_rows", None) is None:
            self._tp_rows = torch.tensor(
                [i for i, (name, *_) in enumerate(self._layout)
                 if name in self._tp_splits], dtype=torch.long,
                device=self.device)
        return self._tp_rows

    def _param_shard(self):
        """This rank's compute-dtype shard, which the update writes: a
        slice of the whole buffer with one unit, the shard buffer of
        bucketed stage 2 and of hpZ, the parameters themselves at stage
        3."""
        if self._pshard is not None:
            return self._pshard
        if self.zero_stage == 3 or not self.zero_plan.sharded:
            return self.params
        lo, hi = self.zero_plan.shard_range()
        return self.params[lo:hi]

    def _target(self):
        """The fp32 buffer the optimizer updates: this rank's master when
        mixed, else its shard of the fp32 parameters."""
        return (self.master if self.master is not None
                else self._param_shard())

    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            return client_scheduler
        return getattr(self, "_sched_for_lr", None)

    # -------------------------------------------------------------- properties
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.zero_stage

    def zero_optimization(self):
        return self.zero_stage > 0

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    @property
    def cur_scale(self):
        """The loss scale of the next micro-step (``engine.py:973``)."""
        return self.scale_state.scale

    def get_lr(self):
        if self._pending_client_lr is not None:
            return [self._pending_client_lr]
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "get_lr"):
            return [float(self.lr_scheduler.get_lr(max(1,
                                                       self.global_steps)))]
        return [None]

    def _scheduler_reclaims_lr(self):
        """An engine-managed scheduler rewrites the lr every step, so a
        one-off client lr write lasts until the scheduler's next step."""
        if self._pending_client_lr is None:
            return
        self._pending_client_lr = None
        if self.opt_state is not None:
            self.opt_state.lr_override = float("nan")

    def _set_client_lr(self, value):
        """A torch-API ``param_groups[0]["lr"]`` write → the state's
        ``lr_override``."""
        self._pending_client_lr = value
        if self.opt_state is not None:
            self.opt_state.lr_override = float(value)

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() \
            == 0

    def train(self, mode=True):
        self.training = mode
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def parameter_names(self):
        return [name for name, *_ in self._layout]

    def fp32_params(self):
        """The whole fp32 flat buffer (the master's, when mixed) in the
        order of :meth:`global_layout`.  A sharded master (or stage 3's
        fp32 parameters), and at ep > 1 the expert stacks, are
        all-gathered: every rank must call this together."""
        self._ensure_state_resident()
        if self.master is None:
            return self.gathered_params()
        return self._whole(self.master)

    def gathered_params(self):
        """The whole compute-dtype flat buffer in the order of
        :meth:`global_layout`: the parameters, or at stage 3 their
        all-gathered shards (every rank must call this together)."""
        if self.zero_stage < 3:
            return self._globalize(self.params)
        return self._whole(self._param_shard())

    def _whole(self, shard):
        """A buffer of :meth:`global_layout` from this rank's shard-sized
        ``shard`` (the master, a moment; a collective)."""
        if self.zero_plan.sharded:
            shard = self._gather_shard(shard)
        return self._globalize(shard)

    def _gather_shard(self, shard):
        """A buffer of the layout from every rank's ``shard``."""
        plan = self.zero_plan
        shard = shard.to(self.device)     # an offloaded master
        if plan.experts_split:
            # unit by unit, each over its own group
            out = torch.empty(plan.padded_numel, dtype=shard.dtype,
                              device=self.device)
            for u in range(plan.n_units):
                lo, hi = plan.unit_range(u)
                a, b = plan.shard_slice(u)
                self._zcomm.gather_shard(out[lo:hi], shard[a:b], u=u)
            return out
        out = torch.empty(plan.world_size * plan.shard_numel,
                          dtype=shard.dtype, device=self.device)
        self._zcomm.gather_shard(out, shard)
        return out if plan.n_units == 1 else plan.assemble(out)

    def get_fp32_param(self, name):
        """The fp32 value of one leaf (the master's, when mixed; a
        collective when the master is sharded, :meth:`fp32_params`)."""
        for n, off, numel, shape in self.global_layout()[0]:
            if n == name:
                src = self.fp32_params()
                return src[off:off + numel].view(shape).float()
        raise KeyError(name)

    # ------------------------------------------------------------- public API
    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def _check_params(self):
        if "params" in self._host_offloaded:
            self._reload("params")
        if self.params is None:
            raise RuntimeError(
                "engine has no parameters — pass model_parameters to "
                "initialize() or call engine.initialize_parameters(seed) "
                "first")

    def forward(self, *inputs, **kwargs):
        """Reference ``engine.py:1848``: the model's loss.  In training mode
        the graph is kept for :meth:`backward`; in eval mode no graph is
        built."""
        self._check_params()
        inputs = [self._to_device(x) for x in inputs]
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        stage3 = self.zero_stage == 3
        if stage3:
            self._coord.start_forward()
        if not self.training:
            with torch.no_grad():
                out = self.module(*inputs, **kwargs)
            if stage3:
                self._coord.release_outer()
            return out
        self.timers(FORWARD_GLOBAL_TIMER).start()
        self._reseed_gating()
        if self._global_loss:
            scaled, loss = self._global_batch_loss(*inputs, **kwargs)
        else:
            scaled, loss = self._loss_fn(self.cur_scale, *inputs, **kwargs)
            if self._data_world > 1:
                loss = dist.all_reduce(loss.detach().float().clone(),
                                       op=ReduceOp.AVG, group=self._dp_group)
        self._pending_loss = scaled
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    def _global_batch_loss(self, *inputs, **kwargs):
        """(scaled local loss, global loss): the model's masked sum over
        the all-reduced count.  Its gradients, summed over the ranks, are
        the global mean's, and every row's share of them is the share it
        has in JAX's program, so fp16 overflows where JAX's does."""
        out = self._apply(*inputs, loss_reduction="sum_count", **kwargs)
        if not isinstance(out, tuple):
            raise TypeError("loss_reduction='sum_count' must return (sum, "
                            "count)")
        total, count = out
        both = torch.stack([total.detach().float(), count.detach().float()])
        dist.all_reduce(both, group=self._dp_group)
        denom = torch.clamp(both[1], min=1.0)
        scaled = (total.float() / denom * self.cur_scale /
                  self.gradient_accumulation_steps())
        return scaled, both[0] / denom

    __call__ = forward

    def backward(self, loss=None, **kwargs):
        """Reference ``engine.py:2007``: autograd of the stashed, scaled
        loss, then the gradients, cast to ``grad_accum_dtype``, are folded
        into the flat accumulator (bucketed plans: unit by unit, during
        autograd)."""
        if self._pending_loss is None:
            raise RuntimeError("backward() called without a prior forward() "
                               "in training mode")
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        if "grad_acc" in self._host_offloaded:
            # before the fold, or the earlier micro-steps' gradients are
            # lost (JAX engine.py:1737-1744)
            self._reload("grad_acc")
        if self._coord is not None:
            self._backward_bucketed()
        else:
            self._autograd()
            if self.zero_stage >= 2:
                self._fold_and_reduce_scatter()
            else:
                if self.grad_acc is None:
                    self.grad_acc = torch.zeros(self.params.numel(),
                                                dtype=self.grad_accum_dtype,
                                                device=self.device)
                self._fold(self.grad_acc, self._acc_fresh)
        self._pending_loss = None
        self._acc_fresh = False
        if self._state_on_nvme and self.is_gradient_accumulation_boundary():
            # the reads overlap what is left of the step's backward
            self._nvme_start_swap_in()
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def _backward_bucketed(self):
        """Autograd with the coordinator's hooks: each unit's gradients go
        to the shard accumulator as soon as they are in."""
        if self.grad_acc is None:
            self.grad_acc = torch.empty(self.zero_plan.shard_numel,
                                        dtype=self.grad_accum_dtype,
                                        device=self.device)
        self._coord.start_backward(self.grad_acc, self._acc_fresh)
        try:
            self._autograd()
        finally:
            self._coord.in_backward = False
        self._coord.finish_backward()

    def _autograd(self):
        """The micro-step's backward pass: autograd of the stashed, scaled
        loss."""
        self._pending_loss.backward()

    def _fold(self, buf, fresh):
        """The module's gradients into the flat ``buf`` (copied when
        ``fresh``, else added in ``buf``'s dtype); the grads are freed."""
        params = dict(self.module.named_parameters())
        with torch.no_grad():
            for name, off, n, _ in self._layout:
                p = params[name]
                view = buf[off:off + n]
                if p.grad is None:
                    if fresh:
                        view.zero_()
                    continue
                g = p.grad.reshape(-1)
                if fresh:
                    view.copy_(g)
                else:
                    view.add_(g.to(buf.dtype))
                p.grad = None

    def _fold_and_reduce_scatter(self):
        """Stage 2: this micro-step's gradients, folded into a full-size
        buffer that lives only until they are reduce-scattered (SUM) into
        this rank's shard-sized accumulator."""
        full = torch.zeros(self.params.numel(), dtype=self.grad_accum_dtype,
                           device=self.device)
        self._fold(full, fresh=True)
        shard = torch.empty(self.zero_plan.shard_numel,
                            dtype=self.grad_accum_dtype, device=self.device)
        self._reduce_scatter_units(shard, full)
        del full
        if self._acc_fresh or self.grad_acc is None:
            self.grad_acc = shard
        else:
            self.grad_acc.add_(shard)

    def _reduce_scatter_units(self, shard, full):
        """``full``'s SUM over the ranks, this rank's slices into ``shard``:
        one collective, or one a unit, each over its own group (the expert
        split)."""
        plan = self.zero_plan
        if not plan.experts_split:
            return self._zcomm.reduce_scatter(shard, full)
        for u in range(plan.n_units):
            lo, hi = plan.unit_range(u)
            a, b = plan.shard_slice(u)
            self._zcomm.reduce_scatter(shard[a:b], full[lo:hi], u=u)
        return shard

    def step(self, use_kernel=True):
        """Reference ``engine.py:2204``: the update at the accumulation
        boundary, in ``engine.py:1469-1535``'s order.  ``use_kernel=False``
        runs the optimizer kernel's plain version leaf by leaf
        (``chip_smoke.py`` compares the two on the card)."""
        self._check_params()
        if self.is_gradient_accumulation_boundary():
            if self._acc_fresh:
                raise RuntimeError("step() at a grad-accum boundary without "
                                   "any backward() since the last boundary")
            self.timers(STEP_GLOBAL_TIMER).start()
            gnorm = self._try_host_offload_step()
            if gnorm is not None:
                self.scale_state = self.loss_scaler.update(self.scale_state,
                                                           False)
                self._last_gnorm, self._last_skipped = gnorm, False
            else:
                self._ensure_state_resident()
                self._apply_update(use_kernel)
                if self._nvme_swapper is not None:
                    self._nvme_swap_out()
            self.timers(STEP_GLOBAL_TIMER).stop()
            if self._config.wall_clock_breakdown:
                self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                                 STEP_GLOBAL_TIMER])
            self._acc_fresh = True
            self.global_steps += 1
            self.global_samples += self.train_batch_size()
            if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                         "step"):
                self.lr_scheduler.step()
                self._scheduler_reclaims_lr()
        self.micro_steps += 1

    def _apply_update(self, use_kernel):
        """Unscale, overflow check, global norm, spike test, clip,
        optimizer, skip, scaler update (``engine.py:1469-1535``)."""
        if self._onebit:
            return self._apply_onebit()
        fp16, guard = self._config.fp16_enabled, self._finite_guard.enabled
        grads = self._reduced_grads()
        world = self._data_world
        # 1/scale (a power of two for the dynamic scaler) and, for a mean
        # of the ranks' means, 1/world, applied to the norm and, through
        # the optimizer's gradient scale, to the update
        inv = np.float32(1.0) / np.float32(self.scale_state.scale)
        if world > 1 and not self._global_loss:
            inv = inv * np.float32(1.0 / world)
        gnorm = self._grad_norm(grads)
        if inv != 1:
            gnorm = gnorm * torch.tensor(inv, device=gnorm.device)
        overflow = skip = False
        if fp16 or guard:
            # one host sync per boundary, only when a step can be skipped;
            # the flags are every rank's (MAX), so all skip together
            flags = has_overflow([grads]).reshape(1)
            if guard:
                flags = torch.cat([flags, (gnorm > self._spike_limit())
                                   .reshape(1)])
            flags = self._agree_flags(flags).cpu()
            overflow = bool(flags[0])
            skip = bool(flags.any())
        if not skip:
            clip = self._config.gradient_clipping
            scale = (clip_coefficient(gnorm, clip) if clip and clip > 0
                     else None)
            if inv != 1:
                inv_t = torch.tensor(inv, device=gnorm.device)
                scale = inv_t if scale is None else scale * inv_t
            mixed = self.master is not None
            self._transform.step(grads, self.opt_state, self._target(),
                                 param_out=(self._param_shard()
                                            if mixed else None),
                                 grad_scale=scale, use_kernel=use_kernel)
            if self.zero_plan.sharded:
                self._gather_updated()
        # loss-scale dynamics key off true fp16 overflow only — a grad-norm
        # spike must not shrink the scale
        self.scale_state = self.loss_scaler.update(self.scale_state,
                                                   overflow)
        if fp16 and skip:
            self.skipped_steps += 1
        if guard:
            self._account_guarded_step(skip, gnorm)
        self._last_gnorm = gnorm
        self._last_skipped = skip

    def _apply_onebit(self):
        """The 1-bit optimizers' boundary step (JAX ``common.py:109
        build_onebit_apply``): this rank's unreduced gradients, unscaled;
        the fp16 overflow flag max-reduced over the ranks (an overflow
        keeps every piece of state); the leaf updates, which average over
        the ranks themselves; the reported norm is the synced momentum's."""
        inv = np.float32(1.0) / np.float32(self.scale_state.scale)
        grads = self.grad_acc.float() * torch.tensor(inv,
                                                     device=self.device)
        overflow = False
        if self._config.fp16_enabled:
            flags = (~torch.isfinite(grads)).any().reshape(1)
            overflow = bool(self._agree_flags(flags).cpu()[0])
        if overflow:
            gnorm = torch.tensor(float("nan"))
            self.skipped_steps += 1
        else:
            gnorm = self._transform.onebit_step(grads, self.opt_state,
                                                self._target(),
                                                group=self._dp_group)
            if self.master is not None:
                self._param_shard().copy_(self.master)
        self.scale_state = self.loss_scaler.update(self.scale_state,
                                                   overflow)
        self._last_gnorm = gnorm
        self._last_skipped = overflow

    def _gather_updated(self):
        """Every rank's updated slices where the module's parameters read
        them: gathered in place into the whole buffer (one unit), unit by
        unit (bucketed stage 2), or at stage 3 only the persistent unit's
        (the next forward gathers the rest; the released units hold no
        stale copy)."""
        plan = self.zero_plan
        if self.zero_stage == 3:
            self._coord.release_all()
            self._coord.refresh_persistent()
            if plan.hpz:
                self._refresh_secondary()
        elif plan.n_units == 1:
            self._zcomm.gather_shard(self.params, self._param_shard())
        else:
            for u in range(plan.n_units):
                lo, hi = plan.unit_range(u)
                a, b = plan.shard_slice(u)
                self._zcomm.gather_shard(self.params[lo:hi],
                                         self._pshard[a:b], u=u)

    def _grad_norm(self, grads):
        """The L2 norm of the summed gradient (before unscaling).  Sharded,
        the ranks' slices are each counted once over the world (an expert
        unit's slices over the expert-data group, its other experts on the
        other ep coordinates); with tp or an unsharded expert split, by
        leaf kind (:meth:`_kind_squares`)."""
        plan = self.zero_plan
        sharded = plan.sharded and plan.world_size > 1
        if self._tp_splits or (plan.experts_split and (
                not sharded or plan.mics)):
            return self._kind_squares(grads).sum().sqrt()
        if sharded:
            return self._sharded_norm(grads)
        # every rank holds the whole summed gradient
        return global_grad_norm([grads])

    def _kind_squares(self, grads, kept=None):
        """[4] sums of squares of ``grads`` (the shard, or the whole layout;
        within the ``kept`` [a, b) ranges only, if given) by leaf kind:
        (replicated, expert) × (dense, tp-sharded), each counted once over
        the world: summed over the data group when sharded, else the
        expert kinds over ep (the other experts), then the tp-sharded kinds
        over tp (the other slices; a replicated leaf is the same on every
        tp rank)."""
        sq = torch.zeros(4, dtype=torch.float32, device=grads.device)
        for kind, ranges in enumerate(self._kind_ranges(grads.numel())):
            for lo, hi in ranges:
                for a, b in (((lo, hi), ) if kept is None else kept):
                    a, b = max(a, lo), min(b, hi)
                    if a < b:
                        sq[kind] += torch.linalg.vector_norm(
                            grads[a:b], dtype=torch.float32).square()
        plan = self.zero_plan
        if plan.experts_split and plan.mics and plan.sharded:
            # MiCS: the dense slices over the shard group (each replica
            # holds them all); the expert slices over their expert-data
            # group, then the other experts over ep
            sq[0::2] = dist.all_reduce(sq[0::2].contiguous(),
                                       group=self._shard_group)
            e = dist.all_reduce(sq[1::2].contiguous(),
                                group=self._zcomm.expert_group)
            sq[1::2] = dist.all_reduce(e, group=self._ep_group)
        elif plan.sharded and plan.world_size > 1:
            sq = dist.all_reduce(sq, group=self._shard_group)
        elif plan.experts_split:
            sq[1::2] = dist.all_reduce(sq[1::2].contiguous(),
                                       group=self._ep_group)
        if self._tp_splits:
            sq[2:] = dist.all_reduce(sq[2:].contiguous(),
                                     group=self._tp_group)
        return sq

    def _kind_ranges(self, numel):
        """The [a, b) ranges of a gradient buffer of ``numel`` elements (the
        shard, or the whole layout) that hold each kind of leaf, in the
        order of :meth:`_kind_squares`, neighbours of one kind merged
        (cached by size)."""
        cache = self.__dict__.setdefault("_kind_range_cache", {})
        if numel not in cache:
            plan = self.zero_plan
            if numel == plan.shard_numel and plan.sharded:
                spans = [(off, off + k, self._layout[i][0])
                         for off, k, _, i in plan.pieces(self._layout)]
            else:
                spans = [(off, off + n, name)
                         for name, off, n, _ in self._layout]
            out, last = ([], [], [], []), None
            for a, b, name in sorted(spans):
                kind = 2 * (name in self._tp_splits) + (name in self._experts)
                if kind == last:    # across zero padding only
                    out[kind][-1] = (out[kind][-1][0], b)
                else:
                    out[kind].append((a, b))
                last = kind
            cache[numel] = out
        return cache[numel]

    def _agree_flags(self, flags):
        """The skip flags, every rank's (MAX), so that all skip together:
        over the data group, then over tp (whose ranks hold other slices
        of the sharded leaves' gradients)."""
        if self._data_world > 1:
            flags = dist.all_reduce(flags.float(), op=ReduceOp.MAX,
                                    group=self._dp_group)
        if self.tp_world_size > 1:
            flags = dist.all_reduce(flags.float().clone(), op=ReduceOp.MAX,
                                    group=self._tp_group)
        return flags

    def _reduced_grads(self):
        """The summed gradient this rank updates with: the accumulator, its
        reduce-scattered shard (stage 1; in fp32), or, at world > 1 without
        ZeRO, the all-reduced accumulator.  Stage 2's accumulator is
        already the shard."""
        grads = self.grad_acc
        if self.zero_stage == 1:
            full = grads if grads.dtype == torch.float32 else grads.float()
            # a shard group of one rank: the shard is the whole buffer,
            # reduced in place (no second fp32 buffer of the model's size)
            shard = (full if self.zero_plan.world_size == 1 else
                     torch.empty(self.zero_plan.shard_numel,
                                 dtype=torch.float32, device=self.device))
            return self._reduce_scatter_units(shard, full)
        if self.zero_stage == 0 and self._data_world > 1:
            plan = self.zero_plan
            if not plan.experts_split:
                return dist.all_reduce(grads, group=self._dp_group)
            for u in range(plan.n_units):
                lo, hi = plan.unit_range(u)
                dist.all_reduce(grads[lo:hi], group=(
                    self._zcomm.expert_group if plan.unit_expert[u]
                    else self._dp_group))
        return grads

    def _sharded_norm(self, grads):
        """L2 norm over every rank's ``grads``: the all-reduced (SUM) sum
        of squares, then a square root (a leaf may straddle two shards)."""
        sq = torch.linalg.vector_norm(grads, dtype=torch.float32).square()
        return dist.all_reduce(sq.reshape(1),
                               group=self._shard_group)[0].sqrt()

    def _spike_limit(self):
        """Grad-norm ceiling for the current step (``engine.py:1565``):
        ``spike_factor ×`` the running mean of recent healthy grad norms,
        +inf while disabled or warming up."""
        g = self._finite_guard
        if (not g.enabled or g.grad_norm_spike_factor <= 0
                or self._gnorm_ema is None
                or self.global_steps < g.spike_warmup_steps):
            return float("inf")
        return float(np.float32(g.grad_norm_spike_factor * self._gnorm_ema))

    def _account_guarded_step(self, skipped, gnorm):
        """Host-side consecutive-skip bookkeeping of the finite-grad guard
        (``engine.py:1577``): aborts when skips persist, since skipping
        forever turns a poisoned input pipeline into a run that 'finishes'
        without having trained."""
        g = self._finite_guard
        gn = float(gnorm)
        if not skipped:
            self._consecutive_skips = 0
            if np.isfinite(gn):
                self._gnorm_ema = (gn if self._gnorm_ema is None
                                   else 0.9 * self._gnorm_ema + 0.1 * gn)
            return
        self._consecutive_skips += 1
        logger.warning(
            "finite-grad guard: skipped poisoned step %d (grad norm %s, "
            "%d consecutive skip(s), abort at %d)", self.global_steps + 1,
            gn, self._consecutive_skips, g.max_consecutive_skips)
        if self._consecutive_skips >= g.max_consecutive_skips:
            raise RuntimeError(
                f"finite-grad guard: {self._consecutive_skips} consecutive "
                f"steps produced non-finite or spiking gradients (last "
                f"grad norm {gn}, step {self.global_steps + 1}) — the "
                "input pipeline or numerics are poisoned, not transient; "
                "aborting so the supervisor can restart from the last "
                "valid checkpoint. Raise resilience.check_finite_grads."
                "max_consecutive_skips if this is expected.")

    def train_batch(self, data_iter=None):
        """Forward, backward and step over one accumulation window; returns
        the mean loss (an fp32 tensor)."""
        if data_iter is None:
            raise not_ported("train_batch() without data_iter (the "
                             "dataloader)", 4)
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            batch = next(data_iter)
            if not isinstance(batch, (tuple, list)):
                batch = (batch, )
            loss = self.forward(*batch)
            self.backward(loss)
            self.step()
            losses.append(loss.detach().float())
        return torch.stack(losses).mean()

    def shard_batch(self, *inputs):
        """This rank's rows of a global batch (``engine.py:1067``): rank r
        takes rows ``[r·B, (r+1)·B)``, B = rows / data-parallel degree, and
        under sequence parallelism (JAX ``:1058-1064``) sp rank q the
        positions ``[q·C, (q+1)·C)`` of dim 1, C = S / sp, on the engine's
        device."""
        w, r = self.dp_world_size, self.dp_rank
        sp, q = self.seq_parallel_world_size, self.seq_parallel_rank
        out = []
        for x in inputs:
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            shape = tuple(t.shape)
            if shape:
                if shape[0] % w:
                    raise ValueError(
                        f"batch dim {shape[0]} is not divisible by the "
                        f"data-parallel degree {w} — feed "
                        f"train_micro_batch_size_per_gpu × dp = "
                        f"{self.train_micro_batch_size_per_gpu()} × {w} "
                        f"rows per micro-step (shape {shape})")
                b = shape[0] // w
                t = t[r * b:(r + 1) * b]
            if sp > 1 and len(shape) >= 2:
                if shape[1] % sp:
                    raise ValueError(
                        f"sequence dim {shape[1]} is not divisible by the "
                        f"sequence-parallel degree {sp} (mesh sp) — pad "
                        f"the sequence (shape {shape})")
                c = shape[1] // sp
                t = t[:, q * c:(q + 1) * c]
            out.append(self._to_device(t))
        return tuple(out)

    # ----------------------------------------------------------- checkpoints
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False,
                        async_save=False):
        """Write a tag (``runtime/checkpoint_engine.py``; JAX
        ``engine.py:2162``), every rank together.  The host copies are made
        before it returns; ``async_save=True`` returns the pending handle,
        whose commit (manifest, then ``latest``) is
        :meth:`wait_for_checkpoint`, also made before the next save or load
        and at exit.  ``exclude_frozen_parameters``: the port trains every
        leaf, so there is none to exclude."""
        from .checkpoint_engine import save_engine_checkpoint
        self._check_params()
        self.wait_for_checkpoint()   # one pending async save at a time
        with self._state_on_host(write_back=False):
            out = save_engine_checkpoint(self, save_dir, tag=tag,
                                         client_state=client_state,
                                         save_latest=save_latest,
                                         async_save=async_save)
        if async_save:
            self._pending_ckpt = out
            if not getattr(self, "_ckpt_atexit", False):
                # a script whose last act is an async save would otherwise
                # exit without committing its tag
                ref = weakref.ref(self)
                atexit.register(
                    lambda: ref() is not None and ref().wait_for_checkpoint())
                self._ckpt_atexit = True
        return out

    def wait_for_checkpoint(self):
        """Block until a pending ``async_save`` tag is committed; raises
        its write's error (JAX ``engine.py:2189``)."""
        pending = getattr(self, "_pending_ckpt", None)
        if pending is not None:
            self._pending_ckpt = None  # even a failed commit must not wedge
            pending.wait()

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        """Load a tag of the port or of upstream DeepSpeed, saved at any
        world size and stage, or with ``checkpoint.load_universal`` a
        universal directory (JAX ``engine.py:2196-2225``); returns ``(tag
        dir, client_state)``, ``(None, {})`` when nothing was loaded.
        ``custom_load_fn(src=module state, dst=module)`` replaces the
        module's load (stages 0-2).  Every rank calls it."""
        if custom_load_fn is not None and self.zero_stage == 3:
            raise ValueError("load_checkpoint(custom_load_fn=...) needs the "
                             "whole parameters: ZeRO stages 0-2")
        self.wait_for_checkpoint()
        if self._nvme_swapper is not None and self.opt_state is None:
            if self.params is None:
                self._install_parameters()
            self._init_opt_state()
        # NVMe: the loaded state goes into host buffers and out to disk
        with self._state_on_host(write_back=True):
            if self._config.load_universal_checkpoint:
                from ..checkpoint.universal_checkpoint import \
                    load_universal_checkpoint
                return load_universal_checkpoint(
                    self, load_dir, tag=tag,
                    load_optimizer_states=load_optimizer_states,
                    load_lr_scheduler_states=load_lr_scheduler_states,
                    load_module_only=load_module_only)
            from .checkpoint_engine import load_engine_checkpoint
            return load_engine_checkpoint(
                self, load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states,
                load_module_only=load_module_only,
                load_module_strict=load_module_strict,
                custom_load_fn=custom_load_fn)

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         exclude_frozen_parameters=False):
        """Rank 0 writes ``torch.save`` of :meth:`module_state_dict` under
        ``save_filename`` (JAX ``engine.py:2232`` writes ``.npz`` only
        because numpy has no bf16).  A stage-3 model is gathered one unit
        at a time, and only with ``stage3_gather_16bit_weights_on_model_
        save``: without it nothing is written and False returned, as
        upstream does.  Every rank calls it."""
        self._check_params()
        if self.zero_stage == 3 and \
                not self._config.zero_config.gather_16bit_weights_on_model_save:
            logger.warning(
                "save_16bit_model: a stage-3 model is written only with "
                "zero_optimization.stage3_gather_16bit_weights_on_model_save"
                " (nothing written); zero_to_fp32 recovers the weights from "
                "a checkpoint")
            return False
        sd = self.module_state_dict(dst=0)
        # at tp > 1 every tp rank's first data rank holds the whole leaves
        if self._data_rank == 0 and self.tp_rank == 0:
            skip = self._tied_copies()
            os.makedirs(save_dir, exist_ok=True)
            torch.save(OrderedDict((k, v) for k, v in sd.items()
                                   if k not in skip),
                       os.path.join(save_dir, save_filename))
        return True

    def module_state_dict(self, dst=None):
        """``{name: compute-dtype tensor on the host}`` of every leaf in the
        layout's order, on rank ``dst`` (every rank when None; None on the
        others), the expert stacks whole.  A stage-3 model is gathered one unit at a time, so one
        unit at most is gathered beside the shard; every rank must call
        it."""
        self._check_params()
        mine = dst is None or self._data_rank == dst
        out = OrderedDict() if mine else None
        if self.zero_stage < 3:
            for name, off, n, shape in self._layout:
                t = self._whole_leaf(name, self.params[off:off + n].view(
                    shape))
                if mine:
                    out[name] = t.to("cpu", copy=True)
            return out
        for u in self._coord.units:
            self._coord.gather(u)
            for name, off, n, shape in u.leaves:
                t = self._whole_leaf(name, u.buffer[off:off + n].view(shape))
                if mine:
                    out[name] = t.to("cpu", copy=True)
            self._coord.release(u)
        return out

    def _all_ranks_agree(self, ok):
        """Whether ``ok`` holds on every rank (a MIN over the data group and
        over tp)."""
        flag = torch.tensor([1.0 if ok else 0.0], device=self.device)
        dist.all_reduce(flag, op=ReduceOp.MIN, group=self._dp_group)
        if self.tp_world_size > 1:
            dist.all_reduce(flag, op=ReduceOp.MIN, group=self._tp_group)
        return bool(flag.item())

    def _load_module(self, module, custom_load_fn=None):
        """The compute-dtype parameters from ``module`` ({name: tensor};
        a leaf it lacks keeps its value): the whole buffer below stage 3,
        this rank's pieces and the persistent unit at stage 3."""
        plan = self.zero_plan
        if custom_load_fn is not None:
            custom_load_fn(src=module, dst=self.module)
        elif self.zero_stage < 3:
            for name, off, n, _ in self._layout:
                if name in module:
                    self.params[off:off + n].copy_(self._local_value(
                        name, module[name]).reshape(-1))
        else:
            # this rank's pieces (hpZ: of its primary world slices, from
            # which the secondary slices are derived)
            shard = self._param_shard()
            for off, k, within, i in plan.pieces(self._layout):
                name = self._layout[i][0]
                if name in module:
                    shard[off:off + k].copy_(self._local_value(
                        name, module[name]).reshape(-1)[within:within + k])
            for u in self._coord.units:
                if u.kind == PERSISTENT:
                    for name, off, n, _ in u.leaves:
                        if name in module:
                            u.buffer[off:off + n].copy_(self._local_value(
                                name, module[name]).reshape(-1))
            self._coord.release_all()
            if plan.hpz:
                self._refresh_secondary()
            return
        if self._pshard is not None:
            plan.take_shard(self.params, out=self._pshard)

    def _master_from_params(self):
        """The fp32 master re-derived from the compute-dtype parameters
        (JAX ``checkpoint_engine.py:677-690``); without a master the
        optimizer's target is the parameters themselves."""
        if self.master is None:
            return
        if self.zero_stage == 3:
            # hpZ: the primary world slices, not the secondary copy
            self.master.copy_(self._param_shard())
        else:
            self.zero_plan.take_shard(self.params, out=self.master)

    def _params_from_master(self):
        """The compute-dtype parameters as the master's cast, gathered
        where other ranks hold their slices (as after a step)."""
        if self.master is not None:
            self._param_shard().copy_(self.master)
        if self.zero_plan.sharded:
            self._gather_updated()

    # the JAX engine's other public methods, each named by its item
    def register_param_transform(self, fn):
        raise not_ported("register_param_transform", 4)

    def register_post_step_hook(self, fn):
        raise not_ported("register_post_step_hook", 4)

    def compile(self, *args, **kwargs):
        raise not_ported("engine.compile", 4)

    def is_compiled(self):
        raise not_ported("engine.is_compiled", 4)

    def zeropp_dispatch_counts(self):
        """{"<op>/<variant>": picks} of the ZeRO++ collectives (qwZ
        gathers, qgZ reduce-scatters); a decline is ``flat_fallback``."""
        return self._zcomm.dispatch_counts

    def _micro_variant(self):
        """Which path the micro-step runs, in the JAX engine's names
        (``engine.py:1336 _micro_variant``): ``qgZ_islands[+qwZ]`` or
        ``qgZ_manual`` (``zero_mode: flat_manual``, hpZ, MiCS), else
        ``overlap``, ``prefetch`` and ``qwZ`` joined by ``+``, or
        ``flat``.  Both ``zero_mode`` values run the port's one path."""
        qv = self._zcomm.micro_variant()
        if qv is not None:
            return qv
        cfg, stage3 = self._config, self.zero_stage >= 3
        parts = [name for name, on in (
            ("overlap", cfg.comm_optimizations_config.overlap.enabled),
            ("prefetch", cfg.prefetch_enabled and stage3 and
             self._gather_prefetch),
            ("qwZ", self._zcomm.qwz)) if on]
        return "+".join(parts) if parts else "flat"

    def _tied_copies(self):
        """Names of the leaves another stage counts and writes (a
        pipeline's copies of tied leaves)."""
        return frozenset()

    def __del__(self):
        # the coordinator's hooks would keep it, and its shard, alive
        # (ZeroCoordinator.close); no waiting: the world may be gone
        coord = getattr(self, "_coord", None)
        if coord is not None:
            coord.close(wait=False)

    def empty_partition_cache(self):
        """Stage 3: release every gathered unit but the persistent one
        (reference semantics); a no-op at other stages, as in the JAX
        engine.  Call it outside a forward/backward pair."""
        if self.zero_stage == 3:
            self._coord.release_all()

    def start_device_trace(self, *args, **kwargs):
        raise not_ported("start_device_trace", 12)

    def stop_device_trace(self, *args, **kwargs):
        raise not_ported("stop_device_trace", 12)

    def compute_block_eigenvalues(self, *args, **kwargs):
        raise not_ported("compute_block_eigenvalues", 11)
