"""PipelineEngine (the port of ``deepspeed_tpu/runtime/pipe/engine.py``;
reference ``runtime/pipe/engine.py:61``).

The JAX engine runs the whole pipelined step as one SPMD program (fill
and drain ticks under ``lax.scan`` with ``ppermute``, differentiated by
``jax.grad``).  Here each rank is one stage of one pipeline, and executes
``TrainSchedule``'s 1F1B instruction stream (``schedule.py``) tick by
tick:

* a tick's ``SendActivation``/``RecvActivation``/``SendGrad``/``RecvGrad``
  are posted as one batched exchange with the neighbouring stages
  (``p2p.exchange``); then its compute runs;
* ``ForwardPass`` runs the stage's layers (``module.PipeStage``): the pre
  layers on the first stage, the blocks ``partition_uniform`` gives it,
  the post layers and ``loss_fn`` on the last; ``BackwardPass`` is
  autograd of the last stage's loss × scale / M, or of the stage's output
  with the gradient the next stage sent back; each micro-step's
  gradients are folded into the flat accumulator as the base engine
  folds them;
* ``ReduceTiedGrads`` all-reduces the tied modules' gradients over the
  stages that hold a copy, so the copies, equal at init, stay equal: the
  accumulator's span (ZeRO 0-1); at ZeRO 2 the spans held back from each
  micro-step's reduce-scatter; at ZeRO 3 and bucketed ZeRO 2 the
  coordinator's *held* units (``runtime/zero/overlap.py``), whose
  gradients sum over the micro-steps and are reduce-scattered only here.
  ``OptimizerStep`` is the base engine's step on the stage's flat buffers
  (B2 or B3 on the stage's ZeRO shard over its dp × sp group, the state
  pinned on the host or on NVMe under ``offload_optimizer``), with the
  gradient norm summed over the stages (a tied leaf counted once) and
  the overflow flag agreed over the stages too, so every stage skips or
  steps together.

ZeRO 3: each block is gathered by its forward pre-hook and released after
its forward, gathered again by the hook on its output's gradient before
its backward (several micro-steps' forwards are in flight under 1F1B);
the outer unit is gathered around each compute instruction and released
after it.  The forward-order gather prefetch is off: 1F1B runs the
forward of micro-step m + 1 between backwards, so a window issued in
forward order would gather blocks no instruction needs next.  Every
backward waits for its reduce-scatters before it returns, so no
collective of the data group is in flight when the next tick's
point-to-point exchange is posted, and every rank of a data group
(the same stage, the same instruction stream) issues its collectives in
one order.

Checkpoints (``runtime/checkpoint_engine.py``): every stage writes its
layers and its partitions, a tied leaf once; a tag loads at any pp, dp,
sp or ZeRO stage, and into the base engine on ``to_module()``.

A receive's shape is announced once per input shape through
``send_obj`` (the store channel, which does not block), never inferred
from the data of each step.  The loss is JAX's (``:404-414``): the M
microbatch losses' mean on the last stage, averaged over the data group
with equal weights, broadcast to every stage.  ``loss_fn`` must be a
uniform per-row mean; under sequence parallelism it sees the rank's
chunk of the sequence and the chunks' means are averaged with equal
weights.

Tensor parallelism (``mesh.tp``, JAX ``:57-96``): each stage's layers
are cut over the stage's tp group by the ``tp_rules`` the caller passes
(``module.tp_leaf_info`` maps a stage's leaf to JAX's pipeline path, its
block stack's leading dim a pipeline slot), and the layers make the tp
collectives themselves (``module_inject/layers.py``).  A tied module's
spans are reduced over the stages of one tp coordinate, each tp rank its
slice; the norm sums the tp-sharded leaves' slices over tp once.

Refused, as in JAX (``__init__.py:68-74``, ``pipe/engine.py:75-93``):
``offload_param``, ZeRO++'s quantized collectives and progressive layer
drop (the config refuses it).
"""

import os
import time

import torch

from ... import comm as dist
from ...comm import ReduceOp
from ...utils import groups
from ...utils.not_ported import not_ported
from ..engine import DeepSpeedEngine
from . import p2p
from .module import PipelineModule
from .schedule import (BackwardPass, ForwardPass, InferenceSchedule,
                       OptimizerStep, RecvActivation, RecvGrad,
                       ReduceTiedGrads, SendActivation, SendGrad,
                       TrainSchedule)


class PipelineEngine(DeepSpeedEngine):
    """Engine for a ``PipelineModule``: ``train_batch(data_iter)`` and
    ``eval_batch(data_iter)`` (reference ``pipe/engine.py:338``, ``:441``);
    ``forward``/``backward``/``step`` raise, as in JAX."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, collate_fn=None, config=None, mpu=None,
                 device=None, mesh_param=None, dist_init_required=None,
                 distributed_port=29500, tp_rules=None):
        from ..config import DeepSpeedConfig
        if not isinstance(model, PipelineModule):
            raise TypeError("PipelineEngine trains a PipelineModule")
        if not isinstance(config, DeepSpeedConfig):
            config = DeepSpeedConfig(config)
        zc = config.zero_config
        if zc.zero_quantized_gradients or zc.zero_quantized_weights:
            # ZeRO++ would be silently ignored by the schedule's own step
            raise NotImplementedError(
                "ZeRO++ quantized communication (zero_quantized_gradients/"
                "zero_quantized_weights) is not wired into the pipeline "
                "step — disable it or use the base engine")
        self.pipe_module = model
        self.micro_batches = None
        # the last step's bytes sent to other stages and, with
        # instruction_timing, its forward and backward ms (CUDA events)
        self.last_step_stats = {}
        self.instruction_timing = False
        self._meta_sent, self._meta_recv = set(), {}
        self._tied_acc = {}     # ZeRO 2: tied spans held back a step
        super().__init__(args=args, model=model, optimizer=optimizer,
                         model_parameters=model_parameters,
                         training_data=training_data,
                         lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                         config=config, mpu=mpu, device=device,
                         mesh_param=mesh_param,
                         dist_init_required=dist_init_required,
                         distributed_port=distributed_port,
                         tp_rules=tp_rules)
        self.micro_batches = self.gradient_accumulation_steps()

    # ------------------------------------------------------------------ setup
    def _requested_mesh(self, mesh_param, model):
        pp, sp = super()._requested_mesh(mesh_param, model)
        stages = model.num_stages
        if stages not in (None, 1) and pp not in (1, stages):
            raise ValueError(f"mesh pp={pp} but PipelineModule(num_stages="
                             f"{stages})")
        return (pp if pp > 1 else stages or 1), sp

    def _build_module(self, model):
        """The stage's layers, built on the meta device (the weights come
        from ``model_parameters`` or ``initialize_parameters``); the tie
        groups, made on every rank; the pipe group's first collective."""
        pp, stage = self.pp_world_size, self.stage_id
        self.stage_layers = model.stage_map(pp)[stage]
        self.is_first_stage, self.is_last_stage = stage == 0, stage == pp - 1
        module = model.build_stage(stage, pp, device="meta")
        self._tie_groups = self._make_tie_groups(model.tie_owners(pp))
        if pp > 1:
            p2p.init_process_groups(device=self.device)
        return module

    def _make_tie_groups(self, owners):
        """{key: (group of this rank's copies, whether this stage counts
        the key's leaves in the norm)} for the keys held on more than one
        stage; every rank makes every group, in one order."""
        import torch.distributed as tdist
        out = {}
        if self.pp_world_size == 1:
            return out
        me = dist.get_rank()
        pipes = groups.axis_rank_lists((groups.PP_AXIS, ))
        for key in sorted(owners):
            stages = owners[key]
            if len(stages) < 2:
                continue
            for ranks in pipes:
                sub = [ranks[s] for s in stages]
                pg = (None if len(sub) == dist.get_world_size()
                      else tdist.new_group(sub))
                if me in sub:
                    out[key] = (dist.ProcessGroup(("tied", ), pg=pg)
                                .as_flat(), self.stage_id == stages[0])
        return out

    def _tied_leaves(self, key):
        """[(name, offset, numel)] of a tied key's leaves in the layout."""
        prefix = f"tied.{key}."
        return [(n, o, k) for n, o, k, _ in self._layout
                if n.startswith(prefix)]

    def _install_parameters(self, model_parameters=None):
        """The base install from this stage's names (``model_parameters``
        may hold every stage's), the tied leaves first broadcast from the
        lowest stage holding them, so every copy starts equal."""
        named = dict(self.module.named_parameters())
        if model_parameters is not None:
            src = {k: v for k, v in dict(model_parameters).items()
                   if k in named}
        else:
            src = dict(named)
        for key, (group, _) in sorted(self._tie_groups.items()):
            for name in sorted(n for n in src if
                               n.startswith(f"tied.{key}.")):
                t = torch.as_tensor(src[name])
                if t.is_meta:
                    continue
                t = t.detach().to(self.device, torch.float32).clone()
                src[name] = dist.broadcast(t, src=0, group=group)
        super()._install_parameters(src)

    # ZeRO 3's prefetch issues gathers in forward order, which the 1F1B
    # stream does not follow (module docstring)
    _gather_prefetch = False

    def _make_coordinator(self, units):
        """The base coordinator, holding back the units of the tied leaves
        until ``ReduceTiedGrads``."""
        super()._make_coordinator(units)
        tied = tuple(f"tied.{key}." for key in self._tie_groups)
        if tied:
            self._coord.held = {u.index for u in units if any(
                name.startswith(tied) for name, *_ in u.leaves)}

    # ---------------------------------------------------- the step's agreement
    def _autograd(self):
        tensors, grads = self._pending_loss
        torch.autograd.backward(tensors, grads)

    def _tied_span(self, key):
        """[lo, hi) of a tied key's leaves in the layout (the ``tied``
        modules come last in a stage, so the span holds only them)."""
        leaves = self._tied_leaves(key)
        return (min(o for _, o, _ in leaves),
                max(o + k for _, o, k in leaves))

    def _fold(self, buf, fresh):
        """The base fold; at ZeRO 2 a micro-step's tied spans are taken
        out of the buffer about to be reduce-scattered and summed here
        until ``ReduceTiedGrads`` (a collective across stages inside the
        1F1B stream would wait on a stage that is elsewhere in it)."""
        super()._fold(buf, fresh)
        if self.zero_stage < 2:
            return
        for key in self._tie_groups:
            lo, hi = self._tied_span(key)
            if self._acc_fresh:
                self._tied_acc[key] = buf[lo:hi].clone()
            else:
                self._tied_acc[key] += buf[lo:hi]
            buf[lo:hi].zero_()

    def _reduce_tied_grads(self):
        """``ReduceTiedGrads``: each tied key's gradient all-reduced over
        the stages holding it, at the end of the stream: the accumulator's
        span (ZeRO 0-1), or at ZeRO 2 the held-back spans, then
        reduce-scattered into the shard accumulator."""
        if not self._tie_groups:
            return
        if self._coord is not None:
            self._coord.reduce_held(self.grad_acc, self._sum_tied_in_unit)
            return
        if self.zero_stage < 2:
            for key, (group, _) in sorted(self._tie_groups.items()):
                lo, hi = self._tied_span(key)
                dist.all_reduce(self.grad_acc[lo:hi], group=group)
            return
        full = torch.zeros(self.params.numel(), dtype=self.grad_accum_dtype,
                           device=self.device)
        for key, (group, _) in sorted(self._tie_groups.items()):
            lo, hi = self._tied_span(key)
            full[lo:hi] = dist.all_reduce(self._tied_acc.pop(key),
                                          group=group)
        shard = torch.empty(self.zero_plan.shard_numel,
                            dtype=self.grad_accum_dtype, device=self.device)
        self.grad_acc.add_(self._zcomm.reduce_scatter(shard, full))

    def _sum_tied_in_unit(self, unit, scratch):
        """A held unit's summed gradients: each tied key's leaves in it
        all-reduced over the stages holding the key, keys in order."""
        for key, (group, _) in sorted(self._tie_groups.items()):
            prefix = f"tied.{key}."
            span = [(off, off + n) for name, off, n, _ in unit.leaves
                    if name.startswith(prefix)]
            if span:
                lo, hi = min(a for a, _ in span), max(b for _, b in span)
                dist.all_reduce(scratch[lo:hi], group=group)

    def _grad_norm(self, grads):
        """The norm over every stage: each stage's sum of squares (its
        copies of a tied leaf counted on the lowest stage only), summed
        over its data group when sharded, then over the stages."""
        if self.pp_world_size == 1:
            return super()._grad_norm(grads)
        drop = self._tied_copies()
        # the shard's pieces of the uncounted leaves (the whole buffer's
        # when not sharded)
        cut = sorted((off, off + k) for off, k, _, i in
                     self.zero_plan.pieces(self._layout)
                     if self._layout[i][0] in drop)
        kept, at = [], 0
        for a, b in cut:
            if a > at:
                kept.append((at, a))
            at = max(at, b)
        if at < grads.numel():
            kept.append((at, grads.numel()))
        sq = self._kind_squares(grads, kept)
        sq = sq.sum().reshape(1)
        return dist.all_reduce(sq, group=self._pp_group.as_flat())[0].sqrt()

    def _agree_flags(self, flags):
        flags = super()._agree_flags(flags)
        if self.pp_world_size > 1:
            flags = dist.all_reduce(flags.float(), op=ReduceOp.MAX,
                                    group=self._pp_group.as_flat())
        return flags

    # -------------------------------------------------------- the executor
    def _peer(self, stage):
        return dist.get_global_rank(self._pp_group, stage)

    def _announce(self, key, out):
        """Send the shape and dtype of the activation of ``key`` to the
        next stage, once."""
        if key not in self._meta_sent:
            dist.send_obj((tuple(out.shape), out.dtype),
                          self._peer(self.stage_id + 1))
            self._meta_sent.add(key)

    def _incoming(self, key):
        """(shape, dtype) of the activation of ``key`` from the previous
        stage: received once, then kept."""
        if key not in self._meta_recv:
            self._meta_recv[key] = dist.recv_obj(
                self._peer(self.stage_id - 1))
        return self._meta_recv[key]

    def _run(self, schedule, batches, train):
        """Execute ``schedule`` over ``batches`` ([(x, y)] this rank's
        microbatches); returns the last stage's (losses, outputs)."""
        stage = self.stage_id
        key = (train, tuple(batches[0][0].shape), str(batches[0][0].dtype))
        inputs, outputs, out_grads = {}, {}, {}
        losses, logits = [], []
        nxt = {k: 0 for k in ("fwd", "bwd", "send_act", "recv_act",
                              "send_grad", "recv_grad")}
        stats = dict(p2p_bytes=0, compute_ms=0.0)
        events = []
        # ZeRO 3: the outer unit is gathered for each compute instruction
        # and released after it (the blocks gather themselves)
        coord = self._coord if self.zero_stage == 3 else None

        def take(kind):
            m = nxt[kind]
            nxt[kind] += 1
            return m

        for cmds in schedule.steps():
            sends, recvs, landed = [], [], []
            for c in cmds:
                if isinstance(c, SendActivation):
                    m = take("send_act")
                    out = outputs[m].detach().contiguous()
                    self._announce(key, out)
                    sends.append((out, stage + 1))
                elif isinstance(c, RecvActivation):
                    m = take("recv_act")
                    shape, dtype = self._incoming(key)
                    t = torch.empty(shape, dtype=dtype, device=self.device)
                    recvs.append((t, stage - 1))
                    inputs[m] = t
                    landed.append(t)
                elif isinstance(c, SendGrad):
                    m = take("send_grad")
                    sends.append((inputs.pop(m).grad.contiguous(),
                                  stage - 1))
                elif isinstance(c, RecvGrad):
                    m = take("recv_grad")
                    g = torch.empty_like(outputs[m])
                    recvs.append((g, stage + 1))
                    out_grads[m] = g
            p2p.exchange(sends, recvs, self._pp_group)
            stats["p2p_bytes"] += sum(t.numel() * t.element_size()
                                      for t, _ in sends)
            if train:
                for t in landed:
                    if t.is_floating_point():
                        t.requires_grad_()
            for c in cmds:
                if isinstance(c, ForwardPass):
                    m = take("fwd")
                    ev = self._mark(events)
                    x, y = batches[m]
                    if stage > 0:
                        x = inputs[m]
                    if coord is not None:
                        coord.gather_outer()
                    if not self.is_last_stage:
                        outputs[m] = self.module(x)
                    elif train:
                        scaled, loss = self._loss_fn(self.cur_scale, x, y)
                        outputs[m] = scaled
                        losses.append(loss.detach().float())
                    else:
                        out = self.module(x)
                        if self.module.loss_fn is not None:
                            losses.append(self.module.loss_fn(out, y)
                                          .detach().float())
                        logits.append(out)
                    if coord is not None:
                        coord.release_outer()
                    self._mark(events, ev)
                elif isinstance(c, BackwardPass):
                    m = take("bwd")
                    ev = self._mark(events)
                    grad = None if self.is_last_stage else [out_grads.pop(m)]
                    self._pending_loss = ([outputs.pop(m)], grad)
                    if coord is not None:
                        # released again by the coordinator's
                        # finish_backward
                        coord.gather_outer()
                    DeepSpeedEngine.backward(self)
                    if nxt["bwd"] < len(batches):
                        self.micro_steps += 1
                    self._mark(events, ev)
                elif isinstance(c, ReduceTiedGrads):
                    self._reduce_tied_grads()
                elif isinstance(c, OptimizerStep):
                    DeepSpeedEngine.step(self)
        if events:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                stats["compute_ms"] = sum(a.elapsed_time(b)
                                          for a, b in events)
            else:
                stats["compute_ms"] = sum(b - a for a, b in events) * 1e3
        self.last_step_stats = stats
        return losses, logits

    def _mark(self, events, start=None):
        """A timing mark around a compute instruction (only with
        ``instruction_timing``): a CUDA event, or the host clock."""
        if not self.instruction_timing:
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        if start is not None:
            events.append((start, ev))
        return ev

    def _loss_everywhere(self, losses):
        """The step's loss on every rank: the last stage's mean over its
        microbatches, averaged over its data group, broadcast over the
        stages."""
        if self.is_last_stage:
            loss = torch.stack(losses).mean()
            if self._data_world > 1:
                loss = dist.all_reduce(loss, op=ReduceOp.AVG,
                                       group=self._dp_group)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if self.pp_world_size > 1:
            loss = dist.broadcast(loss, src=self.pp_world_size - 1,
                                  group=self._pp_group.as_flat())
        return loss

    def _batches(self, data_iter, n):
        out = []
        for _ in range(n):
            batch = next(data_iter)
            out.append(self.shard_batch(batch[0], batch[1]))
        return out

    # ------------------------------------------------------------ public API
    def train_batch(self, data_iter=None):
        """One training step over ``gradient_accumulation_steps``
        microbatches from ``data_iter`` (each ``(inputs, labels)`` of the
        global batch's rows; every rank reads the same stream); returns
        the loss (an fp32 tensor) on every rank."""
        if data_iter is None:
            raise not_ported("train_batch() without data_iter (the "
                             "dataloader)", 4)
        self._check_params()
        self.train()
        batches = self._batches(data_iter, self.micro_batches)
        sched = TrainSchedule(self.micro_batches, self.pp_world_size,
                              self.stage_id)
        losses, _ = self._run(sched, batches, train=True)
        return self._loss_everywhere(losses)

    def eval_batch(self, data_iter, return_logits=False):
        """Forward only, through the pipeline, on ONE batch of
        ``data_iter`` (JAX ``:610``): the loss, and with ``return_logits``
        the last stage's output for this rank's rows, on every rank."""
        self._check_params()
        batches = self._batches(data_iter, 1)
        sched = InferenceSchedule(1, self.pp_world_size, self.stage_id)
        with torch.no_grad():
            losses, logits = self._run(sched, batches, train=False)
            loss = self._loss_everywhere(
                losses or [torch.zeros((), device=self.device)])
            out = logits[0] if logits else None
            if return_logits and self.pp_world_size > 1:
                out = self._logits_everywhere(out, batches)
        return (loss, out) if return_logits else loss

    def _logits_everywhere(self, out, batches):
        last = self.pp_world_size - 1
        key = ("logits", tuple(batches[0][0].shape))
        if self.is_last_stage:
            if key not in self._meta_sent:
                for s in range(last):
                    dist.send_obj((tuple(out.shape), out.dtype),
                                  self._peer(s))
                self._meta_sent.add(key)
        else:
            if key not in self._meta_recv:
                self._meta_recv[key] = dist.recv_obj(self._peer(last))
            shape, dtype = self._meta_recv[key]
            out = torch.empty(shape, dtype=dtype, device=self.device)
        return dist.broadcast(out.contiguous(), src=last,
                              group=self._pp_group.as_flat())

    # forward/backward/step are not the pipeline's interface (JAX :647-654)
    def forward(self, *a, **k):
        raise RuntimeError("PipelineEngine: use train_batch/eval_batch "
                           "(reference pipe/engine.py also disables "
                           "forward())")

    __call__ = forward

    def backward(self, *a, **k):
        raise RuntimeError("PipelineEngine: use train_batch")

    def step(self, *a, **k):
        raise RuntimeError("PipelineEngine: use train_batch")

    # ------------------------------------------------------------- checkpoints
    def _tied_copies(self):
        """This stage's copies of the tied leaves whose first stage is
        another: counted once in the norm, written once in a checkpoint
        (``runtime/checkpoint_engine.py``)."""
        return frozenset(n for key, (_, counts) in self._tie_groups.items()
                         if not counts for n, _, _ in self._tied_leaves(key))

    def _all_ranks_agree(self, ok):
        """Whether ``ok`` holds on every rank of every stage."""
        ok = super()._all_ranks_agree(ok)
        if self.pp_world_size == 1:
            return ok
        flag = torch.tensor([1.0 if ok else 0.0], device=self.device)
        dist.all_reduce(flag, op=ReduceOp.MIN,
                        group=self._pp_group.as_flat())
        return bool(flag.item())

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         exclude_frozen_parameters=False):
        """The base engine's file, of this stage's leaves; under more than
        one stage each stage's first data rank writes its own, named with
        ``_stage_{s:02d}`` before the extension (the port's naming), a tied
        leaf in its first stage's file only.  Every rank calls it."""
        if self.pp_world_size > 1:
            stem, ext = os.path.splitext(save_filename)
            save_filename = f"{stem}_stage_{self.stage_id:02d}{ext}"
        return super().save_16bit_model(save_dir, save_filename)
