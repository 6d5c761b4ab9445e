"""ZeRO++: quantized ZeRO communication, qwZ and qgZ, with hpZ and MiCS's
groups (the port of ``deepspeed_tpu/runtime/zero/zeropp.py``; reference
``runtime/zero/stage3.py:123`` and ``runtime/engine.py:906-913``).

The JAX file rewrites each leaf's gather and reduce inside ``shard_map``;
the port's engine moves flat units (``runtime/zero/partition.py``), so
ZeRO++ is a choice of wire and group for each of its collectives,
:class:`ZeroComm`:

* **qwZ** (stage 3): a unit's gather quantizes the rank's compute-dtype
  slice, all-gathers the codes and the scales asynchronously and
  dequantizes into the unit's buffer when the handle is waited on (B5,
  or B6 on the fp6/fp12 wires); the persistent unit is never quantized;
* **qgZ**: every gradient reduce-scatter (stage 3 and bucketed stage 2 a
  unit at a time, stage 2 a micro-step, stage 1 at the boundary) is
  ``all_to_all_quant_reduce``, or where a hierarchy exists and
  ``hierarchical_allreduce`` is on (hpZ's ``zp_outer × zp``, or the
  world split by ``intra_node_size``) the 2-hop
  ``hierarchical_quant_reduce_scatter``, with its input put in
  inner-major order so rank r still gets slice r.  The engine's SUM
  convention holds (``mean=False``).  Stage 0 reduces flat, as JAX's
  micro does for a leaf with no sharded dim;
* **hpZ** (stage 3): the parameters' gathers run over the ``zp`` group,
  the updated slices reach the secondary shards over ``zp_outer``;
* **MiCS**: all state sharded over the ``zp`` shard group; each gradient
  reduce-scatter over it is followed by an all-reduce over ``zp_outer``.

An expert unit of the plan (ep > 1) takes the expert-data group in place
of the shard group and of the parameter group (``expert_group``).

Every wire goes through the plan's ``wire_for_size`` ladder.  The
collectives run through the facade's ``allgather_fn``/``reduce_scatter_fn``
with this engine's :class:`~...comm.collectives.CollectivesEngine`, which
declines where JAX's does (a group of one rank, an ``"fp32"`` rung) and
counts each pick; the comms logger sees ``op[variant]``.
"""

import torch

from ... import comm as dist
from ...comm.collectives import CollectivesEngine, CommOptimizations
from ...comm.collectives.topology import Hierarchy, factor_group
from ...comm.collectives.quantized import (DEFAULT_GROUP_SIZE,  # noqa: F401
                                           all_to_all_quant_reduce,
                                           hierarchical_quant_reduce_scatter,
                                           qdq_all_gather_st,
                                           quantized_all_gather)
from ...utils import groups

QGZ_SP_PP = ("zero_quantized_gradients supports dp/ep (+tp) meshes only — "
             "sp/pp interleave their own collectives with the DP gradient "
             "reduction this path replaces; disable "
             "zero_quantized_gradients or drop the sp/pp axes")


def check_shard_sizes(zero_config):
    """``mics_shard_size`` and ``zero_hpz_partition_size`` factor dp one
    way (JAX ``engine.py:176-184``); returns that factor (None: none)."""
    mics = zero_config.mics_shard_size
    hpz = zero_config.zero_hpz_partition_size
    if mics and mics > 1 and hpz > 1 and hpz != mics:
        raise ValueError(
            f"mics_shard_size={mics} and zero_hpz_partition_size={hpz} are "
            "mutually exclusive shard-group factorings")
    zp = mics if mics and mics > 1 else hpz
    return zp if zp and zp > 1 else None


class ZeroComm:
    """The groups and wires of one engine's ZeRO collectives (module
    docstring).  ``config``: the engine's ``DeepSpeedConfig``; ``plan``:
    its ``ZeroPartitionPlan`` (set by :meth:`bind`); ``dp_group``: the
    data-parallel group (``flat``)."""

    def __init__(self, config, stage, dp_group):
        zc, co = config.zero_config, config.comm_optimizations_config
        co_on = bool(co.enabled)
        self.zero_config, self.comm_opts = zc, co
        self.stage = stage
        self.qwz = bool(zc.zero_quantized_weights or
                        (co_on and co.quantized_weights)) and stage >= 3
        self.qgz = bool(zc.zero_quantized_gradients or
                        (co_on and co.quantized_gradients))
        self.zero_mode = co.zero_mode
        zp = check_shard_sizes(zc)
        world = dp_group.size()
        self.mics = bool(zc.mics_shard_size and zc.mics_shard_size > 1)
        self.hpz = not self.mics and zp is not None and stage == 3 and \
            zp < world
        self.dp_group = dp_group
        zp_group = zp_outer = None
        if zp is not None and not dp_group.local:
            zp_group = groups._get_zero_param_partition_group().as_flat()
            zp_outer = groups._get_zero_param_partition_outer_group() \
                .as_flat()
        self.shard_group = zp_group if self.mics and zp_group else dp_group
        self.replica_group = (zp_outer if self.mics and zp_outer is not None
                              and not zp_outer.local else None)
        self.param_group = zp_group if self.hpz else self.shard_group
        self.secondary_group = zp_outer if self.hpz else None
        self.hierarchy = None
        if self.qgz and not self.mics and co_on and \
                co.hierarchical_allreduce and not dp_group.local:
            if self.hpz:
                self.hierarchy = Hierarchy(
                    inner=zp_group, outer=zp_outer,
                    outer_size=world // zp, inner_size=zp)
            else:
                groups.prepare_hierarchy(co.intra_node_size)
                h = factor_group(dist.get_world_group(), co.intra_node_size)
                if h is not None:
                    self.hierarchy = Hierarchy(
                        inner=h.inner.as_flat(), outer=h.outer.as_flat(),
                        outer_size=h.outer_size, inner_size=h.inner_size)
        self.plan = None
        self.param_engine = self.grad_engine = None
        # the expert units' group (the engine sets it at ep > 1)
        self.expert_group = None

    def _group(self, u, default):
        """The group of unit ``u``'s collectives: the expert-data group for
        an expert unit, else ``default``."""
        if u is not None and self.plan is not None and \
                self.plan.unit_expert[u]:
            return self.expert_group
        return default

    def bind(self, plan):
        """The plan whose wires and slices the collectives use."""
        self.plan = plan
        qw_fmt, qw_gs = plan.param_wire(
            self.zero_config.zero_quantized_weights_format)
        qg_fmt, qg_gs = plan.grad_wire()
        self.param_fmt, self.grad_fmt = qw_fmt, qg_fmt
        # the 2-hop groups are this object's choice (``hierarchy``), not
        # the engines' own probe
        if self.qwz:
            self.param_engine = CollectivesEngine(CommOptimizations(
                enabled=True, quantized_weights=True, wire_dtype=qw_fmt,
                quantization_group_size=qw_gs, hierarchical_allreduce=False))
        if self.qgz:
            self.grad_engine = CollectivesEngine(CommOptimizations(
                enabled=True, quantized_gradients=True, wire_dtype=qg_fmt,
                quantization_group_size=qg_gs, hierarchical_allreduce=False))

    @property
    def dispatch_counts(self):
        """{"<op>/<variant>": picks} of the quantized routes (a decline is
        ``flat_fallback``)."""
        out = {}
        for eng in (self.param_engine, self.grad_engine):
            if eng is not None:
                for k, v in eng.counts.items():
                    out[k] = out.get(k, 0) + v
        return out

    def micro_variant(self):
        """JAX ``engine.py:_micro_variant``'s name of the path that runs:
        ``qgZ_islands`` (``qgZ_manual`` under ``zero_mode:
        flat_manual`` or hpZ/MiCS, whose JAX micro is the manual one),
        ``+qwZ``; else ``overlap``, ``prefetch``, ``qwZ`` joined by ``+``,
        or ``flat``."""
        if self.qgz:
            if self.zero_mode == "flat_manual" or self.hpz or self.mics:
                return "qgZ_manual"
            return "qgZ_islands" + ("+qwZ" if self.qwz else "")
        return None

    # ---------------------------------------------------------- gradients
    def reduce_scatter(self, out, full, async_op=False, u=None):
        """The SUM of every rank's ``full`` gradient (of unit ``u``, or the
        whole layout), this rank's slice into ``out``: over the shard group
        on the quantized wire (qgZ) or flat, then (MiCS) all-reduced over
        the replica group.  Returns the handle (``async_op``) or
        ``out``."""
        fmt, engine = None, None
        if self.qgz and self.stage >= 1:
            fmt = self.plan.wire_for_size(
                self.grad_fmt, full.numel() * full.element_size())
            engine = self.grad_engine
        expert = self._group(u, None) is not None
        handle = dist.reduce_scatter_fn(
            out, full, group=self._group(u, self.shard_group),
            async_op=async_op, engine=engine, wire_format=fmt,
            hierarchy=None if expert else self.hierarchy)
        if self.replica_group is None or expert:
            # an expert unit's group already holds every copy of its slices
            return handle
        if async_op:
            handle.on_wait(lambda: dist.all_reduce(
                out, group=self.replica_group))
            return handle
        dist.all_reduce(out, group=self.replica_group)
        return out

    # --------------------------------------------------------- parameters
    def gather_params(self, buf, piece, u, async_op=False):
        """Unit ``u``'s buffer ``buf`` from every rank's parameter slice
        (``piece`` here), over the parameter group, on the quantized wire
        under qwZ; under hpZ gathered into a scratch and put in order."""
        plan = self.plan
        fmt = engine = None
        if self.qwz:
            fmt = plan.wire_for_size(self.param_fmt,
                                     buf.numel() * buf.element_size())
            engine = self.param_engine
        if not (plan.secondary(u) and plan.hpz_outer > 1):
            return dist.allgather_fn(buf, piece,
                                     group=self._group(u, self.param_group),
                                     async_op=async_op, engine=engine,
                                     wire_format=fmt)
        scratch = torch.empty(buf.numel(), dtype=buf.dtype,
                              device=buf.device)
        handle = dist.allgather_fn(scratch, piece, group=self.param_group,
                                   async_op=True, engine=engine,
                                   wire_format=fmt)
        handle.on_wait(lambda: plan.secondary_view(buf, u).copy_(
            scratch.view(plan.param_world, plan.hpz_outer,
                         plan.slice_numel[u])))
        return handle if async_op else handle.wait()

    def gather_shard(self, out, shard, async_op=False, u=None):
        """Flat gather of ``shard`` (of unit ``u``, or the whole layout)
        over the shard group into ``out``."""
        return dist.allgather_fn(out, shard,
                                 group=self._group(u, self.shard_group),
                                 async_op=async_op)

    def refresh_secondary(self, secondary, primary):
        """hpZ: this rank's secondary slice of a unit from the ``zp_outer``
        group's updated world slices."""
        dist.allgather_fn(secondary, primary, group=self.secondary_group)
