"""ZeRO partitioning of the engine's flat buffers (the port of
``deepspeed_tpu/runtime/zero/partition.py``).

The JAX file is a sharding policy: each leaf is split along its largest
divisible axis and GSPMD emits the collectives (``partition.py:52-103``).
The port's engine lays every leaf out in flat buffers, so its plan is a plan
of flat ranges, as the reference's ``stage_1_and_2.py`` and ``stage3.py``
partition their flat groups.  The layout is a sequence of *units*:

* each unit's range is padded to a multiple of ``world_size × ALIGN``
  elements and rank r owns slice r of every unit, so every slice starts
  16-element aligned (the optimizer kernels refuse unaligned pointers) and
  a leaf may straddle two ranks' slices;
* the rank's *shard* is its slices of all units, concatenated: the fp32
  master, the moments and the gradient accumulator are one flat buffer
  each, and an optimizer kernel is one launch over it;
* stages 0-2 (without ``overlap_comm``) have ONE unit, the whole buffer
  (rank r owns ``[r·S, (r+1)·S)``); stage 3, and stage 2 with
  ``overlap_comm``, have one unit a block of the model (an element of its
  block ``nn.ModuleList``), an *outer* unit for every other leaf
  (embeddings, final norm, head, tied weights) and, at stage 3, a
  *persistent* unit of the leaves below the persistence threshold, which
  every rank holds whole (``runtime/zero/overlap.py`` gathers and releases
  the others around their use);
* stage 1 shards the fp32 master and the moments; stage 2 also the gradient
  accumulator; stage 3 also the compute-dtype parameters.

The padding is zero in the parameters, the gradients and the moments, so
neither the norm nor the update sees anything but zeros there.

The plan is over the group the state is sharded over: the data-parallel
world, or with MiCS (``mics_shard_size``) the rank's shard group of
``zp`` consecutive ranks, replicated across the groups (JAX
``partition.py:218-252``).  hpZ (``zero_hpz_partition_size``, stage 3
only) keeps the master, the moments and the gradients sharded over the
world and shards the compute-dtype parameters over ``zp`` alone: the
rank at (outer o, inner i) holds, of each unit, the world slices of the
ranks (o', i) for every o' in order (its *secondary* slice), which the
updated slices reach over the ``zp_outer`` group after each step; a
gather over the ``zp`` group then yields the unit with its slices in
(i, o') order, put back in order by one copy (:meth:`param_slice`).
``grad_wire``, ``param_wire`` and ``wire_for_size`` are JAX's
``partition.py:294-330``: the wire each quantized ZeRO collective takes.

Expert units (ep > 1, JAX's ``leaf_zero_axes`` / ``rule_claimed_axes``,
``partition.py:345-376``): the expert leaves' E dimension is split over
ep, so a rank holds its own experts only, and their units are sharded over
the *expert-data* group (the dp/ep ranks that hold the same experts)
instead of the world; their gradients sum over that group.  Every other
unit keeps the world.  ``leaf_base`` ({leaf name: offset of this rank's
elements in the whole leaf}) places an expert leaf's pieces in the global
stack for the checkpoint files (:meth:`fragment_map`, :meth:`fill_shard`).
Under hpZ and MiCS an expert unit keeps its expert-data group: hpZ's
secondary partition and MiCS's shard groups factor the dense units' data
group only (:meth:`secondary`).
"""

import torch

ALIGN = 16   # elements (engine.py's _ALIGN): 64 bytes of fp32

OUTER, BLOCK, PERSISTENT = "outer", "block", "persistent"


def min_partition_size(zero_config):
    """The JAX engine's persistence bound (``engine.py:311``): a leaf with
    fewer elements stays whole on every rank at stage 3."""
    return max(1, int(zero_config.param_persistence_threshold) // 8)


class ZeroPartitionPlan:
    """``units``: [(kind, length)] or [(kind, length, expert)] of the
    layout's units in order (each length a multiple of ``ALIGN``); None:
    one unit of ``numel``.  ``expert_world``, ``expert_rank``: the
    expert-data group's size and this rank's place in it, over which the
    expert units are sharded.  ``schedule``: the gradient-overlap and
    prefetch settings for :meth:`describe`."""

    def __init__(self, stage, world_size, rank, numel, zero_config=None,
                 units=None, schedule=None, param_world=None,
                 comm_opts=None, mics=False, expert_world=None,
                 expert_rank=0):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.stage = stage
        self.world_size = world_size
        self.rank = rank
        self.expert_world = expert_world or world_size
        self.expert_rank = expert_rank if expert_world else rank
        self.zero_config = zero_config
        self.schedule = dict(schedule or {})
        self.comm_opts = comm_opts
        self.mics = bool(mics)
        self.leaf_base = {}
        if units is None:
            units = [(OUTER, int(numel))]
        self.unit_kinds = [u[0] for u in units]
        self.unit_expert = [bool(u[2]) if len(u) > 2 else False
                            for u in units]
        self.unit_numel, self.unit_offset = [], []
        off = 0
        for u, (_, n, *_) in enumerate(units):
            quantum = self.unit_world(u) * ALIGN
            self.unit_offset.append(off)
            self.unit_numel.append(-(-int(n) // quantum) * quantum)
            off += self.unit_numel[-1]
        self.padded_numel = off
        # where the last leaf ends (the layout's length)
        self.numel = (self.unit_offset[-1] + int(units[-1][1]) if units
                      else 0)
        self.slice_numel = [n // self.unit_world(u) if self.sharded else n
                            for u, n in enumerate(self.unit_numel)]
        self.shard_offset, off = [], 0
        for n in self.slice_numel:
            self.shard_offset.append(off)
            off += n
        # hpZ: the compute-dtype parameters over param_world ranks
        pw = param_world or world_size
        if stage != 3 or pw >= world_size or pw < 1:
            pw = world_size
        if world_size % pw:
            raise ValueError(f"zero_hpz_partition_size={pw} must divide "
                             f"the world of {world_size}")
        self.param_world = pw
        self.param_slice_numel = [
            n // (pw if self.secondary(u) else self.unit_world(u))
            if self.sharded else n for u, n in enumerate(self.unit_numel)]
        self.param_offset, off = [], 0
        for n in self.param_slice_numel:
            self.param_offset.append(off)
            off += n
        self.param_numel = off

    def unit_world(self, u):
        """The ranks unit ``u`` is sharded over: the expert-data group for
        an expert unit, else the world."""
        return self.expert_world if self.unit_expert[u] else self.world_size

    def unit_rank(self, u):
        return self.expert_rank if self.unit_expert[u] else self.rank

    @property
    def experts_split(self):
        """Whether some unit is an expert unit."""
        return any(self.unit_expert)

    @property
    def hpz(self):
        """Whether the parameters are sharded over fewer ranks than the
        master (hpZ's secondary partition)."""
        return self.param_world != self.world_size

    def secondary(self, u):
        """Whether unit ``u``'s parameters take hpZ's secondary partition:
        an expert unit keeps its expert-data group's slices (its ``ep``
        claim, JAX ``partition.py:346-351``: hpZ factors only the data
        axes the dense units shard over)."""
        return self.hpz and not self.unit_expert[u]

    @property
    def hpz_outer(self):
        """Ranks in a ``zp_outer`` group: world slices in a secondary
        slice."""
        return self.world_size // self.param_world

    def param_slice(self, u):
        """[lo, hi) of unit ``u``'s slice in this rank's compute-dtype
        parameter shard (its secondary slice under hpZ)."""
        return self.param_offset[u], self.param_offset[u] + \
            self.param_slice_numel[u]

    def secondary_view(self, unit_buf, u):
        """``unit_buf`` (a whole unit) as [zp, n_outer, S]: the layout a
        gather of the secondary slices over the ``zp`` group writes, seen
        in flat order (``.transpose(0, 1)`` of a [n_outer, zp, S] view)."""
        s = self.slice_numel[u]
        return unit_buf.view(self.hpz_outer, self.param_world, s) \
            .transpose(0, 1)

    @property
    def sharded(self):
        """Whether the master and the moments are this rank's shard."""
        return self.stage >= 1

    @property
    def n_units(self):
        return len(self.unit_numel)

    @property
    def bucketed(self):
        """More than one unit: the plan of stage 3 or of ``overlap_comm``."""
        return self.n_units > 1 or self.stage == 3

    @property
    def shard_numel(self):
        return sum(self.slice_numel)

    def unit_range(self, u):
        """[lo, hi) of unit ``u`` in the flat layout."""
        return self.unit_offset[u], self.unit_offset[u] + self.unit_numel[u]

    def unit_slice(self, u, rank=None):
        """[lo, hi) of ``rank``'s (default: this rank's) slice of unit
        ``u`` in the flat layout (the whole unit when not sharded)."""
        lo = self.unit_offset[u]
        if not self.sharded:
            return lo, lo + self.unit_numel[u]
        r = self.unit_rank(u) if rank is None else rank
        s = self.slice_numel[u]
        return lo + r * s, lo + (r + 1) * s

    def shard_slice(self, u):
        """[lo, hi) of unit ``u``'s slice in this rank's shard."""
        return self.shard_offset[u], self.shard_offset[u] + \
            self.slice_numel[u]

    def shard_range(self, rank=None):
        """[lo, hi) of ``rank``'s (default: this rank's) shard in the flat
        buffer; the whole buffer at stage 0.  One-unit plans only: a
        bucketed shard is one slice a unit (:meth:`unit_slice`)."""
        if self.n_units != 1:
            raise ValueError("a bucketed plan's shard is no one range")
        return self.unit_slice(0, rank)

    def _slices(self):
        """[(flat lo, flat hi, shard lo)] of this rank's slices."""
        return [(*self.unit_slice(u), self.shard_offset[u])
                for u in range(self.n_units)]

    def leaf_pieces(self, layout):
        """The shard's part of each leaf: [(leaf offset in the shard, its
        numel, offset within the leaf)] for every leaf the shard touches,
        in shard order."""
        return [p[:3] for p in self.pieces(layout)]

    def pieces(self, layout):
        """:meth:`leaf_pieces`, each with its leaf's index in ``layout``."""
        pieces = []
        for lo, hi, base in self._slices():
            for i, (_, off, n, _) in enumerate(layout):
                a, b = max(off, lo), min(off + n, hi)
                if a < b:
                    pieces.append((a - lo + base, b - a, a - off, i))
        return pieces

    def fragment_map(self, layout, dense=True):
        """This rank's shard as upstream's stage ≤ 2 checkpoints describe a
        partition: ``{leaf name: (numel, offset in the shard, offset in
        the whole leaf)}``, in shard order (``dense=False``: the expert
        leaves only).  At every stage a shard is a concatenation of leaf pieces
        (:meth:`pieces`), and a leaf lies in one unit, whose slices cut it
        into contiguous pieces in rank order: so a leaf has at most one
        piece a rank, and its pieces over the ranks, in rank order, are the
        leaf.  The stage ≤ 2 content (``param_slice_mappings`` and one flat
        fp32 group a rank) therefore describes a stage-3 shard exactly."""
        out = {}
        for off, k, within, i in self.pieces(layout):
            name = layout[i][0]
            if dense or name in self.leaf_base:
                out[name] = (k, off, within + self.leaf_base.get(name, 0))
        return out

    def fill_shard(self, layout, sources, targets):
        """The inverse of :meth:`fragment_map` over every saved partition:
        fill this rank's shard buffers ``targets`` ({field: tensor, or None
        to skip}) from ``sources`` saved at any world size and stage,
        ``[(fragments, flats)]`` with ``fragments = {name: (start, numel,
        within)}`` (the leaf's elements ``[within, within + numel)`` lie at
        ``[start, start + numel)`` of each of ``flats``, ``{field: 1-D
        tensor}``).  Only the pieces that overlap this rank's are copied.
        Raises KeyError when a saved field is missing or the saved pieces
        do not cover this rank's."""
        saved = {}
        for frags, flats in sources:
            for name, (start, n, within) in frags.items():
                saved.setdefault(name, []).append((within, start, n, flats))
        for off, k, mine, i in self.pieces(layout):
            name, covered = layout[i][0], 0
            mine += self.leaf_base.get(name, 0)
            for within, start, n, flats in saved.get(name, ()):
                a, b = max(mine, within), min(mine + k, within + n)
                if a >= b:
                    continue
                for field, t in targets.items():
                    if t is None:
                        continue
                    if field not in flats:
                        raise KeyError(f"{name}: the checkpoint holds no "
                                       f"{field}")
                    t[off + a - mine:off + b - mine].copy_(
                        flats[field][start + a - within:start + b - within])
                covered += b - a
            if covered != k:
                raise KeyError(f"{name}: the checkpoint covers {covered} of "
                               f"the {k} elements of this rank's piece")

    def take_shard(self, flat, out):
        """This rank's shard of a flat buffer of the layout, copied into
        ``out`` slice by slice."""
        for lo, hi, base in self._slices():
            out[base:base + hi - lo].copy_(flat[lo:hi])
        return out

    def assemble(self, gathered):
        """The flat layout from every rank's shard, ``gathered`` rank after
        rank (``world_size × shard_numel`` elements; no expert units)."""
        if not self.sharded:
            return gathered
        per_rank = gathered.view(self.world_size, self.shard_numel)
        return torch.cat([per_rank[:, lo:hi].reshape(-1) for lo, hi in
                          map(self.shard_slice, range(self.n_units))])

    # wire formats (JAX partition.py:294-330) -------------------------------
    def _co_wire(self, flag):
        co = self.comm_opts
        if co is not None and getattr(co, "enabled", False) and \
                getattr(co, flag, False):
            return co.wire_dtype, co.quantization_group_size
        return None

    def grad_wire(self):
        """(wire format, scale-group size) of the quantized gradient
        reduce."""
        from ...comm.collectives.quantized import DEFAULT_GROUP_SIZE
        return self._co_wire("quantized_gradients") or \
            ("int8", DEFAULT_GROUP_SIZE)

    def param_wire(self, fallback_format="int8"):
        """(wire format, scale-group size) of the quantized parameter
        gather."""
        from ...comm.collectives.quantized import DEFAULT_GROUP_SIZE
        return self._co_wire("quantized_weights") or \
            (fallback_format, DEFAULT_GROUP_SIZE)

    def wire_for_size(self, default_fmt, nbytes):
        """A message's wire through the ``wire_dtype_by_size`` ladder: the
        first rung admitting ``nbytes`` logical bytes (``"fp32"``: the flat
        collective), ``default_fmt`` without a ladder or above it."""
        co = self.comm_opts
        if co is None or not getattr(co, "enabled", False):
            return default_fmt
        from ...comm.collectives.engine import (build_wire_ladder,
                                                resolve_in_ladder)
        if not hasattr(self, "_wire_ladder"):
            self._wire_ladder = build_wire_ladder(
                getattr(co, "wire_dtype_by_size", None))
        return resolve_in_ladder(self._wire_ladder, nbytes, default_fmt)

    def hierarchical_reduce(self):
        """Whether ``comm_optimizations`` asks the gradient reduce for the
        2-hop scheme where the group has a hierarchy."""
        co = self.comm_opts
        return bool(co is not None and getattr(co, "enabled", False)
                    and getattr(co, "hierarchical_allreduce", False))

    def units_of(self, kind):
        return [u for u, k in enumerate(self.unit_kinds) if k == kind]

    def collectives_per_step(self, gas):
        """{op: calls a step of ``gas`` micro-steps} of the gathers and
        reduce-scatters the engine makes: at stage 3 each micro-step
        gathers the outer unit and each block (forward), each block again
        (backward), and reduce-scatters every unit; after the step the
        persistent unit's slices are gathered.  Bucketed stage 2
        reduce-scatters every unit a micro-step and gathers every unit
        after the step; one-unit stages 1 and 2 reduce-scatter once a step
        or a micro-step and gather once a step."""
        if self.world_size == 1 and self.stage == 0:
            return {}
        if self.stage == 3:
            blocks = len(self.units_of(BLOCK))
            gathers = len(self.units_of(OUTER)) + 2 * blocks
            # hpZ: each sharded dense unit's updated slices to the
            # secondary
            secondary = sum(1 for u in self.units_of(OUTER) +
                            self.units_of(BLOCK) if self.secondary(u))
            return {"allgather_fn": gas * gathers + secondary +
                    len(self.units_of(PERSISTENT)),
                    "reduce_scatter_fn": gas * self.n_units}
        if self.stage == 2:
            return {"allgather_fn": self.n_units,
                    "reduce_scatter_fn": gas * self.n_units}
        if self.stage == 1:
            return {"allgather_fn": self.n_units,
                    "reduce_scatter_fn": self.n_units}
        return {}

    def describe(self, param_bytes=2, state_buffers=2, grad_bytes=4,
                 master=True):
        """The plan as data (the JAX plan's ``describe`` keys that mean
        something here, and the bytes a rank holds).  ``param_bytes``: an
        element of the compute-dtype parameters; ``state_buffers``: fp32
        buffers of the optimizer (Adam 2); ``grad_bytes``: an element of the
        gradient accumulator; ``master``: whether an fp32 master exists."""
        full, shard = self.padded_numel, self.shard_numel
        sharded = shard * 4 * (state_buffers + (1 if master else 0))
        persistent = sum(self.unit_numel[u]
                         for u in self.units_of(PERSISTENT))
        if self.stage == 3:
            sharded += shard * param_bytes
            replicated = persistent * param_bytes
        else:
            replicated = full * param_bytes
            if self.bucketed:
                sharded += shard * param_bytes   # the update's output
        if self.stage >= 2:
            sharded += shard * grad_bytes
        else:
            replicated += full * grad_bytes
        sch = self.schedule
        if self.hpz:
            # the secondary slices beside the primary shard
            sharded += self.param_numel * param_bytes
        state_axes = ["zp"] if self.mics else ["dp", "ep"]
        co = self.comm_opts
        out = {"stage": self.stage, "world_size": self.world_size,
               "zero_axes": ["dp", "ep"], "state_axes": state_axes,
               "param_axes": ((["zp"] if self.hpz else state_axes)
                              if self.stage >= 3 else []),
               "param_world": self.param_world, "mics": self.mics,
               "expert_axes": (["dp"] if self.experts_split else None),
               "expert_world": (self.expert_world if self.experts_split
                                else None),
               "zero_mode": getattr(co, "zero_mode", None) or "gspmd",
               "grad_wire": list(self.grad_wire()),
               "param_wire": list(self.param_wire()),
               "hierarchical_reduce": self.hierarchical_reduce(),
               "numel": self.numel, "padded_numel": full,
               "shard_numel": shard,
               "shard_range": (list(self.shard_range()) if self.n_units == 1
                               else None),
               "units": self.n_units,
               "unit_kinds": {k: len(self.units_of(k))
                              for k in (OUTER, BLOCK, PERSISTENT)},
               "persistent_numel": persistent,
               "min_partition_size": sch.get("min_partition_size", 1),
               "sharded_bytes": int(sharded),
               "replicated_bytes": int(replicated),
               "offload_optimizer": (
                   self.zero_config is not None and
                   self.zero_config.offload_optimizer_device == "cpu"),
               "offload_param": (
                   self.zero_config is not None and
                   self.zero_config.offload_param_device != "none"),
               "overlap_enabled": bool(sch.get("overlap_enabled", False)),
               "overlap_max_inflight": (sch.get("overlap_max_inflight", 0)
                                        if sch.get("overlap_enabled")
                                        else 0),
               "prefetch_enabled": bool(sch.get("prefetch_enabled", False)),
               "prefetch_bucket_mb": float(sch.get("prefetch_bucket_mb",
                                                   0.0)),
               "prefetch_max_inflight": (sch.get("prefetch_max_inflight",
                                                 0)
                                         if sch.get("prefetch_enabled")
                                         else 0)}
        ignored = ({} if self.zero_config is None
                   else self.zero_config.ignored())
        out["ignored"] = ignored
        if ignored:
            out["ignored_because"] = (
                "the port reduces and gathers one block of the model at a "
                "time" if self.bucketed else "the port reduces and gathers "
                "the whole flat buffer in one collective each")
        return out
