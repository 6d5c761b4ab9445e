"""Process-group topology (the port of ``deepspeed_tpu/utils/groups.py``;
reference ``deepspeed/utils/groups.py``).

The JAX package builds one 5-axis mesh ``(pp, dp, ep, sp, tp)``.  Here the
same axes are sizes over the ``torch.distributed`` world, in the same
order, most-major first: rank r's coordinates are those of the r-th
device of JAX's mesh (``rank = (((pp·DP + dp)·EP + ep)·SP + sp)·TP +
tp``).  A group is a torch process group with the axis names it spans:
the ranks that differ from this one only along those axes.  Every
combination of pp, dp, ep, sp and tp is ported; an ep group is the ranks
of one (pp, dp, sp, tp) coordinate.  tp is the innermost axis, so a tp
group is ``tp`` consecutive ranks (one node's NVLink) and an sp or pp
group strides over them; at tp > 1 the data group is the ranks that share
this rank's tp (and pp) coordinate.  ``devices`` (a list of world ranks, whole tp groups) builds
the mesh over a subset of the world: position p of the list takes the
coordinates of JAX's p-th device, and a rank outside the list holds local
groups only (``MeshState.member``).  ``ep`` factors the data-parallel degree dp into (dp/ep, ep), as
JAX's mesh does (``groups.py:148-158``): the data-parallel rank is
``dp_coord · ep + ep_coord``; the ``ep`` group holds the ranks whose
experts differ, the ``dp`` group (the expert-data group) the ranks that
hold the same experts, and the ``(dp, sp)`` group those ranks with their
sp peers, whose tokens reach the same experts.  hpZ's and MiCS's zp groups
factor the data group with its ep coordinates; the expert units keep their
expert-data group (``runtime/zero/partition.py``).

``torch.distributed.new_group`` is collective: every rank makes every
subgroup once, in the same order, here, at mesh init (the pipeline's, the
sequence-parallel ones, the sequence-data-parallel ones ZeRO shards over,
hpZ's and MiCS's).  A group of one rank is local (no process group), and
one of every rank is the world.

``zero_partition_size`` (hpZ's secondary partition and MiCS's shard
groups, JAX ``groups.py:171-182``) factors each pipeline stage's data
group (dp × sp) into ``zp_outer × zp``: the ``zp`` groups of consecutive
ranks and the ``zp_outer`` groups of the ranks ``zp`` apart, the torch
counterparts of the JAX hpZ mesh's axes (which carries pp and tp too).
At tp > 1, or over a device subset, the data group's ranks are taken in
their data order ("consecutive" there), so each tp coordinate has its
own zp groups.
The collectives engine's hierarchies are the same kind of pair
(:func:`factor_groups`).
"""

from dataclasses import dataclass, field
from itertools import product


PP_AXIS = "pp"
DP_AXIS = "dp"
SP_AXIS = "sp"
TP_AXIS = "tp"
EP_AXIS = "ep"
AXES = (PP_AXIS, DP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)
ZP_AXIS = "zp"
ZP_OUTER_AXIS = "zp_outer"

_mesh_state = None


@dataclass(frozen=True)
class Mesh:
    """The mesh's shape: axis name → size (JAX's ``Mesh.shape``)."""
    pp: int
    dp: int
    ep: int
    sp: int
    tp: int

    @property
    def axis_names(self):
        return AXES

    @property
    def shape(self):
        return {a: getattr(self, a) for a in AXES}

    @property
    def size(self):
        return self.pp * self.dp * self.ep * self.sp * self.tp


@dataclass
class MeshState:
    mesh: Mesh
    pp: int
    dp: int  # the whole data-parallel degree (mesh dp × ep)
    sp: int
    tp: int
    ep: int = 1
    # hpZ / MiCS: ranks a shard group (None: no factoring)
    zero_partition_size: int = None
    # ranks a node from the probe (None: not probed yet)
    node_size: int = None
    # split s → (inner, outer) ProcessGroups holding this rank
    factors: dict = field(default_factory=dict)
    # the same of the ep groups (the 2-hop expert dispatch)
    ep_factors: dict = field(default_factory=dict)
    # built by a caller of initialize_mesh (not by init_distributed or on
    # first use): an engine must not rebuild it
    user_built: bool = True
    # this rank's coordinates, axis name → index
    coord: dict = field(default_factory=dict)
    # axes tuple → the ProcessGroup over them holding this rank
    groups: dict = field(default_factory=dict)
    # the world ranks of the mesh, in mesh order (None: the whole world)
    ranks: tuple = None
    # whether this rank is one of them
    member: bool = True


def _world_size():
    from ..comm import comm
    return comm.get_world_size()


def factor_groups(s, state=None, block=None, lists=None):
    """The (inner, outer) pair of a split of each block of ``block``
    consecutive ranks (default: the world) into groups of ``s``
    consecutive ranks and groups of the ranks ``s`` apart, made once (a
    collective: every rank calls it with the same arguments).  ``s`` equal
    to the block: inner is the block, outer this rank alone; 1: the
    reverse.  A block is a pipeline stage's data group (pp is the mesh's
    most-major axis), so hpZ's and MiCS's groups stay inside a stage.
    ``lists``: the blocks as lists of world ranks instead (the data groups
    of a mesh with tp > 1 or over a device subset: "consecutive" then means
    consecutive in a list); a rank in none of them holds local groups."""
    import torch.distributed as tdist
    from ..comm import comm
    from ..comm.backend import ProcessGroup
    st = state or get_mesh_state()
    world = _world_size()
    block = world if block is None else block
    if (s, block) in st.factors:
        return st.factors[(s, block)]
    if lists is None:
        if world % block:
            raise ValueError(f"a block of {block} ranks must divide the "
                             f"world of {world}")
        lists = [list(range(b, b + block)) for b in range(0, world, block)]
    if s < 1 or block % s:
        raise ValueError(f"a split of {s} ranks a group must divide the "
                         f"{block} ranks of a block of the world of {world}")
    inner_axes, outer_axes = (DP_AXIS + "_in", ), (DP_AXIS + "_out", )
    rank = comm.get_rank() if world > 1 else 0

    def split(groups, axes):
        mine = None
        for ranks in groups:
            # one rank: local; every rank: the world
            pg = (tdist.new_group(ranks) if 1 < len(ranks) < world
                  else None)
            if rank in ranks:
                mine = ProcessGroup(axes, pg=pg, local=len(ranks) == 1)
        return mine or ProcessGroup(axes, local=True)

    inner = split([b[o * s:(o + 1) * s] for b in lists
                   for o in range(block // s)], inner_axes)
    outer = split([b[i::s] for b in lists for i in range(s)], outer_axes)
    st.factors[(s, block)] = pair = (inner, outer)
    return pair


def prepare_hierarchy(intra_node_size=0):
    """Probe the nodes (once) and make the subgroups of the hierarchy that
    ``intra_node_size`` (or ``DS_TPU_INTRA_NODE_SIZE``, or the probe)
    gives the world, if it has one.  Collective: every rank calls it, at
    engine install."""
    from ..comm.collectives.topology import (detect_intra_node_size,
                                             probe_node_size)
    world = _world_size()
    if world <= 1:
        return None
    st = get_mesh_state()
    if st.node_size is None:
        import os
        hosts = None
        if not os.environ.get("LOCAL_WORLD_SIZE"):
            import socket
            import torch.distributed as tdist
            hosts = [None] * world
            tdist.all_gather_object(hosts, socket.gethostname())
        st.node_size = probe_node_size(world, hosts)
    s = detect_intra_node_size(override=intra_node_size)
    if 1 < s < world and world % s == 0:
        return factor_groups(s, st)
    return None


def _axis_ranks(shape, coord, axes, ranks=None):
    """The world ranks that differ from ``coord`` only along ``axes``, in
    rank order (``shape``, ``coord``: axis name → size, index; ``ranks``:
    the mesh's world ranks in mesh order, None for the whole world)."""
    out = []
    for vals in product(*(range(shape[a]) for a in axes)):
        c = dict(coord, **dict(zip(axes, vals)))
        r = 0
        for a in AXES:
            r = r * shape[a] + c[a]
        out.append(r if ranks is None else ranks[r])
    return out


def axis_rank_lists(axes):
    """Every group over ``axes``, as rank lists in one order on every rank
    (one list for each coordinate of the other axes)."""
    st = get_mesh_state()
    return _rank_lists(st.mesh.shape, axes, st.ranks)


def _rank_lists(shape, axes, ranks=None):
    others = [a for a in AXES if a not in axes]
    return [_axis_ranks(shape, dict(zip(others, vals), **{a: 0 for a in axes}),
                        axes, ranks)
            for vals in product(*(range(shape[a]) for a in others))]


# the groups every mesh holds (``_get_*_group`` below); the ep, expert-data
# and expert-data × sp groups at ep > 1; the tp group and the model group (tp × the
# axes that split the model: the ranks whose states together make it)
_GROUP_AXES = ((PP_AXIS, ), (DP_AXIS, EP_AXIS), (SP_AXIS, ),
               (DP_AXIS, EP_AXIS, SP_AXIS))
_EP_GROUP_AXES = ((EP_AXIS, ), (DP_AXIS, ), (DP_AXIS, SP_AXIS))
_TP_GROUP_AXES = ((TP_AXIS, ), )


def _make_groups(shape, rank, group_axes=_GROUP_AXES, ranks=None,
                 world=None):
    """{axes: ProcessGroup holding ``rank``} for every axes tuple of
    ``group_axes``; every group of every such tuple is made, once, in one
    order on every rank (``new_group`` is collective).  ``ranks``: the
    mesh's world ranks (None: the world, of ``world`` ranks); a rank
    outside the mesh gets a local group of each."""
    import torch.distributed as tdist
    from ..comm.backend import ProcessGroup
    size = 1
    for a in AXES:
        size *= shape[a]
    world = size if world is None else world
    made = {}
    out = {}
    for axes in group_axes:
        others = [a for a in AXES if a not in axes]
        mine = None
        for vals in product(*(range(shape[a]) for a in others)):
            base = dict(zip(others, vals), **{a: 0 for a in axes})
            group = tuple(_axis_ranks(shape, base, axes, ranks))
            if len(group) == 1:
                if rank in group:
                    mine = ProcessGroup(axes, local=True)
                continue
            if len(group) == world:
                if rank in group:
                    mine = ProcessGroup(axes)
                continue
            if group not in made:
                made[group] = tdist.new_group(list(group))
            if rank in group:
                mine = ProcessGroup(axes, pg=made[group])
        out[axes] = mine or ProcessGroup(axes, local=True)
    return out


def _check_devices(devices, total, tp):
    """The mesh's world ranks from ``devices`` (world ranks, or objects
    with an ``id``), which must name whole tp groups: each run of ``tp``
    list entries is ``tp`` consecutive ranks from a multiple of ``tp``."""
    ranks = tuple(int(getattr(d, "id", d)) for d in devices)
    if len(set(ranks)) != len(ranks) or any(
            not 0 <= r < total for r in ranks):
        raise ValueError(f"devices {list(ranks)} must be distinct ranks of "
                         f"the world of {total}")
    if len(ranks) % tp or any(
            ranks[i] % tp or ranks[i:i + tp] != tuple(
                range(ranks[i], ranks[i] + tp))
            for i in range(0, len(ranks), tp)):
        raise ValueError(f"devices {list(ranks)} do not name whole tp "
                         f"groups of {tp} consecutive ranks")
    return ranks


def initialize_mesh(dp=None, pp=1, sp=1, tp=1, ep=1, devices=None,
                    zero_partition_size=None, user_built=True):
    """The mesh over the world, or over the world ranks ``devices``
    (``groups.py:initialize_mesh``): ``dp=None`` takes the ranks pp × sp ×
    tp leave; ``ep`` must divide it (the mesh is (pp, dp/ep, ep, sp, tp)).
    Every rank of the world calls this together: it makes the subgroups
    (with ep > 1 the ep and expert-data groups; with tp > 1 the tp group;
    with ``zero_partition_size`` > 1, the ``zp``/``zp_outer`` ones)."""
    global _mesh_state
    from ..comm import comm
    pp, sp, ep = int(pp or 1), int(sp or 1), int(ep or 1)
    tp = int(tp or 1)
    if ep < 1 or tp < 1:
        raise ValueError(f"ep={ep} and tp={tp} must be >= 1")
    world = _world_size()
    rank = comm.get_rank() if world > 1 else 0
    ranks = None if devices is None else _check_devices(devices, world, tp)
    total = world if ranks is None else len(ranks)
    if dp is None:
        if total % (pp * sp * tp):
            raise ValueError(f"world size {total} not divisible by "
                             f"pp*sp*tp={pp * sp * tp}")
        dp = total // (pp * sp * tp)
    if pp * dp * sp * tp != total:
        raise ValueError(f"pp({pp}) * dp({dp}) * sp({sp}) * tp({tp}) = "
                         f"{pp * dp * sp * tp} != world size {total}")
    if dp % ep != 0:
        raise ValueError(
            f"expert parallel size (ep_size) ep={ep} must divide the "
            f"data-parallel world size dp={dp} — the mesh factors dp into "
            f"(dp/ep, ep) = ({dp}/{ep}, {ep}); pick ep from the divisors "
            "of dp")
    zp = zero_partition_size if zero_partition_size and \
        zero_partition_size > 1 else None
    if zp is not None and dp % zp != 0:
        raise ValueError(
            f"zero_partition_size={zp} must divide dp={dp}")
    if ranks is not None and tuple(ranks) == tuple(range(world)):
        ranks = None
    mesh = Mesh(pp=pp, dp=dp // ep, ep=ep, sp=sp, tp=tp)
    member = ranks is None or rank in ranks
    coord = {}
    if member:
        r = rank if ranks is None else ranks.index(rank)
        for a in reversed(AXES):
            coord[a] = r % mesh.shape[a]
            r //= mesh.shape[a]
    state = MeshState(mesh=mesh, pp=pp, dp=dp, sp=sp, tp=tp, ep=ep,
                      zero_partition_size=zp, user_built=user_built,
                      coord=coord, ranks=ranks, member=member)
    kinds = (_GROUP_AXES if pp * sp > 1 or tp > 1 or ranks is not None
             else ())
    if ep > 1:
        kinds += _EP_GROUP_AXES
    if tp > 1 or ranks is not None:
        kinds += _TP_GROUP_AXES
    state.groups = _make_groups(mesh.shape, rank, kinds, ranks, world)
    if zp is not None:
        # each data group (the dp × sp ranks of one pp and tp coordinate,
        # strided by tp) factored into zp × zp_outer
        factor_groups(zp, state, block=dp * sp, lists=_rank_lists(
            mesh.shape, dp_axes() + (SP_AXIS, ), ranks))
    _mesh_state = state
    return _mesh_state


def mesh_is_initialized():
    return _mesh_state is not None


def get_mesh_state():
    if _mesh_state is None:
        initialize_mesh(user_built=False)
    return _mesh_state


def reset_mesh():
    global _mesh_state
    _mesh_state = None


def get_global_mesh():
    return get_mesh_state().mesh


def dp_axes():
    """Mesh axes whose product is the whole data-parallel degree."""
    return (DP_AXIS, EP_AXIS)


def _pg(axes):
    """The group over ``axes`` holding this rank (one made at mesh init,
    the world, or a local one)."""
    from ..comm.backend import ProcessGroup
    st = get_mesh_state()
    axes = tuple(axes)
    if axes in st.groups:
        return st.groups[axes]
    size = 1
    for a in axes:
        size *= st.mesh.shape[a]
    if size == 1 and DP_AXIS not in axes:
        return ProcessGroup(axes, local=True)
    if size == st.mesh.size and st.ranks is None:
        # the world; the data groups at one rank too, whose collectives
        # then run on the backend
        return ProcessGroup(axes)
    if size == 1:
        return ProcessGroup(axes, local=True)
    raise ValueError(f"no group over {axes} on this mesh "
                     f"{st.mesh.shape}")


def _get_data_parallel_group():
    return _pg(dp_axes())


def _get_sequence_parallel_group():
    return _pg((SP_AXIS, ))


def _get_tensor_parallel_group():
    """The ``tp`` consecutive ranks that hold the slices of one model
    replica's sharded leaves."""
    return _pg((TP_AXIS, ))


_get_model_parallel_group = _get_tensor_parallel_group


def _get_tensor_parallel_world_size():
    return get_mesh_state().tp


_get_model_parallel_world_size = _get_tensor_parallel_world_size


def _get_tensor_parallel_rank():
    """The rank's coordinate along tp: which slice of each sharded leaf it
    holds."""
    return _coord(TP_AXIS)


def _get_expert_parallel_group():
    """The ranks that hold the other experts (the ``ep`` axis)."""
    return _pg((EP_AXIS, ))


def _get_expert_data_parallel_group():
    """The ranks that hold this rank's experts (the mesh's ``dp`` axis,
    dp/ep ranks): expert leaves' gradients sum over it."""
    return _pg((DP_AXIS, ))


def _get_expert_data_sequence_group():
    """The ranks that hold this rank's experts over dp × sp (the
    ``(dp, sp)`` axes; the expert-data group at sp 1): under sequence
    parallelism the other sp ranks' tokens reach the same experts, so the
    expert leaves' gradients sum over this group."""
    return _pg((DP_AXIS, SP_AXIS))


def _get_expert_parallel_world_size():
    return get_mesh_state().ep


def _get_expert_parallel_rank():
    return _coord(EP_AXIS)


def _get_sequence_data_parallel_group():
    """ZeRO shards over the combined dp × sp group when sp is on
    (reference ``engine.py:1580,1651`` seq_data_parallel_group)."""
    return _pg(dp_axes() + (SP_AXIS, ))


def _get_pipe_parallel_group():
    return _pg((PP_AXIS, ))


def _get_zero_param_partition_group():
    """hpZ's secondary partition group, MiCS's shard group (JAX
    ``groups.py:258-265``): the ``zp`` consecutive ranks holding this one;
    None without a ``zero_partition_size``."""
    from ..comm.backend import ProcessGroup
    st = get_mesh_state()
    if st.zero_partition_size is None:
        return None
    inner = st.factors[(st.zero_partition_size, st.dp * st.sp)][0]
    return ProcessGroup((ZP_AXIS, ), pg=inner.pg, local=inner.local)


def _get_zero_param_partition_outer_group():
    """The ranks ``zp`` apart holding this one (the hpZ mesh's
    ``zp_outer`` axis); None without a ``zero_partition_size``."""
    from ..comm.backend import ProcessGroup
    st = get_mesh_state()
    if st.zero_partition_size is None:
        return None
    outer = st.factors[(st.zero_partition_size, st.dp * st.sp)][1]
    return ProcessGroup((ZP_OUTER_AXIS, ), pg=outer.pg, local=outer.local)


def _get_data_parallel_world_size():
    return get_mesh_state().dp


def _get_sequence_parallel_world_size():
    return get_mesh_state().sp


def _get_pipe_parallel_world_size():
    return get_mesh_state().pp


def _coord(axis):
    return get_mesh_state().coord.get(axis, 0)


def _get_data_parallel_rank():
    """This process's data-parallel rank, its coordinate along (dp, ep):
    rank r feeds rows ``[r·B, (r+1)·B)`` of a global batch
    (``engine.shard_batch``).  Ranks with the same value (the pp and sp
    axes) feed the same rows."""
    return _coord(DP_AXIS) * get_mesh_state().mesh.ep + _coord(EP_AXIS)


def _get_sequence_parallel_rank():
    """The rank's coordinate along sp: its chunk of the sequence."""
    return _coord(SP_AXIS)


def _get_pipe_parallel_rank():
    """The rank's pipeline stage."""
    return _coord(PP_AXIS)


def zero_sharding_axes(sequence_parallel=False):
    """Mesh axes over which ZeRO partitions optimizer/grad/param state."""
    return dp_axes() + ((SP_AXIS, ) if sequence_parallel else ())
