"""Process-group topology (the port of ``deepspeed_tpu/utils/groups.py``;
reference ``deepspeed/utils/groups.py``).

The JAX package builds one 5-axis mesh ``(pp, dp, ep, sp, tp)``.  Here the
same axes are sizes over the ``torch.distributed`` world, in the same
order, most-major first: rank r's coordinates are those of the r-th
device of JAX's mesh (``rank = (((pp·DP + dp)·EP + ep)·SP + sp)·TP +
tp``).  A group is a torch process group with the axis names it spans:
the ranks that differ from this one only along those axes.  pp, dp, ep
and sp are ported; tp > 1 raises ROADMAP queue A item 9b, as the config's
``mesh`` key does (``runtime/config.py``), and ep > 1 with pp or sp > 1
item 8b.  ``ep`` factors the data-parallel degree dp into (dp/ep, ep), as
JAX's mesh does (``groups.py:148-158``): the data-parallel rank is
``dp_coord · ep + ep_coord``; the ``ep`` group holds the ranks whose
experts differ, the ``dp`` group (the expert-data group) the ranks that
hold the same experts.

``torch.distributed.new_group`` is collective: every rank makes every
subgroup once, in the same order, here, at mesh init (the pipeline's, the
sequence-parallel ones, the sequence-data-parallel ones ZeRO shards over,
hpZ's and MiCS's).  A group of one rank is local (no process group), and
one of every rank is the world.

``zero_partition_size`` (hpZ's secondary partition and MiCS's shard
groups, JAX ``groups.py:171-182``) factors each pipeline stage's data
group (dp × sp) into ``zp_outer × zp``: the ``zp`` groups of consecutive
ranks and the ``zp_outer`` groups of the ranks ``zp`` apart, the torch
counterparts of the JAX hpZ mesh's axes (which carries pp too).
The collectives engine's hierarchies are the same kind of pair
(:func:`factor_groups`).
"""

from dataclasses import dataclass, field
from itertools import product

from .not_ported import not_ported

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
    # built by a caller of initialize_mesh (not by init_distributed or on
    # first use): an engine must not rebuild it
    user_built: bool = True
    # this rank's coordinates, axis name → index
    coord: dict = field(default_factory=dict)
    # axes tuple → the ProcessGroup over them holding this rank
    groups: dict = field(default_factory=dict)


def _world_size():
    from ..comm import comm
    return comm.get_world_size()


def factor_groups(s, state=None, block=None):
    """The (inner, outer) pair of a split of each block of ``block``
    consecutive ranks (default: the world) into groups of ``s``
    consecutive ranks and groups of the ranks ``s`` apart, made once (a
    collective: every rank calls it with the same arguments).  ``s`` equal
    to the block: inner is the block, outer this rank alone; 1: the
    reverse.  A block is a pipeline stage's data group (pp is the mesh's
    most-major axis), so hpZ's and MiCS's groups stay inside a stage."""
    import torch.distributed as tdist
    from ..comm import comm
    from ..comm.backend import ProcessGroup
    st = state or get_mesh_state()
    world = _world_size()
    block = world if block is None else block
    if (s, block) in st.factors:
        return st.factors[(s, block)]
    if s < 1 or world % block or block % s:
        raise ValueError(f"a split of {s} ranks a group must divide the "
                         f"{block} ranks of a block of the world of {world}")
    inner_axes, outer_axes = (DP_AXIS + "_in", ), (DP_AXIS + "_out", )
    rank = comm.get_rank() if world > 1 else 0

    def split(lists, axes):
        mine = None
        for ranks in lists:
            # one rank: local; every rank: the world
            pg = (tdist.new_group(ranks) if 1 < len(ranks) < world
                  else None)
            if rank in ranks:
                mine = ProcessGroup(axes, pg=pg, local=len(ranks) == 1)
        return mine

    bases = range(0, world, block)
    inner = split([list(range(b + o * s, b + (o + 1) * s)) for b in bases
                   for o in range(block // s)], inner_axes)
    outer = split([list(range(b + i, b + block, s)) for b in bases
                   for i in range(s)], outer_axes)
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


def _axis_ranks(shape, coord, axes):
    """The world ranks that differ from ``coord`` only along ``axes``, in
    rank order (``shape``, ``coord``: axis name → size, index)."""
    ranks = []
    for vals in product(*(range(shape[a]) for a in axes)):
        c = dict(coord, **dict(zip(axes, vals)))
        r = 0
        for a in AXES:
            r = r * shape[a] + c[a]
        ranks.append(r)
    return ranks


def axis_rank_lists(axes):
    """Every group over ``axes``, as rank lists in one order on every rank
    (one list for each coordinate of the other axes)."""
    shape = get_mesh_state().mesh.shape
    others = [a for a in AXES if a not in axes]
    return [_axis_ranks(shape, dict(zip(others, vals), **{a: 0 for a in axes}),
                        axes)
            for vals in product(*(range(shape[a]) for a in others))]


# the groups every mesh holds (``_get_*_group`` below); the ep and
# expert-data groups at ep > 1
_GROUP_AXES = ((PP_AXIS, ), (DP_AXIS, EP_AXIS), (SP_AXIS, ),
               (DP_AXIS, EP_AXIS, SP_AXIS))
_EP_GROUP_AXES = ((EP_AXIS, ), (DP_AXIS, ))


def _make_groups(shape, rank, group_axes=_GROUP_AXES):
    """{axes: ProcessGroup holding ``rank``} for every axes tuple of
    ``group_axes``; every group of every such tuple is made, once, in one
    order on every rank (``new_group`` is collective)."""
    import torch.distributed as tdist
    from ..comm.backend import ProcessGroup
    world = 1
    for a in AXES:
        world *= shape[a]
    made = {}
    out = {}
    for axes in group_axes:
        others = [a for a in AXES if a not in axes]
        mine = None
        for vals in product(*(range(shape[a]) for a in others)):
            base = dict(zip(others, vals), **{a: 0 for a in axes})
            ranks = tuple(_axis_ranks(shape, base, axes))
            if len(ranks) == 1:
                if rank in ranks:
                    mine = ProcessGroup(axes, local=True)
                continue
            if len(ranks) == world:
                if rank in ranks:
                    mine = ProcessGroup(axes)
                continue
            if ranks not in made:
                made[ranks] = tdist.new_group(list(ranks))
            if rank in ranks:
                mine = ProcessGroup(axes, pg=made[ranks])
        out[axes] = mine
    return out


def initialize_mesh(dp=None, pp=1, sp=1, tp=1, ep=1, devices=None,
                    zero_partition_size=None, user_built=True):
    """The mesh over the world (``groups.py:initialize_mesh``):
    ``dp=None`` takes the ranks pp × sp leave; ``ep`` must divide it
    (the mesh is (pp, dp/ep, ep, sp, tp)).  tp must be 1.  Every rank
    calls this together: it makes the subgroups (with ep > 1 the ep and
    expert-data groups; with ``zero_partition_size`` > 1, the
    ``zp``/``zp_outer`` ones)."""
    global _mesh_state
    from ..comm import comm
    if devices is not None:
        raise not_ported("initialize_mesh(devices=...) (a mesh over a "
                         "device subset)", "9b")
    if tp not in (None, 1):
        raise not_ported(f"tensor parallelism (tp={tp})", "9b")
    pp, sp, ep = int(pp or 1), int(sp or 1), int(ep or 1)
    if ep < 1:
        raise ValueError(f"expert parallel size ep={ep} must be >= 1")
    total = _world_size()
    if dp is None:
        if total % (pp * sp):
            raise ValueError(f"world size {total} not divisible by "
                             f"pp*sp*tp={pp * sp}")
        dp = total // (pp * sp)
    if pp * dp * sp != total:
        raise ValueError(f"pp({pp}) * dp({dp}) * sp({sp}) * tp(1) = "
                         f"{pp * dp * sp} != world size {total}")
    if dp % ep != 0:
        raise ValueError(
            f"expert parallel size (ep_size) ep={ep} must divide the "
            f"data-parallel world size dp={dp} — the mesh factors dp into "
            f"(dp/ep, ep) = ({dp}/{ep}, {ep}); pick ep from the divisors "
            "of dp")
    if ep > 1 and pp * sp > 1:
        raise not_ported(f"expert parallelism (ep={ep}) with pp or sp > 1",
                         "8b")
    zp = zero_partition_size if zero_partition_size and \
        zero_partition_size > 1 else None
    if zp is not None and dp % zp != 0:
        raise ValueError(
            f"zero_partition_size={zp} must divide dp={dp}")
    if zp is not None and ep > 1:
        raise not_ported("hpZ / MiCS shard groups with ep > 1", "8b")
    mesh = Mesh(pp=pp, dp=dp // ep, ep=ep, sp=sp, tp=1)
    rank = comm.get_rank() if total > 1 else 0
    coord, r = {}, rank
    for a in reversed(AXES):
        coord[a] = r % mesh.shape[a]
        r //= mesh.shape[a]
    state = MeshState(mesh=mesh, pp=pp, dp=dp, sp=sp, tp=1, ep=ep,
                      zero_partition_size=zp, user_built=user_built,
                      coord=coord)
    state.groups = (_make_groups(mesh.shape, rank) if pp * sp > 1 else {})
    if ep > 1:
        state.groups.update(_make_groups(mesh.shape, rank, _EP_GROUP_AXES))
    if zp is not None:
        factor_groups(zp, state, block=dp * sp)
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
    if size == st.mesh.size:
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


def _get_expert_parallel_group():
    """The ranks that hold the other experts (the ``ep`` axis)."""
    return _pg((EP_AXIS, ))


def _get_expert_data_parallel_group():
    """The ranks that hold this rank's experts (the mesh's ``dp`` axis,
    dp/ep ranks): expert leaves' gradients sum over it."""
    return _pg((DP_AXIS, ))


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
