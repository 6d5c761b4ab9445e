"""The hierarchy layer of the collectives engine (the port of
``deepspeed_tpu/comm/collectives/topology.py``): how a group splits into
(inter-node, intra-node) factors.

A hierarchical collective runs ``intra-node reduce-scatter → inter-node
op on 1/N of the data → intra-node all-gather``.  In JAX the factors are
mesh axes; here they are ``torch.distributed`` subgroups of the world:
the *inner* groups of ``s`` consecutive ranks (a node, the fast links)
and the *outer* groups of the ranks ``s`` apart (one a node).  Subgroup
creation is collective, so every rank makes them once, in the same order,
when the mesh is built or the engine installed (``utils/groups.py``),
never at a collective; they go with the world
(``comm.destroy_process_group``).

The split ``s`` comes from the override (``intra_node_size``), then
``DS_TPU_INTRA_NODE_SIZE``, then the node probe: ``LOCAL_WORLD_SIZE``
where the launcher sets it, else the ranks' host names (JAX probes the
device slice and process, ``topology.py:64 _node_key``).  Only the world
group (the data-parallel group) is factored; any other group has no
hierarchy, as a group within one node has none in JAX.
"""

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Hierarchy:
    """A group split into ``outer`` (the ranks ``inner_size`` apart: the
    slow hop) and ``inner`` (consecutive ranks: the fast one) subgroups
    that hold this rank; rank = outer index × inner_size + inner index."""
    inner: object
    outer: object
    outer_size: int
    inner_size: int

    @property
    def size(self):
        return self.outer_size * self.inner_size


def _env_intra_node_size():
    env = os.environ.get("DS_TPU_INTRA_NODE_SIZE")
    if not env:
        return None
    try:
        val = int(env)
    except ValueError:
        raise ValueError(
            f"DS_TPU_INTRA_NODE_SIZE={env!r} is not an integer — set it to "
            "the devices-per-node count (e.g. 4), or unset it for "
            "auto-detection") from None
    if val < 0:
        raise ValueError(f"DS_TPU_INTRA_NODE_SIZE={env!r} must be "
                         "non-negative (0 = auto-detect)")
    return val


def probe_node_size(world, rank_hosts=None):
    """Ranks a node, consecutive from rank 0: ``LOCAL_WORLD_SIZE`` when
    set, else the run of rank 0's host in ``rank_hosts`` (every rank's
    host name, gathered by the caller).  0 when the run is the whole world
    or does not divide it (refuse to guess)."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    if env:
        run = int(env)
    elif rank_hosts is None:
        return 0
    else:
        run = 1
        while run < world and rank_hosts[run] == rank_hosts[0]:
            run += 1
    if run >= world or run < 1 or world % run:
        return 0
    return run


def detect_intra_node_size(group=None, override=0):
    """The intra-node run length: the override > ``DS_TPU_INTRA_NODE_SIZE``
    > the node probe made when the mesh was built.  0: no usable
    hierarchy."""
    if override and override > 1:
        return override
    env = _env_intra_node_size()
    if env is not None:
        return env
    from ...utils import groups
    if not groups.mesh_is_initialized():
        return 0
    return groups.get_mesh_state().node_size or 0


def factor_group(group, intra_node_size=0):
    """The :class:`Hierarchy` of ``group``, or None: a group of one rank,
    a group other than the world, a split that leaves no outer or inner
    factor or does not divide the group.  The subgroups must exist
    (``utils/groups.py:factor_groups``, made at mesh init or engine
    install); a split asked for without them raises."""
    if group is None or group.local or group.pg is not None:
        return None
    n = group.size()
    s = detect_intra_node_size(group, override=intra_node_size)
    if s <= 1 or s >= n or n % s:
        return None
    from ...utils import groups
    made = groups.get_mesh_state().factors.get((s, n))
    if made is None:
        raise RuntimeError(
            f"no subgroups of {s} ranks a node: they are made when the mesh "
            "is built or the collectives engine installed "
            "(groups.factor_groups), on every rank; install the engine after "
            "init_distributed")
    inner, outer = made
    return Hierarchy(inner=inner, outer=outer, outer_size=n // s,
                     inner_size=s)
