"""The expert-parallel dispatch (the port of
``deepspeed_tpu/moe/engine.py``): the ``moe`` config block's options, the
one dispatch point the :class:`~.layer.MoE` layer routes through, the
optional quantized exchange, and the routing statistics.

JAX runs the layer as one GSPMD program over the global tokens: the
dispatched buffer ``[E, C, D]`` is the SUM over tokens, constrained to
``P("ep")`` (``sharded_moe.py:172``), or, with ``moe.quantized_dispatch``,
reduced by hand (``_exchange_st :197``: psum over the token axes other
than ep, then a quantized all-to-all reduce over ep) and gathered back
(``_collect_st :230``).  Each global slot has exactly one contributor
(the gating is global, ``sharded_moe.py``), so the exchange is a sum, not
a concatenation.  Here each rank builds its tokens' part of the buffer,
and :func:`dispatch_combine`:

* reduce-scatters it over the ``ep`` group along E: this rank gets its
  ``E / ep`` experts' buffer ``[E/ep, C, D]``, summed over the ranks of
  its ep group.  The slots of the other ep groups' tokens stay zero: no
  sum over the expert-data group is needed, since the expert FFN works
  row by row and a zero row's output is combined by no token and adds
  nothing to the weights' gradient;
* runs its experts ``[e0, e1)`` (the engine keeps only those of each
  stack at ep > 1, ``Experts.localize``) on it;
* all-gathers the outputs over ep back to ``[E, C, D]`` and combines its
  own tokens.

The backward is the exact one of that linear map (straight-through where
the wire is quantized, as JAX's custom VJPs): the gather's is a
reduce-scatter over ep, the reduce-scatter's an all-gather over ep.  A
rank's expert gradient comes from its ep group's tokens; the engine sums
it over the expert-data group (the ranks holding the same experts), which
gives the gradient of the global loss.

``moe.quantized_dispatch`` at ep > 1 moves the reduce and the gather on a
quantized wire (``comm/collectives/quantized.py``:
``all_to_all_quant_reduce``, which sums in fp32 and hands the buffer back
in its dtype, and ``quantized_all_gather``; B5 and B6 on the card); at
ep 1 it changes nothing, as in JAX.  With an ``intra_node_size`` that
splits the ep group (JAX ``ep_hierarchy``, ``_hier_*``) the two run in two
hops: a flat reduce-scatter over the inner factor, then the quantized
reduce over the outer one on 1/inner of the data (the buffer permuted
inner-major first, so that ep rank j keeps block j), and back a quantized
gather over the outer factor, then a flat one over the inner.  On an sp or
pp mesh the quantized dispatch is ignored with JAX's one warning.

Under the qgZ and 1-bit micros (the engine calls
:func:`set_per_rank_gating`) JAX gates per rank
(``_manual_dispatch_combine``, upstream ``MOELayer``): each
rank's own capacity, the dispatch an all-to-all that concatenates the ep
ranks' blocks into ``[E/ep, ep·C, D]``, never a sum, and the inverse
all-to-all back; tokens never cross the expert-data rows.  That is the
second path of :func:`dispatch_combine`, always one hop.  Under the 1-bit
optimizers the stacks stay whole (ep is a data axis to them, as to JAX's
1-bit micro) and each rank runs its own tokens through every expert.

The token group of the global gating (:func:`token_group`) is the data
group dp × ep × sp at the rank's tp and pp coordinates: under sp a
sequence's tokens sit on several ranks, under pp it is the stage's.  The
telemetry sink of :func:`record_routing` is ROADMAP item 12.
"""

from dataclasses import dataclass

import torch
import torch.distributed as tdist

from ..comm.collectives import quantized as Q
from ..comm.collectives.engine import inner_major
from .sharded_moe import dispatch_combine as _flat_dispatch_combine

#: wire formats the dispatch accepts: the flat rung and the quantized family
DISPATCH_WIRES = (Q.LADDER_FP, ) + Q.WIRE_FORMATS


@dataclass
class MoeOptions:
    """The ``moe`` config block (``runtime/config.py:MoeConfig``) for
    callers without an engine; the dispatcher reads either."""
    enabled: bool = False
    quantized_dispatch: bool = False
    wire_dtype: str = "int8"
    quantization_group_size: int = Q.DEFAULT_GROUP_SIZE
    hierarchical_dispatch: bool = True
    intra_node_size: int = 0


_active = None       # MoeOptions / MoeConfig, or None (the flat exchange)
_comm_opts = None    # comm_optimizations view (its wire ladder)
_ladder = None
_per_rank = False    # the qgZ micro's per-rank gating
_warned = set()
#: bring-ups where the per-rank path or the 2-hop dispatch was asked for
#: and declined (one rank, or an ep group the split does not divide)
declines = {"per_rank": 0, "two_hop": 0}


def configure(moe_opts, comm_opts=None):
    """Install the ``moe`` options (the engine calls this at bring-up;
    None or disabled: the flat exchange).  A refused configuration leaves
    the installed one as it was."""
    global _active, _comm_opts, _ladder
    active = moe_opts if (moe_opts is not None
                          and getattr(moe_opts, "enabled", False)) else None
    ladder = None
    if active is not None:
        wire = getattr(active, "wire_dtype", "int8")
        if wire not in DISPATCH_WIRES:
            raise ValueError(f"moe.wire_dtype {wire!r} unknown (have "
                             f"{', '.join(DISPATCH_WIRES)})")
        if comm_opts is not None and getattr(comm_opts, "enabled", False):
            from ..comm.collectives.engine import build_wire_ladder
            ladder = build_wire_ladder(
                getattr(comm_opts, "wire_dtype_by_size", None))
    _active, _comm_opts, _ladder = active, comm_opts, ladder
    return _active


def reset():
    configure(None)
    set_per_rank_gating(False, 1)


def active_options():
    return _active


def set_per_rank_gating(on, world):
    """The qgZ micro's dispatch (module docstring): each rank gates its own
    tokens and the exchange is the concatenating all-to-all.  Asked for
    over a token group of one rank it declines (counted)."""
    global _per_rank
    if on and world <= 1:
        declines["per_rank"] += 1
    _per_rank = bool(on) and world > 1


def per_rank_gating():
    return _per_rank


def dispatch_wire(nbytes, opts=None):
    """The wire of a dispatch payload of ``nbytes`` logical bytes: the
    ``comm_optimizations.wire_dtype_by_size`` rung where a ladder is
    installed, else ``moe.wire_dtype`` ("fp32": the raw values)."""
    from ..comm.collectives.engine import resolve_in_ladder
    opts = opts if opts is not None else _active
    default = getattr(opts, "wire_dtype", "int8") if opts is not None \
        else Q.LADDER_FP
    return resolve_in_ladder(_ladder, nbytes, default)


def intra_node_size(opts=None):
    """``moe.intra_node_size``, else ``comm_optimizations``' (JAX
    ``_intra_override``); 0: none asked for."""
    opts = opts if opts is not None else _active
    if opts is not None and getattr(opts, "intra_node_size", 0):
        return int(opts.intra_node_size)
    return int(getattr(_comm_opts, "intra_node_size", 0) or 0)


def hier_split(ep, opts=None, n_elements=None):
    """(outer, inner) sizes of the 2-hop split of an ep group of ``ep``
    ranks, or None (one hop): the one place that decides it.
    ``hierarchical_dispatch`` on, an intra-node size strictly between 1
    and ep that divides it (JAX ``ep_hierarchy``, a single-axis split),
    and, where a payload of ``n_elements`` is given, outer × inner dividing
    it (JAX ``resolve_exchange``'s fallback)."""
    opts = opts if opts is not None else _active
    if opts is None or not getattr(opts, "hierarchical_dispatch", True):
        return None
    s = intra_node_size(opts)
    if s <= 1 or s >= ep or ep % s:
        return None
    if n_elements is not None and n_elements % ep:
        return None
    return ep // s, s


def prepare_hierarchy(opts=None):
    """Make the inner and outer subgroups of every ep group's 2-hop split
    (``groups.factor_groups`` over the ep groups' rank lists).  Collective:
    every rank calls it, at engine bring-up, before any dispatch."""
    opts = opts if opts is not None else _active
    if opts is None or not getattr(opts, "quantized_dispatch", False):
        return None
    split = None
    if _world() > 1:
        from ..utils import groups
        st = groups.get_mesh_state()
        split = hier_split(st.ep, opts)
    if split is None:
        if intra_node_size(opts) > 0 and \
                getattr(opts, "hierarchical_dispatch", True):
            declines["two_hop"] += 1
        return None
    from types import SimpleNamespace
    # kept apart from the data groups' splits of the same sizes
    holder = SimpleNamespace(factors=st.ep_factors)
    return groups.factor_groups(split[1], holder, block=st.ep,
                                lists=groups.axis_rank_lists(
                                    (groups.EP_AXIS, )))


def ep_hierarchy(n_elements=None, opts=None, split=None):
    """(inner, outer, n_outer, n_inner) of this rank's ep group's 2-hop
    split of a payload of ``n_elements`` (``split``: :func:`hier_split`'s
    answer where the caller has it; the subgroups made by
    :func:`prepare_hierarchy`), or None: one hop."""
    if _world() <= 1:
        return None
    from ..utils import groups
    st = groups.get_mesh_state()
    if split is None:
        split = hier_split(st.ep, opts, n_elements)
    if split is None:
        return None
    made = st.ep_factors.get((split[1], st.ep))
    if made is None:
        raise RuntimeError("the 2-hop dispatch's subgroups are made at "
                           "engine bring-up on every rank "
                           "(moe.engine.prepare_hierarchy)")
    inner, outer = made
    return inner, outer, split[0], split[1]


def expert_dispatch_wire_bytes(n_elements, wire, group_size, n_inner=1):
    """Transported bytes of one dispatch (or return) exchange on the outer
    (slow) link: the quantized payload and its scales on 1/n_inner of the
    data under the 2-hop exchange, or 4 bytes an element on the flat rung
    (JAX ``engine.py:172``)."""
    n = int(n_elements) // max(1, int(n_inner))
    if wire == Q.LADDER_FP:
        return n * 4
    return Q.quantized_wire_bytes(n, wire, group_size)


# ------------------------------------------------------------ the groups
def _world():
    from .. import comm as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def token_group():
    """The group of the token ranks the gating sees (None at one rank,
    and under the qgZ micro's per-rank gating): dp × ep × sp at this
    rank's tp and pp coordinates (``sharded_moe.py``'s global view)."""
    if _world() <= 1 or _per_rank:
        return None
    from ..utils import groups
    return groups._get_sequence_data_parallel_group().as_flat()


def _ep_group():
    """The ep group, or None at one rank."""
    if _world() <= 1:
        return None
    from ..utils import groups
    return groups._get_expert_parallel_group().as_flat()


def _sp_or_pp():
    from ..utils import groups
    st = groups.get_mesh_state()
    return st.sp > 1 or st.pp > 1


def _all_gather0(t, group):
    if group.local or group.size() == 1:
        return t
    out = torch.empty((group.size(), ) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    tdist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                 group=group.pg)
    return out.reshape((-1, ) + tuple(t.shape[1:]))


def _hier_unpermute(full, n_out, n_in):
    """The 2-hop gather's [inner][outer] block order back to the ep ranks'
    order (JAX ``_hier_unpermute_gathered``): the inverse of the
    reduce-scatter's ``inner_major`` permutation, which lands block j of
    the [E, C, D] buffer on ep rank j (JAX ``_hier_permute``)."""
    E = full.shape[0]
    eloc = E // (n_out * n_in)
    return full.reshape((n_in, n_out, eloc) + tuple(full.shape[1:])) \
        .transpose(0, 1).reshape(full.shape)


class _Exchange(torch.autograd.Function):
    """[E, C, D] → this rank's [E/ep, C, D] of the sum over its ep group:
    a reduce-scatter over ep (flat, or ``all_to_all_quant_reduce`` on a
    quantized wire, its fp32 sum handed back in the buffer's dtype; with
    ``hier`` the 2-hop one).  Backward: the exact flat one, an all-gather
    over ep."""

    @staticmethod
    def forward(ctx, pdisp, ep_group, wire, gs, hier=None):
        ctx.group = ep_group
        n = ep_group.size()
        if n <= 1:
            return pdisp
        if wire == Q.LADDER_FP:
            return Q._reduce_scatter(pdisp, ep_group, 0)
        if hier is not None:
            inner, outer, n_out, n_in = hier
            return Q.hierarchical_quant_reduce_scatter(
                inner_major(pdisp, 0, n_out, n_in), inner, outer, 0, n_in,
                n_out, wire_format=wire, group_size=gs,
                mean=False).to(pdisp.dtype)
        return Q.all_to_all_quant_reduce(
            pdisp, ep_group, 0, n, wire_format=wire, group_size=gs,
            mean=False).to(pdisp.dtype)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather0(dy, ctx.group), None, None, None, None


class _Collect(torch.autograd.Function):
    """This rank's expert outputs [E/ep, C, D] → [E, C, D] on every rank of
    the ep group (flat, or ``quantized_all_gather``; with ``hier``, over
    the outer factor quantized, then over the inner flat).  Backward: a
    reduce-scatter (sum) over ep."""

    @staticmethod
    def forward(ctx, local, ep_group, wire, gs, hier=None):
        ctx.group = ep_group
        if ep_group.size() <= 1:
            return local
        if wire == Q.LADDER_FP:
            return _all_gather0(local, ep_group)
        if hier is not None:
            inner, outer, n_out, n_in = hier
            part = Q.quantized_all_gather(local, outer, 0, wire,
                                          gs).to(local.dtype)
            return _hier_unpermute(_all_gather0(part, inner), n_out, n_in)
        return Q.quantized_all_gather(local, ep_group, 0, wire,
                                      gs).to(local.dtype)

    @staticmethod
    def backward(ctx, dy):
        g = dy if ctx.group.size() <= 1 else \
            Q._reduce_scatter(dy.contiguous(), ctx.group, 0)
        return g, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """The per-rank path's permuting exchange (JAX ``_dispatch_a2a_st``,
    ``_return_a2a_st``): chunk j of dim ``split`` to ep rank j, the chunks
    received concatenated along ``concat`` (flat or quantized).
    Backward: the inverse all-to-all, flat (straight-through)."""

    @staticmethod
    def forward(ctx, x, ep_group, split, concat, wire, gs):
        ctx.group, ctx.split, ctx.concat = ep_group, split, concat
        return Q.quantized_all_to_all(x.contiguous(), ep_group, split,
                                      concat, ep_group.size(),
                                      wire_format=wire, group_size=gs)

    @staticmethod
    def backward(ctx, dy):
        g = Q.quantized_all_to_all(dy.contiguous(), ctx.group, ctx.concat,
                                   ctx.split, ctx.group.size(),
                                   wire_format=Q.LADDER_FP)
        return g, None, None, None, None, None


def exchange_plan(E, C, D, opts=None, ep=None):
    """(wire, group size, 2-hop split, wire bytes of one exchange) of a
    dispatch of an [E, C, D] buffer under ``opts`` (default: the installed
    options) over an ep group of ``ep`` ranks (default: the mesh's).  The
    split is :func:`hier_split`'s (outer, inner) on a quantized wire, else
    None; the bytes are then the 2-hop exchange's outer-link ones."""
    opts = opts if opts is not None else _active
    gs = int(getattr(opts, "quantization_group_size", Q.DEFAULT_GROUP_SIZE)
             if opts is not None else Q.DEFAULT_GROUP_SIZE)
    wire = Q.LADDER_FP
    if opts is not None and getattr(opts, "quantized_dispatch", False):
        wire = dispatch_wire(E * C * D * 4, opts)
    split = None
    if wire != Q.LADDER_FP:
        if ep is None and _world() > 1:
            from ..utils import groups
            ep = groups.get_mesh_state().ep
        split = hier_split(ep or 1, opts, E * C * D)
    return wire, gs, split, expert_dispatch_wire_bytes(
        E * C * D, wire, gs, split[1] if split else 1)


def _warn_sp_pp_once():
    if "sp_pp" not in _warned:
        _warned.add("sp_pp")
        from ..utils.logging import logger
        logger.warning(
            "moe.quantized_dispatch is ignored on sp/pp meshes (the "
            "manual dispatch regions assume tokens shard over (dp, ep) "
            "only); using the GSPMD constraint path")


def _per_rank_dispatch_combine(x, combine, dispatch, experts):
    """The qgZ micro's exchange (JAX ``_manual_dispatch_combine``): this
    rank's own [E, C, D] blocks, E/ep to each ep rank, concatenated there
    into [E/ep, ep·C, D]; the experts; the inverse all-to-all."""
    ep_group = _ep_group()
    ep = ep_group.size()
    if ep <= 1 or experts.whole:
        # a token group of dp ranks only, or the 1-bit optimizers' whole
        # stacks (ep a data axis): nothing to exchange
        return _flat_dispatch_combine(x, combine, dispatch, experts)
    pdisp = torch.einsum("tec,td->ecd", dispatch.to(x.dtype).detach(), x)
    E = pdisp.shape[0]
    if E % ep:
        raise ValueError(
            f"num_experts={E} must be divisible by ep={ep} (expert "
            "stacks split their leading dim over the ep axis)")
    wire, gs = Q.LADDER_FP, Q.DEFAULT_GROUP_SIZE
    if _active is not None and getattr(_active, "quantized_dispatch", False):
        # the rung from the logical (global) payload, as JAX's
        wire = dispatch_wire(pdisp.numel() * token_group_size() * 4)
        gs = int(getattr(_active, "quantization_group_size", gs))
    local = _AllToAll.apply(pdisp, ep_group, 0, 1, wire, gs)
    n, j = E // ep, ep_group.rank()
    out = _AllToAll.apply(experts(local, (j * n, (j + 1) * n)), ep_group,
                          1, 0, wire, gs)
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), out)


def token_group_size():
    """The number of ranks the tokens are sharded over (dp × ep × sp)."""
    if _world() <= 1:
        return 1
    from ..utils import groups
    return groups._get_sequence_data_parallel_group().size()


def dispatch_combine(x, combine, dispatch, experts):
    """THE expert-dispatch point of the :class:`~.layer.MoE` layer.
    ``x`` [T, D] this rank's tokens; ``combine``/``dispatch`` [T, E, C]
    the gating's; ``experts`` the :class:`~.experts.Experts` stack
    (called on [E', C, D] with its slice ``[e0, e1)``).  One rank: the flat
    einsums (``sharded_moe.dispatch_combine``); under the qgZ micro the
    per-rank path; else the global gating's exchange."""
    if _per_rank and token_group_size() > 1:
        return _per_rank_dispatch_combine(x, combine, dispatch, experts)
    ep_group = _ep_group()
    if ep_group is None:
        return _flat_dispatch_combine(x, combine, dispatch, experts)
    pdisp = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    E, C, D = pdisp.shape
    ep, j = ep_group.size(), ep_group.rank()
    if E % ep:
        raise ValueError(
            f"num_experts={E} must be divisible by ep={ep} (expert "
            "stacks split their leading dim over the ep axis)")
    wire, gs, hier = Q.LADDER_FP, Q.DEFAULT_GROUP_SIZE, None
    if ep > 1:
        wire, gs, split, _ = exchange_plan(E, C, D, ep=ep)
        if wire != Q.LADDER_FP and _sp_or_pp():
            _warn_sp_pp_once()
            wire, split = Q.LADDER_FP, None
        if split is not None:
            hier = ep_hierarchy(split=split)
    local = _Exchange.apply(pdisp, ep_group, wire, gs, hier)
    n = E // ep
    out = _Collect.apply(experts(local, (j * n, (j + 1) * n)), ep_group,
                         wire, gs, hier)
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), out)


def record_routing(k, combine, dispatch, exp_counts, l_aux):
    """One MoE layer's routed-token statistics (JAX ``record_routing``'s
    values; its telemetry sink is item 12): the dropped share
    of the T·k assignments, the overflow count, the load imbalance (max /
    mean tokens an expert, after the drop), the aux loss and each
    expert's capacity use.  Device tensors: nothing is read on the
    host."""
    T = dispatch.shape[0]
    kept = dispatch.float().sum()
    total = float(max(1, T * k))
    counts = exp_counts.float()
    C = max(1, dispatch.shape[-1])
    return {
        "drop_fraction": 1.0 - kept / total,
        "overflow_tokens": total - kept,
        "load_imbalance": counts.max() / counts.mean().clamp_min(1e-9),
        "aux_loss": torch.as_tensor(l_aux, dtype=torch.float32),
        "expert_util": dispatch.float().sum(dim=(0, 2)) / C,
    }
