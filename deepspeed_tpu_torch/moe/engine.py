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
ep 1 it changes nothing, as in JAX.  The 2-hop hierarchical exchange
(``ep_hierarchy``, ``_hier_*``), the qgZ manual micro's per-rank gating
(``_manual_dispatch_combine``) and the telemetry sink of
:func:`record_routing` are ROADMAP queue A item 8b.
"""

from dataclasses import dataclass

import torch
import torch.distributed as tdist

from ..comm.collectives import quantized as Q
from ..utils.not_ported import not_ported
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
        ep_hierarchy(active)
        if comm_opts is not None and getattr(comm_opts, "enabled", False):
            from ..comm.collectives.engine import build_wire_ladder
            ladder = build_wire_ladder(
                getattr(comm_opts, "wire_dtype_by_size", None))
    _active, _comm_opts, _ladder = active, comm_opts, ladder
    return _active


def reset():
    configure(None)


def active_options():
    return _active


def dispatch_wire(nbytes, opts=None):
    """The wire of a dispatch payload of ``nbytes`` logical bytes: the
    ``comm_optimizations.wire_dtype_by_size`` rung where a ladder is
    installed, else ``moe.wire_dtype`` ("fp32": the raw values)."""
    from ..comm.collectives.engine import resolve_in_ladder
    opts = opts if opts is not None else _active
    default = getattr(opts, "wire_dtype", "int8") if opts is not None \
        else Q.LADDER_FP
    return resolve_in_ladder(_ladder, nbytes, default)


def ep_hierarchy(opts=None):
    """None: the exchange is one hop.  An ``intra_node_size`` that splits
    the ep group (JAX's 2-hop dispatch) raises item 8b."""
    opts = opts if opts is not None else _active
    if opts is None or not getattr(opts, "hierarchical_dispatch", True):
        return None
    if int(getattr(opts, "intra_node_size", 0) or 0) > 0 and \
            getattr(opts, "quantized_dispatch", False):
        raise not_ported("the 2-hop hierarchical expert dispatch "
                         "(moe.intra_node_size)", "8b")
    return None


def expert_dispatch_wire_bytes(n_elements, wire, group_size, n_inner=1):
    """Transported bytes of one dispatch (or return) exchange: the
    quantized payload and its scales, or 4 bytes an element on the flat
    rung (JAX ``engine.py:172``)."""
    n = int(n_elements) // max(1, int(n_inner))
    if wire == Q.LADDER_FP:
        return n * 4
    return Q.quantized_wire_bytes(n, wire, group_size)


# ------------------------------------------------------------ the groups
def _world():
    from .. import comm as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def token_group():
    """The data-parallel group of the token ranks (None at one rank):
    the gating's global view (``sharded_moe.py``)."""
    if _world() <= 1:
        return None
    from ..utils import groups
    st = groups.get_mesh_state()
    if st.pp * st.sp > 1:
        raise not_ported("the MoE layer with pp or sp > 1", "8b")
    return groups._get_data_parallel_group().as_flat()


def _ep_group():
    """The ep group, or None at one rank."""
    if _world() <= 1:
        return None
    from ..utils import groups
    return groups._get_expert_parallel_group().as_flat()


def _all_gather0(t, group):
    if group.local or group.size() == 1:
        return t
    out = torch.empty((group.size(), ) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    tdist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                 group=group.pg)
    return out.reshape((-1, ) + tuple(t.shape[1:]))


class _Exchange(torch.autograd.Function):
    """[E, C, D] → this rank's [E/ep, C, D] of the sum over its ep group:
    a reduce-scatter over ep (flat, or ``all_to_all_quant_reduce`` on a
    quantized wire, its fp32 sum handed back in the buffer's dtype).
    Backward: the exact flat one, an all-gather over ep."""

    @staticmethod
    def forward(ctx, pdisp, ep_group, wire, gs):
        ctx.group = ep_group
        n = ep_group.size()
        if n <= 1:
            return pdisp
        if wire == Q.LADDER_FP:
            return Q._reduce_scatter(pdisp, ep_group, 0)
        return Q.all_to_all_quant_reduce(
            pdisp, ep_group, 0, n, wire_format=wire, group_size=gs,
            mean=False).to(pdisp.dtype)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather0(dy, ctx.group), None, None, None


class _Collect(torch.autograd.Function):
    """This rank's expert outputs [E/ep, C, D] → [E, C, D] on every rank of
    the ep group (flat, or ``quantized_all_gather``).  Backward: a
    reduce-scatter (sum) over ep."""

    @staticmethod
    def forward(ctx, local, ep_group, wire, gs):
        ctx.group = ep_group
        if ep_group.size() <= 1:
            return local
        if wire == Q.LADDER_FP:
            return _all_gather0(local, ep_group)
        return Q.quantized_all_gather(local, ep_group, 0, wire,
                                      gs).to(local.dtype)

    @staticmethod
    def backward(ctx, dy):
        g = dy if ctx.group.size() <= 1 else \
            Q._reduce_scatter(dy.contiguous(), ctx.group, 0)
        return g, None, None, None


def exchange_plan(E, C, D, opts=None):
    """(wire, group size, wire bytes of one exchange) of a dispatch of an
    [E, C, D] buffer under ``opts`` (default: the installed options)."""
    opts = opts if opts is not None else _active
    gs = int(getattr(opts, "quantization_group_size", Q.DEFAULT_GROUP_SIZE)
             if opts is not None else Q.DEFAULT_GROUP_SIZE)
    wire = Q.LADDER_FP
    if opts is not None and getattr(opts, "quantized_dispatch", False):
        wire = dispatch_wire(E * C * D * 4, opts)
    return wire, gs, expert_dispatch_wire_bytes(E * C * D, wire, gs)


def dispatch_combine(x, combine, dispatch, experts):
    """THE expert-dispatch point of the :class:`~.layer.MoE` layer.
    ``x`` [T, D] this rank's tokens; ``combine``/``dispatch`` [T, E, C]
    the global gating's; ``experts`` the :class:`~.experts.Experts` stack
    (called on [E', C, D] with its slice ``[e0, e1)``).  One rank: the flat
    einsums (``sharded_moe.dispatch_combine``)."""
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
    wire, gs, _ = exchange_plan(E, C, D) if ep > 1 else \
        (Q.LADDER_FP, Q.DEFAULT_GROUP_SIZE, 0)
    local = _Exchange.apply(pdisp, ep_group, wire, gs)
    n = E // ep
    out = _Collect.apply(experts(local, (j * n, (j + 1) * n)), ep_group,
                         wire, gs)
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), out)


def record_routing(k, combine, dispatch, exp_counts, l_aux):
    """One MoE layer's routed-token statistics (JAX ``record_routing``'s
    values; its telemetry sink is item 8b with item 12): the dropped share
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
