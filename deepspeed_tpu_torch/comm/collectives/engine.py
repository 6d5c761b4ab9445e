"""The pluggable collectives engine behind the ``dist.*`` facade (the port
of ``deepspeed_tpu/comm/collectives/engine.py``).

``comm/comm.py`` has one dispatch point (``_dispatch``): with an engine
installed and enabled, every ``all_reduce``, ``all_gather``,
``reduce_scatter`` (and ``allgather_fn``, ``reduce_scatter_fn`` and the
coalesced helpers) is offered to :meth:`CollectivesEngine.dispatch`
first, which picks a *variant*:

    ==================  =============================================
    variant             meaning
    ==================  =============================================
    (None: declined)    the flat single-hop collective, bit-exact
    ``hier``            hierarchical all-reduce (fp payload)
    ``q_<fmt>``         quantized payload (all-gather / reduce-scatter)
    ``hier_q_<fmt>``    2-hop: fp intra-node, quantized inter-node
    ==================  =============================================

and returns ``(result, variant, wire_bytes)`` or None.  ``wire_bytes``
is what this rank puts on the slow (inter-node) link, which the comms
logger reports beside the message size (this rank's input, as for a flat
op).  Every pick is counted in
:attr:`CollectivesEngine.counts` (``"<op>/<variant>"``, a decline as
``flat_fallback``), as the JAX engine's telemetry counters count them.

Selection follows the JAX engine's rules: a reduce op outside SUM/AVG
(MIN/MAX/PRODUCT), a non-float dtype, a group of one rank, a split that
does not divide, a message under ``min_message_size``, an ``"fp32"``
ladder rung, or no hierarchy all decline.  The message size is the JAX
facade's global array: the gathered tensor for all-gather and
all-reduce, the whole tensor for reduce-scatter.

Results keep the facade's per-rank contract: a reduce-scatter leaves
block r on rank r on every variant (the 2-hop one is inner-major, so its
input is permuted first), an all-reduce writes its result in place.
"""

from collections import Counter

import torch

from ..backend import AsyncHandle
from ..reduce_op import ReduceOp
from . import quantized as Q
from .config import CommOptimizations
from .quantized import LADDER_FP
from .topology import factor_group

_LINEAR_OPS = (ReduceOp.SUM, ReduceOp.AVG)


def build_wire_ladder(raw):
    """A ``wire_dtype_by_size`` value → an ascending tuple of
    ``(max_bytes, wire)`` rungs, or None when absent or empty (the global
    ``wire_dtype`` everywhere).  Takes ``[max_bytes, wire]`` pairs or
    ``{"max_bytes":, "wire_dtype":}`` dicts; a ``max_bytes`` of None is the
    catch-all rung (at most one, last).  Unknown wires, bounds that are
    not positive and duplicate bounds raise."""
    if not raw:
        return None
    rungs = []
    for entry in raw:
        if isinstance(entry, dict):
            mb, wire = entry.get("max_bytes"), entry.get("wire_dtype")
        else:
            if len(entry) != 2:
                raise ValueError(
                    f"wire_dtype_by_size entry {entry!r} is not a "
                    "[max_bytes, wire_dtype] pair")
            mb, wire = entry
        if wire != LADDER_FP and wire not in Q.WIRE_FORMATS:
            raise ValueError(
                f"wire_dtype_by_size wire {wire!r} unknown "
                f"(have {LADDER_FP}, {', '.join(Q.WIRE_FORMATS)})")
        if mb is not None:
            mb = int(mb)
            if mb <= 0:
                raise ValueError(
                    f"wire_dtype_by_size max_bytes {mb} must be positive "
                    "(use null for the catch-all rung)")
        rungs.append((mb, str(wire)))
    bounded = [r for r in rungs if r[0] is not None]
    catchall = [r for r in rungs if r[0] is None]
    if len(catchall) > 1:
        raise ValueError("wire_dtype_by_size has multiple catch-all "
                         "(max_bytes: null) rungs")
    if len({mb for mb, _ in bounded}) != len(bounded):
        raise ValueError("wire_dtype_by_size has duplicate max_bytes bounds")
    bounded.sort(key=lambda r: r[0])
    return tuple(bounded + catchall)


def resolve_in_ladder(ladder, nbytes, default):
    """The first rung admitting ``nbytes`` (bounds inclusive, None the
    catch-all); ``default`` without a ladder or above every bounded rung.
    Shared by the facade's dispatch and the ZeRO plan's
    ``wire_for_size``."""
    if ladder is None:
        return default
    for bound, wire in ladder:
        if bound is None or nbytes <= bound:
            return wire
    return default


def inner_major(x, axis, n_outer, n_inner):
    """``x`` with its ``n_outer · n_inner`` blocks along ``axis`` reordered
    so that a 2-hop reduce-scatter, which gives the rank at (o, i) block
    ``i · n_outer + o``, gives it block ``o · n_inner + i``: its own."""
    xm = x.movedim(axis, 0)
    rest = tuple(xm.shape[1:])
    blk = xm.shape[0] // (n_outer * n_inner)
    y = xm.reshape((n_outer, n_inner, blk) + rest).transpose(0, 1)
    return y.reshape((-1, ) + rest).movedim(0, axis)


def _done(result, async_op):
    return AsyncHandle(None, result) if async_op else result


class CollectivesEngine:
    """Per-op variant selection over a duck-typed ``comm_optimizations``
    options object (the parsed config block or :class:`CommOptimizations`).
    """

    def __init__(self, opts=None):
        self.opts = opts if opts is not None else CommOptimizations()
        fmt = getattr(self.opts, "wire_dtype", "int8")
        if fmt not in Q.WIRE_FORMATS:
            raise ValueError(
                f"comm_optimizations.wire_dtype {fmt!r} unknown "
                f"(have {', '.join(Q.WIRE_FORMATS)})")
        self._ladder = build_wire_ladder(
            getattr(self.opts, "wire_dtype_by_size", None))
        self.counts = Counter()

    def resolve_wire_dtype(self, nbytes):
        """The wire for a payload of ``nbytes`` logical bytes (may be
        ``"fp32"``: the caller runs the flat path)."""
        return resolve_in_ladder(self._ladder, nbytes, self.opts.wire_dtype)

    @property
    def enabled(self):
        return bool(getattr(self.opts, "enabled", False))

    @property
    def group_size(self):
        return getattr(self.opts, "quantization_group_size",
                       Q.DEFAULT_GROUP_SIZE)

    def prepare(self):
        """Make the subgroups this engine's hierarchy needs (a collective:
        every rank calls it when the engine is installed)."""
        if self.enabled and getattr(self.opts, "hierarchical_allreduce",
                                    False):
            from ...utils import groups
            groups.prepare_hierarchy(getattr(self.opts, "intra_node_size",
                                             0))

    # ------------------------------------------------------------- helpers
    def _hierarchy(self, group):
        if not getattr(self.opts, "hierarchical_allreduce", False):
            return None
        return factor_group(group, getattr(self.opts, "intra_node_size", 0))

    # ------------------------------------------------------------ dispatch
    def dispatch(self, op_name, x, group, reduce_op=ReduceOp.SUM, axis=0,
                 out=None, async_op=False, wire_format=None,
                 hierarchy=None):
        """Offer ``x`` to the variants: ``(result, variant, wire_bytes)``,
        or None (the caller runs the flat path).

        ``out`` (``allgather_fn``/``reduce_scatter_fn``): the flat output
        to write; ``async_op``: the result is a handle (a quantized gather
        dequantizes when it is waited on).  ``wire_format`` (the ZeRO
        plan's wire, already through its ladder) and ``hierarchy`` (the
        plan's 2-hop groups) replace the options' choice of both."""
        hit = None
        if x.dim() > 0 and group is not None and (
                wire_format is not None or self._big_enough(op_name, x,
                                                            group)):
            if op_name == "all_reduce":
                hit = self._all_reduce(x, group, reduce_op, async_op)
            elif op_name == "all_gather":
                hit = self._all_gather(x, group, axis, out, async_op,
                                       wire_format)
            elif op_name == "reduce_scatter":
                hit = self._reduce_scatter(x, group, reduce_op, axis, out,
                                           async_op, wire_format, hierarchy)
        self.counts[f"{op_name}/{hit[1] if hit else 'flat_fallback'}"] += 1
        return hit

    @staticmethod
    def _logical_bytes(op_name, x, group):
        """The JAX facade's message: the global array (the gathered one
        for all-gather and all-reduce)."""
        n = 1 if op_name == "reduce_scatter" else group.size()
        return n * x.numel() * x.element_size()

    def _big_enough(self, op_name, x, group):
        return self._logical_bytes(op_name, x, group) >= getattr(
            self.opts, "min_message_size", 0)

    def _all_reduce(self, x, group, op, async_op):
        if op not in _LINEAR_OPS or not x.is_floating_point():
            return None  # MIN/MAX/PRODUCT: flat, stays correct
        h = self._hierarchy(group)
        if h is None or x.shape[0] % h.inner_size:
            return None
        r = Q._reduce_scatter(x, h.inner, 0)
        if not h.outer.local:
            torch.distributed.all_reduce(r, group=h.outer.pg)
        full = torch.empty_like(x)
        Q._gather_into(full.view((h.inner_size, ) + tuple(r.shape)), r,
                       h.inner)
        if op == ReduceOp.AVG:
            full /= h.size
        x.copy_(full)
        # fp payload; the inter-node hop carries 1/n_inner of it
        wire = x.numel() * x.element_size() // h.inner_size
        return _done(x, async_op), "hier", wire

    def _all_gather(self, x, group, axis, out, async_op, wire_format):
        forced = wire_format is not None
        if not forced and not getattr(self.opts, "quantized_weights",
                                      False):
            return None
        n = group.size()
        if not x.is_floating_point() or n <= 1:
            return None
        fmt = wire_format if forced else self.resolve_wire_dtype(
            self._logical_bytes("all_gather", x, group))
        if fmt == LADDER_FP:
            return None  # the ladder keeps this band flat
        gs = self.group_size
        # what this rank sends, as the logger's message size is its input
        wire = Q.quantized_wire_bytes(x.numel(), fmt, gs)
        if out is not None:
            parts = list(out.view((n, ) + tuple(x.shape)))
            handle = Q.start_quantized_gather(x, parts, group, fmt, gs,
                                              async_op=async_op)
            # the facade's handle: its wait dequantizes
            return (AsyncHandle(handle, out) if async_op else out), \
                f"q_{fmt}", wire
        result = Q.quantized_all_gather(x, group, axis, fmt, gs)
        return _done(result, async_op), f"q_{fmt}", wire

    def _reduce_scatter(self, x, group, op, axis, out, async_op,
                        wire_format, hierarchy):
        forced = wire_format is not None
        if not forced and not getattr(self.opts, "quantized_gradients",
                                      False):
            return None
        n = group.size()
        if op not in _LINEAR_OPS or not x.is_floating_point() or n <= 1 \
                or x.shape[axis] % n:
            return None
        fmt = wire_format if forced else self.resolve_wire_dtype(
            self._logical_bytes("reduce_scatter", x, group))
        if fmt == LADDER_FP:
            return None
        gs = self.group_size
        mean = op == ReduceOp.AVG
        h = hierarchy if hierarchy is not None else self._hierarchy(group)
        if h is not None and h.inner_size > 1 and h.outer_size > 1:
            xi = inner_major(x, axis, h.outer_size, h.inner_size)
            r = Q.hierarchical_quant_reduce_scatter(
                xi, h.inner, h.outer, axis, h.inner_size, h.outer_size,
                wire_format=fmt, group_size=gs, mean=mean)
            variant = f"hier_q_{fmt}"
            # quantized payload crosses the slow hop on 1/n_inner
            wire = Q.quantized_wire_bytes(x.numel() // h.inner_size, fmt,
                                          gs)
        else:
            r = Q.all_to_all_quant_reduce(x, group, axis, n,
                                          wire_format=fmt, group_size=gs,
                                          mean=mean)
            variant = f"q_{fmt}"
            wire = Q.quantized_wire_bytes(x.numel(), fmt, gs)
        if out is not None:
            out.copy_(r.reshape(out.shape))
            r = out
        else:
            r = r.to(x.dtype)
        return _done(r, async_op), variant, wire
