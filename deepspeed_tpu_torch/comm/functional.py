"""Collectives on tensors over a process group, for the callers that run
inside a model's forward and backward (the port of
``deepspeed_tpu/comm/functional.py``).

The JAX file wraps ``jax.lax`` collectives over a mesh axis name for use
inside ``shard_map``, where autodiff transposes them.  Here a group is a
``ProcessGroup`` and autograd needs to be told:

* :func:`all_to_all`: the Ulysses reshard (``sequence/layer.py``); its
  backward is the inverse all-to-all (split along the gathered dim,
  concatenated along the scattered one);
* :func:`send_next_recv_prev` / :func:`send_prev_recv_next`: a ring shift
  along the group (JAX's ``ppermute`` of the pipeline and of ring
  attention), one batched exchange of the sends and receives so that
  neither side can block the other;
* :func:`psum`, :func:`pmean`, :func:`pmax`, :func:`pmin`,
  :func:`all_gather` and :func:`reduce_scatter`: JAX's ``lax`` collectives
  with the gradients JAX's transposes give them (a psum's cotangent is
  itself psummed, an all-gather's is the rank's block of the cotangent's
  reduce-scatter, ...); pmax and pmin pass the summed cotangent to the
  ranks that held the extreme value;
* Megatron's pair for tensor parallelism (``module_inject/layers.py``):
  :func:`copy_to_tp_region` (identity forward, psum backward) before a
  column-parallel product, :func:`reduce_from_tp_region` (psum forward,
  identity backward) after a row-parallel one, and
  :func:`gather_from_tp_region` (all-gather of the last dim forward, the
  rank's block backward) for vocabulary-sharded logits.  Under GSPMD the
  JAX package gets these from the sharding propagation; here every rank of
  the tp group runs the same program on the same replicated activations,
  so each replicated cotangent is the same on every rank.
  :func:`reduce_from_tp_region_async` starts the same psum async, and
  :func:`wait_tp_region` waits for it where its sum is used (Domino's
  µ-streams); each marks its start and its wait with a profiler range
  (:data:`ASYNC_START`, :data:`ASYNC_WAIT`), which
  ``runtime/domino/overlap.py`` reads.

Every op takes a ``ProcessGroup`` and runs on its flat form (never through
the collectives engine's quantized wires); a group of one rank, or None,
returns its input.
"""

import torch
import torch.distributed as tdist

from . import comm

ASYNC_START = "ds_tp::async_reduce_start"
ASYNC_WAIT = "ds_tp::async_reduce_wait"


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, scatter_idx, gather_idx):
        ctx.group, ctx.idx = group, (scatter_idx, gather_idx)
        return comm.all_to_all_single(x, group=group, split_axis=scatter_idx,
                                      concat_axis=gather_idx)

    @staticmethod
    def backward(ctx, grad):
        scatter_idx, gather_idx = ctx.idx
        return (comm.all_to_all_single(grad.contiguous(), group=ctx.group,
                                       split_axis=gather_idx,
                                       concat_axis=scatter_idx),
                None, None, None)


def all_to_all(x, group, scatter_idx, gather_idx):
    """``x`` split along ``scatter_idx`` into the group's size of chunks,
    chunk j sent to group rank j, the received chunks concatenated along
    ``gather_idx`` in rank order (JAX's tiled ``all_to_all``); differentiable.
    A group of one rank returns ``x``."""
    if group is None or group.size() == 1:
        return x
    return _AllToAll.apply(x, group, scatter_idx, gather_idx)


def _shift(x, group, step):
    many = isinstance(x, (list, tuple))
    xs = list(x) if many else [x]
    n = group.size()
    if n == 1:
        return xs if many else x
    me = group.rank()
    peer = lambda r: comm.get_global_rank(group, r % n)  # noqa: E731
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in xs]
    ops = []
    for t, out in zip(xs, outs):
        ops += [tdist.P2POp(tdist.isend, t.contiguous(), peer(me + step),
                            group=group.pg),
                tdist.P2POp(tdist.irecv, out, peer(me - step),
                            group=group.pg)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return outs if many else outs[0]


def send_next_recv_prev(x, group):
    """Group rank i sends ``x`` to rank i + 1 and returns what rank i − 1
    sent (a ring: ``ppermute`` with ``(i, (i + 1) % n)``).  ``x`` may be a
    list of tensors: all of them go in one batched exchange, and the list
    of what arrived comes back."""
    return _shift(x, group, 1)


def send_prev_recv_next(x, group):
    """Group rank i sends ``x`` to rank i − 1 and returns what rank i + 1
    sent."""
    return _shift(x, group, -1)


def _one(group):
    return group is None or group.size() == 1


def _reduce(x, group, op):
    return comm.all_reduce(x.contiguous().clone(), op=op,
                           group=group.as_flat())


class _Psum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group, comm.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group, comm.ReduceOp.SUM), None


class _Extreme(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group = group
        out = _reduce(x, group, op)
        ctx.save_for_backward((x == out).to(x.dtype))
        return out

    @staticmethod
    def backward(ctx, grad):
        # every rank's cotangent, to the ranks that held the extreme
        mask, = ctx.saved_tensors
        return (_reduce(grad, ctx.group, comm.ReduceOp.SUM) * mask, None,
                None)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return comm.all_gather(x.contiguous(), group=group.as_flat(),
                               axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return (comm.reduce_scatter(grad.contiguous(),
                                    group=ctx.group.as_flat(),
                                    axis=ctx.axis), None, None)


class _ReduceScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return comm.reduce_scatter(x.contiguous(), group=group.as_flat(),
                                   axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return (comm.all_gather(grad.contiguous(), group=ctx.group.as_flat(),
                                axis=ctx.axis), None, None)


def psum(x, group):
    """The sum over the group's ranks (``lax.psum``); differentiable."""
    return x if _one(group) else _Psum.apply(x, group)


def pmean(x, group):
    """The mean over the group's ranks (``lax.pmean``)."""
    return x if _one(group) else psum(x, group) / group.size()


def pmax(x, group):
    """The elementwise maximum over the group's ranks (``lax.pmax``)."""
    return x if _one(group) else _Extreme.apply(x, group, comm.ReduceOp.MAX)


def pmin(x, group):
    """The elementwise minimum over the group's ranks (``lax.pmin``)."""
    return x if _one(group) else _Extreme.apply(x, group, comm.ReduceOp.MIN)


def all_gather(x, group, axis=0):
    """The ranks' blocks concatenated along ``axis`` (``lax.all_gather``,
    tiled); its gradient is the rank's block of the summed cotangent."""
    if _one(group):
        return x
    return _AllGather.apply(x, group, axis % x.dim())


def reduce_scatter(x, group, axis=0):
    """Block r along ``axis`` of the sum over the ranks
    (``lax.psum_scatter``, tiled); its gradient is the all-gathered
    cotangent."""
    if _one(group):
        return x
    return _ReduceScatter.apply(x, group, axis % x.dim())


class _CopyToRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group, comm.ReduceOp.SUM), None


class _ReduceFromRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group, comm.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_gather(x.contiguous(), group=group.as_flat(),
                               axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        n, r = ctx.group.size(), ctx.group.rank()
        k = grad.shape[-1] // n
        return grad[..., r * k:(r + 1) * k].contiguous(), None


class _AsyncReduceFromRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, box):
        y = x.contiguous().clone()
        with torch.profiler.record_function(ASYNC_START):
            box.append(comm.all_reduce(y, group=group.as_flat(),
                                       async_op=True))
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_tp_region(x, group):
    """Identity forward; the cotangent summed over the tp group backward
    (the input of a column-parallel product: each rank's product sees only
    its own columns, so each holds a part of the input's gradient)."""
    return x if _one(group) else _CopyToRegion.apply(x, group)


def reduce_from_tp_region(x, group):
    """Sum over the tp group forward (a row-parallel product's partial
    sums); the cotangent as it is backward."""
    return x if _one(group) else _ReduceFromRegion.apply(x, group)


def reduce_from_tp_region_async(x, group):
    """:func:`reduce_from_tp_region` started async (Domino's µ-streams,
    ``runtime/domino/``): ``(y, handle)``, where ``y`` holds the sum only
    after :func:`wait_tp_region`; the current stream may run other work
    meanwhile.  A group of one rank: ``(x, None)``."""
    if _one(group):
        return x, None
    box = []
    y = _AsyncReduceFromRegion.apply(x, group, box)
    return y, box[0]


def wait_tp_region(y, handle):
    """``y`` of :func:`reduce_from_tp_region_async`, once its reduce has
    landed (the current stream waits for it)."""
    if handle is not None:
        with torch.profiler.record_function(ASYNC_WAIT):
            handle.wait()
    return y


def gather_from_tp_region(x, group):
    """The tp group's blocks of the last dim, concatenated in rank order
    (vocabulary-sharded logits); backward, the rank's block of the
    cotangent, which every rank computes alike from the same gathered
    value."""
    return x if _one(group) else _GatherFromRegion.apply(x, group)
