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
  along the group (JAX's ``ppermute`` of the pipeline), one batched
  exchange of a send and a receive so that neither side can block the
  other.

The rest of the JAX file (psum, pmean, ...) waits for its callers (ROADMAP
queue A items 8 and 9b).
"""

import torch
import torch.distributed as tdist

from . import comm


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
    n = group.size()
    if n == 1:
        return x
    me = group.rank()
    peer = lambda r: comm.get_global_rank(group, r % n)  # noqa: E731
    out = torch.empty_like(x)
    ops = [tdist.P2POp(tdist.isend, x.contiguous(), peer(me + step),
                       group=group.pg),
           tdist.P2POp(tdist.irecv, out, peer(me - step), group=group.pg)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return out


def send_next_recv_prev(x, group):
    """Group rank i sends ``x`` to rank i + 1 and returns what rank i − 1
    sent (a ring: ``ppermute`` with ``(i, (i + 1) % n)``)."""
    return _shift(x, group, 1)


def send_prev_recv_next(x, group):
    """Group rank i sends ``x`` to rank i − 1 and returns what rank i + 1
    sent."""
    return _shift(x, group, -1)
