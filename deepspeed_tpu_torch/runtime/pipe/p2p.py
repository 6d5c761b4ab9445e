"""Point-to-point between pipeline stages (the port of
``deepspeed_tpu/runtime/pipe/p2p.py``; reference ``runtime/pipe/p2p.py``).

The JAX package moves activations with ``ppermute`` inside its fused
program and keeps only the host object channel here.  The port runs one
process a stage, so this is where tensors cross: :func:`exchange` posts a
tick's sends and receives to the neighbouring stages as ONE batched call
(``torch.distributed.batch_isend_irecv``) over the pipe group, so that two
stages that each send and receive in the same tick cannot deadlock on
NCCL.  ``send_obj``/``recv_obj`` are the comm layer's store channel.
"""

import torch
import torch.distributed as tdist

from ... import comm as dist
from ...utils import groups


def init_process_groups(grid=None, device=None):
    """The pipe groups are made at mesh init (``utils/groups.py``); this
    brings the world up and runs the first collective on this rank's pipe
    group, an all-reduce of one element on ``device`` (default: the card
    under NCCL): NCCL lets a batch of point-to-point calls involve only
    some of a group's ranks once a collective has run over the whole
    group."""
    dist.init_distributed()
    group = groups._get_pipe_parallel_group()
    if group.size() > 1:
        if device is None:
            device = ("cuda" if tdist.get_backend(group.pg) == "nccl"
                      else "cpu")
        dist.all_reduce(torch.zeros(1, device=device), group=group.as_flat())
    return group


def can_send_recv():
    return dist.get_world_size() > 1


def send_obj(msg, dest, tag=0):
    """Reference ``p2p.py`` ``send_obj``: a picklable object to world rank
    ``dest``."""
    dist.send_obj(msg, dest, tag=tag)


def recv_obj(sender, tag=0, timeout_s=300):
    """Reference ``p2p.py`` ``recv_obj``: blocking object receive."""
    return dist.recv_obj(sender, tag=tag, timeout_s=timeout_s)


def send(tensor, dest_stage, tag=0):
    """``tensor`` to this rank's peer on stage ``dest_stage``."""
    exchange([(tensor, dest_stage)], [])


def recv(tensor, src_stage, tag=0):
    """Into ``tensor`` from this rank's peer on stage ``src_stage``."""
    exchange([], [(tensor, src_stage)])
    return tensor


def exchange(sends, recvs, group=None):
    """One tick's point-to-point: ``sends`` and ``recvs`` are (tensor,
    stage) pairs with this rank's peers on other stages of ``group`` (the
    pipe group).  All are posted as one batch and waited for; returns when
    every receive has landed (on the card: the current stream waits)."""
    if not sends and not recvs:
        return
    group = group or groups._get_pipe_parallel_group()
    peer = lambda s: dist.get_global_rank(group, s)  # noqa: E731
    ops = [tdist.P2POp(tdist.isend, t, peer(s), group=group.pg)
           for t, s in sends]
    ops += [tdist.P2POp(tdist.irecv, t, peer(s), group=group.pg)
            for t, s in recvs]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
