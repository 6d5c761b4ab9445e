"""Reduce ops (the port of ``deepspeed_tpu/comm/reduce_op.py``; reference
``deepspeed/comm/reduce_op.py``), each mapped onto
``torch.distributed.ReduceOp`` by :func:`torch_op`."""

from enum import Enum


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BAND = 4
    BOR = 5
    BXOR = 6
    AVG = 7
    UNUSED = 8


def torch_op(op):
    """The ``torch.distributed.ReduceOp`` of ``op`` (this enum or torch's
    own)."""
    import torch.distributed as dist
    if not isinstance(op, ReduceOp):
        return op
    if op is ReduceOp.UNUSED:
        raise ValueError("ReduceOp.UNUSED is not an operation")
    return getattr(dist.ReduceOp, op.name)
