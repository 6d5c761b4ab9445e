"""MiCS, Minimal-Communication Sharding (the port of
``deepspeed_tpu/runtime/zero/mics.py``; reference
``runtime/zero/mics.py``): parameters, gradients and optimizer state
sharded over a *shard group* of ``mics_shard_size`` ranks and replicated
across the groups.  The gathers stay within the group; each gradient
reduce-scatter over the group is followed by an all-reduce across the
groups (``runtime/zero/zeropp.py:ZeroComm``).

Config: ``{"zero_optimization": {"stage": 3, "mics_shard_size": N}}``.
``mics_hierarchical_params_gather`` parses and is implied.  The engine
builds the plan itself; :func:`mics_plan` and :class:`MiCS_Init` are for
import parity with the JAX package.
"""

from .partition import ZeroPartitionPlan


def mics_plan(shard_size, rank_in_group, numel, stage=3, **kw):
    """The MiCS plan: the state of ``numel`` elements sharded over a shard
    group of ``shard_size`` ranks (this one at ``rank_in_group``)."""
    return ZeroPartitionPlan(stage, shard_size, rank_in_group, numel,
                             mics=True, **kw)


class MiCS_Init:
    """Import parity with ``deepspeed.zero.MiCS_Init``: a no-op context
    (the engine creates partitioned state in ``initialize_parameters``)."""

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
