"""ZeRO partitioning of the engine's flat buffers (the port of
``deepspeed_tpu/runtime/zero/partition.py``).

The JAX file is a sharding policy: each leaf is split along its largest
divisible axis and GSPMD emits the collectives (``partition.py:52-103``).
The port's engine already lays every leaf out in ONE flat buffer
(``runtime/engine.py:flat_layout``), so its plan is a plan of flat ranges,
as the reference's ``stage_1_and_2.py`` partitions its flat groups:

* the buffer is padded to a multiple of ``world_size × ALIGN`` elements, so
  every rank's shard has the same length and starts 16-byte aligned (the
  optimizer kernels refuse unaligned pointers);
* rank r owns ``[r·S, (r+1)·S)``; a leaf may straddle two shards;
* stage 1 shards the fp32 master and the optimizer's moments; stage 2 also
  the gradient accumulator; the compute-dtype parameters stay whole on
  every rank (stage 3, which shards them, is ROADMAP queue A item 6).

The padding is zero in the parameters, the gradients and the moments, so
neither the norm nor the update sees anything but zeros there.
"""

ALIGN = 16   # elements (engine.py's _ALIGN): 64 bytes of fp32


class ZeroPartitionPlan:

    def __init__(self, stage, world_size, rank, numel, zero_config=None):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.stage = stage
        self.world_size = world_size
        self.rank = rank
        self.numel = int(numel)
        quantum = world_size * ALIGN
        self.padded_numel = -(-self.numel // quantum) * quantum
        self.zero_config = zero_config

    @property
    def sharded(self):
        """Whether the master and the moments are this rank's shard."""
        return self.stage >= 1

    @property
    def shard_numel(self):
        return (self.padded_numel // self.world_size if self.sharded
                else self.padded_numel)

    def shard_range(self, rank=None):
        """[lo, hi) of ``rank``'s (default: this rank's) shard in the flat
        buffer; the whole buffer at stage 0."""
        if not self.sharded:
            return 0, self.padded_numel
        r = self.rank if rank is None else rank
        return r * self.shard_numel, (r + 1) * self.shard_numel

    def leaf_pieces(self, layout):
        """The shard's part of each leaf: [(leaf offset in the shard, its
        numel, offset within the leaf)] for every leaf the shard touches."""
        lo, hi = self.shard_range()
        pieces = []
        for _, off, n, _ in layout:
            a, b = max(off, lo), min(off + n, hi)
            if a < b:
                pieces.append((a - lo, b - a, a - off))
        return pieces

    def describe(self, param_bytes=2, state_buffers=2, grad_bytes=4,
                 master=True):
        """The plan as data (the JAX plan's ``describe`` keys that mean
        something here, and the bytes a rank holds).  ``param_bytes``: an
        element of the compute-dtype parameters; ``state_buffers``: fp32
        buffers of the optimizer (Adam 2); ``grad_bytes``: an element of the
        gradient accumulator; ``master``: whether an fp32 master exists."""
        full, shard = self.padded_numel, self.shard_numel
        sharded = shard * 4 * (state_buffers + (1 if master else 0))
        replicated = full * param_bytes
        if self.stage >= 2:
            sharded += shard * grad_bytes
        else:
            replicated += full * grad_bytes
        out = {"stage": self.stage, "world_size": self.world_size,
               "zero_axes": ["dp", "ep"], "numel": self.numel,
               "padded_numel": full, "shard_numel": shard,
               "shard_range": list(self.shard_range()),
               "sharded_bytes": int(sharded),
               "replicated_bytes": int(replicated),
               "offload_optimizer": False, "offload_param": False,
               "overlap_enabled": False, "prefetch_enabled": False}
        ignored = ({} if self.zero_config is None
                   else self.zero_config.ignored())
        out["ignored"] = ignored
        if ignored:
            out["ignored_because"] = ("the port reduces and gathers the "
                                      "whole flat buffer in one collective "
                                      "each")
        return out
