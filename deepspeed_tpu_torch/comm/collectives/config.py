"""The ``comm_optimizations`` block as plain dataclasses (the port of
``deepspeed_tpu/comm/collectives/config.py``): the same fields and
defaults as the config system's parse (``runtime/config.py``), for
consumers that take no config, such as tests and tools.  The engine is
duck-typed: either object works."""

from dataclasses import dataclass, field

from .quantized import DEFAULT_GROUP_SIZE


@dataclass
class Prefetch:
    """Stage 3's forward gather prefetch (``runtime/zero/overlap.py``);
    its own enable gate, apart from ``Overlap.enabled``."""
    enabled: bool = False
    # bucket bound in MiB; 0: the 32 MiB overlap default
    bucket_mb: float = 0.0
    # buckets with their all-gather outstanding (clamped by
    # stage3_max_live_parameters)
    max_inflight: int = 2


@dataclass
class Overlap:
    """The bucketed gradient reduce of the backward pass."""
    enabled: bool = False
    # bucket bound in MiB of gradient payload (fractional ok)
    bucket_mb: float = 32.0
    # reduce-scatters outstanding at once
    max_inflight: int = 2
    prefetch: Prefetch = field(default_factory=Prefetch)


@dataclass
class CommOptimizations:
    enabled: bool = False
    # intra-node reduce-scatter → inter-node op on 1/N → intra-node
    # all-gather, and the 2-hop quantized reduce-scatter, where the group
    # has a hierarchy (intra_node_size, DS_TPU_INTRA_NODE_SIZE, the nodes)
    hierarchical_allreduce: bool = True
    # quantize all-gather payloads (qwZ)
    quantized_weights: bool = False
    # quantize reduce-scatter payloads (qgZ)
    quantized_gradients: bool = False
    # int8 | int4 | fp8 | fp6 | fp12
    wire_dtype: str = "int8"
    # [[max_bytes, wire], ...] ascending ([null, wire] the catch-all,
    # "fp32" a band kept flat); None: wire_dtype for every size
    wire_dtype_by_size: list = None
    # elements a scale group (lane-aligned down, ≥ 128)
    quantization_group_size: int = DEFAULT_GROUP_SIZE
    # ranks a node for the hierarchy; 0: DS_TPU_INTRA_NODE_SIZE or the
    # node probe
    intra_node_size: int = 0
    # messages under this many bytes take the flat path
    min_message_size: int = 0
    # "gspmd" | "flat_manual": the JAX package's two qgZ micro-steps; the
    # port runs one path for both and records which was asked for
    zero_mode: str = "gspmd"
    overlap: Overlap = field(default_factory=Overlap)
