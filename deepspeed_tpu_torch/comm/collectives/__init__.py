"""The topology-aware quantized collectives engine (the port of
``deepspeed_tpu/comm/collectives``):

* :mod:`.topology`: a group's (inter-node, intra-node) subgroups;
* :mod:`.quantized`: the quantized and hierarchical primitives, shared
  with ZeRO++ (``runtime/zero/zeropp.py``);
* :mod:`.engine`: per-op variant selection behind the ``dist.*`` facade;
* :mod:`.config`: the ``comm_optimizations`` options as dataclasses.
"""

from .config import CommOptimizations, Overlap, Prefetch
from .engine import (LADDER_FP, CollectivesEngine, build_wire_ladder,
                     inner_major, resolve_in_ladder)
from .quantized import (DEFAULT_GROUP_SIZE, PAYLOAD_BYTES, WIRE_FORMATS,
                        all_to_all_quant_reduce, effective_group_size,
                        hierarchical_quant_reduce_scatter,
                        qdq_all_gather_st, quantized_all_gather,
                        quantized_all_to_all, quantized_wire_bytes,
                        rowwise_codec, wire_codec)
from .topology import Hierarchy, detect_intra_node_size, factor_group
