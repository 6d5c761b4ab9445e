"""Domino: tensor-parallel communication hidden under compute (the port of
``deepspeed_tpu/runtime/domino/``; reference ``runtime/domino/
transformer.py:518`` ``DominoTransformerLayer``).

The JAX package splits each batch into independent µ-streams and leaves
the interleaving to XLA's latency-hiding scheduler, then reads the
optimized HLO to see whether the tp all-reduces have compute inside their
start→done windows.  Eager PyTorch has no scheduler: the port does what
the reference does by hand.  A Llama-family block over µ-streams
(:func:`~.transformer.domino_layer`) starts each stream's row-parallel
reduce async (``comm/functional.py:reduce_from_tp_region_async``, NCCL's
own stream on the card) and runs the next stream's products while it is
in flight, waiting for it only where its sum is used.
:func:`~.overlap.measure_tp_overlap` reads the same evidence from a
``torch.profiler`` trace of one call.
"""

from .overlap import DominoTransformerLayer, measure_tp_overlap
from .transformer import (domino_ab, domino_layer, split_block_microstreams,
                          split_microstreams)
