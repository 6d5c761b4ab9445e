"""Compressed communication (the port of ``deepspeed_tpu/runtime/comm/``;
reference ``deepspeed/runtime/comm/``): the 1-bit error-feedback
all-reduce of the 1-bit optimizers.  The quantized ZeRO++ collectives live
in ``comm/collectives/`` and ``runtime/zero/zeropp.py``."""

from .compressed import (CompressedBackend, compressed_allreduce,
                         compressed_allreduce_many, error_shapes, pack_signs,
                         unpack_signs)
