"""Import path of the blockwise int8/int4 quantizer (reference
``deepspeed/ops/quantizer``; the port of ``deepspeed_tpu/ops/quantizer.py``):
the implementation is ``ops/kernels/quantizer.py`` (CUDA kernels + plain
versions)."""

from .kernels.quantizer import (dequantize_blockwise,  # noqa: F401
                                quantize_blockwise)
