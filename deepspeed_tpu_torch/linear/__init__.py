"""deepspeed_tpu_torch.linear (reference ``deepspeed/linear/``; the port of
``deepspeed_tpu/linear/``): OptimizedLinear (frozen, optionally quantized
base + LoRA adapters), LoRAConfig, QuantizationConfig, and quantized
parameter trees (FP6/FP12 through kernel B6, int8/int4 through B5)."""

from .config import LoRAConfig, QuantizationConfig
from .optimized_linear import (OptimizedLinear, init_lora, merge_lora,
                               unmerge_lora)
from .quantization import QuantizedParameter, quantize_param_tree
