"""LoRA / quantization configs (reference ``deepspeed/linear/config.py``;
the port of ``deepspeed_tpu/linear/config.py``: same fields and
defaults)."""

from dataclasses import dataclass, field
from typing import List


@dataclass
class LoRAConfig:
    """Reference ``linear/config.py:11``."""
    lora_r: int = 64
    lora_alpha: float = 16.0
    base_weight_sharding: int = 1
    offload: bool = False
    offload_ratio: float = 0.0
    delay_lora_init: bool = False
    target_mods: List[str] = field(default_factory=lambda: [
        'q_proj', 'k_proj', 'v_proj', 'o_proj', 'gate_proj', 'up_proj',
        'down_proj'
    ])


@dataclass
class QuantizationConfig:
    """Reference ``linear/config.py:37`` (+ ``q_dtype`` selecting the int
    blockwise kernels vs the FP6-LLM-style float formats)."""
    q_bits: int = 8
    mantissa_bits: int = 3
    group_size: int = 512
    q_dtype: str = "int"  # "int" (blockwise int8/4) | "fp" (e4m3/e3m2/e4m7)
