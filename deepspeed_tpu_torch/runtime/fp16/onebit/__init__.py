"""The 1-bit optimizers (the port of ``deepspeed_tpu/runtime/fp16/onebit/``;
reference ``runtime/fp16/onebit/``): OnebitAdam, OnebitLamb and
ZeroOneAdam, whose momentum is averaged over the ranks with the 1-bit
error-feedback all-reduce (``runtime/comm/compressed.py``) after a
full-precision warmup."""

from .adam import OnebitAdam
from .lamb import OnebitLamb
from .zoadam import ZeroOneAdam
