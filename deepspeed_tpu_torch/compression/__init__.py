"""Compression (reference ``deepspeed/compression/``; the port of
``deepspeed_tpu/compression/``).  Only the fake-quantizer that
``linear.OptimizedLinear`` calls is ported so far; the rest of the
subsystem is ROADMAP.md queue A item 11."""

from .quantizers import fake_quantize
