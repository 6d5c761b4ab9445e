"""Inference constants shared by the serving config and the quantizer (the
port keeps its own copy of what it needs from
``deepspeed_tpu/inference/config.py``)."""

#: the blockwise quantizer's minimum group — one 128-element row, the group
#: size of weight-only quantized serving (``quant_serving``); the JAX package
#: derives it from the TPU lane width, and the port keeps the same value so
#: that both packages group the same elements.
LANE_GROUP = 128
