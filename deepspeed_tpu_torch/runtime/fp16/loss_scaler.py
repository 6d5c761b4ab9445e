"""Back-compat import path (the port of ``deepspeed_tpu/runtime/fp16/
loss_scaler.py``; reference ``deepspeed/runtime/fp16/loss_scaler.py:270``):
the implementation lives in ``runtime/loss_scaler.py``."""

from ..loss_scaler import (DynamicLossScaler, LossScaleState,  # noqa: F401
                           StaticLossScaler, create_loss_scaler, has_overflow)

# reference class name for the static variant
LossScaler = StaticLossScaler
