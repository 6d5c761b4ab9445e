"""fp16 runtime (the port of ``deepspeed_tpu/runtime/fp16/``; reference
``deepspeed/runtime/fp16/``): loss scaling lives in
``runtime/loss_scaler.py``, and the engine's boundary step does what the
reference's FP16_Optimizer does.  ``onebit/`` holds the 1-bit
communication-compressed optimizers."""
