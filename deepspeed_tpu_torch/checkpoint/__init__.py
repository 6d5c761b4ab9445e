"""Universal checkpointing and checkpoint tools (the port of
``deepspeed_tpu/checkpoint/``; reference ``deepspeed/checkpoint/``).

The engine writes upstream DeepSpeed's per-rank ZeRO files
(``runtime/checkpoint_engine.py``).  :func:`convert_to_universal` merges a
tag into per-parameter fp32 and moment files in the JAX package's names and
shapes, :func:`load_universal_checkpoint` repartitions such a directory (the
JAX package's own included) under any stage and world size, and
:mod:`zero_to_fp32` recovers the fp32 weights standalone.
"""

from .constants import (EXP_AVG, EXP_AVG_SQ, FP32, STEP, UNIVERSAL_META,
                        ZERO_FILE_PREFIX)
from .deepspeed_checkpoint import DeepSpeedCheckpoint
from .ds_to_universal import convert_to_universal
from .universal_checkpoint import load_universal_checkpoint
from .zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,
                           get_fp32_state_dict_from_zero_checkpoint)
