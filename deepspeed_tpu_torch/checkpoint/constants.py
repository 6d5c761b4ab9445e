"""Universal-checkpoint key names (the port of
``deepspeed_tpu/checkpoint/constants.py``; reference
``deepspeed/checkpoint/constants.py``).

The per-parameter state files keep the reference's key vocabulary (``fp32``,
``exp_avg``, ``exp_avg_sq``, ``step``) so tooling written against DeepSpeed's
universal layout maps 1:1.
"""

FP32 = "fp32"
EXP_AVG = "exp_avg"
EXP_AVG_SQ = "exp_avg_sq"
STEP = "step"

# dir layout
ZERO_FILE_PREFIX = "zero"
UNIVERSAL_META = "universal_meta.json"
DS_VERSION = "ds_version"

# the JAX package's optimizer-state field names → the universal (torch-style)
# names (ds_to_universal.py:232 merges "exp_avg"/"exp_avg_sq" slices); the
# port's states already use the torch names
STATE_FIELD_TO_UNIVERSAL = {
    "mu": EXP_AVG,
    "nu": EXP_AVG_SQ,
    "m": EXP_AVG,
    "v": EXP_AVG_SQ,
    "momentum": EXP_AVG,
    "exp_avg": EXP_AVG,
    "exp_avg_sq": EXP_AVG_SQ,
    "sum": EXP_AVG_SQ,   # adagrad squared-grad accumulator (torch key "sum")
}

# the fields a port tag and a universal directory carry, in file order
STATE_FIELDS = (FP32, EXP_AVG, EXP_AVG_SQ)
