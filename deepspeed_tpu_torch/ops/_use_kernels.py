"""The one kernel gate of the attention dispatch sites (the port of
``deepspeed_tpu/ops/_use_kernels.py``).

``DS_TPU_DISABLE_PALLAS_ATTN`` (any non-empty value) is the user's switch
that turns the attention kernels off, as it is in the JAX package: the
training attention takes its XLA-style path, the Evoformer op its chunked
path and ``SparseSelfAttention`` its gather formulation, on any device.
``DS_TPU_DISABLE_PALLAS_PAGED`` (any non-empty value) turns the paged
attention kernel off in the serving path's ragged step, as it does in the
JAX package (``inference/v2/ragged_forward.py:64-67``): every row then
gathers its own block run (``paged_attention_plain``).

Both are switches, not fallbacks: a kernel that fails to build or launch
still raises.
"""

import os


def kernels_disabled():
    """True when ``DS_TPU_DISABLE_PALLAS_ATTN`` is set."""
    return bool(os.environ.get("DS_TPU_DISABLE_PALLAS_ATTN"))


def paged_kernels_disabled():
    """True when ``DS_TPU_DISABLE_PALLAS_PAGED`` is set: the ragged step's
    paged attention takes the gather path."""
    return bool(os.environ.get("DS_TPU_DISABLE_PALLAS_PAGED"))


def use_kernels(t):
    """True for a CUDA tensor unless the switch is set."""
    return t.device.type == "cuda" and not kernels_disabled()
