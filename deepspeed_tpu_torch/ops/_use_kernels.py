"""The one kernel gate of the attention dispatch sites (the port of
``deepspeed_tpu/ops/_use_kernels.py``).

``DS_TPU_DISABLE_PALLAS_ATTN`` (any non-empty value) is the user's switch
that turns the attention kernels off, as it is in the JAX package: the
training attention takes its XLA-style path, the Evoformer op its chunked
path and ``SparseSelfAttention`` its gather formulation, on any device.
It is a switch, not a fallback: a kernel that fails to build or launch
still raises.
"""

import os


def kernels_disabled():
    """True when ``DS_TPU_DISABLE_PALLAS_ATTN`` is set."""
    return bool(os.environ.get("DS_TPU_DISABLE_PALLAS_ATTN"))


def use_kernels(t):
    """True for a CUDA tensor unless the switch is set."""
    return t.device.type == "cuda" and not kernels_disabled()
