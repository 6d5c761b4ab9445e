"""Back-compat import path (the port of ``deepspeed_tpu/module_inject/
replace_module.py``; reference ``deepspeed/module_inject/
replace_module.py:183``).

The JAX package's ``generic_injection`` (``diffusers_injection.py``)
intercepts Flax CLIP and diffusers attention modules, which have no torch
model in the port: it, ``fused_attention`` and ``make_interceptor`` raise
``not_ported`` (ROADMAP queue A item 9b).
"""

from ..utils.not_ported import not_ported
from .containers import replace_transformer_layer  # noqa: F401


def generic_injection(module=None, dtype=None, enable_cuda_graph=None,
                      policies=None, assume_full_mask=False):
    raise not_ported("generic_injection (diffusers/CLIP attention, "
                     "module_inject/diffusers_injection.py)", "9b")


def fused_attention(policies=None, counter=None, assume_full_mask=False):
    raise not_ported("fused_attention (diffusers/CLIP attention, "
                     "module_inject/diffusers_injection.py)", "9b")


def make_interceptor(policies=None, counter=None, assume_full_mask=False):
    raise not_ported("make_interceptor (diffusers/CLIP attention, "
                     "module_inject/diffusers_injection.py)", "9b")
