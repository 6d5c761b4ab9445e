"""Back-compat import path (the port of ``deepspeed_tpu/module_inject/
replace_module.py``; reference ``deepspeed/module_inject/
replace_module.py:183``): the injection entry points live in
``containers.py`` and ``diffusers_injection.py``."""

from .containers import replace_transformer_layer  # noqa: F401
from .diffusers_injection import (fused_attention,  # noqa: F401
                                  generic_injection, make_interceptor)
