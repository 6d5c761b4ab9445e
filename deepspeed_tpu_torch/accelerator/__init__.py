from .abstract_accelerator import DeepSpeedAccelerator
from .real_accelerator import (accelerator_for, full_fp32_matmul,
                               get_accelerator, resolve_device,
                               set_accelerator, set_accelerator_name)

__all__ = ["DeepSpeedAccelerator", "accelerator_for", "full_fp32_matmul",
           "get_accelerator", "resolve_device", "set_accelerator",
           "set_accelerator_name"]
