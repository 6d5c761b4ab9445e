from .real_accelerator import full_fp32_matmul, resolve_device

__all__ = ["full_fp32_matmul", "resolve_device"]
