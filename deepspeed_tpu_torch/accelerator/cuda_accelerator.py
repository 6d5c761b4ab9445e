"""The CUDA card (reference ``accelerator/cuda_accelerator.py``): NCCL,
``torch.cuda`` events, RNG and memory statistics."""

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    # ------------------------------------------------------------------ device
    def is_synchronized_device(self):
        return False

    def device_name(self, device_index=None):
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device(self, device_index=None):
        return torch.device("cuda", self.current_device()
                            if device_index is None else device_index)

    def set_device(self, device_index):
        torch.cuda.set_device(device_index)

    def current_device(self):
        return torch.cuda.current_device()

    def current_device_name(self):
        return f"cuda:{self.current_device()}"

    def device_count(self):
        return torch.cuda.device_count()

    def synchronize(self, device_index=None):
        torch.cuda.synchronize(device_index)

    def Event(self, **kwargs):
        return torch.cuda.Event(**kwargs)

    # --------------------------------------------------------------------- RNG
    def manual_seed(self, seed):
        torch.cuda.manual_seed(seed)

    def initial_seed(self):
        return torch.cuda.initial_seed()

    def default_generator(self, device_index=None):
        return torch.cuda.default_generators[
            self.current_device() if device_index is None else device_index]

    # ------------------------------------------------------------------ memory
    def memory_stats(self, device_index=None):
        return torch.cuda.memory_stats(device_index)

    def memory_allocated(self, device_index=None):
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None):
        return torch.cuda.max_memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    def total_memory(self, device_index=None):
        return torch.cuda.get_device_properties(
            self.current_device() if device_index is None
            else device_index).total_memory

    def available_memory(self, device_index=None):
        free, _ = torch.cuda.mem_get_info(device_index)
        return free

    def empty_cache(self):
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- dtypes
    def is_bf16_supported(self):
        return torch.cuda.is_bf16_supported()

    def is_fp16_supported(self):
        return True

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16]

    def preferred_dtype(self):
        return torch.bfloat16

    # ------------------------------------------------------------------- misc
    def is_available(self):
        return torch.cuda.is_available()

    def range_push(self, msg):
        torch.cuda.nvtx.range_push(msg)

    def range_pop(self):
        torch.cuda.nvtx.range_pop()

    def visible_devices_envs(self):
        return ["CUDA_VISIBLE_DEVICES"]
