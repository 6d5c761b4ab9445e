"""The CPU (reference ``accelerator/cpu_accelerator.py:19``): gloo, host
clocks, the process's memory.  The tests' multi-process runs use it."""

import time

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class _HostEvent:
    """``torch.cuda.Event``'s timing surface on the host clock."""

    def __init__(self, enable_timing=True, **kwargs):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class CPU_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"
        self._initial_seed = 0

    # ------------------------------------------------------------------ device
    def is_synchronized_device(self):
        return True

    def device_name(self, device_index=None):
        return "cpu"

    def device(self, device_index=None):
        return torch.device("cpu")

    def set_device(self, device_index):
        pass

    def current_device(self):
        return 0

    def current_device_name(self):
        return "cpu"

    def device_count(self):
        return 1

    def synchronize(self, device_index=None):
        pass

    def Event(self, **kwargs):
        return _HostEvent(**kwargs)

    # --------------------------------------------------------------------- RNG
    def manual_seed(self, seed):
        self._initial_seed = seed
        torch.manual_seed(seed)

    def initial_seed(self):
        return self._initial_seed

    def default_generator(self, device_index=None):
        return torch.default_generator

    # ------------------------------------------------------------------ memory
    def memory_stats(self, device_index=None):
        try:
            import psutil
        except ImportError:
            return {}
        vm = psutil.virtual_memory()
        return {"bytes_in_use": vm.used, "bytes_limit": vm.total}

    def memory_allocated(self, device_index=None):
        return self.memory_stats(device_index).get("bytes_in_use", 0)

    def max_memory_allocated(self, device_index=None):
        return self.memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index=None):
        pass

    def total_memory(self, device_index=None):
        return self.memory_stats(device_index).get("bytes_limit", 0)

    def available_memory(self, device_index=None):
        stats = self.memory_stats(device_index)
        return stats.get("bytes_limit", 0) - stats.get("bytes_in_use", 0)

    def empty_cache(self):
        pass

    # ---------------------------------------------------------------- dtypes
    def is_bf16_supported(self):
        return True

    def is_fp16_supported(self):
        return True

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16]

    def preferred_dtype(self):
        return torch.float32

    # ------------------------------------------------------------------- misc
    def is_available(self):
        return True

    def range_push(self, msg):
        pass

    def range_pop(self):
        pass

    def visible_devices_envs(self):
        return []
