"""Accelerator abstraction (the port of
``deepspeed_tpu/accelerator/abstract_accelerator.py``; reference
``accelerator/abstract_accelerator.py:10``, ``DeepSpeedAccelerator``).

Layers that need hardware services take them from
:func:`deepspeed_tpu_torch.accelerator.get_accelerator`: device handles,
synchronisation and events, RNG, memory statistics, dtype support and the
name of the communication backend.  Two implementations: the CUDA card
(``cuda_accelerator.py``, NCCL) and the CPU (``cpu_accelerator.py``, gloo).

The entry points' ``device=None`` does not go through this singleton: it
means the card and raises without one, whatever ``DS_ACCELERATOR`` says
(``real_accelerator.resolve_device``).
"""

import abc
from abc import ABC


class DeepSpeedAccelerator(ABC):
    """Surface mirroring the JAX package's ``DeepSpeedAccelerator``."""

    def __init__(self):
        self._name = None
        self._communication_backend_name = None
        self._compile_backend = None

    # ------------------------------------------------------------------ device
    @abc.abstractmethod
    def is_synchronized_device(self):
        ...

    @abc.abstractmethod
    def device_name(self, device_index=None):
        ...

    @abc.abstractmethod
    def device(self, device_index=None):
        ...

    @abc.abstractmethod
    def set_device(self, device_index):
        ...

    @abc.abstractmethod
    def current_device(self):
        ...

    @abc.abstractmethod
    def current_device_name(self):
        ...

    @abc.abstractmethod
    def device_count(self):
        ...

    @abc.abstractmethod
    def synchronize(self, device_index=None):
        ...

    @abc.abstractmethod
    def Event(self, **kwargs):
        """A timing event (``torch.cuda.Event`` on the card)."""
        ...

    # --------------------------------------------------------------------- RNG
    @abc.abstractmethod
    def manual_seed(self, seed):
        ...

    @abc.abstractmethod
    def initial_seed(self):
        ...

    @abc.abstractmethod
    def default_generator(self, device_index=None):
        ...

    # ------------------------------------------------------------------ memory
    @abc.abstractmethod
    def memory_stats(self, device_index=None):
        ...

    @abc.abstractmethod
    def memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index=None):
        ...

    @abc.abstractmethod
    def total_memory(self, device_index=None):
        ...

    @abc.abstractmethod
    def available_memory(self, device_index=None):
        ...

    @abc.abstractmethod
    def empty_cache(self):
        ...

    # ---------------------------------------------------------------- dtypes
    @abc.abstractmethod
    def is_bf16_supported(self):
        ...

    @abc.abstractmethod
    def is_fp16_supported(self):
        ...

    @abc.abstractmethod
    def supported_dtypes(self):
        ...

    @abc.abstractmethod
    def preferred_dtype(self):
        ...

    # ------------------------------------------------------------------- comm
    def communication_backend_name(self):
        return self._communication_backend_name

    # ------------------------------------------------------------------- misc
    @abc.abstractmethod
    def is_available(self):
        ...

    @abc.abstractmethod
    def range_push(self, msg):
        ...

    @abc.abstractmethod
    def range_pop(self):
        ...

    @abc.abstractmethod
    def visible_devices_envs(self):
        ...

    def set_visible_devices_envs(self, current_env, local_accelerator_ids):
        """Reference ``abstract_accelerator.py:297``: the launcher pins each
        spawned process to its devices."""
        for env in self.visible_devices_envs():
            current_env[env] = ",".join(map(str, local_accelerator_ids))
