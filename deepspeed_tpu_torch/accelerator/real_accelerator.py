"""Device selection for the port's entry points, and the accelerator
singleton (reference ``accelerator/real_accelerator.py:51``).

The CUDA card is the default.  The CPU runs only when a caller names it
(``device="cpu"``); asking for CUDA on a machine without a card raises
instead of falling back.  :func:`resolve_device` never reads
``DS_ACCELERATOR``: that variable picks the singleton of
:func:`get_accelerator` (the comm backend's name, events, memory
statistics), not where an entry point runs.
"""

import contextlib
import os

import torch

_ACCELERATOR_NAMES = ("cuda", "cpu")
_accelerator = None


def get_accelerator():
    """The accelerator singleton: ``DS_ACCELERATOR`` ("cuda" or "cpu") when
    set, else the card when torch sees one, else the CPU."""
    if _accelerator is None:
        name = os.environ.get("DS_ACCELERATOR")
        if name is None:
            name = "cuda" if torch.cuda.is_available() else "cpu"
        set_accelerator_name(name)
    return _accelerator


def set_accelerator_name(name):
    """Install the singleton by name."""
    global _accelerator
    if name not in _ACCELERATOR_NAMES:
        raise ValueError(f"DS_ACCELERATOR must be one of "
                         f"{_ACCELERATOR_NAMES}, got {name!r}")
    if name == "cuda":
        from .cuda_accelerator import CUDA_Accelerator
        _accelerator = CUDA_Accelerator()
    else:
        from .cpu_accelerator import CPU_Accelerator
        _accelerator = CPU_Accelerator()
    return _accelerator


def set_accelerator(accel):
    global _accelerator
    _accelerator = accel
    return _accelerator


def accelerator_for(device):
    """The accelerator of a ``torch.device`` (an engine's own device, which
    may differ from the singleton's when the CPU was asked for by name)."""
    if torch.device(device).type == "cuda":
        from .cuda_accelerator import CUDA_Accelerator
        return CUDA_Accelerator()
    from .cpu_accelerator import CPU_Accelerator
    return CPU_Accelerator()


def resolve_device(device=None):
    """The device an entry point runs on.  ``None`` means the CUDA card and
    raises when there is none; the CPU runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but torch sees "
                               "no CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 products inside the block run in full fp32 on the card, as the
    JAX package's fp32 products do: TF32 is off for the block only and the
    caller's setting comes back after it."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
