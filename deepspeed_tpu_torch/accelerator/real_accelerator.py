"""Device selection for the port's entry points.

The CUDA card is the default.  The CPU runs only when a caller names it
(``device="cpu"``); asking for CUDA on a machine without a card raises
instead of falling back.
"""

import contextlib

import torch


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
