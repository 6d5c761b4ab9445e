"""Grouped (MoE expert) matmul: the hand-written CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``deepspeed_tpu/ops/pallas/grouped_matmul.py``
— ``gmm`` (:80, launched at :100, kernel body ``_gmm_kernel`` :37) — which
the JAX MoE layer reaches through ``lax.ragged_dot``'s semantics:
``y[i] = x[i] @ w[g(i)]`` for rows sorted by group, fp32 accumulation, one
rounding to x's dtype.  The kernel is ``csrc/grouped_matmul.cu``, built by
``ops/op_builder.py`` with nvcc for ``sm_90a`` and called through ctypes on
PyTorch's current stream.

What bounds it on an H100: the bytes of the active experts' weights when a
few rows meet each expert (decode), the bf16 tensor rate when hundreds do
(prefill).  The kernel runs bf16/fp16 on tensor cores (``mma.sync``) and
fp32 on CUDA-core FMA.  ``group_sizes`` stays on the device: every block of
the kernel's static grid (``ceil(T/64) + E`` row tiles) finds its expert
itself, so the caller never waits for the routing.

On a CPU tensor ``gmm`` returns the plain version; on a CUDA tensor it
launches the kernel or raises.  ``gmm.launches`` counts kernel launches.
"""

import torch

from ...accelerator import full_fp32_matmul
from ..op_builder import GroupedMatmulBuilder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def gmm_plain(x, w, group_sizes):
    """Per-group ``x[rows_g] @ w[g]`` in fp32 (full fp32 on the card),
    rounded once to x's dtype; rows past the sum of the sizes are zero
    (``lax.ragged_dot``).  Reads the sizes on the host."""
    y = torch.zeros(x.shape[0], w.shape[2], dtype=x.dtype, device=x.device)
    start = 0
    with full_fp32_matmul():
        for g, n in enumerate(group_sizes.tolist()):
            if n > 0:
                y[start:start + n] = (x[start:start + n].float()
                                      @ w[g].float()).to(x.dtype)
            start += n
    return y


def _check(x, w, group_sizes):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"gmm takes x [T, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tuple(group_sizes.shape) != (w.shape[0], ):
        raise ValueError(f"group_sizes must be [E={w.shape[0]}], got "
                         f"{tuple(group_sizes.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"x and w must share a dtype, got {x.dtype} and "
                        f"{w.dtype}")
    devices = {t.device for t in (x, w, group_sizes)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return x.device.type


def _launch(x, w, group_sizes):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"gmm kernel takes fp32, bf16 or fp16, got {x.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError("group_sizes must be int32")
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T, K = x.shape
    E, _, N = w.shape
    y = torch.zeros(T, N, dtype=x.dtype, device=x.device)
    if T == 0:
        return y, False
    lib = GroupedMatmulBuilder().load()
    with torch.cuda.device(x.device):
        err = lib.ds_gmm(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                         y.data_ptr(), T, K, N, E, _DTYPE_CODES[x.dtype],
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")
    return y, True


def gmm(x, w, group_sizes):
    """Grouped matmul: ``y[i] = x[i] @ w[g(i)]``.  x: [T, K] with rows
    sorted by group; w: [E, K, N]; group_sizes: [E] int32 summing to T (on
    x's device).  Returns [T, N] in x's dtype."""
    device = _check(x, w, group_sizes)
    if device == "cpu":
        return gmm_plain(x, w, group_sizes)
    if device != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {device}")
    y, launched = _launch(x, w, group_sizes)
    gmm.launches += launched
    return y


gmm.launches = 0
