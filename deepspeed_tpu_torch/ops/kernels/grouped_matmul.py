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
(prefill).  ``group_sizes`` stays on the device: every block of the
kernel's static grid (``ceil(T/BM) + E`` row tiles) finds its expert
itself, so the caller never waits for the routing.

Routes (:func:`gmm_route`, a function of shapes, dtype and alignment fixed
on the host and handed to the kernel's C entry, which launches that route
or refuses it): bf16/fp16 with K a multiple of 64, N of 8 and 16-byte aligned x and w take
``wgmma`` fed by TMA (128-row tiles, or 64-row ones for T <= 64, the
decode shapes); other bf16/fp16 shapes ``mma.sync``; fp32 the CUDA cores.

On a CPU tensor ``gmm`` returns the plain version; on a CUDA tensor it
launches the kernel or raises.  ``gmm.launches`` counts kernel launches,
``gmm.route_launches`` the same by route.
"""

import torch

from ...accelerator import full_fp32_matmul
from ..op_builder import GroupedMatmulBuilder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("fp32", "mma_sync", "wgmma_tma", "wgmma_tma_64")  # C route codes
SMALL_T = 64          # T at or below: the 64-row TMA tiles


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


def gmm_route(T, K, N, dtype, x_addr, w_addr):
    """The kernel route of a call: "fp32" for fp32; for bf16/fp16
    "wgmma_tma" (or "wgmma_tma_64" when T <= SMALL_T) where TMA can take
    the shapes (K % 64 == 0, so that a 64-deep box never straddles two
    experts of w viewed as [E·K, N]; N % 8 == 0, rows of whole 16 bytes;
    x and w at 16-byte aligned addresses), else "mma_sync"."""
    if dtype == torch.float32:
        return "fp32"
    if K % 64 == 0 and N % 8 == 0 and x_addr % 16 == 0 and w_addr % 16 == 0:
        return "wgmma_tma_64" if T <= SMALL_T else "wgmma_tma"
    return "mma_sync"


def _launch(x, w, group_sizes, route=None):
    """One launch on ``route`` (default: :func:`gmm_route`'s); returns
    (y, the route taken, or None where T = 0 launched nothing)."""
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
        return y, None
    route = route or gmm_route(T, K, N, x.dtype, x.data_ptr(), w.data_ptr())
    lib = GroupedMatmulBuilder().load()
    with torch.cuda.device(x.device):
        err = lib.ds_gmm(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
            T, K, N, E, _DTYPE_CODES[x.dtype], ROUTES.index(route),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm kernel launch failed ({route}): "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")
    return y, route


def gmm(x, w, group_sizes):
    """Grouped matmul: ``y[i] = x[i] @ w[g(i)]``.  x: [T, K] with rows
    sorted by group; w: [E, K, N]; group_sizes: [E] int32 summing to T (on
    x's device).  Returns [T, N] in x's dtype."""
    device = _check(x, w, group_sizes)
    if device == "cpu":
        return gmm_plain(x, w, group_sizes)
    if device != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {device}")
    y, route = _launch(x, w, group_sizes)
    if route is not None:
        gmm.launches += 1
        gmm.route_launches[route] += 1
    return y


gmm.launches = 0
gmm.route_launches = dict.fromkeys(ROUTES, 0)
