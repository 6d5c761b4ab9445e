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

The gradient (training): :class:`GroupedMatmul`, the autograd Function
``gmm`` runs through when x or w needs one, launches two more kernels of
the same file in its backward, each only where its input needs a
gradient: :func:`gmm_dx` (``dx[i] = dy[i] @ w[g(i)]ᵀ``; the forward's
``wgmma`` + TMA kernel with w, as it lies, the K-major B operand — no
transposed copy of the stack — its blocks taken in bands of row tiles that
walk every column tile, so that dy, the streamed operand, is read from
device memory about once) and :func:`gmm_dw` (``dw[e] = x_eᵀ @ dy_e`` over
expert e's rows: a persistent ``wgmma`` + TMA kernel whose boxes start at
each expert's first row, with x read as the MN-major A operand, and the
rows of the next expert in an expert's last box zeroed in shared memory
in both operands before they are multiplied; an expert with no rows gets
zeros).  Both do 2·T·K·N flops and are bound by the bf16 tensor rate at
training shapes.  Both accumulate in fp32 and round once
(``ragged_dot``'s transpose), with no atomics (reruns are bit-equal), and
find their rows from ``group_sizes`` on the device, so a training step
reads no group size on the host.  :func:`gmm_bwd_route` is their one rule
of routes.  JAX differentiates ``lax.ragged_dot`` through XLA; these two
replace no Pallas kernel of their own.

On a CPU tensor ``gmm`` (and each backward kernel) returns the plain
version; on a CUDA tensor it launches the kernel or raises.
``gmm.launches`` counts kernel launches, ``gmm.route_launches`` the same
by route; ``gmm_dx`` and ``gmm_dw`` carry their own counts.
"""

import torch

from ...accelerator import full_fp32_matmul
from ..op_builder import GroupedMatmulBuilder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("fp32", "mma_sync", "wgmma_tma", "wgmma_tma_64")  # C route codes
# the backward's, by their C codes: the forward's plus "simt" (4), the
# CUDA cores in any dtype
BWD_ROUTES = {"dx": ("wgmma_tma", "wgmma_tma_64", "simt"),
              "dw": ("wgmma_tma", "mma_sync", "simt")}
_BWD_CODES = ROUTES + ("simt", )
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


def gmm_dx_plain(dy, w, group_sizes):
    """``dx[rows_g] = dy[rows_g] @ w[g]ᵀ`` in fp32 (full fp32 on the card),
    rounded once to dy's dtype; rows past the sizes are zero."""
    dx = torch.zeros(dy.shape[0], w.shape[1], dtype=dy.dtype,
                     device=dy.device)
    start = 0
    with full_fp32_matmul():
        for g, n in enumerate(group_sizes.tolist()):
            if n > 0:
                dx[start:start + n] = (dy[start:start + n].float()
                                       @ w[g].float().t()).to(dy.dtype)
            start += n
    return dx


def gmm_dw_plain(x, dy, group_sizes):
    """``dw[g] = x[rows_g]ᵀ @ dy[rows_g]`` in fp32, rounded once to x's
    dtype; zeros for a group with no rows.  [E, K, N]."""
    dw = torch.zeros(group_sizes.shape[0], x.shape[1], dy.shape[1], dtype=x.dtype,
                     device=x.device)
    start = 0
    with full_fp32_matmul():
        for g, n in enumerate(group_sizes.tolist()):
            if n > 0:
                dw[g] = (x[start:start + n].float().t()
                         @ dy[start:start + n].float()).to(x.dtype)
            start += n
    return dw


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


def _forward(x, w, group_sizes):
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


def gmm(x, w, group_sizes):
    """Grouped matmul: ``y[i] = x[i] @ w[g(i)]``.  x: [T, K] with rows
    sorted by group; w: [E, K, N]; group_sizes: [E] int32 summing to at
    most T (on x's device; the rows past the sum come out zero and their
    gradients are zero, as ``lax.ragged_dot``'s).  Returns [T, N] in x's
    dtype.  Differentiable in x and w (:class:`GroupedMatmul`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)


gmm.launches = 0
gmm.route_launches = dict.fromkeys(ROUTES, 0)


class GroupedMatmul(torch.autograd.Function):
    """``gmm`` with its gradient: the backward launches :func:`gmm_dx`
    only where x needs a gradient and :func:`gmm_dw` only where w does.
    x, w and ``group_sizes`` are saved tensors, which autograd frees after
    the backward: no reference to w outlives it (under ZeRO 3, w is a
    gathered buffer that the coordinator releases)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous().to(x.dtype)
        dx = gmm_dx(dy, w, group_sizes) if ctx.needs_input_grad[0] else None
        dw = gmm_dw(x, dy, group_sizes) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def gmm_bwd_route(kind, T, K, N, dtype, a_addr, w_addr):
    """The backward kernel's route.  For bf16/fp16 where TMA can take the
    shapes (K % 8 == 0 and N % 8 == 0: rows of x, dy and w in whole 16
    bytes, and dx's or dw's paired stores; both operands 16-byte
    aligned): "dx" takes "wgmma_tma" (or "wgmma_tma_64" when T <=
    SMALL_T), "dw" "wgmma_tma"; for its other shapes dx takes "simt" (the
    CUDA cores), dw "mma_sync".  fp32: "simt".  ``a_addr``: dy's address
    (dx) or x's (dw); ``w_addr``: w's (dx) or dy's (dw)."""
    if kind not in BWD_ROUTES:
        raise ValueError(f"kind {kind!r}: 'dx' or 'dw'")
    if dtype == torch.float32:
        return "simt"
    tma = (K % 8 == 0 and N % 8 == 0 and a_addr % 16 == 0
           and w_addr % 16 == 0)
    if kind == "dw":
        return "wgmma_tma" if tma else "mma_sync"
    if tma:
        return "wgmma_tma_64" if T <= SMALL_T else "wgmma_tma"
    return "simt"


def _check_bwd(kind, a, b, group_sizes):
    for name, t in (("a", a), ("b", b), ("group_sizes", group_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"gmm_{kind}: {name} must be contiguous")
    if a.dtype != b.dtype:
        raise TypeError(f"gmm_{kind} takes two tensors of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    devices = {t.device for t in (a, b, group_sizes)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = a.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"gmm_{kind} runs on cpu or cuda, not {device}")
    if device == "cuda" and a.dtype not in _DTYPE_CODES:
        raise TypeError(f"gmm_{kind} kernel takes fp32, bf16 or fp16, got "
                        f"{a.dtype}")
    if device == "cuda" and group_sizes.dtype != torch.int32:
        raise TypeError("group_sizes must be int32")
    return device


def _launch_bwd(kind, a, b, group_sizes, out, T, K, N, E, route):
    lib = GroupedMatmulBuilder().load()
    fn = lib.ds_gmm_dx if kind == "dx" else lib.ds_gmm_dw
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), group_sizes.data_ptr(),
                 out.data_ptr(), T, K, N, E, _DTYPE_CODES[a.dtype],
                 _BWD_CODES.index(route),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm_{kind} kernel launch failed ({route}): "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")


def gmm_dx(dy, w, group_sizes, route=None):
    """``dx[i] = dy[i] @ w[g(i)]ᵀ``: dy [T, N], w [E, K, N] → [T, K] in
    dy's dtype (rows past the sizes zero).  On the card: one launch on
    ``route`` (default :func:`gmm_bwd_route`'s)."""
    if dy.dim() != 2 or w.dim() != 3 or dy.shape[1] != w.shape[2]:
        raise ValueError(f"gmm_dx takes dy [T, N] and w [E, K, N], got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    if _check_bwd("dx", dy, w, group_sizes) == "cpu":
        return gmm_dx_plain(dy, w, group_sizes)
    T, N = dy.shape
    E, K, _ = w.shape
    dx = torch.zeros(T, K, dtype=dy.dtype, device=dy.device)
    if T == 0:
        return dx
    route = route or gmm_bwd_route("dx", T, K, N, dy.dtype, dy.data_ptr(),
                                   w.data_ptr())
    _launch_bwd("dx", dy, w, group_sizes, dx, T, K, N, E, route)
    gmm_dx.launches += 1
    gmm_dx.route_launches[route] += 1
    return dx


def gmm_dw(x, dy, group_sizes, route=None):
    """``dw[e] = x_eᵀ @ dy_e`` over expert e's rows: x [T, K], dy [T, N]
    → [E, K, N] in x's dtype (E = ``group_sizes``' length; zeros for an
    expert with no rows; rows past the sizes unread).  On the card: one launch on ``route`` (default
    :func:`gmm_bwd_route`'s), which writes every expert; T = 0 launches
    nothing and gives zeros."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"gmm_dw takes x [T, K] and dy [T, N], got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if _check_bwd("dw", x, dy, group_sizes) == "cpu":
        return gmm_dw_plain(x, dy, group_sizes)
    T, K = x.shape
    N, E = dy.shape[1], group_sizes.shape[0]
    if T == 0:
        return torch.zeros(E, K, N, dtype=x.dtype, device=x.device)
    dw = torch.empty(E, K, N, dtype=x.dtype, device=x.device)
    route = route or gmm_bwd_route("dw", T, K, N, x.dtype, x.data_ptr(),
                                   dy.data_ptr())
    _launch_bwd("dw", x, dy, group_sizes, dw, T, K, N, E, route)
    gmm_dw.launches += 1
    gmm_dw.route_launches[route] += 1
    return dw


for _fn, _kind in ((gmm_dx, "dx"), (gmm_dw, "dw")):
    _fn.launches = 0
    _fn.route_launches = dict.fromkeys(BWD_ROUTES[_kind], 0)
