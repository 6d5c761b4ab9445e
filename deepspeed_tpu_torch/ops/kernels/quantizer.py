"""Blockwise symmetric int8/int4 quantization: the hand-written CUDA
kernels' wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/quantizer.py``:
``quantize_blockwise`` (:67, launched at :91, kernel body ``_quant_kernel``
:31) and ``dequantize_blockwise`` (:105, launched at :121,
``_dequant_kernel`` :40).  A tensor is flattened row-major and cut into
groups of ``group_size`` consecutive elements; each group keeps int8 values
and one fp32 scale ``absmax / qmax`` (1 where the group is all zeros).  int4
values stay in int8 storage at ±7, unpacked.  The kernels are
``csrc/quantizer.cu``, built by ``ops/op_builder.py`` and called through
ctypes on PyTorch's current stream.  What bounds them on an H100: bytes.

The quantize kernel reads its input on one of three routes, chosen by one
host rule on shapes and strides (:func:`quantize_route`): ``contiguous``;
``transposed``, the ``p.t()`` of a row-major ``nn.Linear`` weight read as
it lies (the serving path's 225 of Llama-2-7B's 226 weights: no transposed
copy); and ``copy``, any other layout made contiguous first (a stated
route, counted apart).

The JAX package pads the group count to its Pallas row block (a TPU tiling
detail); the port pads only the last group, and ``meta``'s third entry is
the group count either way.

On CPU tensors each wrapper computes its plain version; on CUDA tensors it
launches its kernel or raises.  ``quantize_blockwise.launches`` and
``dequantize_blockwise.launches`` count kernel launches,
``quantize_blockwise.route_launches`` the same by route.
"""

import torch

from ..op_builder import QuantizerBuilder

LANES = 128           # group sizes are multiples of this (quantizer.py:74)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("contiguous", "transposed", "copy")
# the transposed kernel's groups: one tile of gs rows of p a block
TRANSPOSED_GROUPS = (128, 256)


def _is_contiguous(shape, strides):
    want = 1
    for d, st in zip(reversed(shape), reversed(strides)):
        if d != 1 and st != want:
            return False
        want *= d
    return True


def quantize_route(shape, strides, dtype, addr, group_size):
    """How the quantize kernel reads a tensor of ``shape``/``strides``
    (elements) at address ``addr``, from host-known facts alone.

    ``contiguous``: row-major.  ``transposed``: a 2-D ``p.t()`` of a
    row-major [out, in] p (strides (1, in)) in fp32, bf16 or fp16, with
    groups of 128 or 256 that tile ``out`` (out % gs == 0), p's rows
    16-byte aligned (in · element size % 16 == 0) and p at a 16-byte
    aligned address.  ``copy``: anything else, made contiguous before the
    contiguous kernel."""
    gs = max(LANES, group_size - group_size % LANES)
    if _is_contiguous(shape, strides):
        return "contiguous"
    if (len(shape) == 2 and tuple(strides) == (1, shape[0])
            and dtype in _DTYPE_CODES and gs in TRANSPOSED_GROUPS
            and shape[1] % gs == 0 and addr % 16 == 0
            and shape[0] * torch.finfo(dtype).bits % 128 == 0):
        return "transposed"
    return "copy"


def _params(x, num_bits, group_size):
    """(group size after the JAX clamp, qmax, element count, groups)."""
    gs = max(LANES, group_size - group_size % LANES)
    qmax = 127.0 if num_bits == 8 else float(2**(num_bits - 1) - 1)
    n = x.numel()
    return gs, qmax, n, -(-n // gs)


def quantize_blockwise_plain(x, num_bits=8, group_size=2048):
    """The XLA path of ``quantizer.py:80-85``: fp32 absmax per group, a
    true division, round half to even, clip."""
    gs, qmax, n, groups = _params(x, num_bits, group_size)
    flat = torch.zeros(groups * gs, dtype=torch.float32, device=x.device)
    flat[:n] = x.reshape(-1)
    tiles = flat.view(groups, gs)
    absmax = tiles.abs().amax(dim=1, keepdim=True)
    # a 0-dim tensor, not a Python float: PyTorch's CUDA division by a host
    # scalar is a product with its reciprocal, by a tensor a true division
    qmax_t = torch.tensor(qmax, dtype=torch.float32, device=x.device)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax / qmax_t)
    q = torch.clamp(torch.round(tiles / scale), -qmax, qmax).to(torch.int8)
    return q, scale[:, 0], (tuple(x.shape), x.dtype, groups)


def dequantize_blockwise_plain(q, scales, meta):
    """``float(q) · scale`` rounded once to the original dtype
    (``quantizer.py:113-114, 129``)."""
    shape, dtype, _ = meta
    n = 1
    for d in shape:
        n *= d
    out = q.float() * scales[:, None]
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def _into(out, value):
    """``value`` written into ``out`` when given (its shape and dtype),
    else ``value``."""
    if out is None:
        return value
    if tuple(out.shape) != tuple(value.shape) or out.dtype != value.dtype:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, the "
                         f"result {tuple(value.shape)} {value.dtype}")
    return out.copy_(value)


def _launch_quantize(x, num_bits, group_size):
    """One launch on :func:`quantize_route`'s route; returns (q, scales,
    meta, the route, or None where an empty tensor launched nothing)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize kernel takes fp32, bf16 or fp16, got "
                        f"{x.dtype}")
    gs, qmax, n, groups = _params(x, num_bits, group_size)
    meta = (tuple(x.shape), x.dtype, groups)
    route = quantize_route(tuple(x.shape), x.stride(), x.dtype,
                           x.data_ptr(), group_size)
    if route == "copy":
        x = x.contiguous()
    q = torch.empty(groups, gs, dtype=torch.int8, device=x.device)
    scales = torch.empty(groups, dtype=torch.float32, device=x.device)
    if not groups:
        return q, scales, meta, None
    lib = QuantizerBuilder().load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if route == "transposed":
            # x = p^T: p is [out, in] = [x.shape[1], x.shape[0]]
            err = lib.ds_quantize_blockwise_t(
                x.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
                scales.data_ptr(), x.shape[1], x.shape[0], gs, qmax, stream)
        else:
            err = lib.ds_quantize_blockwise(
                x.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
                scales.data_ptr(), n, groups, gs, qmax, stream)
    if err:
        raise RuntimeError(f"quantize kernel launch failed ({route}): "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")
    return q, scales, meta, route


def quantize_blockwise(x, num_bits=8, group_size=2048):
    """Symmetric per-group quantization.  Returns ``(q int8 [groups, gs],
    scales fp32 [groups], meta)`` with ``meta = (shape, dtype, groups)``."""
    if not x.is_floating_point():
        raise TypeError(f"quantize_blockwise takes a float tensor, got "
                        f"{x.dtype}")
    if x.device.type == "cpu":
        return quantize_blockwise_plain(x, num_bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_blockwise runs on cpu or cuda, not "
                         f"{x.device.type}")
    q, scales, meta, route = _launch_quantize(x, num_bits, group_size)
    if route is not None:
        quantize_blockwise.launches += 1
        quantize_blockwise.route_launches[route] += 1
    return q, scales, meta


quantize_blockwise.launches = 0
quantize_blockwise.route_launches = dict.fromkeys(ROUTES, 0)


def dequantize_blockwise(q, scales, meta, out=None):
    """Inverse of :func:`quantize_blockwise`: the original shape and dtype,
    each value ``float(q) · scale`` rounded once.  ``out``: a contiguous
    tensor of that shape and dtype to write (the kernel writes it in
    place)."""
    shape, dtype, groups = meta
    if q.dim() != 2 or q.dtype != torch.int8 or q.shape[0] < groups or \
            tuple(scales.shape) != (q.shape[0], ):
        raise ValueError(f"q must be int8 [groups, gs] with scales [groups], "
                         f"got {tuple(q.shape)} {q.dtype} and "
                         f"{tuple(scales.shape)}")
    if q.device.type == "cpu":
        return _into(out, dequantize_blockwise_plain(q, scales, meta))
    if q.device.type != "cuda" or scales.device != q.device:
        raise ValueError(f"dequantize_blockwise runs on cpu or cuda, got q "
                         f"on {q.device} and scales on {scales.device}")
    if dtype not in _DTYPE_CODES or scales.dtype != torch.float32:
        raise TypeError(f"dequantize kernel writes fp32, bf16 or fp16 from "
                        f"fp32 scales, got {dtype} and {scales.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q and scales must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=q.device)
    elif (tuple(out.shape) != tuple(shape) or out.dtype != dtype
          or out.device != q.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous {tuple(shape)} {dtype} on "
                         f"{q.device}, got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")
    n = out.numel()
    if n > q.numel():
        raise ValueError(f"q holds {q.numel()} values, meta wants {n}")
    if n:
        lib = QuantizerBuilder().load()
        with torch.cuda.device(q.device):
            err = lib.ds_dequantize_blockwise(
                q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[dtype], n, q.shape[1],
                torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"dequantize kernel launch failed: "
                               f"{lib.ds_cuda_error_string(err).decode()} "
                               f"({err})")
        dequantize_blockwise.launches += 1
    return out


dequantize_blockwise.launches = 0
