"""FP6/FP12 grid quantization: the hand-written CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel of ``deepspeed_tpu/ops/fp_quantizer.py``:
``quantize_fp`` (:155), launched at :188, kernel body ``_fpq_kernel``
(:144).  Per group of ``gs`` consecutive elements (row-major flatten,
zero-padded to the padded group count of ``fp_groups``): the absmax; the
scale ``absmax / fmt_max`` (a true fp32 division), 1 for an all-zero group;
each element ``x / scale`` (a true division) rounded half to even onto the
(q_bits, mantissa_bits) grid with subnormals and saturation
(``round_to_fp_grid``) and encoded as sign|exp|mantissa (``encode_fp``).
Codes come out as uint8 for q_bits <= 8 and as 16 bits (int16 holding the
code) above; scales as fp32.  This is the function of JAX's XLA branch
(:199-204), which the port follows bit for bit.  Packing stays plain
PyTorch (``ops/fp_quantizer.py:pack_codes``).  The kernel is
``csrc/fp_quantizer.cu``; what bounds it on an H100: bytes.

On CPU tensors :func:`quantize_fp_codes` computes its plain version; on
CUDA tensors it launches the kernel or raises.
``quantize_fp_codes.launches`` counts kernel launches.
"""

import torch

from ..fp_quantizer import (_fmt, encode_fp, fp_groups, group_tiles,
                            round_to_fp_grid)
from ..op_builder import FPQuantizerBuilder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def code_dtype(q_bits):
    return torch.uint8 if q_bits <= 8 else torch.int16


def quantize_fp_codes_plain(x, q_bits, mantissa_bits, group_size):
    """The kernel's function in plain PyTorch: (codes [groups_pad, gs],
    scales fp32 [groups_pad])."""
    _, _, _, maxv = _fmt(q_bits, mantissa_bits)
    tiles = group_tiles(x, group_size)
    absmax = tiles.abs().amax(dim=1, keepdim=True)
    # a 0-dim tensor, not a Python float: on the card PyTorch divides by a
    # host scalar as a product with its reciprocal, by a tensor truly
    top = torch.tensor(maxv, dtype=torch.float32, device=x.device)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / top)
    v = round_to_fp_grid(tiles / scale, q_bits, mantissa_bits)
    codes = encode_fp(v, q_bits, mantissa_bits).to(code_dtype(q_bits))
    return codes, scale[:, 0]


def quantize_fp_codes(x, q_bits, mantissa_bits, group_size):
    """Per-group FP grid codes and fp32 scales of ``x`` (any shape, fp32,
    bf16 or fp16): ``(codes [groups_pad, gs], scales [groups_pad])``."""
    if not x.is_floating_point():
        raise TypeError(f"quantize_fp takes a float tensor, got {x.dtype}")
    _, _, _, maxv = _fmt(q_bits, mantissa_bits)
    if x.device.type == "cpu":
        return quantize_fp_codes_plain(x, q_bits, mantissa_bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_fp runs on cpu or cuda, not "
                         f"{x.device.type}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"FP quantize kernel takes fp32, bf16 or fp16, got "
                        f"{x.dtype}")
    gs, _, padded = fp_groups(x.numel(), group_size)
    x = x.contiguous()
    codes = torch.empty(padded, gs, dtype=code_dtype(q_bits),
                        device=x.device)
    scales = torch.empty(padded, dtype=torch.float32, device=x.device)
    if padded:
        lib = FPQuantizerBuilder().load()
        with torch.cuda.device(x.device):
            err = lib.ds_quantize_fp(
                x.data_ptr(), _DTYPE_CODES[x.dtype], codes.data_ptr(),
                scales.data_ptr(), x.numel(), padded, gs, q_bits,
                mantissa_bits, maxv,
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"FP quantize kernel launch failed: "
                               f"{lib.ds_cuda_error_string(err).decode()} "
                               f"({err})")
        quantize_fp_codes.launches += 1
    return codes, scales


quantize_fp_codes.launches = 0
