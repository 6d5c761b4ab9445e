"""FP6/FP12 grid quantization to packed codes: the hand-written CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel of ``deepspeed_tpu/ops/fp_quantizer.py``:
``quantize_fp`` (:155), launched at :188, kernel body ``_fpq_kernel``
(:144), with the code packing that XLA ran beside it (``pack_codes``,
:106) in the same launch.  Per group of ``gs`` consecutive elements
(row-major flatten, zero-padded to the padded group count of
``fp_groups``): the absmax; the scale ``absmax / fmt_max`` (a true fp32
division), 1 for an all-zero group; each element ``x / scale`` (a true
division) rounded half to even onto the (q_bits, mantissa_bits) grid with
subnormals and saturation (``round_to_fp_grid``) and encoded as
sign|exp|mantissa (``encode_fp``); the codes packed as ``pack_codes``
packs them (4 × 6 b → 3 B, 2 × 12 b → 3 B, 8 b → 1 B).  This is the
function of JAX's XLA branch (:199-204), which the port follows bit for
bit.  The kernel is ``csrc/fp_quantizer.cu``; what bounds it on an H100:
instruction issue about as much as bytes (its source says why).

On CPU tensors :func:`quantize_fp_packed` computes its plain version; on
CUDA tensors it launches the kernel once or raises.
``quantize_fp_packed.launches`` counts kernel launches.
:func:`quantize_fp_codes_plain` (the unpacked codes) stays for the tests.
"""

import torch

from ..fp_quantizer import (_fmt, encode_fp, fp_groups, group_tiles,
                            pack_codes, round_to_fp_grid)
from ..op_builder import FPQuantizerBuilder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PACKED_BITS = (6, 8, 12)     # the widths pack_codes packs


def code_dtype(q_bits):
    return torch.uint8 if q_bits <= 8 else torch.int16


def quantize_fp_codes_plain(x, q_bits, mantissa_bits, group_size):
    """The unpacked codes in plain PyTorch: (codes [groups_pad, gs],
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


def quantize_fp_packed_plain(x, q_bits, mantissa_bits, group_size):
    """The kernel's function in plain PyTorch: (packed uint8
    [groups_pad · gs · q_bits / 8], scales fp32 [groups_pad])."""
    codes, scales = quantize_fp_codes_plain(x, q_bits, mantissa_bits,
                                            group_size)
    return pack_codes(codes.reshape(-1), q_bits), scales


def _launch(x, q_bits, mantissa_bits, group_size):
    """One launch; returns (packed, scales, launched)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"FP quantize kernel takes fp32, bf16 or fp16, got "
                        f"{x.dtype}")
    _, _, _, maxv = _fmt(q_bits, mantissa_bits)
    gs, _, padded = fp_groups(x.numel(), group_size)
    x = x.contiguous()
    packed = torch.empty(padded * gs * q_bits // 8, dtype=torch.uint8,
                         device=x.device)
    scales = torch.empty(padded, dtype=torch.float32, device=x.device)
    if not padded:
        return packed, scales, False
    lib = FPQuantizerBuilder().load()
    with torch.cuda.device(x.device):
        err = lib.ds_quantize_fp_packed(
            x.data_ptr(), _DTYPE_CODES[x.dtype], packed.data_ptr(),
            scales.data_ptr(), x.numel(), padded, gs, q_bits, mantissa_bits,
            maxv, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"FP quantize kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")
    return packed, scales, True


def quantize_fp_packed(x, q_bits, mantissa_bits, group_size):
    """Per-group FP grid codes of ``x`` (any shape, fp32, bf16 or fp16),
    packed, and fp32 scales: ``(packed uint8, scales [groups_pad])``."""
    if not x.is_floating_point():
        raise TypeError(f"quantize_fp takes a float tensor, got {x.dtype}")
    _fmt(q_bits, mantissa_bits)
    if q_bits not in PACKED_BITS:
        raise ValueError(f"no packing for q_bits={q_bits}")
    if x.device.type == "cpu":
        return quantize_fp_packed_plain(x, q_bits, mantissa_bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_fp runs on cpu or cuda, not "
                         f"{x.device.type}")
    packed, scales, launched = _launch(x, q_bits, mantissa_bits, group_size)
    quantize_fp_packed.launches += launched
    return packed, scales


quantize_fp_packed.launches = 0
