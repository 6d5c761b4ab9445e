"""Floating-point quantization, FP8 / FP6 / FP12: the port of
``deepspeed_tpu/ops/fp_quantizer.py`` (reference ``csrc/fp_quantizer/
fp_quantize.cu`` + ``deepspeed/ops/fp_quantizer/quantize.py``).

The format is ``q_bits`` in all with ``mantissa_bits`` of mantissa, so
``exp_bits = q_bits - mantissa_bits - 1``: (8, 3) = e4m3, (6, 2) = e3m2
(FP6-LLM, max 28), (12, 7) = e4m7 (max 511).  Each group of
``group_size`` consecutive elements (row-major flatten, zero-padded) keeps
one fp32 scale ``absmax / fmt_max`` (1 for an all-zero group) and one code
per element; codes are bit-packed for storage (4 × 6 b → 3 B, 2 × 12 b →
3 B).  The group count is padded as the JAX package's ``_group_view``
pads it (to a multiple of 8, then of its Pallas row block when above
it), so ``scales`` and the packed bytes have JAX's sizes.

The per-group absmax, scale, grid rounding, encoding and packing is
kernel B6 (``ops/kernels/fp_quantizer.py``, hand-written CUDA on the card,
one launch a tensor); the element math, packing and decoding here are
plain PyTorch (the plain version's and the decode's), as they are XLA code
in JAX.  fp8 e4m3 skips the kernel: a clamp and a native
``torch.float8_e4m3fn`` cast, as JAX casts to ``float8_e4m3fn``.

Powers of two are built from their exponent bits, so every step is exact.
JAX's ``jnp.exp2`` is ``exp(x · ln 2)`` on the CPU, exact for the
exponents these formats use except 2^-13, the step of e4m7's smallest
binade: there JAX rounds values within 4.8e-7 of a tie up, and encodes
values that round to 2^-5 as 2^-6, where this port takes the nearest grid
value, half to even (ROADMAP queue C; ``tests/test_torch_fp_quantizer.py``
holds both differences exactly).
"""

import math

import torch

_LANES = 128
# float8_e4m3fn's largest finite value: 448, not the generic 480 (the fn
# encoding spends the top mantissa code on NaN)
_E4M3_MAX = torch.finfo(torch.float8_e4m3fn).max


def _fmt(q_bits, mantissa_bits):
    exp_bits = q_bits - mantissa_bits - 1
    if exp_bits < 2:
        raise ValueError(f"q_bits={q_bits}, mantissa_bits={mantissa_bits} "
                         "leaves <2 exponent bits")
    if exp_bits > 7 or q_bits > 16:
        # the exact powers of two of a wider exponent leave fp32's normal
        # range; every format in use has 3-5 exponent bits
        raise ValueError(f"q_bits={q_bits}, mantissa_bits={mantissa_bits}: "
                         "the port takes at most 7 exponent bits and 16 "
                         "bits in all")
    bias = 2 ** (exp_bits - 1) - 1
    max_unb = (2 ** exp_bits - 1) - bias
    maxv = (2.0 - 2.0 ** (-mantissa_bits)) * 2.0 ** max_unb
    return exp_bits, bias, max_unb, maxv


def _pick_block(group_size):
    """The JAX quantizer's Pallas row block (``pallas/quantizer.py:44``),
    kept because the group count is padded to it."""
    block = 512
    while block > 8 and block * group_size * 4 > (1 << 20):
        block //= 2
    return block


def fp_groups(n, group_size):
    """(group size after JAX's clamp to a multiple of 128, groups holding
    ``n`` elements, padded group count as ``_group_view`` pads it)."""
    gs = max(_LANES, group_size - group_size % _LANES)
    groups = -(-n // gs)
    padded = groups + (-groups) % 8
    block = _pick_block(gs)
    if padded > block:
        padded += (-padded) % block
    return gs, groups, padded


def _pow2(e):
    """2^e for an int32 tensor e in [-126, 127], exact (exponent bits)."""
    return ((e + 127) << 23).view(torch.float32)


def _floor_log2(a):
    """Exact floor(log2(a)) for normal positive fp32, from the exponent
    bits."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def round_to_fp_grid(y, q_bits, mantissa_bits):
    """Round ``y`` (already scaled into range) to the nearest representable
    value of the (q_bits, mantissa_bits) grid, half to even; subnormals
    included, values beyond the grid max saturate.  fp32."""
    _, bias, max_unb, maxv = _fmt(q_bits, mantissa_bits)
    a = y.float().abs()
    e = _floor_log2(a.clamp_min(torch.finfo(torch.float32).tiny))
    step = _pow2(e.clamp(1 - bias, max_unb) - mantissa_bits)
    q = (torch.round(a / step) * step).clamp_max(maxv)
    return torch.sign(y.float()) * q


def encode_fp(v, q_bits, mantissa_bits):
    """Exactly representable value → int32 code (sign|exp|mantissa)."""
    _, bias, _, _ = _fmt(q_bits, mantissa_bits)
    a = v.float().abs()
    sign = (v < 0).to(torch.int32)
    e = _floor_log2(a.clamp_min(torch.finfo(torch.float32).tiny))
    normal = a >= 2.0 ** (1 - bias)
    zero = torch.zeros_like(e)
    efield = torch.where(normal, e + bias, zero)
    # a / 2^e in [1, 2) for normals: exact power-of-two scaling
    man_norm = torch.round((a * _pow2(-e) - 1.0) * 2.0 ** mantissa_bits)
    man_sub = torch.round(a * 2.0 ** (mantissa_bits - (1 - bias)))
    mfield = torch.where(normal, man_norm, man_sub).to(torch.int32)
    mfield = torch.where(a == 0.0, zero, mfield)
    efield = torch.where(a == 0.0, zero, efield)
    return (sign << (q_bits - 1)) | (efield << mantissa_bits) | mfield


def decode_fp(code, q_bits, mantissa_bits, dtype=torch.float32):
    """Integer code → value."""
    exp_bits, bias, _, _ = _fmt(q_bits, mantissa_bits)
    code = code.to(torch.int32)
    sign = (code >> (q_bits - 1)) & 0x1
    efield = (code >> mantissa_bits) & ((1 << exp_bits) - 1)
    mfield = code & ((1 << mantissa_bits) - 1)
    mag = torch.where(
        efield > 0,
        (1.0 + mfield.float() * 2.0 ** (-mantissa_bits))
        * _pow2(efield - bias),
        mfield.float() * 2.0 ** ((1 - bias) - mantissa_bits))
    return torch.where(sign == 1, -mag, mag).to(dtype)


# ----------------------------------------------------------------- packing
def pack_codes(codes, q_bits):
    """[N] integer codes → packed uint8.  6-bit: 4 → 3 bytes; 12-bit: 2 → 3
    bytes; 8-bit: identity bytes."""
    c = codes.to(torch.int32)
    if q_bits == 8:
        return c.to(torch.uint8)
    if q_bits == 6:
        c = c.reshape(-1, 4)
        b0 = (c[:, 0] << 2) | (c[:, 1] >> 4)
        b1 = ((c[:, 1] & 0xF) << 4) | (c[:, 2] >> 2)
        b2 = ((c[:, 2] & 0x3) << 6) | c[:, 3]
    elif q_bits == 12:
        c = c.reshape(-1, 2)
        b0 = c[:, 0] >> 4
        b1 = ((c[:, 0] & 0xF) << 4) | (c[:, 1] >> 8)
        b2 = c[:, 1] & 0xFF
    else:
        raise ValueError(f"no packing for q_bits={q_bits}")
    return torch.stack([b0, b1, b2], dim=1).to(torch.uint8).reshape(-1)


def unpack_codes(packed, q_bits, n):
    """Packed uint8 → the first ``n`` int32 codes."""
    if q_bits == 8:
        return packed.to(torch.int32)[:n]
    p = packed.to(torch.int32).reshape(-1, 3)
    if q_bits == 6:
        cs = [p[:, 0] >> 2, ((p[:, 0] & 0x3) << 4) | (p[:, 1] >> 4),
              ((p[:, 1] & 0xF) << 2) | (p[:, 2] >> 6), p[:, 2] & 0x3F]
    elif q_bits == 12:
        cs = [(p[:, 0] << 4) | (p[:, 1] >> 4),
              ((p[:, 1] & 0xF) << 8) | p[:, 2]]
    else:
        raise ValueError(f"no packing for q_bits={q_bits}")
    return torch.stack(cs, dim=1).reshape(-1)[:n]


# --------------------------------------------------------------- quantize
def group_tiles(x, group_size):
    """``x`` flattened, zero-padded to the padded group count, as fp32
    [groups_pad, gs]."""
    gs, _, padded = fp_groups(x.numel(), group_size)
    flat = torch.zeros(padded * gs, dtype=torch.float32, device=x.device)
    flat[:x.numel()] = x.reshape(-1)
    return flat.view(padded, gs)


def quantize_fp(x, q_bits=8, mantissa_bits=3, group_size=512,
                use_pallas=None):
    """Per-group scaled FP quantization.

    Returns ``(packed uint8, scales fp32 [groups_pad], meta)`` with
    ``meta = (shape, dtype, groups, q_bits, mantissa_bits, group_size)``;
    fp8 e4m3 gives the native dtype's bytes as [groups_pad, gs]
    (bit-identical to a scaled ``float8_e4m3fn`` cast).  Other formats run
    kernel B6 on a CUDA tensor and its plain version on a CPU one.
    ``use_pallas`` is accepted for the JAX signature and ignored."""
    from .kernels.fp_quantizer import quantize_fp_packed
    gs, groups, _ = fp_groups(x.numel(), group_size)
    meta = (tuple(x.shape), x.dtype, groups, q_bits, mantissa_bits, gs)
    if q_bits == 8 and mantissa_bits == 3:
        xf = group_tiles(x, gs)
        absmax = xf.abs().amax(dim=1, keepdim=True)
        # a 0-dim tensor, not a Python float: on the card PyTorch divides
        # by a host scalar as a product with its reciprocal
        top = torch.tensor(_E4M3_MAX, device=x.device)
        scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                            absmax / top)
        # clamp: x / scale can round a hair past the format max, and
        # e4m3fn overflows to NaN (no inf encoding)
        q8 = (xf / scale).clamp(-_E4M3_MAX, _E4M3_MAX).to(
            torch.float8_e4m3fn)
        return q8.view(torch.uint8), scale[:, 0], meta
    packed, scales = quantize_fp_packed(x, q_bits, mantissa_bits, gs)
    return packed, scales, meta


def dequantize_fp(packed, scales, meta, use_pallas=None):
    """Inverse of :func:`quantize_fp`: the original shape and dtype, each
    value ``decode(code) · scale`` in fp32, rounded once."""
    shape, dtype, _, q_bits, mantissa_bits, group_size = meta
    n = math.prod(shape)
    if q_bits == 8 and mantissa_bits == 3:
        vals = packed.view(torch.float8_e4m3fn).float() * scales[:, None]
        return vals.reshape(-1)[:n].reshape(shape).to(dtype)
    total = scales.shape[0] * group_size
    codes = unpack_codes(packed, q_bits, total)
    vals = decode_fp(codes, q_bits, mantissa_bits).reshape(
        scales.shape[0], group_size) * scales[:, None]
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)


class FP_Quantize:
    """Reference ``deepspeed/ops/fp_quantizer/quantize.py`` API surface.

    Stateless with respect to payloads: pass ``meta`` (third return of
    ``quantize`` with ``return_meta_tensor=True``) back into
    ``dequantize``; one instance may serve many tensors and formats."""

    def __init__(self, group_size=512):
        self.group_size = group_size

    def quantize(self, input, q_bits=8, q_mantisa_bits=3,
                 return_meta_tensor=False):
        packed, scales, meta = quantize_fp(
            input, q_bits=q_bits, mantissa_bits=q_mantisa_bits,
            group_size=self.group_size)
        if return_meta_tensor:
            return packed, scales, meta
        self._last_meta = meta
        return packed, scales

    def dequantize(self, input_q, scale=None, meta=None, q_bits=8,
                   q_mantisa_bits=3):
        if meta is None:
            meta = getattr(self, "_last_meta", None)
            if meta is None:
                raise ValueError(
                    "dequantize needs the meta from quantize(..., "
                    "return_meta_tensor=True) (or an immediately preceding "
                    "quantize call on this instance)")
            if meta[3] != q_bits or meta[4] != q_mantisa_bits:
                raise ValueError(
                    f"payload format ({q_bits},{q_mantisa_bits}) does not "
                    f"match the last quantize call ({meta[3]},{meta[4]}) — "
                    "pass meta explicitly")
        return dequantize_fp(input_q, scale, meta)
