"""Quantized collective primitives, the wire-compression layer (the port
of ``deepspeed_tpu/comm/collectives/quantized.py``; ZeRO++ qwZ/qgZ,
arxiv 2306.10209, and EQuARX, arxiv 2506.17615): block-wise quantize the
payload, move int8/fp8/packed fp6/fp12 codes and one fp32 scale a group,
dequantize on arrival.

The JAX functions run inside ``shard_map`` over mesh axes; here each takes
a process group of the port (``comm/backend.py``'s ``ProcessGroup``) and
runs on ``torch.distributed`` (NCCL on the card, gloo on the CPU), with
the same per-rank inputs and results.  The codecs are the port's kernel
wrappers, which the JAX codecs' XLA branches match bit for bit: B5's
``quantize_blockwise``/``dequantize_blockwise`` (int8, int4 in int8
storage) and B6's ``quantize_fp`` (fp6, fp12; fp8 is the native e4m3fn
cast).  On CUDA tensors they launch the kernels, on CPU tensors they run
the plain versions; the codes travel as they are (int8, uint8), never
cast.

Each rank's codes and scales have one size whatever its values (the last
group of a piece is zero-padded), so every exchange is well-formed.
"""

import math

import torch
import torch.distributed as tdist

from ...ops.fp_quantizer import dequantize_fp, quantize_fp
from ...ops.kernels.quantizer import dequantize_blockwise, quantize_blockwise

DEFAULT_GROUP_SIZE = 2048
_LANES = 128  # scale-group granularity of the blockwise kernels

# fp wire formats: (q_bits, mantissa_bits); fp6 packs 4 codes in 3 bytes
_FP_FORMATS = {"fp8": (8, 3), "fp6": (6, 2), "fp12": (12, 7)}

# transported bytes an element for each wire format (int4 travels in int8
# storage, reported as it travels)
PAYLOAD_BYTES = {"int8": 1.0, "int4": 1.0, "fp8": 1.0, "fp6": 0.75,
                 "fp12": 1.5}

WIRE_FORMATS = tuple(PAYLOAD_BYTES)

#: the wire ladder's rung meaning "do not quantize this size band"
LADDER_FP = "fp32"


def wire_codec(wire_format, group_size):
    """Wire format name → ``(quantize, dequantize)``: ``quantize(x) -> (q,
    scales, meta)``, ``dequantize(q, scales, meta, out=None)`` (``out``:
    where to write the result, of meta's shape and dtype)."""
    if wire_format in ("int8", "int4"):
        bits = 8 if wire_format == "int8" else 4

        def quant(x):
            return quantize_blockwise(x, num_bits=bits,
                                      group_size=group_size)

        return quant, dequantize_blockwise
    if wire_format in _FP_FORMATS:
        bits, man = _FP_FORMATS[wire_format]

        def quant(x):
            return quantize_fp(x, q_bits=bits, mantissa_bits=man,
                               group_size=group_size)

        def dequant(q, s, meta, out=None):
            value = dequantize_fp(q, s, meta)
            return value if out is None else out.copy_(value)

        return quant, dequant
    raise ValueError(f"unknown wire format {wire_format!r} "
                     f"(have {', '.join(WIRE_FORMATS)})")


def effective_group_size(group_size):
    """The scale-group size the kernels use (a multiple of 128, ≥ 128)."""
    return max(_LANES, group_size - group_size % _LANES)


def quantized_wire_bytes(n_elements, wire_format, group_size):
    """Transported bytes for a quantized payload of ``n_elements``: the
    codes and one fp32 scale a group (``"fp32"``, the ladder's flat rung:
    the logical size, no scales)."""
    if wire_format == LADDER_FP:
        return int(n_elements) * 4
    gs = effective_group_size(group_size)
    groups = -(-n_elements // gs)
    return int(math.ceil(n_elements * PAYLOAD_BYTES[wire_format])) + \
        groups * 4


# ------------------------------------------------------------ rowwise codec
ROWWISE_FORMATS = ("int8", "fp8")


def rowwise_storage_dtype(wire_format):
    """Element dtype a rowwise-quantized payload is stored as."""
    if wire_format == "int8":
        return torch.int8
    if wire_format == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown rowwise wire format {wire_format!r} "
                     f"(have {', '.join(ROWWISE_FORMATS)})")


def rowwise_codec(wire_format, reduce_axes=2):
    """Wire format name → ``(encode, decode)`` with one fp32 scale a
    leading index, the trailing ``reduce_axes`` axes forming its group.
    ``encode(x) -> (q, scale)``: ``q`` of x's shape in the storage dtype,
    ``scale`` of the leading shape; ``decode(q, scale)`` is fp32."""
    ax = tuple(range(-reduce_axes, 0))
    if wire_format == "int8":
        qmax = 127.0

        def store(y):
            return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    elif wire_format == "fp8":
        # e4m3fn has no inf: clamp before the cast, or overflow is NaN
        qmax = float(torch.finfo(torch.float8_e4m3fn).max)

        def store(y):
            return torch.clamp(y, -qmax, qmax).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown rowwise wire format {wire_format!r} "
                         f"(have {', '.join(ROWWISE_FORMATS)})")

    def encode(x):
        xf = x.float()
        absmax = xf.abs().amax(dim=ax, keepdim=True)
        top = torch.tensor(qmax, dtype=torch.float32, device=x.device)
        scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                            absmax / top)
        return store(xf / scale), scale.reshape(scale.shape[:-reduce_axes])

    def decode(q, scale):
        return q.float() * scale.reshape(tuple(scale.shape)
                                         + (1, ) * reduce_axes)

    return encode, decode


# --------------------------------------------------------------- exchanges
def _gather_into(out, t, group, async_op=False):
    """Every rank's ``t`` stacked into ``out`` ([n, *t.shape])."""
    if group.local:
        out[0].copy_(t)
        return None
    # flat views: gloo wants the output's dim 0 to be n × the input's
    return tdist.all_gather_into_tensor(out.view(-1), t.reshape(-1),
                                        group=group.pg, async_op=async_op)


def _all_to_all(t, group):
    """Row j of ``t`` ([n, ...]) sent to rank j; row j of the result came
    from rank j."""
    if group.local:
        return t.clone()
    out = torch.empty_like(t)
    tdist.all_to_all_single(out, t.contiguous(), group=group.pg)
    return out


def _reduce_scatter(x, group, dim):
    """Block r (along ``dim``) of the SUM of the ranks' ``x``."""
    n = group.size()
    if group.local:
        return x.clone()
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n, ) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    tdist.reduce_scatter_tensor(out, xm, group=group.pg)
    return out.movedim(0, dim)


def _stack_codes(chunks, quant):
    """Each chunk quantized: (codes [n, ...], scales [n, ...], meta of one
    chunk).  Every chunk has one shape, so its codes and scales too."""
    qs, ss, meta = [], [], None
    for c in chunks:
        q, s, meta = quant(c)
        qs.append(q)
        ss.append(s)
    return torch.stack(qs), torch.stack(ss), meta


class GatherHandle:
    """A quantized all-gather in flight: the codes and the scales are kept
    alive until :meth:`wait`, which waits for both exchanges and
    dequantizes every rank's part, in rank order, into its place."""

    def __init__(self, works, codes, scales, meta, dequant, outs):
        self._works = [w for w in works if w is not None]
        self._codes, self._scales = codes, scales
        self._meta, self._dequant, self._outs = meta, dequant, outs

    def is_completed(self):
        return self._codes is None

    def wait(self):
        if self._codes is not None:
            for w in self._works:
                w.wait()
            for k, out in enumerate(self._outs):
                self._dequant(self._codes[k], self._scales[k], self._meta,
                              out=out)
            self._works, self._codes, self._scales = [], None, None


def start_quantized_gather(x, outs, group, wire_format="int8",
                           group_size=DEFAULT_GROUP_SIZE, async_op=False):
    """Quantize ``x`` (this rank's piece), all-gather the codes and the
    scales, and dequantize rank k's part into ``outs[k]`` (each of ``x``'s
    shape and dtype) when the returned :class:`GatherHandle` is waited on
    (at once unless ``async_op``)."""
    quant, dequant = wire_codec(wire_format, group_size)
    q, s, meta = quant(x)
    n = group.size()
    codes = torch.empty((n, ) + tuple(q.shape), dtype=q.dtype,
                        device=q.device)
    scales = torch.empty((n, ) + tuple(s.shape), dtype=s.dtype,
                         device=s.device)
    works = (_gather_into(codes, q, group, async_op=True),
             _gather_into(scales, s, group, async_op=True))
    handle = GatherHandle(works, codes, scales, meta, dequant, outs)
    if not async_op:
        handle.wait()
    return handle


def quantized_all_gather(x, group, dim=0, wire_format="int8",
                         group_size=DEFAULT_GROUP_SIZE):
    """The ranks' ``x`` concatenated along ``dim`` in rank order, moved as
    codes and scales (reference qwZ).  ``wire_format="fp32"`` (the
    ladder's flat rung) gathers the raw values: the same schedule,
    bit-exact."""
    n = group.size()
    if wire_format == LADDER_FP:
        out = torch.empty((n, ) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        _gather_into(out, x, group)
        return torch.cat(list(out), dim=dim)
    parts = torch.empty((n, ) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    start_quantized_gather(x, list(parts), group, wire_format, group_size)
    return torch.cat(list(parts), dim=dim)


class _QdqAllGatherST(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim, wire_format, group_size):
        ctx.group, ctx.dim = group, dim
        return quantized_all_gather(x, group, dim, wire_format, group_size)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group, ctx.dim), None, None, None, \
            None


def qdq_all_gather_st(x, group, dim, wire_format, group_size):
    """Straight-through quantized gather: the forward is
    :func:`quantized_all_gather`, the backward the exact reduce-scatter of
    the cotangent (the rounding must not zero the gradient)."""
    return _QdqAllGatherST.apply(x, group, dim, wire_format, group_size)


def quantized_all_to_all(x, group, split_axis, concat_axis, n,
                         wire_format="int8", group_size=DEFAULT_GROUP_SIZE):
    """Permuting quantized all-to-all: chunk j of ``split_axis`` goes to
    rank j, the received chunks are concatenated along ``concat_axis`` in
    rank order; nothing is summed (the expert-dispatch exchange).
    ``"fp32"``: the raw values, bit-exact."""
    chunks = torch.stack(list(x.chunk(n, dim=split_axis)))
    if wire_format == LADDER_FP:
        parts = _all_to_all(chunks, group)
        return torch.cat(list(parts), dim=concat_axis)
    quant, dequant = wire_codec(wire_format, group_size)
    q, s, meta = _stack_codes(chunks, quant)
    qx, sx = _all_to_all(q, group), _all_to_all(s, group)
    parts = [dequant(qx[k], sx[k], meta) for k in range(n)]
    return torch.cat(parts, dim=concat_axis).to(x.dtype)


def all_to_all_quant_reduce(g, group, dim, n, num_bits=8,
                            group_size=DEFAULT_GROUP_SIZE, wire_format=None,
                            mean=True):
    """Quantized reduce-scatter of each rank's whole gradient ``g``: split
    along ``dim`` into ``n`` chunks, chunk j of every rank quantized and
    sent to rank j (``all_to_all_single``), dequantized straight to fp32
    and summed in rank order.  Returns this rank's chunk of the mean
    (``mean=False``: the sum), fp32 (reference ``all_to_all_quant_reduce``,
    ``runtime/comm/coalesced_collectives.py:31``).  ``"fp32"``: the same
    schedule with the raw values."""
    fmt = wire_format or ("int8" if num_bits == 8 else "int4")
    if g.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(g.shape)} does not split "
                         f"into {n}")
    chunks = list(g.chunk(n, dim=dim))
    if fmt == LADDER_FP:
        parts = _all_to_all(torch.stack(chunks), group)
        out = parts[0].float().clone()
        for k in range(1, n):
            out += parts[k].float()
    else:
        quant, dequant = wire_codec(fmt, group_size)
        q, s, meta = _stack_codes(chunks, quant)
        # dequantized straight to fp32: the sum never rounds through a
        # narrower source dtype
        meta = (meta[0], torch.float32) + tuple(meta[2:])
        qx, sx = _all_to_all(q, group), _all_to_all(s, group)
        del q, s
        out = dequant(qx[0], sx[0], meta)
        if n > 1:
            part = torch.empty_like(out)
            for k in range(1, n):     # summed in rank order
                out += dequant(qx[k], sx[k], meta, out=part)
    return out / n if mean else out


def hierarchical_quant_reduce_scatter(g, inner_group, outer_group, dim,
                                      n_inner, n_outer, wire_format="int8",
                                      group_size=DEFAULT_GROUP_SIZE,
                                      mean=True):
    """2-hop qgZ: a full-precision reduce-scatter over ``inner_group``
    (the fast links, all the data), then :func:`all_to_all_quant_reduce`
    over ``outer_group`` on 1/n_inner of it (one quantization error, on
    the slow hop only; ZeRO++ §4.3).

    The result is **inner-major**: the rank at (outer o, inner i) holds
    chunk ``i · n_outer + o`` of ``n_inner · n_outer`` along ``dim``."""
    part = _reduce_scatter(g, inner_group, dim)
    out = all_to_all_quant_reduce(part, outer_group, dim, n_outer,
                                  wire_format=wire_format,
                                  group_size=group_size, mean=False)
    if mean:
        out = out / (n_inner * n_outer)
    return out
