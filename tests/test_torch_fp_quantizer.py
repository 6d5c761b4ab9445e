"""The port's FP8/FP6/FP12 quantizer (``ops/fp_quantizer.py`` with kernel
B6's plain version, on the CPU) against the JAX package's.

Codes, packed bytes, scales and ``meta`` must equal JAX's XLA branch
(``fp_quantizer.py:199-206``, the semantics the CUDA kernel implements)
bit for bit, with the same padded group count, for (6, 2), (12, 7) and
the native fp8 path (8, 3), in bf16 and fp32; so must the dequantized
tensor.  JAX's own ``tests/unit/ops/test_fp_quantizer.py`` cases are
ported here, all but the qwZ wire-format case (ROADMAP queue A item 7).

Two known differences of JAX's, each held exactly:
- JAX's ``jnp.exp2(-13)`` is ``exp(-13 · ln 2)``, 4.8e-7 below 2^-13, so in
  e4m7's smallest binade (|y| < 2^-5) a value within that margin of a
  rounding tie rounds up in JAX, and a value that rounds to 2^-5 becomes
  256 · exp2(-13), just below 2^-5, which JAX's ``encode_fp`` encodes as
  2^-6; the port (exact powers of two) takes the nearest grid value, half
  to even.  Where a tensor reaches neither, packed bytes are equal;
- JAX's Pallas kernel in interpret mode computes its scale as
  ``absmax · fl(1/maxv)``, not ``absmax / maxv`` (the same finding as B5's,
  ``tests/test_torch_quantizer.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fp_quantizer as jax_fp
from deepspeed_tpu_torch.ops import fp_quantizer as port_fp
from deepspeed_tpu_torch.ops.kernels import fp_quantizer as port_kfp

FORMATS = [(6, 2), (12, 7), (8, 3)]


def _np(x):
    return np.asarray(x)


# ------------------------------------------- JAX's own cases, on the port
@pytest.mark.parametrize("q_bits,man", FORMATS)
def test_code_roundtrip_exhaustive(q_bits, man):
    """decode(encode(v)) == v for every representable value, and both
    functions equal JAX's on every code."""
    codes = torch.arange(2 ** q_bits, dtype=torch.int32)
    vals = port_fp.decode_fp(codes, q_bits, man)
    back = port_fp.encode_fp(vals, q_bits, man)
    neg_zero = 1 << (q_bits - 1)
    ok = back.numpy() == codes.numpy()
    ok[neg_zero] = int(back[neg_zero]) in (0, neg_zero)
    assert ok.all(), np.nonzero(~ok)
    jcodes = jnp.arange(2 ** q_bits, dtype=jnp.uint32)
    jvals = jax_fp.decode_fp(jcodes, q_bits, man)
    np.testing.assert_array_equal(vals.numpy(), _np(jvals))
    np.testing.assert_array_equal(
        back.numpy(), _np(jax_fp.encode_fp(jvals, q_bits, man)))


@pytest.mark.parametrize("q_bits", [6, 12])
def test_pack_roundtrip(q_bits):
    n = 96
    codes = np.random.default_rng(0).integers(0, 2 ** q_bits, size=n)
    packed = port_fp.pack_codes(torch.tensor(codes), q_bits)
    assert packed.dtype == torch.uint8 and packed.numel() == n * q_bits // 8
    np.testing.assert_array_equal(
        packed.numpy(), _np(jax_fp.pack_codes(jnp.asarray(codes, jnp.uint32),
                                              q_bits)))
    np.testing.assert_array_equal(
        port_fp.unpack_codes(packed, q_bits, n).numpy(), codes)


def test_grid_rounding_max_and_subnormal():
    # fp6 e3m2: max 28, subnormal step 0.0625
    y = [100.0, -100.0, 28.0, 0.0625, 0.03, 0.0, -0.07, 0.05]
    q = port_fp.round_to_fp_grid(torch.tensor(y), 6, 2)
    np.testing.assert_allclose(
        q.numpy(), [28.0, -28.0, 28.0, 0.0625, 0.0, 0.0, -0.0625, 0.0625])
    np.testing.assert_array_equal(
        q.numpy(), _np(jax_fp.round_to_fp_grid(jnp.asarray(y), 6, 2)))


@pytest.mark.parametrize("q_bits,man,rtol", [(8, 3, 0.08), (6, 2, 0.30),
                                             (12, 7, 0.006)])
def test_quantize_roundtrip_error(q_bits, man, rtol):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 256)) * 3).astype(np.float32)
    packed, scales, meta = port_fp.quantize_fp(torch.tensor(x), q_bits, man,
                                               group_size=128)
    back = port_fp.dequantize_fp(packed, scales, meta).numpy()
    assert back.shape == x.shape
    denom = np.maximum(np.abs(x), 1e-3)
    assert np.median(np.abs(back - x) / denom) < rtol


def test_fp8_matches_native_cast():
    """The (8, 3) path is bit-identical to a scaled native e4m3 cast."""
    x = (np.random.default_rng(2).standard_normal(256) * 5).astype(
        np.float32)
    packed, scales, meta = port_fp.quantize_fp(torch.tensor(x), 8, 3,
                                               group_size=128)
    xf = torch.tensor(x).reshape(2, 128)
    absmax = xf.abs().amax(dim=1, keepdim=True)
    ref = (xf / (absmax / torch.tensor(448.0))).to(torch.float8_e4m3fn)
    # group rows are padded to a multiple of 8: the live rows lead
    assert torch.equal(packed.reshape(-1, 128)[:2], ref.view(torch.uint8))


def test_fp_quantize_class_api():
    q = port_fp.FP_Quantize(group_size=128)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((32, 128)), dtype=torch.float32)
    packed, scales, meta = q.quantize(x, q_bits=6, q_mantisa_bits=2,
                                      return_meta_tensor=True)
    # stateless: a second quantize in another format must not corrupt the
    # first payload's dequantize
    q.quantize(torch.tensor(rng.standard_normal((16, 128)),
                            dtype=torch.float32), q_bits=8, q_mantisa_bits=3)
    back = q.dequantize(packed, scale=scales, meta=meta)
    assert back.shape == x.shape
    with pytest.raises(ValueError, match="does not match"):
        q.dequantize(packed, scale=scales, q_bits=6, q_mantisa_bits=2)


# -------------------------------------------------- bit for bit against JAX
CASES = {
    # (group_size, shape): a partial last group and padding to 8 groups;
    # group 200 rounds down to 128; padding past the Pallas row block of
    # 512 groups (600 → 1024)
    "partial": (512, (37, 300)),
    "gs200": (200, (64, 256)),
    "pad8": (512, (4099, )),
    "pad_block": (512, (600, 512)),
}


def _input(case, dtype):
    gs, shape = CASES[case]
    x = (np.random.default_rng(len(case)).standard_normal(shape) * 3).astype(
        np.float32)
    x.reshape(-1)[:128] = 0.0                    # an all-zero group (gs 128)
    x.reshape(-1)[gs:gs + 8] = [28.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -1e4]
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.tensor(_np(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    return gs, xj, xt


def _codes_apart_at_jax_exp2_margin(pt, pj, st, xt, q_bits, man, gs):
    """Packed bytes equal JAX's, or, in e4m7 only, codes that differ only
    where JAX's inexact exp2(-13) decides, at |y| < 2^-5 (y = x / scale):
    within 1e-6 relative of a tie, where JAX's code is one step up; or
    rounding to 2^-5, which JAX reaches as 256 · exp2(-13), just below
    2^-5, and encodes as 2^-6 (code 128).  Returns how many codes
    differ."""
    if np.array_equal(pt.numpy(), _np(pj)):
        return 0
    assert (q_bits, man) == (12, 7), "codes differ outside e4m7"
    tiles = port_fp.group_tiles(xt, gs)
    y = (tiles / st[:, None]).reshape(-1).numpy()
    cj = port_fp.unpack_codes(torch.tensor(_np(pj)), 12, y.size).numpy()
    ct = port_fp.unpack_codes(pt, 12, y.size).numpy()
    diff = np.nonzero(cj != ct)[0]
    yd = np.abs(y[diff]).astype(np.float64) * 2.0 ** 13
    mj, mt = cj[diff] & 0x7FF, ct[diff] & 0x7FF
    near_tie = np.abs(yd - np.floor(yd) - 0.5) <= 1e-6 * yd
    step_up = near_tie & (mj - mt == 1) & (yd < 255)
    halved = (mt == 256) & (mj == 128) & (yd >= 255.5 - 1e-3) & (yd < 256)
    assert (step_up | halved).all(), (yd, mj, mt)
    return len(diff)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("q_bits,man", FORMATS)
def test_quantize_fp_equals_jax_xla_branch(q_bits, man, case, dtype):
    """Scales and meta bit for bit; packed bytes bit for bit but at JAX's
    exp2 margin (e4m7 only, held exactly); the dequantized tensor of the
    same bytes bit for bit."""
    gs, xj, xt = _input(case, dtype)
    pj, sj, mj = jax_fp.quantize_fp(xj, q_bits, man, gs, use_pallas=False)
    pt, st, mt = port_fp.quantize_fp(xt, q_bits, man, gs)
    assert mt[2:] == tuple(mj[2:]) and mt[0] == tuple(mj[0])
    assert mt[1] == xt.dtype
    assert pt.dtype == torch.uint8 and tuple(pt.shape) == pj.shape
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    _codes_apart_at_jax_exp2_margin(pt, pj, st, xt, q_bits, man, gs)
    dj = jax_fp.dequantize_fp(jnp.asarray(pt.numpy()), jnp.asarray(
        st.numpy()), mj)
    dt = port_fp.dequantize_fp(pt, st, mt)
    assert dt.dtype == xt.dtype and dt.shape == xt.shape
    np.testing.assert_array_equal(dt.float().numpy(),
                                  _np(dj.astype(jnp.float32)))
    if q_bits != 8:
        codes, scales = port_kfp.quantize_fp_codes_plain(xt, q_bits, man,
                                                         gs)
        assert codes.dtype == port_kfp.code_dtype(q_bits)
        assert torch.equal(port_fp.pack_codes(codes.reshape(-1), q_bits), pt)


@pytest.mark.parametrize("q_bits,man", [(6, 2), (12, 7)])
def test_pallas_interpreted_scales(q_bits, man):
    """JAX's ``use_pallas=True`` (interpret mode): its scale is
    ``absmax · fl(1/maxv)``; where that rounds as ``absmax / maxv`` does,
    scales and codes equal the port's bit for bit.  Counted, not hidden:
    how many groups' scales differ (B5's kernel does the same,
    ``tests/test_torch_quantizer.py``)."""
    gs, xj, xt = _input("partial", "float32")
    pj, sj, _ = jax_fp.quantize_fp(xj, q_bits, man, gs, use_pallas=True)
    pt, st, _ = port_fp.quantize_fp(xt, q_bits, man, gs)
    maxv = port_fp._fmt(q_bits, man)[3]
    tiles = port_fp.group_tiles(xt, gs).numpy()
    absmax = np.abs(tiles).max(axis=1)
    recip = np.float32(1.0) / np.float32(maxv)
    np.testing.assert_array_equal(
        _np(sj), np.where(absmax == 0, np.float32(1), absmax * recip))
    same = _np(sj) == st.numpy()
    n = tiles.size
    cj = port_fp.unpack_codes(torch.tensor(_np(pj)), q_bits, n).numpy()
    ct = port_fp.unpack_codes(pt, q_bits, n).numpy()
    np.testing.assert_array_equal(cj.reshape(tiles.shape)[same],
                                  ct.reshape(tiles.shape)[same])
    differing = int((~same).sum())
    assert 0 < differing < same.size, differing     # both kinds occur here


def test_fp12_smallest_binade_follows_the_exact_grid():
    """Values at and just below the ties of e4m7's smallest binade (step
    2^-13, where a code's magnitude is k for the value k · 2^-13): the
    port's code is the nearest grid value's, ties to even.  JAX's is one
    step up wherever its exp2(-13) margin reaches, equal on the grid, and
    128 (2^-6) for the values that round to 2^-5 (its 256 · exp2(-13) lies
    just below 2^-5, and its ``encode_fp`` then carries the mantissa into
    an exponent field it ORs, not adds)."""
    step = 2.0 ** -13
    k = np.arange(1, 256)
    ties = ((k + 0.5) * step).astype(np.float32)            # exact ties
    below = np.nextafter(ties, np.float32(0))               # just below
    grid = (k * step).astype(np.float32)
    y = np.concatenate([ties, below, -ties, grid])

    def mags(mod, arr):
        c = _np(mod.encode_fp(mod.round_to_fp_grid(arr, 12, 7), 12, 7))
        return c.astype(np.int64) & 0x7FF, c.astype(np.int64) >> 11

    got, sign = mags(port_fp, torch.from_numpy(y))
    exact = np.round(np.abs(y).astype(np.float64) / step)  # half to even
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(sign, y < 0)
    jax_mag, _ = mags(jax_fp, jnp.asarray(y))
    n = len(k)
    want = np.concatenate([k + 1, k + 1, k + 1, k])        # JAX: one up
    want[[n - 1, 2 * n - 1, 3 * n - 1]] = 128               # 2^-5 → 2^-6
    np.testing.assert_array_equal(jax_mag, want)


def test_fp12_bf16_tiny_values_differ_only_at_jax_exp2_margin():
    """A bf16 tensor with a run of values 1e-4 of the rest: in FP12 some
    of them land within JAX's exp2 margin of a tie (the case above);
    those, and only those, differ, each by one code step."""
    x = (np.random.default_rng(0).standard_normal((37, 300)) * 3).astype(
        np.float32)
    x.reshape(-1)[:300] *= 1e-4
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(_np(xj.astype(jnp.float32))).to(torch.bfloat16)
    pj, sj, _ = jax_fp.quantize_fp(xj, 12, 7, 512, use_pallas=False)
    pt, st, _ = port_fp.quantize_fp(xt, 12, 7, 512)
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    assert _codes_apart_at_jax_exp2_margin(pt, pj, st, xt, 12, 7, 512) > 0


def test_wrapper_on_the_cpu_is_the_plain_version():
    x = torch.randn(5, 300, generator=torch.Generator().manual_seed(0))
    packed, scales = port_kfp.quantize_fp_packed(x, 6, 2, 128)
    ref = port_kfp.quantize_fp_packed_plain(x, 6, 2, 128)
    assert torch.equal(packed, ref[0]) and torch.equal(scales, ref[1])
    codes, _ = port_kfp.quantize_fp_codes_plain(x, 6, 2, 128)
    assert codes.shape == (16, 128) and codes.dtype == torch.uint8
    assert torch.equal(packed, port_fp.pack_codes(codes.reshape(-1), 6))
    assert packed.shape == (16 * 128 * 6 // 8, )
    packed12, _ = port_kfp.quantize_fp_packed(x, 12, 7, 128)
    codes12, _ = port_kfp.quantize_fp_codes_plain(x, 12, 7, 128)
    assert codes12.dtype == torch.int16 and int(codes12.max()) < 4096
    assert torch.equal(packed12, port_fp.pack_codes(codes12.reshape(-1), 12))
    assert port_kfp.quantize_fp_packed.launches == 0
    with pytest.raises(TypeError, match="float"):
        port_kfp.quantize_fp_packed(torch.ones(4, dtype=torch.int32), 6, 2,
                                    128)
    with pytest.raises(ValueError, match="exponent bits"):
        port_fp.quantize_fp(x, q_bits=4, mantissa_bits=2)


def test_group_padding_matches_jax_group_view():
    from deepspeed_tpu.ops.pallas.quantizer import _group_view, _pick_block
    for n in (1, 1000, 4096, 512 * 513, 128 * 9000):
        for group_size in (128, 200, 512, 2048):
            gs, groups, padded = port_fp.fp_groups(n, group_size)
            tiles, _, jgroups = _group_view(jnp.zeros(n), gs,
                                            _pick_block(gs))
            assert (groups, padded) == (jgroups, tiles.shape[0])
            assert gs == max(128, group_size - group_size % 128)
            assert padded * gs >= n and math.ceil(n / gs) == groups


# ------------------------------------------- the kernel's arithmetic, emulated
def _kernel_codes(y, q_bits, man):
    """``csrc/fp_quantizer.cu``'s ``FpEnc::code`` step by step in numpy
    (int64 for its uint32/int32 arithmetic): the normal grid rounding on
    the fp32 bits, the subnormal one by adding 2^(24 - bias - m), the sign
    bit only on a nonzero code."""
    _, bias, _, maxv = port_fp._fmt(q_bits, man)
    u = y.view(np.uint32).astype(np.int64)
    a = u & 0x7FFFFFFF
    sh, base = 23 - man, (127 - bias) << 23
    kept = ((a >> sh) | (1 if man == 0 else 0)) & 1
    max_r = int(np.float32(maxv).view(np.uint32)) - base
    cn = (np.minimum(a + ((1 << (22 - man)) - 1) + kept - base, max_r)
          & 0xFFFFFFFF) >> sh
    sub = np.float32(2.0 ** (24 - bias - man))
    cs = ((a.astype(np.uint32).view(np.float32) + sub).view(np.uint32)
          .astype(np.int64) - int(sub.view(np.uint32)))
    c = np.where(a < int(np.float32(2.0 ** (1 - bias)).view(np.uint32)), cs,
                 cn)
    return c | np.where((u >> 31).astype(bool) & (c != 0),
                        1 << (q_bits - 1), 0)


def _kernel_pack(codes, q_bits):
    """The kernel's packing of 16 codes a unit: 24-bit values with the
    first code in the high bits, their bytes laid out by the three
    ``__byte_perm`` selectors of ``FpEnc::bytes12`` (or four bytes a word
    at 8 bits)."""
    c = codes.reshape(-1, 16).astype(np.uint32)

    def perm(x, y, sel):          # __byte_perm: bytes 0-3 of x, 4-7 of y
        both = np.stack([(x >> (8 * k)) & 0xFF for k in range(4)]
                        + [(y >> (8 * k)) & 0xFF for k in range(4)])
        return sum(both[(sel >> (4 * k)) & 0xF] << (8 * k)
                   for k in range(4))

    def bytes12(v):
        return [perm(v[0], v[1], 0x6012), perm(v[1], v[2], 0x5601),
                perm(v[2], v[3], 0x4560)]

    if q_bits == 6:
        v = [((c[:, 4 * k] << 6 | c[:, 4 * k + 1]) << 6 | c[:, 4 * k + 2])
             << 6 | c[:, 4 * k + 3] for k in range(4)]
        words = bytes12(v)
    elif q_bits == 12:
        v = [c[:, 2 * k] << 12 | c[:, 2 * k + 1] for k in range(8)]
        words = bytes12(v[:4]) + bytes12(v[4:])
    else:
        words = [perm(perm(c[:, 4 * k], c[:, 4 * k + 1], 0x0040),
                      perm(c[:, 4 * k + 2], c[:, 4 * k + 3], 0x0040),
                      0x5410) for k in range(4)]
    w = np.stack(words, axis=1).astype(np.uint32)
    return w.view(np.uint8).reshape(-1)       # little-endian words


@pytest.mark.parametrize("q_bits,man", [(6, 2), (12, 7), (6, 0), (6, 3),
                                        (8, 2), (12, 4), (12, 9)])
def test_kernel_grid_rounding_on_bits_equals_plain(q_bits, man):
    """The kernel's integer rounding gives ``encode_fp(round_to_fp_grid)``
    for every finite bf16 pattern within the grid's range, for every tie
    of every binade (both signs), the subnormal steps' ties, ±0, fp32
    subnormals and values past the maximum; and its packing gives
    ``pack_codes``'s bytes."""
    _, bias, max_unb, maxv = port_fp._fmt(q_bits, man)
    every_bf16 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    ys = [every_bf16[np.isfinite(every_bf16)
                     & (np.abs(every_bf16) <= maxv * 1.01)],
          np.float32(2.0 ** (1 - bias - man))
          * (np.arange(2 ** (man + 2)) + 0.5).astype(np.float32),
          np.array([0.0, -0.0, maxv, -maxv, 1e-40, -1e-40, maxv * 1.004,
                    2.0 ** (1 - bias)], np.float32)]
    k = np.arange(2 ** man, dtype=np.float64)
    for e in range(1 - bias, max_unb + 1):
        tie = ((1 + (k + 0.5) / 2 ** man) * 2.0 ** e).astype(np.float32)
        ys += [tie, -tie]
    y = np.concatenate(ys)
    y = np.concatenate([y, np.zeros(-len(y) % 16, np.float32)])
    want = port_fp.encode_fp(port_fp.round_to_fp_grid(
        torch.from_numpy(y), q_bits, man), q_bits, man).numpy()
    got = _kernel_codes(y, q_bits, man)
    np.testing.assert_array_equal(got, want)
    if q_bits in (6, 8, 12):
        np.testing.assert_array_equal(
            _kernel_pack(got, q_bits),
            port_fp.pack_codes(torch.from_numpy(want), q_bits).numpy())


def test_quantize_fp_makes_one_launch_and_packs_nothing(monkeypatch):
    """The card path of ``quantize_fp``: one call of the packed kernel's
    wrapper, one C launch handed x's pointer, the padded group count and
    the format, an output of groups_pad · gs · q_bits / 8 bytes, and no
    ``pack_codes``."""
    import contextlib

    def refuse(*a, **k):
        raise AssertionError("pack_codes called")

    calls, launches = [], []

    class Lib:
        def ds_quantize_fp_packed(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(port_kfp.FPQuantizerBuilder, "load",
                        lambda self: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(port_fp, "pack_codes", refuse)
    monkeypatch.setattr(port_kfp, "pack_codes", refuse)

    def on_the_card(x, q_bits, man, gs):      # quantize_fp_packed on CUDA
        launches.append(q_bits)
        packed, scales, _ = port_kfp._launch(x, q_bits, man, gs)
        return packed, scales

    monkeypatch.setattr(port_kfp, "quantize_fp_packed", on_the_card)
    x = torch.randn(4096, 110).to(torch.bfloat16)
    for q_bits, man in ((6, 2), (12, 7)):
        calls.clear()
        packed, scales, meta = port_fp.quantize_fp(x, q_bits, man, 512)
        gs, groups, padded = port_fp.fp_groups(x.numel(), 512)
        (args, ) = calls
        assert args[:2] == (x.data_ptr(), 1)
        assert args[2:4] == (packed.data_ptr(), scales.data_ptr())
        assert args[4:9] == (x.numel(), padded, 512, q_bits, man)
        assert args[9] == port_fp._fmt(q_bits, man)[3]
        assert packed.shape == (padded * 512 * q_bits // 8, )
        assert scales.shape == (padded, ) and meta[2] == groups
    assert launches == [6, 12]
