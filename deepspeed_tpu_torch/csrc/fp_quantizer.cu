// Per-group FP grid quantization to packed codes (FP6 e3m2, FP12 e4m7 and
// any format of 6, 8 or 12 bits with 2-7 exponent bits) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of deepspeed_tpu/ops/fp_quantizer.py:
// `quantize_fp` (:155), launched at :188, kernel body `_fpq_kernel` (:144),
// and the code packing that XLA fused beside it there (`pack_codes`, :106).
// The input is viewed as rows of `gs` consecutive elements (row-major
// flatten; zeros past n).  For each row (group), with e the exponent bits,
// bias = 2^(e-1) - 1, max_unb = 2^e - 1 - bias and maxv the grid maximum:
//   scale = absmax == 0 ? 1 : absmax / maxv          (true fp32 division)
//   y     = x / scale                                (true fp32 division)
//   q     = |y| rounded half to even onto the grid, saturated at maxv
//           (subnormal steps 2^(1 - bias - m) below 2^(1 - bias))
//   code  = sign | exponent field | mantissa field of q; the sign bit only
//           where q > 0, as JAX's `encode_fp` sees sign(y) * q.
// Codes are packed as pack_codes packs them: 4 x 6 bits -> 3 bytes and
// 2 x 12 bits -> 3 bytes, big-endian within the 3 bytes (the first code in
// the high bits), 8 bits one byte each; one fp32 scale per row.
//
// Design.  The load scheme is csrc/group_quant.cuh: a team of 8-32
// lanes a group, each lane holding its 16-element units in registers
// between the absmax and the encode (one pass, 16-byte loads, every load
// of a group issued before its reduction).  A unit's 16 codes pack into 12
// bytes (FP6, three 4-byte stores), 24 (FP12, three 8-byte stores) or 16
// (8 bits, one 16-byte store): a unit's bytes are its own, since groups
// (multiples of 128 codes) never share a byte.  The grid rounding works on
// the fp32 bits of |y|, with no rintf, no products by powers of two and
// one comparison:
//   normal (|y| >= 2^(1 - bias)): add (2^(22 - m) - 1) plus the kept lsb
//     to the bits and drop the low 23 - m: round half to even, a carry
//     moving into the exponent; rebased by bias and clamped at maxv's
//     bits, the shift leaves exponent field << m | mantissa field;
//   subnormal: |y| + 2^(24 - bias - m) rounds |y| half to even at the step
//     2^(1 - bias - m) (that sum's ulp), whose bits less the constant's are
//     the code (2^m, the smallest normal, where it rounds up).
// About 14 integer and fp32 operations a code besides the division; the
// 16 divisions of a unit come first, so the format's constants stay in
// registers across the codes.
//
// What bounds it on an H100: with packed codes it moves 2.75 (FP6) or 3.5
// (FP12) bytes a bf16 element; a whole group's path issues ~31-33
// instructions an element (the IEEE division ~12 of them: MUFU.RCP, five
// FFMA, the FCHK range check and its branch), about as long at 4 warp
// instructions a clock an SM as the bytes take at 3.35 TB/s: the two
// bounds are close (chip_smoke.py stage 21 counts that path in the SASS),
// and neither is reached.  No --use_fast_math: both divisions must be
// IEEE so that the codes and scales equal the plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

#include "group_quant.cuh"

namespace {

// group_quant.cuh's encoder: a unit's 16 elements -> Q-bit packed codes
template <int Q>
struct FpEnc {
  uint8_t* out;
  float* scales;
  float top;             // maxv
  int sh;                // 23 - m: the dropped bits of a normal value
  uint32_t half;         // 2^(22 - m) - 1
  uint32_t lsb_or;       // 1 where m = 0 (the kept lsb is the implicit 1)
  int base;              // (127 - bias) << 23: rebases the exponent
  int max_r;             // bits(maxv) - base
  uint32_t min_normal;   // bits(2^(1 - bias))
  float sub;             // 2^(24 - bias - m): its ulp is the subnormal step
  uint32_t sub_bits;
  static constexpr uint32_t sign = 1u << (Q - 1);

  __device__ uint32_t code(float y) const {
    const uint32_t u = __float_as_uint(y), a = u & 0x7fffffffu;
    const int r =
        min((int)(a + half + (((a >> sh) | lsb_or) & 1u)) - base, max_r);
    const uint32_t cn = (uint32_t)r >> sh;
    const uint32_t cs = __float_as_uint(__uint_as_float(a) + sub) - sub_bits;
    const uint32_t c = a < min_normal ? cs : cn;
    return c | ((u >> 31) && c ? sign : 0u);
  }

  // 4 x 24-bit values, each the bytes b0 b1 b2 from its high bits down ->
  // 12 bytes in that order, as 3 words
  __device__ static void bytes12(const uint32_t* v, uint32_t* w) {
    w[0] = __byte_perm(v[0], v[1], 0x6012);
    w[1] = __byte_perm(v[1], v[2], 0x5601);
    w[2] = __byte_perm(v[2], v[3], 0x4560);
  }

  __device__ void store(long long unit, const float* y) const {
    uint32_t c[gq::kUnit];
#pragma unroll
    for (int i = 0; i < gq::kUnit; ++i) c[i] = code(y[i]);
    if constexpr (Q == 6) {  // 16 codes -> 12 bytes
      uint32_t v[4], w[3];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = (((c[4 * k] << 6 | c[4 * k + 1]) << 6 | c[4 * k + 2]) << 6) |
               c[4 * k + 3];
      bytes12(v, w);
      uint32_t* o = reinterpret_cast<uint32_t*>(out + unit * 12);
      o[0] = w[0];
      o[1] = w[1];
      o[2] = w[2];
    } else if constexpr (Q == 12) {  // 16 codes -> 24 bytes
      uint32_t v[8], w[6];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = c[2 * k] << 12 | c[2 * k + 1];
      bytes12(v, w);
      bytes12(v + 4, w + 3);
      uint2* o = reinterpret_cast<uint2*>(out + unit * 24);
      o[0] = make_uint2(w[0], w[1]);
      o[1] = make_uint2(w[2], w[3]);
      o[2] = make_uint2(w[4], w[5]);
    } else {  // 16 codes -> 16 bytes
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = __byte_perm(__byte_perm(c[4 * k], c[4 * k + 1], 0x0040),
                           __byte_perm(c[4 * k + 2], c[4 * k + 3], 0x0040),
                           0x5410);
      *reinterpret_cast<uint4*>(out + unit * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

float pow2f(int e) { return ldexpf(1.f, e); }

uint32_t bits_of(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

template <int Q>
int launch(const void* x, int dtype, void* out, void* scales, long long n,
           long long groups, int gs, int m, int bias, float maxv,
           cudaStream_t st) {
  FpEnc<Q> enc;
  enc.out = static_cast<uint8_t*>(out);
  enc.scales = static_cast<float*>(scales);
  enc.top = maxv;
  enc.sh = 23 - m;
  enc.half = (1u << (22 - m)) - 1u;
  enc.lsb_or = m == 0 ? 1u : 0u;
  enc.base = (127 - bias) << 23;
  enc.max_r = (int)bits_of(maxv) - enc.base;
  enc.min_normal = bits_of(pow2f(1 - bias));
  enc.sub = pow2f(24 - bias - m);
  enc.sub_bits = bits_of(enc.sub);
  if (dtype == 0)
    return (int)gq::launch(static_cast<const float*>(x), n, groups, gs, enc,
                           st);
  if (dtype == 1)
    return (int)gq::launch(static_cast<const __nv_bfloat16*>(x), n, groups,
                           gs, enc, st);
  if (dtype == 2)
    return (int)gq::launch(static_cast<const __half*>(x), n, groups, gs, enc,
                           st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: n elements (dtype 0 fp32, 1 bf16, 2 fp16); out: groups * gs * q_bits
// / 8 bytes of packed codes; scales: [groups] fp32; gs a multiple of 128
// with groups * gs >= n.  The format is q_bits (6, 8 or 12) with
// mantissa_bits of mantissa (2-7 exponent bits) and grid maximum maxv.
// Returns a cudaError_t code.
extern "C" int ds_quantize_fp_packed(const void* x, int dtype, void* out,
                                     void* scales, long long n,
                                     long long groups, int gs, int q_bits,
                                     int mantissa_bits, float maxv,
                                     void* stream) {
  const int exp_bits = q_bits - mantissa_bits - 1;
  if (n < 0 || groups < 0 || gs <= 0 || gs % 128 || groups * gs < n ||
      mantissa_bits < 0 || exp_bits < 2 || exp_bits > 7 ||
      (q_bits != 6 && q_bits != 8 && q_bits != 12) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const int m = mantissa_bits, bias = (1 << (exp_bits - 1)) - 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bits == 6)
    return launch<6>(x, dtype, out, scales, n, groups, gs, m, bias, maxv, st);
  if (q_bits == 12)
    return launch<12>(x, dtype, out, scales, n, groups, gs, m, bias, maxv,
                      st);
  return launch<8>(x, dtype, out, scales, n, groups, gs, m, bias, maxv, st);
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
