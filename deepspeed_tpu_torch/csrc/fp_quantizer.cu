// Per-group FP grid quantization (FP6 e3m2, FP12 e4m7 and any format of
// 2-7 exponent bits and at most 16 bits) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel of deepspeed_tpu/ops/fp_quantizer.py:
// `quantize_fp` (:155), launched at :188, kernel body `_fpq_kernel` (:144).
// The input is viewed as rows of `gs` consecutive elements (row-major
// flatten; zeros past n).  For each row (group), with e the exponent bits,
// bias = 2^(e-1) - 1, max_unb = 2^e - 1 - bias and maxv the grid maximum:
//   scale = absmax == 0 ? 1 : absmax / maxv          (true fp32 division)
//   y     = x / scale                                (true fp32 division)
//   ex    = clamp(floor(log2 |y|), 1 - bias, max_unb) (from the fp32 bits)
//   q     = min(rint(|y| / 2^(ex - m)) * 2^(ex - m), maxv)
//   code  = sign | exponent field | mantissa field of q (subnormal when
//           q < 2^(1 - bias)); the sign bit only where q > 0, as JAX's
//           `encode_fp` sees sign(y) * q.
// Powers of two are built from their exponent bits, so the rounding is
// exact and half to even (JAX's `jnp.round`).  Codes are written as uint8
// for q_bits <= 8 and as 16 bits above; one fp32 scale per row.  Packing
// (4 x 6 b -> 3 B, 2 x 12 b -> 3 B) is left to the caller.
//
// Design (B5's quantize kernel, csrc/quantizer.cu).  One warp per group,
// 8 groups per 256-thread block; each lane takes 4 consecutive elements
// per pass (one 16- or 8-byte load where the input is aligned), the warp
// reduces its absmax through shuffles, then a second pass over the same
// elements (now in L1/L2) encodes them and writes 4 codes as one 32-bit
// (uint8 codes) or 64-bit (16-bit codes) store per lane; lane 0 writes the
// scale.
//
// What bounds it on an H100: bytes.  It reads each input element once and
// writes one or two bytes of code (plus 4 bytes per group), with a few
// dozen integer and fp32 operations per element, far below the ~295
// operations per byte where compute would bind.  No --use_fast_math: both
// divisions must be IEEE so that the codes and scales equal the plain
// version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static void load4(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static void load4(const __nv_bfloat16* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

template <>
struct Cvt<__half> {
  __device__ static float to_f(__half x) { return __half2float(x); }
  __device__ static void load4(const __half* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

// elements i..i+3 of x (zeros past n); one vector load when all 4 are in
// range and the input is aligned
template <typename T>
__device__ __forceinline__ void load4(const T* x, long long i, long long n,
                                      bool vec, float* f) {
  if (vec && i + 4 <= n) {
    Cvt<T>::load4(x + i, f);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = i + k < n ? Cvt<T>::to_f(x[i + k]) : 0.f;
}

struct Format {
  int q_bits, m, bias, max_unb;
  float maxv;
};

// 2^e for e in [-126, 127], exact.
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ int floor_log2(float a) {
  return (int)((__float_as_uint(a) >> 23) & 0xFF) - 127;
}

// One value, already divided by its group's scale, -> its code.
__device__ __forceinline__ uint32_t fp_code(float y, const Format& f) {
  const float a = fabsf(y);
  const int ex = min(max(floor_log2(fmaxf(a, 1.17549435e-38f)), 1 - f.bias),
                     f.max_unb);
  // |y| / 2^(ex - m) and the product back are exact (powers of two)
  const float q =
      fminf(rintf(a * pow2(f.m - ex)) * pow2(ex - f.m), f.maxv);
  if (q == 0.f) return 0u;
  const uint32_t sign = y < 0.f ? 1u : 0u;
  uint32_t efield, mfield;
  if (q >= pow2(1 - f.bias)) {           // normal: q = (1 + M / 2^m) 2^E
    const uint32_t bits = __float_as_uint(q);
    efield = (uint32_t)(floor_log2(q) + f.bias);
    mfield = (bits >> (23 - f.m)) & ((1u << f.m) - 1u);
  } else {                                // subnormal: q = M 2^(1 - bias - m)
    efield = 0u;
    mfield = (uint32_t)(q * pow2(f.m - 1 + f.bias));
  }
  return (sign << (f.q_bits - 1)) | (efield << f.m) | mfield;
}

__device__ __forceinline__ void store4(uint8_t* p, const uint32_t* c) {
  *reinterpret_cast<uchar4*>(p) = make_uchar4(c[0], c[1], c[2], c[3]);
}

__device__ __forceinline__ void store4(uint16_t* p, const uint32_t* c) {
  *reinterpret_cast<ushort4*>(p) = make_ushort4(c[0], c[1], c[2], c[3]);
}

template <typename T, typename C>
__global__ void __launch_bounds__(kWarps * 32)
    fp_quantize_kernel(const T* __restrict__ x, C* __restrict__ codes,
                       float* __restrict__ scales, long long n,
                       long long groups, int gs, Format f, bool vec) {
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= groups) return;
  const int lane = threadIdx.x % 32;
  const long long base = g * gs;
  float amax = 0.f;
  for (int j = lane * 4; j < gs; j += 128) {
    float v[4];
    load4(x, base + j, n, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) amax = fmaxf(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax == 0.f ? 1.f : amax / f.maxv;
  for (int j = lane * 4; j < gs; j += 128) {
    float v[4];
    load4(x, base + j, n, vec, v);
    uint32_t c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = fp_code(v[k] / scale, f);
    store4(codes + base + j, c);
  }
  if (lane == 0) scales[g] = scale;
}

template <typename C>
int launch(const void* x, int dtype, void* codes, float* scales, long long n,
           long long groups, int gs, const Format& f, cudaStream_t st) {
  const unsigned blocks = (unsigned)((groups + kWarps - 1) / kWarps);
  const bool vec =
      reinterpret_cast<uintptr_t>(x) % (dtype == 0 ? 16 : 8) == 0;
  C* cp = static_cast<C*>(codes);
  if (dtype == 0)
    fp_quantize_kernel<float, C><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), cp, scales, n, groups, gs, f, vec);
  else if (dtype == 1)
    fp_quantize_kernel<__nv_bfloat16, C><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cp, scales, n, groups, gs, f,
        vec);
  else if (dtype == 2)
    fp_quantize_kernel<__half, C><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __half*>(x), cp, scales, n, groups, gs, f, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x: n elements (dtype 0 fp32, 1 bf16, 2 fp16); codes: [groups, gs] of
// uint8 (q_bits <= 8) or 16 bits (q_bits <= 16); scales: [groups] fp32;
// gs a multiple of 128 with groups * gs >= n.  The format is q_bits with
// mantissa_bits of mantissa (2-7 exponent bits) and grid maximum
// maxv.  Returns a cudaError_t code.
extern "C" int ds_quantize_fp(const void* x, int dtype, void* codes,
                              void* scales, long long n, long long groups,
                              int gs, int q_bits, int mantissa_bits,
                              float maxv, void* stream) {
  const int exp_bits = q_bits - mantissa_bits - 1;
  if (n < 0 || groups < 0 || gs <= 0 || gs % 128 || groups * gs < n ||
      mantissa_bits < 0 || exp_bits < 2 || exp_bits > 7 || q_bits > 16)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  Format f;
  f.q_bits = q_bits;
  f.m = mantissa_bits;
  f.bias = (1 << (exp_bits - 1)) - 1;
  f.max_unb = ((1 << exp_bits) - 1) - f.bias;
  f.maxv = maxv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scales);
  if (q_bits <= 8)
    return launch<uint8_t>(x, dtype, codes, sp, n, groups, gs, f, st);
  return launch<uint16_t>(x, dtype, codes, sp, n, groups, gs, f, st);
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
