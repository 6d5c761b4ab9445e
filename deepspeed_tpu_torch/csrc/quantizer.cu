// Blockwise symmetric int8/int4 quantization and its inverse for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/quantizer.py:
// quantize_blockwise (:67, _quant_kernel :31) and dequantize_blockwise
// (:105, _dequant_kernel :40).  The input is viewed as rows of `gs`
// consecutive elements (row-major flatten; the last row zero-padded):
//   scale = absmax == 0 ? 1 : absmax / qmax          (true fp32 division)
//   q     = clamp(rint(x / scale), -qmax, qmax)      (half to even, as
//                                                      jnp.round)
// int4 values stay in int8 storage at +-7.  The inverse writes
// float(q) * scale rounded once to the output dtype, for the first n
// elements only.
//
// Design.  Quantize: one warp per group (8 groups per 256-thread block);
// each lane takes 4 consecutive elements per pass (one 16- or 8-byte load
// where the input is aligned), the warp reduces its absmax through shuffles,
// then a second pass over the same elements (now in L1/L2) writes 4 int8 as
// one 32-bit store per lane, and lane 0 the scale.  Dequantize: one thread
// per 4 elements (a 32-bit load of q, one scale, a 16- or 8-byte store).
//
// What bounds both on an H100: bytes.  Quantize reads each input element
// once and writes one byte (plus 4 bytes per group); dequantize reads one
// byte and writes the output element; both do a handful of operations per
// element, far below the ~295 per byte where compute would bind.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQWarps = 8;
constexpr int kDThreads = 256;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
  __device__ static void load4(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static void load4(const __nv_bfloat16* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  __device__ static void store4(__nv_bfloat16* p, const float* f) {
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&a);
    v.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
  }
};

template <>
struct Cvt<__half> {
  __device__ static float to_f(__half x) { return __half2float(x); }
  __device__ static __half from_f(float x) { return __float2half_rn(x); }
  __device__ static void load4(const __half* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  __device__ static void store4(__half* p, const float* f) {
    __half2 a = __floats2half2_rn(f[0], f[1]);
    __half2 b = __floats2half2_rn(f[2], f[3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&a);
    v.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
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

__device__ __forceinline__ signed char quant1(float v, float scale,
                                              float qmax) {
  const float r = fminf(fmaxf(rintf(v / scale), -qmax), qmax);
  return static_cast<signed char>(static_cast<int>(r));
}

template <typename T>
__global__ void __launch_bounds__(kQWarps * 32)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, long long n, long long groups,
                    int gs, float qmax, bool vec) {
  const long long g = (long long)blockIdx.x * kQWarps + threadIdx.x / 32;
  if (g >= groups) return;
  const int lane = threadIdx.x % 32;
  const long long base = g * gs;
  float amax = 0.f;
  for (int j = lane * 4; j < gs; j += 128) {
    float f[4];
    load4(x, base + j, n, vec, f);
#pragma unroll
    for (int k = 0; k < 4; ++k) amax = fmaxf(amax, fabsf(f[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax == 0.f ? 1.f : amax / qmax;
  for (int j = lane * 4; j < gs; j += 128) {
    float f[4];
    load4(x, base + j, n, vec, f);
    char4 o;
    o.x = quant1(f[0], scale, qmax);
    o.y = quant1(f[1], scale, qmax);
    o.z = quant1(f[2], scale, qmax);
    o.w = quant1(f[3], scale, qmax);
    *reinterpret_cast<char4*>(q + base + j) = o;
  }
  if (lane == 0) scales[g] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kDThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, T* __restrict__ out,
                      long long n, int gs, bool vec) {
  const long long i =
      ((long long)blockIdx.x * kDThreads + threadIdx.x) * 4;
  if (i >= n) return;
  // gs is a multiple of 4, so the 4 values share one group, and q holds
  // groups * gs >= i + 4 values
  const char4 c = *reinterpret_cast<const char4*>(q + i);
  const float s = scales[i / gs];
  const float f[4] = {static_cast<float>(c.x) * s, static_cast<float>(c.y) * s,
                      static_cast<float>(c.z) * s, static_cast<float>(c.w) * s};
  if (vec && i + 4 <= n) {
    Cvt<T>::store4(out + i, f);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < n) out[i + k] = Cvt<T>::from_f(f[k]);
}

bool aligned(const void* p, int dtype) {
  return reinterpret_cast<uintptr_t>(p) % (dtype == 0 ? 16 : 8) == 0;
}

}  // namespace

// x: n elements (dtype 0 fp32, 1 bf16, 2 fp16); q: [groups, gs] int8;
// scales: [groups] fp32; gs a multiple of 128.  Returns a cudaError_t code.
extern "C" int ds_quantize_blockwise(const void* x, int dtype, void* q,
                                     void* scales, long long n,
                                     long long groups, int gs, float qmax,
                                     void* stream) {
  if (n < 0 || groups < 0 || gs <= 0 || gs % 128 || groups * gs < n)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((groups + kQWarps - 1) / kQWarps);
  const bool vec = aligned(x, dtype);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (dtype == 0)
    quantize_kernel<float><<<blocks, kQWarps * 32, 0, st>>>(
        static_cast<const float*>(x), qp, sp, n, groups, gs, qmax, vec);
  else if (dtype == 1)
    quantize_kernel<__nv_bfloat16><<<blocks, kQWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, n, groups, gs, qmax,
        vec);
  else if (dtype == 2)
    quantize_kernel<__half><<<blocks, kQWarps * 32, 0, st>>>(
        static_cast<const __half*>(x), qp, sp, n, groups, gs, qmax, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q: [groups, gs] int8 with groups * gs >= n; out: n elements of dtype.
extern "C" int ds_dequantize_blockwise(const void* q, const void* scales,
                                       void* out, int dtype, long long n,
                                       int gs, void* stream) {
  if (n < 0 || gs <= 0 || gs % 128) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long vecs = (n + 3) / 4;
  const unsigned blocks = (unsigned)((vecs + kDThreads - 1) / kDThreads);
  const bool vec = aligned(out, dtype);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  if (dtype == 0)
    dequantize_kernel<float><<<blocks, kDThreads, 0, st>>>(
        qp, sp, static_cast<float*>(out), n, gs, vec);
  else if (dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<blocks, kDThreads, 0, st>>>(
        qp, sp, static_cast<__nv_bfloat16*>(out), n, gs, vec);
  else if (dtype == 2)
    dequantize_kernel<__half><<<blocks, kDThreads, 0, st>>>(
        qp, sp, static_cast<__half*>(out), n, gs, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
