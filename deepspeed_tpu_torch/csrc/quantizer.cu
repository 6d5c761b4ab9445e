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
// Design.  Quantize reads each element once: the groups' load
// scheme is csrc/group_quant.cuh (a team of 8-32 lanes a group, each lane
// holding its 16-element units in registers between the absmax and the
// encode, every load of a group issued before its reduction, 16-byte loads,
// warps striding over the groups); each unit's 16 int8 go out as one
// 16-byte store, the scale once a group.  An element is
//   y = clamp(x / scale, -qmax, qmax)        (the IEEE division: nvcc's
//                                             fast path with the reciprocal
//                                             taken once a group instead
//                                             held more registers and ran
//                                             slower)
//   q = low byte of bits(y + 1.5 * 2^23)     (the add rounds half to even at
//                                             an ulp of 1: rint(y), two's
//                                             complement in the low bits)
// which equals clamp(rint(x / scale)) since qmax is an integer.
//
// The transposed route reads a weight as nn.Linear keeps it: x = p^T with
// p row-major [out][in] (x is the JAX [in, out] kernel, whose row-major
// flatten is what is grouped), so a group is gs = 128 or 256 consecutive
// `out` rows of one column i of p, its index i * (out / gs) + out-block.
// A block stages a tile of p (gs rows x 64 columns, 128-byte rows) in
// shared memory by 16-byte cp.async copies, each row's eight 16-byte
// chunks XOR-swizzled by (row / 16) % 8, then each lane reads 16 rows of a
// column pair as 4-byte words (conflict-free at gs = 128), reduces the two
// columns' absmax over its team (gs / 16 lanes), and writes 16 int8 of
// each column as one 16-byte store: no transposed copy of the weight.
// fp32 tiles hold 32 columns and a lane one column.  It needs out % gs
// == 0, 16-byte rows of p (in % 8 == 0 in bf16/fp16, in % 4 == 0 in
// fp32) and p 16-byte aligned; the host rule
// (ops/kernels/quantizer.py:quantize_route) sends other layouts to the
// copy route.
//
// Dequantize: one thread per 4 elements (a 32-bit load of q, one scale, a
// 16- or 8-byte store).
//
// What bounds both on an H100: bytes.  Quantize reads each input element
// once and writes one byte (plus 4 bytes per group); dequantize reads one
// byte and writes the output element.  Quantize issues ~18 instructions
// an element (the IEEE division's ~12 the most: MUFU.RCP, five FFMA, the
// FCHK range check and its branch), below the ~26 issue slots an element
// that the byte bound leaves at 2 bytes in and 1 out.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_quant.cuh"

namespace {

constexpr int kDThreads = 256;
constexpr float kRound = 12582912.f;  // 1.5 * 2^23: y + kRound rounds y

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float from_f(float x) { return x; }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
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
  __device__ static __half from_f(float x) { return __float2half_rn(x); }
  __device__ static void store4(__half* p, const float* f) {
    __half2 a = __floats2half2_rn(f[0], f[1]);
    __half2 b = __floats2half2_rn(f[2], f[3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&a);
    v.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
  }
};

// clamp(rint(y)) in the low byte (two's complement), y = v / scale
__device__ __forceinline__ uint32_t quant1(float y, float qmax) {
  return __float_as_uint(fminf(fmaxf(y, -qmax), qmax) + kRound);
}

// the low bytes of four words, in order, as one word
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// group_quant.cuh's encoder: a unit's 16 int8 as one 16-byte store
struct Int8Enc {
  int8_t* q;
  float* scales;
  float top;  // qmax
  __device__ void store(long long unit, const float* y) const {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = low_bytes(quant1(y[4 * k], top), quant1(y[4 * k + 1], top),
                       quant1(y[4 * k + 2], top), quant1(y[4 * k + 3], top));
    *reinterpret_cast<uint4*>(q + unit * gq::kUnit) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// --------------------------------------------------- transposed route
// Words of the staged tile (4 bytes: two bf16/fp16 elements, low one
// first, or one fp32) -> element values and their absmax.
template <typename T>
struct Words;

template <>
struct Words<float> {
  __device__ static float lo(uint32_t w) { return __uint_as_float(w); }
  __device__ static uint32_t amax(uint32_t a, uint32_t b) {
    return __float_as_uint(fmaxf(fabsf(__uint_as_float(a)),
                                 fabsf(__uint_as_float(b))));
  }
};

template <>
struct Words<__nv_bfloat16> {
  __device__ static float lo(uint32_t w) { return gq::bf16_lo(w); }
  __device__ static float hi(uint32_t w) { return gq::bf16_hi(w); }
  __device__ static uint32_t amax(uint32_t a, uint32_t b) {
    return gq::amax2_bf16(a, b);
  }
};

template <>
struct Words<__half> {
  __device__ static float lo(uint32_t w) { return gq::f16_lo(w); }
  __device__ static float hi(uint32_t w) { return gq::f16_hi(w); }
  __device__ static uint32_t amax(uint32_t a, uint32_t b) {
    return gq::amax2_f16(a, b);
  }
};

// One column's 16 values (element `half` of each word) -> 16 int8 at dst
template <typename T>
__device__ __forceinline__ void store_column(const uint32_t* w, int half,
                                             float scale, float qmax,
                                             int8_t* dst) {
  float y[gq::kUnit];
#pragma unroll
  for (int i = 0; i < gq::kUnit; ++i) {
    if constexpr (sizeof(T) == 4)
      y[i] = Words<T>::lo(w[i]) / scale;
    else
      y[i] = (half ? Words<T>::hi(w[i]) : Words<T>::lo(w[i])) / scale;
  }
  uint32_t c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = low_bytes(quant1(y[4 * k], qmax), quant1(y[4 * k + 1], qmax),
                     quant1(y[4 * k + 2], qmax), quant1(y[4 * k + 3], qmax));
  *reinterpret_cast<uint4*>(dst) = make_uint4(c[0], c[1], c[2], c[3]);
}

// x = p^T, p row-major [out][in]; group (i, ob) = p[ob GS .. ob GS + GS, i]
// goes to q row i * (out / GS) + ob.  A tile is GS rows of p by 32 words
// (128 bytes: 64 bf16/fp16 or 32 fp32 columns); grid (ceil(in / tile
// columns), out / GS).  A lane takes one word column (two bf16/fp16
// columns or one fp32 column) of 16 rows.
template <typename T, int GS>
__global__ void __launch_bounds__(gq::kThreads)
    quantize_t_kernel(const T* __restrict__ p, int8_t* __restrict__ q,
                      float* __restrict__ scales, int out, int in,
                      float qmax) {
  constexpr int EPW = 4 / sizeof(T);  // elements a word
  constexpr int TL = GS / 16;         // lanes of a word column: 16 rows each
  constexpr int COLS = 32 / TL;       // word columns a warp
  constexpr int WARPS = gq::kThreads / 32;
  __shared__ __align__(16) uint32_t tile[GS * 32];
  const int ob = blockIdx.y, i0 = blockIdx.x * 32 * EPW;
  const T* src = p + (long long)ob * GS * in;
  for (int idx = threadIdx.x; idx < GS * 8; idx += gq::kThreads) {
    const int o = idx / 8, c = idx % 8, i = i0 + c * 4 * EPW;
    const bool ok = i < in;  // in is whole chunks: a chunk is in or out
    gq::cp_async16(tile + o * 32 + ((c ^ ((o >> 4) & 7)) << 2),
                   src + (long long)o * in + (ok ? i : 0), ok);
  }
  gq::cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = lane % TL;  // the lane's 16 rows: 16 s ..
  const long long blocks_out = out / GS;
  for (int wc = warp * COLS + lane / TL; wc < 32; wc += WARPS * COLS) {
    const int col = (((wc >> 2) ^ (s & 7)) << 2) | (wc & 3);
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = tile[(16 * s + k) * 32 + col];
    uint32_t m = Words<T>::amax(w[0], w[1]);
#pragma unroll
    for (int k = 2; k < 16; ++k) m = Words<T>::amax(m, w[k]);
#pragma unroll
    for (int o = TL / 2; o > 0; o >>= 1)
      m = Words<T>::amax(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int i = i0 + EPW * wc;
    if (i >= in) continue;  // the word column lies past p's columns
#pragma unroll
    for (int h = 0; h < EPW; ++h) {
      float a;
      if constexpr (EPW == 1)
        a = Words<T>::lo(m);
      else
        a = h ? Words<T>::hi(m) : Words<T>::lo(m);
      const float scale = a == 0.f ? 1.f : a / qmax;
      const long long g = (long long)(i + h) * blocks_out + ob;
      store_column<T>(w, h, scale, qmax, q + g * GS + 16 * s);
      if (s == 0) scales[g] = scale;
    }
  }
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

template <typename T>
void launch_t(const T* p, int8_t* q, float* scales, int out, int in, int gs,
              float qmax, dim3 grid, cudaStream_t st) {
  if (gs == 128)
    quantize_t_kernel<T, 128>
        <<<grid, gq::kThreads, 0, st>>>(p, q, scales, out, in, qmax);
  else
    quantize_t_kernel<T, 256>
        <<<grid, gq::kThreads, 0, st>>>(p, q, scales, out, in, qmax);
}

bool aligned(const void* p, int dtype) {
  return reinterpret_cast<uintptr_t>(p) % (dtype == 0 ? 16 : 8) == 0;
}

}  // namespace

// The contiguous route.  x: n elements (dtype 0 fp32, 1 bf16, 2 fp16);
// q: [groups, gs] int8; scales: [groups] fp32; gs a multiple of 128.
// Returns a cudaError_t code.
extern "C" int ds_quantize_blockwise(const void* x, int dtype, void* q,
                                     void* scales, long long n,
                                     long long groups, int gs, float qmax,
                                     void* stream) {
  if (n < 0 || groups < 0 || gs <= 0 || gs % 128 || groups * gs < n)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Int8Enc enc{static_cast<int8_t*>(q), static_cast<float*>(scales),
                    qmax};
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

// The transposed route.  p: row-major [out, in] (dtype 0 fp32, 1 bf16,
// 2 fp16), 16-byte aligned, with 16-byte rows (in * element size % 16 ==
// 0); the tensor quantized is p^T ([in, out], row-major flatten), in
// groups of gs = 128 or 256 with out % gs == 0; q: [in * out / gs, gs]
// int8; scales: [in * out / gs] fp32.  Returns a cudaError_t code.
extern "C" int ds_quantize_blockwise_t(const void* p, int dtype, void* q,
                                       void* scales, int out, int in, int gs,
                                       float qmax, void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  if (out <= 0 || in <= 0 || (gs != 128 && gs != 256) || out % gs ||
      (in * esz) % 16 || reinterpret_cast<uintptr_t>(p) % 16 ||
      out / gs > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = 128 / esz;  // columns of p a tile
  const dim3 grid((in + cols - 1) / cols, out / gs);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (dtype == 0)
    launch_t(static_cast<const float*>(p), qp, sp, out, in, gs, qmax, grid,
             st);
  else if (dtype == 1)
    launch_t(static_cast<const __nv_bfloat16*>(p), qp, sp, out, in, gs, qmax,
             grid, st);
  else
    launch_t(static_cast<const __half*>(p), qp, sp, out, in, gs, qmax, grid,
             st);
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
