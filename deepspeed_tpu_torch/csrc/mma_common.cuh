// Tensor-core building blocks shared by the bf16/fp16 attention kernels
// of csrc/flash_attention.cu (B1), csrc/flash_bias.cu (B10) and
// csrc/block_sparse_attention.cu (B9), sm_90a.
//
// - Tc<T>: mma.sync.m16n8k16 (bf16 or f16 in, fp32 accumulate) and the
//   packing of fp32 values into two 16-bit halves, plain or split into
//   hi = round(x) and lo = round(x - hi), so that an fp32 operand (P, dS)
//   keeps about 16 (bf16) or 22 (fp16) significant bits in two mmas;
// - ex2 (one MUFU instruction), pow2, and the fp16 dS row scales
//   (ds_exp, ds_rescale, scale_rows);
// - ldmatrix fragments (load_a, load_b, load_bt) from tiles kept in the
//   input type in shared memory with rows padded by 16 bytes;
// - cp.async copies (16 and 4 bytes, zero-filling what lies past the
//   sequence or the head dim) and stage_rows, which fills a ring slot
//   (stage_rows_at: the same from a table of gathered rows);
// - store_frag: an fp32 fragment rounded once into the output rows.
// Everything here is inline device code in an anonymous namespace: each
// source that includes it compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr float kDeadRowLse = -1e30f;  // lse of a row that sees no key
constexpr int kMmaThreads = 128;       // 4 warps
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// How stage_rows fills a slot: 16-byte cp.async copies (D % 8 == 0,
// 16-byte aligned rows), 4-byte ones (D even, 4-byte aligned rows), or
// element copies (synchronous).
constexpr int kCopyElem = 0, kCopy16 = 1, kCopy4 = 2;

template <typename T>
struct Cvt;

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Cvt<__half> {
  __device__ static float to_f(__half x) { return __half2float(x); }
  __device__ static __half from_f(float x) { return __float2half_rn(x); }
};

__device__ inline float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename V>
__device__ __forceinline__ uint32_t bits(V v) {
  static_assert(sizeof(V) == 4, "two 16-bit values");
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// The mma and the packing of two fp32 values into one register of two
// 16-bit values (the first in the low half), per input type.
template <typename T>
struct Tc;

// kPScale: the power of two P is scaled by before its split (and the
// product unscaled by after); kScaleDs: dS rows are scaled before theirs.
// Only fp16 needs either: its hi and lo have 5 exponent bits, so lo
// would be subnormal, keeping fewer bits, for |x| below 2^-3, and hi
// would overflow above 65504.  bf16 has fp32's exponent range.
template <>
struct Tc<__nv_bfloat16> {
  static constexpr float kPScale = 1.f;
  static constexpr bool kScaleDs = false;
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static uint32_t pack(float x, float y) {
    return bits(__floats2bfloat162_rn(x, y));
  }
  // hi = round(x), lo = round(x - hi), for x and y at once
  __device__ static void split(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    hi = bits(h);
    lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
  }
};

template <>
struct Tc<__half> {
  static constexpr float kPScale = 32768.f;  // P <= 1 -> hi <= 2^15
  static constexpr bool kScaleDs = true;
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static uint32_t pack(float x, float y) {
    return bits(__floats2half2_rn(x, y));
  }
  __device__ static void split(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 f = __half22float2(h);
    hi = bits(h);
    lo = bits(__floats2half2_rn(x - f.x, y - f.y));
  }
};

// 2^x in one MUFU instruction (relative error about 2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^e as a float, -126 <= e <= 127
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

// The fp16 dS scale.  A row's dS enters its split as dS * 2^e, where e is
// the least of ds_exp(m) over the row's tiles so far (m the tile's largest
// |dS| in the row): m * 2^e lies in [2^14, 2^15), so hi stays finite and lo
// a normal number down to 2^-17 of the row's largest |dS| (below that the
// error is at most 2^-25 * 2^-e, 2^-39 of that largest value).  When e
// falls, the row's accumulator is multiplied by the power of two between
// the two scales; it is unscaled once at the end.  All exact: powers of two.
constexpr int kDsExpMax = 60;  // |e| <= 60 keeps every factor a normal float

__device__ __forceinline__ int ds_exp(float m) {
  const int bexp = (__float_as_int(m) >> 23) & 0xff;  // m >= 0
  if (bexp == 0) return kDsExpMax;                    // 0 or subnormal
  return max(-kDsExpMax, min(kDsExpMax, 141 - bexp));  // 14 - (bexp - 127)
}

// Row max of |x| over a warp's [16][8 * NJ] fragments (rows g and g + 8 of
// the thread, over the quad), folded into the rows' exponents de; returns
// the factors the accumulator rows are multiplied by, and sc the rows'
// scales.
template <int NJ>
__device__ __forceinline__ void ds_rescale(const float (*x)[4], int* de,
                                           float* factor, float* sc) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], fabsf(x[j][e]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const int e = min(de[i], ds_exp(mx[i]));
    factor[i] = pow2(e - de[i]);
    sc[i] = pow2(e);
    de[i] = e;
  }
}

// acc rows (g, g + 8) *= f[0], f[1]
template <int NT>
__device__ __forceinline__ void scale_rows(float (*acc)[4], const float* f) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] *= f[0];
    acc[nt][1] *= f[0];
    acc[nt][2] *= f[1];
    acc[nt][3] *= f[1];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// global -> shared; a `valid` false copy reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment (16 x 16, row-major) at rows r0.., columns c0.. of a tile
// with row stride S: the four 8 x 8 matrices are (rows 0-7 | 8-15) x
// (columns 0-7 | 8-15), column half outer.
template <int S, typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * S + c0 +
                     (lane / 16) * 8);
}

// B fragments of the two 8-wide n tiles n0.. and n0 + 8.. at depth c0..
// (16) from a tile stored [n][k] (rows are n): b[0..1] and b[2..3].
template <int S, typename T>
__device__ __forceinline__ void load_b(uint32_t* b, const T* tile, int n0,
                                       int c0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane / 16) * 8 + lane % 8) * S + c0 +
                     ((lane / 8) % 2) * 8);
}

// The same fragments from a tile stored [k][n] (rows are k, depth k0..):
// ldmatrix.trans turns its rows into the column-major B fragment.
template <int S, typename T>
__device__ __forceinline__ void load_bt(uint32_t* b, const T* tile, int k0,
                                        int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * S +
                           n0 + (lane / 16) * 8);
}

// Rows [row0, row0 + R) of a [S, heads, D] slice (`src` at head h, d 0,
// row stride `rs` elements) → dst [R][DP + 8] in T; rows >= nrows and
// columns >= D become zeros.  copy: kCopy16 (16-byte cp.async copies),
// kCopy4 (4-byte ones, two elements each) or kCopyElem (synchronous).
// The tile's base is computed once; each copy takes a 32-bit offset from
// it (R * rs < 2^31 for every shape the callers accept).
template <typename T, int R, int DP>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int row0, int nrows, int64_t rs,
                                           int D, int copy) {
  constexpr int S = DP + 8;
  const T* base = src + row0 * rs;
  const int live = nrows - row0, stride = (int)rs;
  if (copy == kCopy16) {
    constexpr int CH = DP / 8;
    static_assert(R * CH % kMmaThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < R * CH / kMmaThreads; ++i) {
      const int idx = threadIdx.x + i * kMmaThreads;
      const int r = idx / CH, c = (idx % CH) * 8;
      const bool ok = r < live && c < D;
      cp_async16(dst + r * S + c, base + (ok ? r * stride + c : 0), ok);
    }
  } else if (copy == kCopy4) {
    constexpr int CH = DP / 2;
#pragma unroll 4
    for (int i = 0; i < R * CH / kMmaThreads; ++i) {
      const int idx = threadIdx.x + i * kMmaThreads;
      const int r = idx / CH, c = (idx % CH) * 2;
      const bool ok = r < live && c < D;
      cp_async4(dst + r * S + c, base + (ok ? r * stride + c : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += kMmaThreads) {
      const int r = idx / DP, d = idx % DP;
      dst[r * S + d] = r < live && d < D ? base[r * stride + d]
                                         : Cvt<T>::from_f(0.f);
    }
  }
}

// stage_rows for gathered rows: tile row r is source row rows[r] of the
// slice (`src` at head h, d 0, row stride `rs` elements), or zeros where
// rows[r] < 0; rows[] lies in shared memory.  Same copy modes, same
// zero-fill past D.  Offsets are 64-bit: a gathered row may lie anywhere.
template <typename T, int R, int DP>
__device__ __forceinline__ void stage_rows_at(T* dst,
                                              const T* __restrict__ src,
                                              const int* rows, int64_t rs,
                                              int D, int copy) {
  constexpr int S = DP + 8;
  if (copy == kCopy16) {
    constexpr int CH = DP / 8;
    static_assert(R * CH % kMmaThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < R * CH / kMmaThreads; ++i) {
      const int idx = threadIdx.x + i * kMmaThreads;
      const int r = idx / CH, c = (idx % CH) * 8, row = rows[r];
      const bool ok = row >= 0 && c < D;
      cp_async16(dst + r * S + c, src + (ok ? row * rs + c : 0), ok);
    }
  } else if (copy == kCopy4) {
    constexpr int CH = DP / 2;
#pragma unroll 4
    for (int i = 0; i < R * CH / kMmaThreads; ++i) {
      const int idx = threadIdx.x + i * kMmaThreads;
      const int r = idx / CH, c = (idx % CH) * 2, row = rows[r];
      const bool ok = row >= 0 && c < D;
      cp_async4(dst + r * S + c, src + (ok ? row * rs + c : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += kMmaThreads) {
      const int r = idx / DP, d = idx % DP, row = rows[r];
      dst[r * S + d] = row >= 0 && d < D ? src[row * rs + d]
                                         : Cvt<T>::from_f(0.f);
    }
  }
}

// out[d], out[d + 1] = x, y rounded to T (d even; d + 1 may be past D).
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int d, int D, float x,
                                           float y, bool vec) {
  if (vec && d < D) {
    *reinterpret_cast<uint32_t*>(out + d) = Tc<T>::pack(x, y);
  } else {
    if (d < D) out[d] = Cvt<T>::from_f(x);
    if (d + 1 < D) out[d + 1] = Cvt<T>::from_f(y);
  }
}

// Rows r0 and r0 + 8 of a warp's [16][DP] fp32 fragments → out (row stride
// rs), rounded once; rows >= nrows are not written.
template <typename T, int DP>
__device__ __forceinline__ void store_frag(T* __restrict__ out,
                                           const float (*acc)[4], int r0,
                                           int nrows, int64_t rs, int D,
                                           int t, bool vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= nrows) continue;
    T* orow = out + (int64_t)row * rs;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
      store_pair<T>(orow, 8 * nt + 2 * t, D, acc[nt][2 * i],
                    acc[nt][2 * i + 1], vec);
  }
}

}  // namespace
