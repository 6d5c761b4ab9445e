// One pass over groups of `gs` consecutive elements, the load scheme of
// B5's quantize (csrc/quantizer.cu) and B6 (csrc/fp_quantizer.cu).
//
// The input is viewed as rows of gs elements (row-major flatten, zeros past
// n; gs a multiple of 128).  A lane takes "units" of 16 consecutive
// elements (32 bytes of bf16/fp16 in two 16-byte loads, 64 of fp32 in
// four).  A group of gs / 16 units is served by a team of `tl` lanes (8,
// 16 or 32: the largest that divides gs / 16), each holding `vpl` =
// gs / (16 tl) of its units, unit t + j tl for lane t of the team, in
// registers; a warp serves 32 / tl groups at once.  Every load of a group
// is issued before its first reduction, the team reduces the absmax by
// shuffles, the scale is absmax / top (a true fp32 division, 1 for an
// all-zero group), each element is divided by it (the IEEE division), and
// each unit is encoded from the registers and stored whole by the
// encoder: no second load.  Warps stride over the groups
// (a grid of the blocks that fit at once).
//
// Groups wider than kMaxUnits units a lane (gs > 4096) do not fit in the
// registers: their kernel reads each unit twice, once for the absmax and
// once to encode it.  Where every group is whole and x is aligned (the
// weights of the main paths), the kernel is built without the scalar
// loads of a group's tail, so that it holds only the code it runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gq {

constexpr int kUnit = 16;       // consecutive elements a lane takes at once
constexpr int kThreads = 256;   // a block
constexpr int kMaxUnits = 8;    // units of a group a lane holds, at most

// 16 consecutive elements of T in registers: unit(i) is element i as fp32
// (exact), absmax() the largest |element|.
template <typename T>
struct Unit;

template <>
struct Unit<float> {
  float f[kUnit];
  __device__ void load_vec(const float* p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      f[4 * k] = v.x;
      f[4 * k + 1] = v.y;
      f[4 * k + 2] = v.z;
      f[4 * k + 3] = v.w;
    }
  }
  __device__ void load_elems(const float* p, long long left) {
#pragma unroll
    for (int i = 0; i < kUnit; ++i) f[i] = i < left ? p[i] : 0.f;
  }
  __device__ float get(int i) const { return f[i]; }
  __device__ float absmax() const {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kUnit; ++i) m = fmaxf(m, fabsf(f[i]));
    return m;
  }
};

// bf16 and fp16: 8 words of two elements (element 2k in the low half)
template <typename T>
struct Unit16 {
  uint32_t w[kUnit / 2];
  __device__ void load_vec(const T* p) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  }
  __device__ void load_elems(const T* p, long long left) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int k = 0; k < kUnit / 2; ++k) {
      const uint32_t lo = 2 * k < left ? h[2 * k] : 0u;
      const uint32_t hi = 2 * k + 1 < left ? h[2 * k + 1] : 0u;
      w[k] = lo | (hi << 16);
    }
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// max(|a|, |b|) of each half of two words of bf16 pairs (the max is exact)
__device__ __forceinline__ uint32_t amax2_bf16(uint32_t a, uint32_t b) {
  a &= 0x7fff7fffu;
  b &= 0x7fff7fffu;
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t amax2_f16(uint32_t a, uint32_t b) {
  a &= 0x7fff7fffu;
  b &= 0x7fff7fffu;
  __half2 r = __hmax2(*reinterpret_cast<__half2*>(&a),
                      *reinterpret_cast<__half2*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

template <>
struct Unit<__nv_bfloat16> : Unit16<__nv_bfloat16> {
  __device__ float get(int i) const {
    return i % 2 ? bf16_hi(w[i / 2]) : bf16_lo(w[i / 2]);
  }
  __device__ float absmax() const {
    uint32_t m = w[0] & 0x7fff7fffu;
#pragma unroll
    for (int k = 1; k < kUnit / 2; ++k) m = amax2_bf16(m, w[k]);
    return fmaxf(bf16_lo(m), bf16_hi(m));
  }
};

template <>
struct Unit<__half> : Unit16<__half> {
  __device__ float get(int i) const {
    return i % 2 ? f16_hi(w[i / 2]) : f16_lo(w[i / 2]);
  }
  __device__ float absmax() const {
    uint32_t m = w[0] & 0x7fff7fffu;
#pragma unroll
    for (int k = 1; k < kUnit / 2; ++k) m = amax2_f16(m, w[k]);
    return fmaxf(f16_lo(m), f16_hi(m));
  }
};

// unit at element e of x (zeros past n): vector loads where the unit is
// whole and x is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_unit(Unit<T>& u, const T* __restrict__ x,
                                          long long e, long long n,
                                          bool vec) {
  if (vec && e + kUnit <= n)
    u.load_vec(x + e);
  else
    u.load_elems(x + e, n - e);
}

// global -> shared, 16 bytes (zeros, reading nothing, where !valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// The team layout of a group size: (tl, vpl).
__host__ __device__ inline void team(int gs, int& tl, int& vpl) {
  const int units = gs / kUnit;  // a multiple of 8
  tl = units % 32 == 0 ? 32 : units % 16 == 0 ? 16 : 8;
  vpl = units / tl;
}

// unit at element e of x (zeros past n): vector loads only where WHOLE
// (every group whole, x 16-byte aligned), else where the unit is whole and
// x aligned (`vec`)
template <bool WHOLE, typename T>
__device__ __forceinline__ void load_at(Unit<T>& u, const T* __restrict__ x,
                                        long long e, long long n, bool vec) {
  if (WHOLE)
    u.load_vec(x + e);
  else
    load_unit(u, x, e, n, vec);
}

// Enc: `top` (the scale's divisor), `scales` (fp32 [groups]) and
// store(unit index, y), which encodes the unit's 16 quotients y = x / scale
// and writes them whole.
//
// MAXV: the units a lane holds (1, 2, 4 or 8, at least vpl; 1 and 2 only
// where vpl equals it), or 0: the lane reads its vpl (> kMaxUnits) units
// twice (built only with !WHOLE).  WHOLE: every group is whole (n ==
// groups * gs) and x is 16-byte aligned, so every load is a vector load.
// Each instantiation holds only the code its launches run.
template <typename T, int MAXV, bool WHOLE, class Enc>
__global__ void __launch_bounds__(kThreads)
    group_kernel(const T* __restrict__ x, long long n, long long groups,
                 int gs, int tl, int vpl, bool vec, Enc enc) {
  const int lane = threadIdx.x % 32, t = lane % tl;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const int per_warp = 32 / tl;
  const long long upg = gs / kUnit;  // units a group
  for (long long gw = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32 *
                      per_warp;
       gw < groups; gw += warps * per_warp) {
    const long long g = gw + lane / tl;
    const bool live = g < groups;
    // a team past the last group reads the last one and stores nothing
    const long long first = (live ? g : groups - 1) * gs;
    float amax = 0.f;
    if constexpr (MAXV > 0) {
      Unit<T> u[MAXV];
#pragma unroll
      for (int j = 0; j < MAXV; ++j) {
        if (MAXV <= 2 || j < vpl) {
          load_at<WHOLE>(u[j], x, first + (t + j * tl) * kUnit, n, vec);
          amax = fmaxf(amax, u[j].absmax());
        }
      }
      for (int o = tl / 2; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = amax == 0.f ? 1.f : amax / enc.top;
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < MAXV; ++j) {
        if (MAXV <= 2 || j < vpl) {
          float y[kUnit];
#pragma unroll
          for (int i = 0; i < kUnit; ++i) y[i] = u[j].get(i) / scale;
          enc.store(g * upg + t + j * tl, y);
        }
      }
      if (t == 0) enc.scales[g] = scale;
    } else {
      for (int j = 0; j < vpl; ++j) {
        Unit<T> u;
        load_at<WHOLE>(u, x, first + (t + j * tl) * kUnit, n, vec);
        amax = fmaxf(amax, u.absmax());
      }
      for (int o = tl / 2; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = amax == 0.f ? 1.f : amax / enc.top;
      if (!live) continue;
      for (int j = 0; j < vpl; ++j) {
        Unit<T> u;
        load_at<WHOLE>(u, x, first + (t + j * tl) * kUnit, n, vec);
        float y[kUnit];
#pragma unroll
        for (int i = 0; i < kUnit; ++i) y[i] = u.get(i) / scale;
        enc.store(g * upg + t + j * tl, y);
      }
      if (t == 0) enc.scales[g] = scale;
    }
  }
}

// Blocks of group_kernel<T, MAXV, WHOLE, Enc> that the card holds at once.
template <typename T, int MAXV, bool WHOLE, class Enc>
int resident_blocks() {
  static int blocks = 0;  // once per instantiation
  if (!blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, group_kernel<T, MAXV, WHOLE, Enc>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T, int MAXV, bool WHOLE, class Enc>
cudaError_t launch_maxv(const T* x, long long n, long long groups, int gs,
                        int tl, int vpl, bool vec, const Enc& enc,
                        cudaStream_t st) {
  const int fit = resident_blocks<T, MAXV, WHOLE, Enc>();
  if (!fit) return cudaGetLastError();
  const long long need = (groups * tl + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(need < fit ? need : fit);
  group_kernel<T, MAXV, WHOLE, Enc>
      <<<grid, kThreads, 0, st>>>(x, n, groups, gs, tl, vpl, vec, enc);
  return cudaGetLastError();
}

template <typename T, bool WHOLE, class Enc>
cudaError_t launch_whole(const T* x, long long n, long long groups, int gs,
                         bool vec, const Enc& enc, cudaStream_t st) {
  int tl, vpl;
  team(gs, tl, vpl);
  if (vpl == 1)
    return launch_maxv<T, 1, WHOLE>(x, n, groups, gs, tl, vpl, vec, enc, st);
  if (vpl == 2)
    return launch_maxv<T, 2, WHOLE>(x, n, groups, gs, tl, vpl, vec, enc, st);
  if (vpl <= 4)
    return launch_maxv<T, 4, WHOLE>(x, n, groups, gs, tl, vpl, vec, enc, st);
  if (vpl <= kMaxUnits)
    return launch_maxv<T, kMaxUnits, WHOLE>(x, n, groups, gs, tl, vpl, vec,
                                            enc, st);
  // groups read twice: one kernel, with the tail's loads (no main path
  // runs it)
  return launch_maxv<T, 0, false>(x, n, groups, gs, tl, vpl, vec, enc, st);
}

// One launch over `groups` groups of gs elements of x (n of them real).
template <typename T, class Enc>
cudaError_t launch(const T* x, long long n, long long groups, int gs,
                   const Enc& enc, cudaStream_t st) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec && n == groups * gs)
    return launch_whole<T, true>(x, n, groups, gs, vec, enc, st);
  return launch_whole<T, false>(x, n, groups, gs, vec, enc, st);
}

}  // namespace gq
