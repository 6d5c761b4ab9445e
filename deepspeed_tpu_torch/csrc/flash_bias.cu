// Flash attention with a trainable additive bias (forward, dq, dk/dv and
// dbias) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_bias.py
// behind `flash_attention_bias` (:397): the forward `_fwd_kernel` (:56,
// launched at :261), `_bwd_dq_kernel` (:127, :302), `_bwd_dkv_kernel`
// (:158, :315) and the dbias reduction `_bwd_dbias_kernel` (:194, :337).
// Semantics are theirs:
// - q, k, v: [B, S, H, D] (no GQA); bias: [Bb, Hb, Sq, Sk], batch b reads
//   bias row b / (B / Bb) and head h bias head h / (H / Hb); mask: an
//   optional fp32 [Bm, 1, 1, Sk], batch b reads row b / (B / Bm);
// - fp32 scores in this order: s = (q . k) * scale, then + bias, then
//   + mask, each step rounded on its own (no FMA), as the plain version
//   computes it: against a -1e9 mask the fp32 spacing is 64, so the order
//   decides which value a masked score takes;
// - the causal mask is bottom-right aligned (row + sk - sq >= col); a row
//   that sees no key outputs 0 and gets the finite lse sentinel -1e30;
// - the backward recomputes p = exp(s - lse) with delta = rowsum(dO * O)
//   in fp32; dq = sum_k ds * scale * k, dk = sum_q (ds * scale)^T q,
//   dv = sum_q p^T dO, ds = p * (dp - delta);
// - dbias = sum of ds over each bias element's (batch, head) group
//   members, in fp32, in a fixed order (batch member outer, head member
//   inner, as the TPU grid walks them): two runs give the same bits.
// Every accumulator is fp32; o, dq, dk and dv are rounded once to the
// input type (fp32, bf16 or fp16).  The bias may be fp32, bf16 or fp16
// whatever the inputs' type (a runtime switch in its load); dbias is
// written in fp32 and cast to the bias's type by the caller.
//
// Design (the tiling of csrc/flash_attention.cu, kernel B1).  Every block
// has 256 threads as a 16 x 16 grid (ty, tx) over a 64 x 64 score tile:
// thread (ty, tx) owns rows ty + 16i and columns tx + 16j (i, j < 4).
// Tiles live in shared memory as fp32 rows of DP + 4 floats, DP the head
// dim rounded up to 16, 32, 64 or 128 (zero-filled past D), so D = 32,
// AlphaFold's width, does a quarter of the work of a 128-wide tile.
// Products are fp32 FMA on the CUDA cores.
// - Forward: one block per (q tile, head, batch), online softmax over the
//   live k tiles.
// - dq: one block per (q tile, head, batch); forms delta for its rows
//   (written out for the other two passes), then loops over the k tiles.
// - dk/dv: one block per (k tile, head, batch), looping over the q tiles;
//   the bias tile is staged in shared memory so that the transposed reads
//   stay on-chip.
// - dbias: one block per (bias tile, bias head, bias batch).  The TPU
//   kernel carries its sum across the innermost sequential grid axes; here
//   the block loops over the Gb x Gh group members itself and keeps the
//   sum in registers, each thread for its own 16 elements, so the order is
//   fixed and nothing is atomic.  The [B, H, Sq, Sk] score gradient is
//   never written to memory.
//
// What bounds it on an H100.  At D = 32 a score tile pair costs 64*64*32
// FMAs per product for 2 x 4 KB of bf16 inputs: the whole call is below
// the ~300 flops per byte where the tensor cores would bind, so its bound
// is the bytes of q, k, v, o (and dO, dq, dk, dv) at 3.35 TB/s.  These
// kernels run the products on the fp32 FMA units (67 TFLOP/s), whose time
// is above that bound; mma.sync/wgmma with fp32 accumulation and
// split-K dbias blocks (the dbias grid is only Bb * Hb * tiles wide) are
// the levers for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = 80;        // row stride (floats) of the P / dS tiles
constexpr int kBS = 65;        // row stride of the staged bias tile (odd)
constexpr float kDeadRowLse = -1e30f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

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

// One bias element; code 0 = float32, 1 = bfloat16, 2 = float16.
__device__ inline float ld_bias(const void* p, int code, int64_t i) {
  if (code == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// s = (q . k) * scale + bias + mask, each operation rounded on its own.
__device__ inline float logit(float qk, float scale, float bias, float mask) {
  return __fadd_rn(__fadd_rn(__fmul_rn(qk, scale), bias), mask);
}

// A DP-wide accumulator row: thread tx owns VW consecutive columns at
// VW * tx + 16 * VW * j, j < NJ (DP / 16 columns in all), so a half-warp
// reads one contiguous run of a shared-memory row.
template <int DP>
struct Cols {
  static constexpr int VW = DP >= 64 ? 4 : DP / 16;
  static constexpr int NJ = DP / (16 * VW);
  static constexpr int N = DP / 16;
};

template <int VW>
__device__ inline void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

// Shared-memory byte sizes, per kernel and padded head dim DP.
template <int DP>
struct Smem {
  static constexpr int kST = DP + 4;                     // padded row stride
  static constexpr int tile = kTile * kST * 4;           // one fp32 tile
  static constexpr int ptile = kTile * kPS * 4;          // one P / dS tile
  static constexpr int rows = 2 * kTile * 4;             // lse and delta
  static constexpr int fwd = 3 * tile + ptile;           // q, k, v, p
  static constexpr int dq = 4 * tile + ptile + rows;
  static constexpr int dkv = 4 * tile + 2 * ptile + kTile * kBS * 4 + rows;
  static constexpr int dbias = 4 * tile + rows;
};

// Two blocks an SM where the registers allow it (DP <= 64).
template <int DP>
struct Occ {
  static constexpr int blocks = DP <= 64 ? 2 : 1;
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

// Rows [row0, row0 + 64) of a [S, heads, D] slice (row stride `rstride`
// elements, `src` at head h, d 0) -> fp32 tile [64][DP + 4]; rows >= nrows
// and columns >= D are zero.
template <typename T, int DP>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                          int nrows, int64_t rstride, int D) {
  constexpr int ST = DP + 4;
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, s = row0 + r;
    float x = 0.f;
    if (s < nrows && d < D) x = Cvt<T>::to_f(src[(int64_t)s * rstride + d]);
    dst[r * ST + d] = x;
  }
}

// s[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]; A, B padded tiles.
template <int DP>
__device__ inline void dot_nt(const float* A, const float* B, float s[4][4],
                              int ty, int tx) {
  constexpr int ST = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ST + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ST + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

__device__ inline float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// acc[i][:] += sum_c P[ty + 16i][c] * V[c][this thread's columns]; P a
// [64][kPS] tile, V a padded [64][DP + 4] tile.
template <int DP>
__device__ inline void dot_nn(const float* P, const float* V,
                              float acc[4][Cols<DP>::N], int ty, int tx) {
  constexpr int ST = DP + 4, VW = Cols<DP>::VW, NJ = Cols<DP>::NJ;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* vr = V + (c + cc) * ST + VW * tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v[VW];
        load_vec<VW>(vr + 16 * VW * j, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = comp(p[i], cc);
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][j * VW + e] = fmaf(pv, v[e], acc[i][j * VW + e]);
        }
      }
    }
  }
}

template <int DP>
__device__ inline void zero_acc(float acc[4][Cols<DP>::N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Cols<DP>::N; ++c) acc[i][c] = 0.f;
}

__device__ inline bool visible(int row, int col, int sq, int sk, int causal) {
  if (col >= sk || row >= sq) return false;
  return !causal || row + (sk - sq) >= col;
}

// Rows of a [64][DP] accumulator tile -> out[row, head, d] in the output
// type, each divided by den[i] when `divide`.
template <typename T, int DP>
__device__ void store_rows(T* __restrict__ out,
                           const float acc[4][Cols<DP>::N], const float den[4],
                           bool divide, int row0, int nrows, int64_t rstride,
                           int D, int ty, int tx) {
  constexpr int VW = Cols<DP>::VW, NJ = Cols<DP>::NJ;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty + 16 * i;
    if (s >= nrows) continue;
    T* o = out + (int64_t)s * rstride;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = VW * tx + 16 * VW * j + e;
        const float a = acc[i][j * VW + e];
        if (d < D) o[d] = Cvt<T>::from_f(divide ? a / den[i] : a);
      }
  }
}

struct Params {
  const void *q, *k, *v, *o, *dout, *bias;
  const float *mask, *lse, *delta;
  void *out, *dq, *dk, *dv;
  float *lse_out, *delta_out, *dbias;
  int B, H, sq, sk, D, Bb, Hb, Bm;  // Bm = 0: no mask
  float scale;
  int causal, bias_code;
};

// Offsets of batch b, head h: into q-like [B, sq, H, D], k-like
// [B, sk, H, D], the [B, H, sq] row vectors, the bias plane and the mask
// row (-1: no mask).
struct Where {
  int64_t q, kv, rowvec, bias, mask;
  __device__ Where(const Params& a, int b, int h) {
    const int64_t hd = (int64_t)a.H * a.D;
    q = (int64_t)b * a.sq * hd + (int64_t)h * a.D;
    kv = (int64_t)b * a.sk * hd + (int64_t)h * a.D;
    rowvec = ((int64_t)b * a.H + h) * a.sq;
    const int bb = b / (a.B / a.Bb), hb = h / (a.H / a.Hb);
    bias = ((int64_t)bb * a.Hb + hb) * a.sq * a.sk;
    mask = a.Bm ? (int64_t)(b / (a.B / a.Bm)) * a.sk : -1;
  }
};

__device__ inline float mask_at(const Params& a, const Where& w, int col) {
  return w.mask >= 0 && col < a.sk ? a.mask[w.mask + col] : 0.f;
}

// ------------------------------------------------------------------ forward
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Occ<DP>::blocks)
fb_fwd_kernel(Params a) {
  constexpr int ST = DP + 4, NC = Cols<DP>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kTile * ST;
  float* vs = ks + kTile * ST;
  float* ps = vs + kTile * ST;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const int64_t rs = (int64_t)a.H * a.D;
  const Where w(a, b, h);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_tile<T, DP>(qs, q + w.q, q0, a.sq, rs, a.D);
  int k_hi = a.sk - 1;
  if (a.causal) k_hi = min(k_hi, q0 + kTile - 1 + a.sk - a.sq);

  float m[4], l[4], acc[4][NC];
  zero_acc<DP>(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int k0 = 0; k0 <= k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(ks, k + w.kv, k0, a.sk, rs, a.D);
    load_tile<T, DP>(vs, v + w.kv, k0, a.sk, rs, a.D);
    __syncthreads();
    float s[4][4], mk[4];
    dot_nt<DP>(qs, ks, s, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) mk[j] = mask_at(a, w, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = visible(row, col, a.sq, a.sk, a.causal)
                      ? logit(s[i][j], a.scale,
                              ld_bias(a.bias, a.bias_code,
                                      w.bias + (int64_t)row * a.sk + col),
                              mk[j])
                      : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = alpha * l[i] + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    dot_nn<DP>(ps, vs, acc, ty, tx);
  }

  float lsafe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lsafe[i] = l[i] == 0.f ? 1.f : l[i];
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < a.sq)
      a.lse_out[w.rowvec + row] =
          m[i] == -INFINITY ? kDeadRowLse : m[i] + logf(lsafe[i]);
  }
  store_rows<T, DP>(static_cast<T*>(a.out) + w.q, acc, lsafe, true, q0,
                    a.sq, rs, a.D, ty, tx);
}

// ----------------------------------------------------------------- dq pass
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Occ<DP>::blocks)
fb_dq_kernel(Params a) {
  constexpr int ST = DP + 4, NC = Cols<DP>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kTile * ST;
  float* ks = dos + kTile * ST;
  float* vs = ks + kTile * ST;
  float* dss = vs + kTile * ST;
  float* r_lse = dss + kTile * kPS;
  float* r_delta = r_lse + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile;
  const int64_t rs = (int64_t)a.H * a.D;
  const Where w(a, b, h);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);

  load_tile<T, DP>(qs, static_cast<const T*>(a.q) + w.q, q0, a.sq, rs, a.D);
  load_tile<T, DP>(dos, static_cast<const T*>(a.dout) + w.q, q0, a.sq, rs,
                   a.D);
  __syncthreads();
  // delta = rowsum(dO * O) over this tile's rows; one warp per 8 rows
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int s = q0 + r;
    float acc = 0.f;
    if (s < a.sq) {
      const T* orow = o + w.q + (int64_t)s * rs;
      for (int d = lane; d < a.D; d += 32)
        acc += dos[r * ST + d] * Cvt<T>::to_f(orow[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      r_delta[r] = acc;
      r_lse[r] = s < a.sq ? a.lse[w.rowvec + s] : 0.f;
      if (s < a.sq) a.delta_out[w.rowvec + s] = acc;
    }
  }
  __syncthreads();
  float lse_i[4], delta_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_i[i] = r_lse[ty + 16 * i];
    delta_i[i] = r_delta[ty + 16 * i];
  }

  int k_hi = a.sk - 1;
  if (a.causal) k_hi = min(k_hi, q0 + kTile - 1 + a.sk - a.sq);
  float acc[4][NC];
  zero_acc<DP>(acc);

  for (int k0 = 0; k0 <= k_hi; k0 += kTile) {
    __syncthreads();
    load_tile<T, DP>(ks, k + w.kv, k0, a.sk, rs, a.D);
    load_tile<T, DP>(vs, v + w.kv, k0, a.sk, rs, a.D);
    __syncthreads();
    float s[4][4], dp[4][4], mk[4];
    dot_nt<DP>(qs, ks, s, ty, tx);
    dot_nt<DP>(dos, vs, dp, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) mk[j] = mask_at(a, w, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float p = 0.f;
        if (visible(row, col, a.sq, a.sk, a.causal))
          p = expf(logit(s[i][j], a.scale,
                         ld_bias(a.bias, a.bias_code,
                                 w.bias + (int64_t)row * a.sk + col),
                         mk[j]) -
                   lse_i[i]);
        dss[(ty + 16 * i) * kPS + tx + 16 * j] =
            p * (dp[i][j] - delta_i[i]) * a.scale;
      }
    }
    __syncthreads();
    dot_nn<DP>(dss, ks, acc, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, DP>(static_cast<T*>(a.dq) + w.q, acc, one, false, q0, a.sq,
                    rs, a.D, ty, tx);
}

// -------------------------------------------------------------- dk/dv pass
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Occ<DP>::blocks)
fb_dkv_kernel(Params a) {
  constexpr int ST = DP + 4, NC = Cols<DP>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile * ST;
  float* qs = vs + kTile * ST;
  float* dos = qs + kTile * ST;
  float* pts = dos + kTile * ST;
  float* dsts = pts + kTile * kPS;
  float* bts = dsts + kTile * kPS;  // bias tile [query][key]
  float* r_lse = bts + kTile * kBS;
  float* r_delta = r_lse + kTile;

  const int kt = blockIdx.x;  // the first k tiles see the most queries
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * kTile;
  const int64_t rs = (int64_t)a.H * a.D;
  const Where w(a, b, h);
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);

  load_tile<T, DP>(ks, static_cast<const T*>(a.k) + w.kv, k0, a.sk, rs, a.D);
  load_tile<T, DP>(vs, static_cast<const T*>(a.v) + w.kv, k0, a.sk, rs, a.D);
  float mk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mk[i] = mask_at(a, w, k0 + ty + 16 * i);

  const int q_lo = a.causal ? max(0, k0 - (a.sk - a.sq)) : 0;
  float dk_acc[4][NC], dv_acc[4][NC];
  zero_acc<DP>(dk_acc);
  zero_acc<DP>(dv_acc);

  for (int q0 = (q_lo / kTile) * kTile; q0 < a.sq; q0 += kTile) {
    __syncthreads();
    load_tile<T, DP>(qs, q + w.q, q0, a.sq, rs, a.D);
    load_tile<T, DP>(dos, dout + w.q, q0, a.sq, rs, a.D);
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx % kTile;
      const int row = q0 + r, col = k0 + c;
      bts[r * kBS + c] =
          row < a.sq && col < a.sk
              ? ld_bias(a.bias, a.bias_code,
                        w.bias + (int64_t)row * a.sk + col)
              : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int s = q0 + threadIdx.x;
      r_lse[threadIdx.x] = s < a.sq ? a.lse[w.rowvec + s] : 0.f;
      r_delta[threadIdx.x] = s < a.sq ? a.delta[w.rowvec + s] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_nt<DP>(ks, qs, st, ty, tx);    // [key ty+16i][query tx+16j]
    dot_nt<DP>(vs, dos, dpt, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      const float lse_j = r_lse[tx + 16 * j];
      const float delta_j = r_delta[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty + 16 * i;
        float p = 0.f;
        if (visible(row, col, a.sq, a.sk, a.causal))
          p = expf(logit(st[i][j], a.scale,
                         bts[(tx + 16 * j) * kBS + ty + 16 * i], mk[i]) -
                   lse_j);
        pts[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        dsts[(ty + 16 * i) * kPS + tx + 16 * j] =
            p * (dpt[i][j] - delta_j) * a.scale;
      }
    }
    __syncthreads();
    dot_nn<DP>(pts, dos, dv_acc, ty, tx);
    dot_nn<DP>(dsts, qs, dk_acc, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, DP>(static_cast<T*>(a.dk) + w.kv, dk_acc, one, false, k0,
                    a.sk, rs, a.D, ty, tx);
  store_rows<T, DP>(static_cast<T*>(a.dv) + w.kv, dv_acc, one, false, k0,
                    a.sk, rs, a.D, ty, tx);
}

// -------------------------------------------------------------- dbias pass
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Occ<DP>::blocks)
fb_dbias_kernel(Params a, int nk) {
  constexpr int ST = DP + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kTile * ST;
  float* ks = dos + kTile * ST;
  float* vs = ks + kTile * ST;
  float* r_lse = vs + kTile * ST;
  float* r_delta = r_lse + kTile;

  const int q0 = (blockIdx.x / nk) * kTile, k0 = (blockIdx.x % nk) * kTile;
  const int hb = blockIdx.y, bb = blockIdx.z;
  const int gb = a.B / a.Bb, gh = a.H / a.Hb;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t rs = (int64_t)a.H * a.D;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int64_t plane = ((int64_t)bb * a.Hb + hb) * a.sq * a.sk;

  // this thread's bias elements: the same for every group member
  float bv[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
      bv[i][j] = row < a.sq && col < a.sk
                     ? ld_bias(a.bias, a.bias_code,
                               plane + (int64_t)row * a.sk + col)
                     : 0.f;
      acc[i][j] = 0.f;
    }

  // a tile above the causal diagonal sees no key: its sum stays 0
  const bool live = !a.causal || k0 <= q0 + kTile - 1 + (a.sk - a.sq);
  for (int g = 0; live && g < gb; ++g) {
    for (int e = 0; e < gh; ++e) {
      const int b = bb * gb + g, h = hb * gh + e;
      const Where w(a, b, h);
      __syncthreads();
      load_tile<T, DP>(qs, q + w.q, q0, a.sq, rs, a.D);
      load_tile<T, DP>(dos, dout + w.q, q0, a.sq, rs, a.D);
      load_tile<T, DP>(ks, k + w.kv, k0, a.sk, rs, a.D);
      load_tile<T, DP>(vs, v + w.kv, k0, a.sk, rs, a.D);
      if (threadIdx.x < kTile) {
        const int s = q0 + threadIdx.x;
        r_lse[threadIdx.x] = s < a.sq ? a.lse[w.rowvec + s] : 0.f;
        r_delta[threadIdx.x] = s < a.sq ? a.delta[w.rowvec + s] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4], mk[4];
      dot_nt<DP>(qs, ks, s, ty, tx);
      dot_nt<DP>(dos, vs, dp, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) mk[j] = mask_at(a, w, k0 + tx + 16 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        const float lse_i = r_lse[ty + 16 * i];
        const float delta_i = r_delta[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          if (visible(row, col, a.sq, a.sk, a.causal)) {
            const float p =
                expf(logit(s[i][j], a.scale, bv[i][j], mk[j]) - lse_i);
            acc[i][j] += p * (dp[i][j] - delta_i);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
      if (row < a.sq && col < a.sk)
        a.dbias[plane + (int64_t)row * a.sk + col] = acc[i][j];
    }
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2, kDbias = 3 };

template <typename T, int DP>
cudaError_t run(int pass, const Params& a, cudaStream_t st) {
  const int nq = (a.sq + kTile - 1) / kTile, nk = (a.sk + kTile - 1) / kTile;
  static bool configured[4] = {false, false, false, false};
  cudaError_t e = cudaSuccess;
  if (pass == kFwd) {
    if (!configured[kFwd] &&
        (e = allow_smem(fb_fwd_kernel<T, DP>, Smem<DP>::fwd)) != cudaSuccess)
      return e;
    fb_fwd_kernel<T, DP><<<dim3(nq, a.H, a.B), kThreads, Smem<DP>::fwd, st>>>(a);
  } else if (pass == kDq) {
    if (!configured[kDq] &&
        (e = allow_smem(fb_dq_kernel<T, DP>, Smem<DP>::dq)) != cudaSuccess)
      return e;
    fb_dq_kernel<T, DP><<<dim3(nq, a.H, a.B), kThreads, Smem<DP>::dq, st>>>(a);
  } else if (pass == kDkv) {
    if (!configured[kDkv] &&
        (e = allow_smem(fb_dkv_kernel<T, DP>, Smem<DP>::dkv)) != cudaSuccess)
      return e;
    fb_dkv_kernel<T, DP><<<dim3(nk, a.H, a.B), kThreads, Smem<DP>::dkv, st>>>(
        a);
  } else {
    if (!configured[kDbias] &&
        (e = allow_smem(fb_dbias_kernel<T, DP>, Smem<DP>::dbias)) !=
            cudaSuccess)
      return e;
    fb_dbias_kernel<T, DP>
        <<<dim3(nq * nk, a.Hb, a.Bb), kThreads, Smem<DP>::dbias, st>>>(a, nk);
  }
  configured[pass] = true;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(int pass, const Params& a, cudaStream_t st) {
  if (a.D <= 16) return run<T, 16>(pass, a, st);
  if (a.D <= 32) return run<T, 32>(pass, a, st);
  if (a.D <= 64) return run<T, 64>(pass, a, st);
  return run<T, 128>(pass, a, st);
}

int dispatch(int pass, const Params& a, int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.sq <= 0 || a.sk <= 0 || a.D <= 0 ||
      a.D > 128 || a.Bb <= 0 || a.Hb <= 0 || a.B % a.Bb || a.H % a.Hb ||
      a.Bm < 0 || (a.Bm && a.B % a.Bm) || a.B > 65535 || a.H > 65535 ||
      a.bias_code < 0 || a.bias_code > 2 ||
      (int64_t)((a.sq + kTile - 1) / kTile) * ((a.sk + kTile - 1) / kTile) >
          0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_d<float>(pass, a, st);
  if (dtype == 1) return (int)run_d<__nv_bfloat16>(pass, a, st);
  if (dtype == 2) return (int)run_d<__half>(pass, a, st);
  return (int)cudaErrorInvalidValue;
}

Params make(int B, int H, int sq, int sk, int D, int Bb, int Hb, int Bm,
            float scale, int causal, int bias_code) {
  Params a{};
  a.B = B; a.H = H; a.sq = sq; a.sk = sk; a.D = D;
  a.Bb = Bb; a.Hb = Hb; a.Bm = Bm;
  a.scale = scale; a.causal = causal; a.bias_code = bias_code;
  return a;
}

}  // namespace

// All tensors contiguous on the card.  q, o, dout, dq: [B, sq, H, D];
// k, v, dk, dv: [B, sk, H, D] (dtype 0 = float32, 1 = bfloat16,
// 2 = float16); bias: [Bb, Hb, sq, sk] in bias_dtype (same codes); mask:
// float32 [Bm, 1, 1, sk] or NULL with Bm = 0; lse, delta: [B, H, sq]
// float32; dbias: float32 [Bb, Hb, sq, sk].  causal: 0/1.  Each returns a
// cudaError_t (0 = launched).
#define FB_DIMS                                                             \
  int B, int H, int sq, int sk, int D, int Bb, int Hb, int Bm, float scale, \
      int causal, int dtype, int bias_dtype, void* stream
#define FB_MAKE make(B, H, sq, sk, D, Bb, Hb, Bm, scale, causal, bias_dtype)

// o and lse from q, k, v, bias, mask.
extern "C" int ds_flash_bias_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* mask, void* o,
                                 void* lse, FB_DIMS) {
  Params a = FB_MAKE;
  a.q = q; a.k = k; a.v = v; a.bias = bias;
  a.mask = static_cast<const float*>(mask);
  a.out = o; a.lse_out = static_cast<float*>(lse);
  return dispatch(kFwd, a, dtype, stream);
}

// dq, and delta = rowsum(dout * o) for the dk/dv and dbias passes.
extern "C" int ds_flash_bias_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    const void* bias, const void* mask,
                                    void* dq, void* delta, FB_DIMS) {
  Params a = FB_MAKE;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.bias = bias;
  a.lse = static_cast<const float*>(lse);
  a.mask = static_cast<const float*>(mask);
  a.dq = dq; a.delta_out = static_cast<float*>(delta);
  return dispatch(kDq, a, dtype, stream);
}

// dk and dv.
extern "C" int ds_flash_bias_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* bias, const void* mask,
                                     void* dk, void* dv, FB_DIMS) {
  Params a = FB_MAKE;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const float*>(mask);
  a.dk = dk; a.dv = dv;
  return dispatch(kDkv, a, dtype, stream);
}

// dbias in fp32 at the bias's own shape, summed over each element's group
// members in a fixed order.
extern "C" int ds_flash_bias_bwd_dbias(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* bias, const void* mask,
                                       void* dbias, FB_DIMS) {
  Params a = FB_MAKE;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const float*>(mask);
  a.dbias = static_cast<float*>(dbias);
  return dispatch(kDbias, a, dtype, stream);
}

// Dynamic shared memory of one block of a pass (0 fwd, 1 dq, 2 dk/dv,
// 3 dbias) at head dim D; ptxas -v does not see dynamic shared memory.
extern "C" int ds_flash_bias_smem_bytes(int pass, int D) {
#define FB_SMEM(DP)                                                      \
  (pass == kFwd ? Smem<DP>::fwd : pass == kDq ? Smem<DP>::dq            \
                                : pass == kDkv ? Smem<DP>::dkv          \
                                               : Smem<DP>::dbias)
  if (D <= 16) return FB_SMEM(16);
  if (D <= 32) return FB_SMEM(32);
  if (D <= 64) return FB_SMEM(64);
  return FB_SMEM(128);
#undef FB_SMEM
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
