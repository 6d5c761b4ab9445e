// Flash attention (forward, dq and dk/dv backward) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/
// flash_attention.py: the forward `_fwd_kernel` (:114, launched at :185) and
// the two backward kernels `_bwd_dq_kernel` (:219, :321) and
// `_bwd_dkv_kernel` (:259, :348).  Semantics are theirs: public layout
// [B, S, H, D]; the causal mask is bottom-right aligned (row + sk - sq >=
// col); a sliding window keeps col > row + sk - sq - window; GQA maps q
// head h to kv head h * Hkv / Hq; ALiBi adds slope_h * key position; a row
// that sees no key outputs 0 and gets the finite lse sentinel -1e30.
// Scores, probabilities, the running max/sum and every accumulator are fp32;
// o, dq, dk and dv are rounded once to the input type (fp32, bf16 or fp16:
// the type changes only the loads and that final rounding).
//
// Design.  Every block has 256 threads as a 16 x 16 grid (ty, tx) over a
// 64 x 64 score tile: thread (ty, tx) owns rows ty + 16i and columns
// tx + 16j (i, j < 4), so the 16 threads of one row are one half-warp and
// row reductions are four xor-shuffles.  Tiles live in shared memory as
// fp32 (converted once on load), rows padded by 4 floats so that float4
// reads of 16 different rows hit distinct banks.  Products are fp32 FMA on
// the CUDA cores: scores as float4 dot products along D, P*V with each
// thread holding a 4 x (D/16) slice of the output.
// - Forward: one block per (q tile of 64 rows, q head, batch), looping over
//   the live k tiles only (causal and window bounds), online softmax.
// - dq: one block per (q tile, q head, batch).  It first forms
//   delta = rowsum(dO * O) for its rows (written out for the dk/dv kernel),
//   then loops over the live k tiles: P from the saved lse, dP = dO V^T,
//   dS = P (dP - delta) scale, dq += dS K.
// - dk/dv: one block per (k tile, kv head, batch).  The TPU kernel carries
//   its accumulators across a sequential grid axis; here the block loops
//   over the g = Hq / Hkv query heads of its kv head and over the live q
//   tiles, so dk and dv are summed over the GQA group in fp32 and written
//   once (the Pallas path writes per-q-head results and sums them after).
// Blocks are ordered heaviest first (the last q tiles see the most keys,
// the first k tiles the most queries).
//
// What bounds it on an H100: operations.  At D = 128 a 64 x 64 tile pair
// does 64*64*128*2 FMAs per product for 2 x 32 KB of fp32 tiles, far above
// the ~300 flops per byte where bytes would bind; the work runs on the
// fp32 FMA units (67 TFLOP/s), not the bf16 tensor cores (989), so it is
// well above the bound computed at the tensor-core rate.  mma.sync/wgmma
// with fp32 accumulation is the lever for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = 80;        // row stride (floats) of the P / dS tiles
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

// Shared-memory byte sizes, per kernel and padded head dim DP.
template <int DP>
struct Smem {
  static constexpr int kST = DP + 4;                     // padded row stride
  static constexpr int tile = kTile * kST * 4;           // one fp32 tile
  static constexpr int ptile = kTile * kPS * 4;          // one P / dS tile
  static constexpr int fwd = 3 * tile + ptile;           // q, k, v, p
  static constexpr int dq = 4 * tile + ptile + 2 * kTile * 4;
  static constexpr int dkv = 4 * tile + 2 * ptile + 2 * kTile * 4;
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
// elements, `src` at head h, d 0) → fp32 tile [64][DP + 4]; rows >= nrows
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

__device__ inline void fma4(float p, const float4& v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// acc[i][j] += sum_c P[ty + 16i][c] * V[c][4tx + 64j .. +3]; P a [64][kPS]
// tile, V a padded [64][DP + 4] tile.
template <int DP>
__device__ inline void dot_nn(const float* P, const float* V,
                              float4 acc[4][DP / 64], int ty, int tx) {
  constexpr int ST = DP + 4, NJ = DP / 64;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPS + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* vc = V + c * ST + 4 * tx + 64 * j;
      const float4 v0 = *reinterpret_cast<const float4*>(vc);
      const float4 v1 = *reinterpret_cast<const float4*>(vc + ST);
      const float4 v2 = *reinterpret_cast<const float4*>(vc + 2 * ST);
      const float4 v3 = *reinterpret_cast<const float4*>(vc + 3 * ST);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(p[i].x, v0, acc[i][j]);
        fma4(p[i].y, v1, acc[i][j]);
        fma4(p[i].z, v2, acc[i][j]);
        fma4(p[i].w, v3, acc[i][j]);
      }
    }
  }
}

__device__ inline bool visible(int row, int col, int sq, int sk, int causal,
                               int window) {
  if (col >= sk || row >= sq) return false;
  if (!causal) return true;
  const int r = row + (sk - sq);
  return r >= col && (window <= 0 || col > r - window);
}

// Rows of a [64][*] accumulator tile → out[row, head, d] in the output type.
template <typename T, int DP>
__device__ void store_rows(T* __restrict__ out, const float4 acc[4][DP / 64],
                           const float den[4], bool divide, int row0,
                           int nrows, int64_t rstride, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty + 16 * i;
    if (s >= nrows) continue;
    T* o = out + (int64_t)s * rstride;
#pragma unroll
    for (int j = 0; j < DP / 64; ++j) {
      const int d = 4 * tx + 64 * j;
      const float a[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z, acc[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) o[d + e] = Cvt<T>::from_f(divide ? a[e] / den[i] : a[e]);
    }
  }
}

// ------------------------------------------------------------------ forward
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ slopes,
                 T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv,
                 int sq, int sk, int D, float scale, int causal, int window) {
  constexpr int ST = DP + 4, NJ = DP / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kTile * ST;
  float* vs = ks + kTile * ST;
  float* ps = vs + kTile * ST;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)((int64_t)h * Hkv / Hq);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile, off = sk - sq;
  const int64_t qrs = (int64_t)Hq * D, kvrs = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * sq * qrs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float slope = slopes ? slopes[h] : 0.f;

  load_tile<T, DP>(qs, qb, q0, sq, qrs, D);

  int k_lo = 0, k_hi = sk - 1;
  if (causal) {
    k_hi = min(k_hi, q0 + kTile - 1 + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }

  float m[4], l[4];
  float4 acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = (k_lo / kTile) * kTile; k0 <= k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(ks, kb, k0, sk, kvrs, D);
    load_tile<T, DP>(vs, vb, k0, sk, kvrs, D);
    __syncthreads();
    float s[4][4];
    dot_nt<DP>(qs, ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = s[i][j] * scale + slope * (float)col;
        s[i][j] = visible(row, col, sq, sk, causal, window) ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    __syncthreads();
    dot_nn<DP>(ps, vs, acc, ty, tx);
  }

  float lsafe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lsafe[i] = l[i] == 0.f ? 1.f : l[i];
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < sq)
      lse[((int64_t)b * Hq + h) * sq + row] =
          m[i] == -INFINITY ? kDeadRowLse : m[i] + logf(lsafe[i]);
  }
  store_rows<T, DP>(o + (int64_t)b * sq * qrs + (int64_t)h * D, acc, lsafe,
                    true, q0, sq, qrs, D, ty, tx);
}

// ----------------------------------------------------------------- dq pass
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ slopes, T* __restrict__ dq,
                    float* __restrict__ delta, int Hq, int Hkv, int sq,
                    int sk, int D, float scale, int causal, int window) {
  constexpr int ST = DP + 4, NJ = DP / 64;
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
  const int kvh = (int)((int64_t)h * Hkv / Hq);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile, off = sk - sq;
  const int64_t qrs = (int64_t)Hq * D, kvrs = (int64_t)Hkv * D;
  const int64_t qoff = (int64_t)b * sq * qrs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float slope = slopes ? slopes[h] : 0.f;
  const int64_t rowvec = ((int64_t)b * Hq + h) * sq;

  load_tile<T, DP>(qs, q + qoff, q0, sq, qrs, D);
  load_tile<T, DP>(dos, dout + qoff, q0, sq, qrs, D);
  __syncthreads();
  // delta = rowsum(dO * O) over this tile's rows; one warp per 8 rows
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int s = q0 + r;
    float acc = 0.f;
    if (s < sq) {
      const T* orow = o + qoff + (int64_t)s * qrs;
      for (int d = lane; d < D; d += 32)
        acc += dos[r * ST + d] * Cvt<T>::to_f(orow[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      r_delta[r] = acc;
      r_lse[r] = s < sq ? lse[rowvec + s] : 0.f;
      if (s < sq) delta[rowvec + s] = acc;
    }
  }
  __syncthreads();
  float lse_i[4], delta_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_i[i] = r_lse[ty + 16 * i];
    delta_i[i] = r_delta[ty + 16 * i];
  }

  int k_lo = 0, k_hi = sk - 1;
  if (causal) {
    k_hi = min(k_hi, q0 + kTile - 1 + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  float4 acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = (k_lo / kTile) * kTile; k0 <= k_hi; k0 += kTile) {
    __syncthreads();
    load_tile<T, DP>(ks, kb, k0, sk, kvrs, D);
    load_tile<T, DP>(vs, vb, k0, sk, kvrs, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_nt<DP>(qs, ks, s, ty, tx);
    dot_nt<DP>(dos, vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = s[i][j] * scale + slope * (float)col;
        const float p = visible(row, col, sq, sk, causal, window)
                            ? expf(x - lse_i[i]) : 0.f;
        dss[(ty + 16 * i) * kPS + tx + 16 * j] =
            p * (dp[i][j] - delta_i[i]) * scale;
      }
    }
    __syncthreads();
    dot_nn<DP>(dss, ks, acc, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, DP>(dq + qoff, acc, one, false, q0, sq, qrs, D, ty, tx);
}

// -------------------------------------------------------------- dk/dv pass
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ slopes, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int sq, int sk,
                     int D, float scale, int causal, int window) {
  constexpr int ST = DP + 4, NJ = DP / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile * ST;
  float* qs = vs + kTile * ST;
  float* dos = qs + kTile * ST;
  float* pts = dos + kTile * ST;
  float* dsts = pts + kTile * kPS;
  float* r_lse = dsts + kTile * kPS;
  float* r_delta = r_lse + kTile;

  const int kt = blockIdx.x;  // the first k tiles see the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * kTile, off = sk - sq;
  const int64_t qrs = (int64_t)Hq * D, kvrs = (int64_t)Hkv * D;
  const int64_t kvoff = (int64_t)b * sk * kvrs + (int64_t)kvh * D;

  load_tile<T, DP>(ks, k + kvoff, k0, sk, kvrs, D);
  load_tile<T, DP>(vs, v + kvoff, k0, sk, kvrs, D);

  int q_lo = 0, q_hi = sq - 1;
  if (causal) {
    q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(q_hi, k0 + kTile - 2 - off + window);
  }
  float4 dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const float slope = slopes ? slopes[h] : 0.f;
    const int64_t qoff = (int64_t)b * sq * qrs + (int64_t)h * D;
    const int64_t rowvec = ((int64_t)b * Hq + h) * sq;
    for (int q0 = (q_lo / kTile) * kTile; q0 <= q_hi; q0 += kTile) {
      __syncthreads();
      load_tile<T, DP>(qs, q + qoff, q0, sq, qrs, D);
      load_tile<T, DP>(dos, dout + qoff, q0, sq, qrs, D);
      if (threadIdx.x < kTile) {
        const int s = q0 + threadIdx.x;
        r_lse[threadIdx.x] = s < sq ? lse[rowvec + s] : 0.f;
        r_delta[threadIdx.x] = s < sq ? delta[rowvec + s] : 0.f;
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
          const float x = st[i][j] * scale + slope * (float)col;
          const float p = visible(row, col, sq, sk, causal, window)
                              ? expf(x - lse_j) : 0.f;
          pts[(ty + 16 * i) * kPS + tx + 16 * j] = p;
          dsts[(ty + 16 * i) * kPS + tx + 16 * j] =
              p * (dpt[i][j] - delta_j) * scale;
        }
      }
      __syncthreads();
      dot_nn<DP>(pts, dos, dv_acc, ty, tx);
      dot_nn<DP>(dsts, qs, dk_acc, ty, tx);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, DP>(dk + kvoff, dk_acc, one, false, k0, sk, kvrs, D, ty, tx);
  store_rows<T, DP>(dv + kvoff, dv_acc, one, false, k0, sk, kvrs, D, ty, tx);
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *slopes;
  void *out, *lse, *dq, *delta, *dk, *dv;
  int B, Hq, Hkv, sq, sk, D;
  float scale;
  int causal, window;
};

template <typename T, int DP>
cudaError_t run_fwd(const Args& a, cudaStream_t st) {
  static bool configured = false;
  auto kern = flash_fwd_kernel<T, DP>;
  if (!configured) {
    cudaError_t e = allow_smem(kern, Smem<DP>::fwd);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.sq + kTile - 1) / kTile, a.Hq, a.B);
  kern<<<grid, kThreads, Smem<DP>::fwd, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.slopes),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.Hq, a.Hkv, a.sq,
      a.sk, a.D, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t run_dq(const Args& a, cudaStream_t st) {
  static bool configured = false;
  auto kern = flash_bwd_dq_kernel<T, DP>;
  if (!configured) {
    cudaError_t e = allow_smem(kern, Smem<DP>::dq);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.sq + kTile - 1) / kTile, a.Hq, a.B);
  kern<<<grid, kThreads, Smem<DP>::dq, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.slopes), static_cast<T*>(a.dq),
      static_cast<float*>(a.delta), a.Hq, a.Hkv, a.sq, a.sk, a.D, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t run_dkv(const Args& a, cudaStream_t st) {
  static bool configured = false;
  auto kern = flash_bwd_dkv_kernel<T, DP>;
  if (!configured) {
    cudaError_t e = allow_smem(kern, Smem<DP>::dkv);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.sk + kTile - 1) / kTile, a.Hkv, a.B);
  kern<<<grid, kThreads, Smem<DP>::dkv, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.slopes), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Hq, a.Hkv, a.sq, a.sk, a.D, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DP>
cudaError_t run(int pass, const Args& a, cudaStream_t st) {
  if (pass == kFwd) return run_fwd<T, DP>(a, st);
  if (pass == kDq) return run_dq<T, DP>(a, st);
  return run_dkv<T, DP>(a, st);
}

int dispatch(int pass, const Args& a, int dtype, void* stream) {
  if (a.B <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv || a.sq <= 0 ||
      a.sk <= 0 || a.D <= 0 || a.D > 128 || a.B > 65535 || a.Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = a.D > 64;
  if (dtype == 0)
    return (int)(wide ? run<float, 128>(pass, a, st) : run<float, 64>(pass, a, st));
  if (dtype == 1)
    return (int)(wide ? run<__nv_bfloat16, 128>(pass, a, st)
                      : run<__nv_bfloat16, 64>(pass, a, st));
  if (dtype == 2)
    return (int)(wide ? run<__half, 128>(pass, a, st)
                      : run<__half, 64>(pass, a, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous on the card.  q, o, dout, dq: [B, sq, Hq, D];
// k, v, dk, dv: [B, sk, Hkv, D] (dtype 0 = float32, 1 = bfloat16,
// 2 = float16); lse and
// delta: [B, Hq, sq] float32; slopes: [Hq] float32 or NULL (no ALiBi).
// causal: 0/1; window: 0 = none (needs causal).  Each returns a cudaError_t
// (0 = launched).

// o and lse from q, k, v.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* slopes, void* o, void* lse, int B,
                            int Hq, int Hkv, int sq, int sk, int D,
                            float scale, int causal, int window, int dtype,
                            void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.slopes = slopes; a.out = o; a.lse = lse;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.sq = sq; a.sk = sk; a.D = D;
  a.scale = scale; a.causal = causal; a.window = window;
  return dispatch(kFwd, a, dtype, stream);
}

// dq, and delta = rowsum(dout * o) for ds_flash_bwd_dkv.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* slopes, void* dq,
                               void* delta, int B, int Hq, int Hkv, int sq,
                               int sk, int D, float scale, int causal,
                               int window, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = const_cast<void*>(lse);
  a.slopes = slopes; a.dq = dq; a.delta = delta;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.sq = sq; a.sk = sk; a.D = D;
  a.scale = scale; a.causal = causal; a.window = window;
  return dispatch(kDq, a, dtype, stream);
}

// dk and dv, summed over each kv head's group of q heads.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* slopes,
                                void* dk, void* dv, int B, int Hq, int Hkv,
                                int sq, int sk, int D, float scale,
                                int causal, int window, int dtype,
                                void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = const_cast<void*>(lse);
  a.delta = const_cast<void*>(delta);
  a.slopes = slopes; a.dk = dk; a.dv = dv;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.sq = sq; a.sk = sk; a.D = D;
  a.scale = scale; a.causal = causal; a.window = window;
  return dispatch(kDkv, a, dtype, stream);
}

// Dynamic shared memory of one block of a pass (0 fwd, 1 dq, 2 dk/dv) at
// head dim D; ptxas -v does not see dynamic shared memory.
extern "C" int ds_flash_smem_bytes(int pass, int D) {
  if (D > 64)
    return pass == kFwd ? Smem<128>::fwd : pass == kDq ? Smem<128>::dq
                                                       : Smem<128>::dkv;
  return pass == kFwd ? Smem<64>::fwd : pass == kDq ? Smem<64>::dq
                                                    : Smem<64>::dkv;
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
