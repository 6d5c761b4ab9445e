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
// o, dq, dk and dv are rounded once to the input type.
//
// Two routes, chosen by the input type in dispatch(); no fallback between
// them (a launch that fails returns its error).
//
// bf16 and fp16 (both training paths): the tensor cores, built from the
// pieces in mma_common.cuh (shared with flash_bias.cu).  Products are
// mma.sync.m16n8k16 (bf16 or f16 in, fp32 accumulate).  Tiles stay in the
// input type in shared memory, filled by 16-byte cp.async copies (zero-fill
// past the sequence and past D, as `src-size` 0) into a double-buffered
// ring whose next tile is in flight while the current one is multiplied;
// rows are padded by 16 bytes, so the 8 row addresses of an ldmatrix fall
// in 8 distinct bank groups.  Operands reach the registers by ldmatrix
// (.trans for the [k][n] operands: V in P*V, K in dS*K, dO in Pt*dO, Q in
// dSt*Q).  S = Q K^T and dP = dO V^T have exact bf16/fp16 inputs, so one
// mma each is exact up to the fp32 summation order.  P and dS are fp32
// values (the reference's arithmetic): each is split into hi = round(x)
// and lo = round(x - hi) in the input type, and two mmas (lo, then hi) add
// hi*B and lo*B into the same fp32 accumulator, which keeps P and dS to
// about 16 significant bits (bf16) or 22 (fp16) instead of 8 or 11.  In
// fp16 that needs scaling by powers of two, since fp16's lo is subnormal
// (fewer bits, down to none) for |x| below 2^-3 and its hi overflows above
// 65504: P enters its split as P * 2^15 (22 bits for P >= 2^-18), each
// row's dS as dS * 2^e with e from the row's largest |dS| so far (22 bits
// down to 2^-17 of that value; see ds_exp), and the accumulators are
// unscaled exactly.  bf16 has fp32's exponent range and is not scaled.
// That costs 3 product-units in the forward (S, 2 x PV) and 10 in the
// backward (S, dP, 2 x dQ; S, dP, 2 x dV, 2 x dK) where the bound counts
// 2 and 5.
// Exponentials are one ex2.approx each (scores kept in log2 units; lse is
// written in natural log).  Blocks are 4 warps of 16 rows (or keys) each,
// and an SM holds 2-4 of them (Cfg: registers and shared memory decide),
// so that one block's softmax and barrier overlap another's products; one
// barrier a tile, after which the next tile's copies are issued into the
// slot the previous tile freed.
// - Forward: a block per (64 query rows, q head, batch); a warp keeps its
//   Q fragments in registers.  The fp32 C fragment of a 16 x 8 score tile
//   is laid out as the A fragment of m16n8k16 for two neighbouring 8-key
//   tiles, so P's hi and lo halves are packed in registers and fed
//   straight to P*V; the online softmax (row max and sum over the 4
//   threads of a quad) works on the fragments.  64-key tiles, live ones
//   only (causal and window bounds).
// - dq: the same grid.  The block first forms delta = rowsum(dO * O) for
//   its rows from o as stored (written out for the dk/dv kernel: the one
//   fp32 FMA loop over D left, S * D work); per key tile (32 keys at D =
//   128, 64 at 64) a warp forms S and dP for its 16 rows, P from the saved
//   lse, dS = P (dP - delta) scale in registers, and dq += dS K.
// - dk/dv: a block per (64 keys, kv head, batch).  It loops over the g =
//   Hq / Hkv q heads of its kv head and the live 64-row q tiles (Q, dO,
//   lse and delta in the ring), 32 queries at a time, forming S^T = K Q^T
//   and dP^T = V dO^T directly, so that P^T and dS^T are A fragments for
//   dv += P^T dO and dk += dS^T Q; dk and dv are summed over the GQA group
//   in fp32 and written once (the Pallas path writes per-q-head results
//   and sums them after).
// A warp whose rows (or keys) see nothing of a tile skips it: the masked
// products would add exact zeros.  Blocks are ordered heaviest first (the
// last q tiles see the most keys, the first k tiles the most queries).  No
// atomics: every output has one writer and a fixed summation order, so two
// runs are bit-equal.
//
// fp32 (no training path runs it on the card): the CUDA cores, as before.
// Every block has 256 threads as a 16 x 16 grid (ty, tx) over a 64 x 64
// score tile: thread (ty, tx) owns rows ty + 16i and columns tx + 16j (i, j
// < 4), so row reductions are four xor-shuffles over a half-warp.  Tiles
// live in shared memory as fp32, rows padded by 4 floats; products are fp32
// FMA: scores as float4 dot products along D, P*V with each thread holding
// a 4 x (D/16) slice of the output.  Same grid and loops as above, with
// 64-row tiles.
//
// What bounds it on an H100: operations.  At D = 128 a 64 x 64 tile pair
// does 2 * 64 * 64 * 128 flops per product for 32 KB of bf16 tiles, far
// above the ~300 flops per byte where bytes would bind.  mma.sync reaches
// part of the 989 TFLOP/s that wgmma can; the split products add 50 %
// (forward) and 100 % (backward) to the tensor-core work, and every warp
// reads its B operands from shared memory for 16 rows only, so ldmatrix
// traffic is as large as the products'.  What a later wgmma/TMA PR would
// add: 64-row warpgroup products with B read straight from shared memory
// (no ldmatrix, no per-warp copies of K and V in registers), TMA tile
// loads signalled through mbarriers instead of cp.async issued by every
// thread, and producer/consumer warp specialisation so that one
// warpgroup's softmax overlaps another's products (FlashAttention-3's
// ping-pong).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_common.cuh"

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = 80;        // row stride (floats) of the P / dS tiles

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

// Rows [row0, row0 + 64) of a [S, heads, D] slice (row stride `rstride`
// elements, `src` at head h, d 0) → fp32 tile [64][DP + 4]; rows >= nrows
// and columns >= D are zero.
template <int DP>
__device__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                          int nrows, int64_t rstride, int D) {
  constexpr int ST = DP + 4;
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, s = row0 + r;
    float x = 0.f;
    if (s < nrows && d < D) x = src[(int64_t)s * rstride + d];
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

// Rows of a [64][*] accumulator tile → out[row, head, d].
template <int DP>
__device__ void store_rows(float* __restrict__ out,
                           const float4 acc[4][DP / 64],
                           const float den[4], bool divide, int row0,
                           int nrows, int64_t rstride, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty + 16 * i;
    if (s >= nrows) continue;
    float* o = out + (int64_t)s * rstride;
#pragma unroll
    for (int j = 0; j < DP / 64; ++j) {
      const int d = 4 * tx + 64 * j;
      const float a[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z, acc[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) o[d + e] = divide ? a[e] / den[i] : a[e];
    }
  }
}

// ------------------------------------------------------------------ forward
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ slopes, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int sq, int sk,
                 int D, float scale, int causal, int window) {
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
  const float* qb = q + (int64_t)b * sq * qrs + (int64_t)h * D;
  const float* kb = k + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float* vb = v + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float slope = slopes ? slopes[h] : 0.f;

  load_tile<DP>(qs, qb, q0, sq, qrs, D);

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
    load_tile<DP>(ks, kb, k0, sk, kvrs, D);
    load_tile<DP>(vs, vb, k0, sk, kvrs, D);
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
  store_rows<DP>(o + (int64_t)b * sq * qrs + (int64_t)h * D, acc, lsafe,
                    true, q0, sq, qrs, D, ty, tx);
}

// ----------------------------------------------------------------- dq pass
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ slopes, float* __restrict__ dq,
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
  const float* kb = k + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float* vb = v + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float slope = slopes ? slopes[h] : 0.f;
  const int64_t rowvec = ((int64_t)b * Hq + h) * sq;

  load_tile<DP>(qs, q + qoff, q0, sq, qrs, D);
  load_tile<DP>(dos, dout + qoff, q0, sq, qrs, D);
  __syncthreads();
  // delta = rowsum(dO * O) over this tile's rows; one warp per 8 rows
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int s = q0 + r;
    float acc = 0.f;
    if (s < sq) {
      const float* orow = o + qoff + (int64_t)s * qrs;
      for (int d = lane; d < D; d += 32)
        acc += dos[r * ST + d] * orow[d];
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
    load_tile<DP>(ks, kb, k0, sk, kvrs, D);
    load_tile<DP>(vs, vb, k0, sk, kvrs, D);
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
  store_rows<DP>(dq + qoff, acc, one, false, q0, sq, qrs, D, ty, tx);
}

// -------------------------------------------------------------- dk/dv pass
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ slopes, float* __restrict__ dk,
                     float* __restrict__ dv, int Hq, int Hkv, int sq, int sk,
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

  load_tile<DP>(ks, k + kvoff, k0, sk, kvrs, D);
  load_tile<DP>(vs, v + kvoff, k0, sk, kvrs, D);

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
      load_tile<DP>(qs, q + qoff, q0, sq, qrs, D);
      load_tile<DP>(dos, dout + qoff, q0, sq, qrs, D);
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
  store_rows<DP>(dk + kvoff, dk_acc, one, false, k0, sk, kvrs, D, ty, tx);
  store_rows<DP>(dv + kvoff, dv_acc, one, false, k0, sk, kvrs, D, ty, tx);
}

// ===================================== tensor-core route (bf16 and fp16)

constexpr int kBQ = 64;           // fwd, dq: query rows a block, 16 a warp
constexpr int kBN = 64;           // fwd: keys a tile
constexpr int kBKV = 64;          // dk/dv: keys a block, 16 a warp
constexpr int kBM = 64;           // dk/dv: query rows a ring slot
constexpr int kQC = 32;           // dk/dv: queries a warp takes at once

// What depends on the padded head dim DP: dq's keys a tile, and the blocks
// an SM holds at once (the register cap follows: 65536 / (128 x blocks)),
// as registers and shared memory allow at each width.  Shared-memory
// tiles are in the input type with row stride DP + 8 elements.
template <int DP>
struct Cfg {
  static constexpr int kS = DP + 8;
  static constexpr int fwd_blocks = DP == 64 ? 3 : 2;
  static constexpr int dq_kn = DP == 64 ? 64 : 32;
  static constexpr int dq_blocks = DP == 64 ? 4 : 3;
  static constexpr int dkv_blocks = DP == 64 ? 3 : 2;
  // bytes: q | k, v ring; q, dO | k, v ring | lse, delta;
  // k, v | q, dO ring | lse, delta ring
  static constexpr int fwd_smem = (kBQ + 4 * kBN) * kS * 2;
  static constexpr int dq_smem = (2 * kBQ + 4 * dq_kn) * kS * 2 + 2 * kBQ * 4;
  static constexpr int dkv_smem = (2 * kBKV + 4 * kBM) * kS * 2 + 4 * kBM * 4;
};

// ------------------------------------------------------------ forward
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, Cfg<DP>::fwd_blocks)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ slopes, T* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hkv, int sq,
                     int sk, int D, float scale, int causal, int window,
                     int vec) {
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8;
  constexpr float kP = Tc<T>::kPScale;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * S;  // [2][kBN][S]
  T* vs = ks + 2 * kBN * S;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)((int64_t)h * Hkv / Hq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kBQ, off = sk - sq;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int r0 = w0 + g;          // the thread's rows: r0 and r0 + 8
  const int64_t qrs = (int64_t)Hq * D, kvrs = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * sq * qrs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  // scores in log2 units, so that every exponential is one ex2
  const float sl2 = scale * kLog2e;
  const float al2 = (slopes ? slopes[h] : 0.f) * kLog2e;

  int k_lo = 0, k_hi = sk - 1;
  if (causal) {
    k_hi = min(k_hi, q0 + kBQ - 1 + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  const int kt0 = k_lo / kBN;
  const int n = k_hi < k_lo ? 0 : k_hi / kBN - kt0 + 1;

  stage_rows<T, kBQ, DP>(qs, qb, q0, sq, qrs, D, vec);
  cp_async_commit();
  if (n > 0) {
    stage_rows<T, kBN, DP>(ks, kb, kt0 * kBN, sk, kvrs, D, vec);
    stage_rows<T, kBN, DP>(vs, vb, kt0 * kBN, sk, kvrs, D, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    load_a<S>(qa[kd], qs, warp * 16, kd * 16, lane);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * kBN;
    const T* kt = ks + (it & 1) * kBN * S;
    const T* vt = vs + (it & 1) * kBN * S;
    cp_async_wait<0>();  // tile it has landed (this thread's copies)
    // every thread's copies have landed, and every warp is done with tile
    // it - 1, whose slot the next copies refill while tile it is used
    __syncthreads();
    if (it + 1 < n) {
      stage_rows<T, kBN, DP>(ks + ((it + 1) & 1) * kBN * S, kb, k0 + kBN, sk,
                             kvrs, D, vec);
      stage_rows<T, kBN, DP>(vs + ((it + 1) & 1) * kBN * S, vb, k0 + kBN, sk,
                             kvrs, D, vec);
    }
    cp_async_commit();
    bool live = w0 < sq;  // some row of the warp sees some key of the tile
    if (causal)
      live = live && k0 <= w0 + 15 + off &&
             (window <= 0 || k0 + kBN - 1 > w0 + off - window);
    if (live) {
      float s[kBN / 8][4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int nj = 0; nj < kBN / 16; ++nj) {
          uint32_t bf[4];
          load_b<S>(bf, kt, nj * 16, kd * 16, lane);
          Tc<T>::mma(s[2 * nj], qa[kd], bf);
          Tc<T>::mma(s[2 * nj + 1], qa[kd], bf + 2);
        }
      // every (row, key) pair of the warp and the tile is visible
      const bool full =
          k0 + kBN <= sk && w0 + 15 < sq &&
          (!causal || (k0 + kBN - 1 <= w0 + off &&
                       (window <= 0 || k0 > w0 + 15 + off - window)));
      float mx[2] = {-INFINITY, -INFINITY};
      const float c0 = (float)(k0 + 2 * t);  // + 8j + e%2: exact in fp32
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e / 2) * 8, col = k0 + 8 * j + 2 * t + e % 2;
          const float x =
              s[j][e] * sl2 + al2 * (c0 + (float)(8 * j + e % 2));
          s[j][e] = (full || visible(row, col, sq, sk, causal, window))
                        ? x : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float alpha[2], msafe[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        msafe[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = m[i] == -INFINITY ? 0.f : ex2(m[i] - msafe[i]);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - msafe[e / 2]);  // masked: 2^-inf = 0
          rs[e / 2] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = alpha[i] * l[i] + rs[i];
      }
      scale_rows<NT>(acc, alpha);
      // o += P V, P = hi + lo (of P * kP): the score fragments of keys
      // 16kk.. are the A fragment of that depth step
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        uint32_t ph[4], pl[4];
        Tc<T>::split(kP * s[2 * kk][0], kP * s[2 * kk][1], ph[0], pl[0]);
        Tc<T>::split(kP * s[2 * kk][2], kP * s[2 * kk][3], ph[1], pl[1]);
        Tc<T>::split(kP * s[2 * kk + 1][0], kP * s[2 * kk + 1][1], ph[2],
                     pl[2]);
        Tc<T>::split(kP * s[2 * kk + 1][2], kP * s[2 * kk + 1][3], ph[3],
                     pl[3]);
#pragma unroll
        for (int nd = 0; nd < NT / 2; ++nd) {
          uint32_t bf[4];
          load_bt<S>(bf, vt, kk * 16, nd * 16, lane);
          Tc<T>::mma(acc[2 * nd], pl, bf);
          Tc<T>::mma(acc[2 * nd], ph, bf);
          Tc<T>::mma(acc[2 * nd + 1], pl, bf + 2);
          Tc<T>::mma(acc[2 * nd + 1], ph, bf + 2);
        }
      }
    }
  }

  float den[2];  // l * kP: acc holds kP * sum P V (exact scalings)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    den[i] = lsafe * kP;
    const int row = r0 + 8 * i;
    if (t == 0 && row < sq)
      lse[((int64_t)b * Hq + h) * sq + row] =
          m[i] == -INFINITY ? kDeadRowLse : m[i] * kLn2 + logf(lsafe);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] /= den[0];
    acc[nt][1] /= den[0];
    acc[nt][2] /= den[1];
    acc[nt][3] /= den[1];
  }
  store_frag<T, DP>(o + (int64_t)b * sq * qrs + (int64_t)h * D, acc, r0, sq,
                    qrs, D, t, vec);
}

// ------------------------------------------------------------- dq pass
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, Cfg<DP>::dq_blocks)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ slopes, T* __restrict__ dq,
                        float* __restrict__ delta, int Hq, int Hkv, int sq,
                        int sk, int D, float scale, int causal, int window,
                        int vec) {
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8;
  constexpr int KN = Cfg<DP>::dq_kn;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kBQ * S;
  T* ks = dos + kBQ * S;  // [2][KN][S]
  T* vs = ks + 2 * KN * S;
  float* r_lse = reinterpret_cast<float*>(vs + 2 * KN * S);
  float* r_delta = r_lse + kBQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)((int64_t)h * Hkv / Hq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kBQ, off = sk - sq;
  const int w0 = q0 + warp * 16, r0 = w0 + g;
  const int64_t qrs = (int64_t)Hq * D, kvrs = (int64_t)Hkv * D;
  const int64_t qoff = (int64_t)b * sq * qrs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float sl2 = scale * kLog2e;  // log2 units, as in the forward
  const float al2 = (slopes ? slopes[h] : 0.f) * kLog2e;
  const int64_t rowvec = ((int64_t)b * Hq + h) * sq;

  int k_lo = 0, k_hi = sk - 1;
  if (causal) {
    k_hi = min(k_hi, q0 + kBQ - 1 + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  const int kt0 = k_lo / KN;
  const int n = k_hi < k_lo ? 0 : k_hi / KN - kt0 + 1;

  stage_rows<T, kBQ, DP>(qs, q + qoff, q0, sq, qrs, D, vec);
  stage_rows<T, kBQ, DP>(dos, dout + qoff, q0, sq, qrs, D, vec);
  cp_async_commit();
  if (n > 0) {
    stage_rows<T, KN, DP>(ks, kb, kt0 * KN, sk, kvrs, D, vec);
    stage_rows<T, KN, DP>(vs, vb, kt0 * KN, sk, kvrs, D, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // delta = rowsum(dO * O) over the warp's own 16 rows
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, s = q0 + r;
    float a = 0.f;
    if (s < sq) {
      const T* orow = o + qoff + (int64_t)s * qrs;
      for (int d = lane; d < D; d += 32)
        a += Cvt<T>::to_f(dos[r * S + d]) * Cvt<T>::to_f(orow[d]);
    }
    a = warp_sum(a);
    if (lane == 0) {
      r_delta[r] = a;
      r_lse[r] = s < sq ? lse[rowvec + s] : 0.f;
      if (s < sq) delta[rowvec + s] = a;
    }
  }
  __syncwarp();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = r_lse[warp * 16 + g + 8 * i] * kLog2e;
    delta_r[i] = r_delta[warp * 16 + g + 8 * i];
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  int de[2] = {kDsExpMax, kDsExpMax};  // fp16: the rows' dS exponents

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * KN;
    const T* kt = ks + (it & 1) * KN * S;
    const T* vt = vs + (it & 1) * KN * S;
    cp_async_wait<0>();  // as in the forward: one barrier a tile
    __syncthreads();
    if (it + 1 < n) {
      stage_rows<T, KN, DP>(ks + ((it + 1) & 1) * KN * S, kb, k0 + KN, sk,
                             kvrs, D, vec);
      stage_rows<T, KN, DP>(vs + ((it + 1) & 1) * KN * S, vb, k0 + KN, sk,
                             kvrs, D, vec);
    }
    cp_async_commit();
    bool live = w0 < sq;
    if (causal)
      live = live && k0 <= w0 + 15 + off &&
             (window <= 0 || k0 + KN - 1 > w0 + off - window);
    if (live) {
      float s[KN / 8][4], dp[KN / 8][4];
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t aq[4], ado[4];
        load_a<S>(aq, qs, warp * 16, kd * 16, lane);
        load_a<S>(ado, dos, warp * 16, kd * 16, lane);
#pragma unroll
        for (int nj = 0; nj < KN / 16; ++nj) {
          uint32_t bk[4], bv[4];
          load_b<S>(bk, kt, nj * 16, kd * 16, lane);
          load_b<S>(bv, vt, nj * 16, kd * 16, lane);
          Tc<T>::mma(s[2 * nj], aq, bk);
          Tc<T>::mma(s[2 * nj + 1], aq, bk + 2);
          Tc<T>::mma(dp[2 * nj], ado, bv);
          Tc<T>::mma(dp[2 * nj + 1], ado, bv + 2);
        }
      }
      const bool full =
          k0 + KN <= sk && w0 + 15 < sq &&
          (!causal || (k0 + KN - 1 <= w0 + off &&
                       (window <= 0 || k0 > w0 + 15 + off - window)));
      // dS = P (dP - delta) scale, in place of s
      const float c0 = (float)(k0 + 2 * t);
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e / 2) * 8, col = k0 + 8 * j + 2 * t + e % 2;
          const float x =
              s[j][e] * sl2 + al2 * (c0 + (float)(8 * j + e % 2));
          const float p = (full || visible(row, col, sq, sk, causal, window))
                              ? ex2(x - lse_r[e / 2]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[e / 2]) * scale;
        }
      if constexpr (Tc<T>::kScaleDs) {
        float factor[2], sc[2];
        ds_rescale<KN / 8>(s, de, factor, sc);
        scale_rows<NT>(acc, factor);
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sc[e / 2];
      }
      // dq += dS K, dS = hi + lo
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        uint32_t dh[4], dl[4];
        Tc<T>::split(s[2 * kk][0], s[2 * kk][1], dh[0], dl[0]);
        Tc<T>::split(s[2 * kk][2], s[2 * kk][3], dh[1], dl[1]);
        Tc<T>::split(s[2 * kk + 1][0], s[2 * kk + 1][1], dh[2], dl[2]);
        Tc<T>::split(s[2 * kk + 1][2], s[2 * kk + 1][3], dh[3], dl[3]);
#pragma unroll
        for (int nd = 0; nd < NT / 2; ++nd) {
          uint32_t bf[4];
          load_bt<S>(bf, kt, kk * 16, nd * 16, lane);
          Tc<T>::mma(acc[2 * nd], dl, bf);
          Tc<T>::mma(acc[2 * nd], dh, bf);
          Tc<T>::mma(acc[2 * nd + 1], dl, bf + 2);
          Tc<T>::mma(acc[2 * nd + 1], dh, bf + 2);
        }
      }
    }
  }
  if constexpr (Tc<T>::kScaleDs) {
    const float f[2] = {pow2(-de[0]), pow2(-de[1])};
    scale_rows<NT>(acc, f);
  }
  store_frag<T, DP>(dq + qoff, acc, r0, sq, qrs, D, t, vec);
}

// ---------------------------------------------------------- dk/dv pass
// Q, dO rows [q0, q0 + kBM) of q head h, and their lse and delta, into one
// slot of the ring.
template <typename T, int DP>
__device__ __forceinline__ void stage_q_tile(
    T* qs, T* dos, float* rl, float* rd, const T* __restrict__ q,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int64_t qoff, int64_t rowvec, int q0,
    int sq, int64_t qrs, int D, bool vec) {
  stage_rows<T, kBM, DP>(qs, q + qoff, q0, sq, qrs, D, vec);
  stage_rows<T, kBM, DP>(dos, dout + qoff, q0, sq, qrs, D, vec);
  const int i = threadIdx.x;
  if (i < 2 * kBM) {
    const int r = i % kBM, s = q0 + r;
    const bool ok = s < sq;
    const float* src = i < kBM ? lse : delta;
    cp_async4((i < kBM ? rl : rd) + r, ok ? src + rowvec + s : src, ok);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, Cfg<DP>::dkv_blocks)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ slopes,
                         T* __restrict__ dk, T* __restrict__ dv, int Hq,
                         int Hkv, int sq, int sk, int D, float scale,
                         int causal, int window, int vec) {
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8;
  constexpr float kP = Tc<T>::kPScale;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBKV * S;
  T* qs = vs + kBKV * S;   // [2][kBM][S]
  T* dos = qs + 2 * kBM * S;
  float* r_lse = reinterpret_cast<float*>(dos + 2 * kBM * S);  // [2][kBM]
  float* r_delta = r_lse + 2 * kBM;

  const int kt = blockIdx.x;  // the first k tiles see the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int grp = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = kt * kBKV, off = sk - sq;
  const int kw0 = k0 + warp * 16;  // the warp's first key
  const float kf = (float)(kw0 + g);  // the thread's key, + 8 (e / 2)
  const int64_t qrs = (int64_t)Hq * D, kvrs = (int64_t)Hkv * D;
  const int64_t kvoff = (int64_t)b * sk * kvrs + (int64_t)kvh * D;
  const float sl2 = scale * kLog2e;  // log2 units, as in the forward

  int q_lo = 0, q_hi = sq - 1;
  if (causal) {
    q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(q_hi, k0 + kBKV - 2 - off + window);
  }
  const int qt0 = q_lo / kBM;
  const int nqt = q_hi < q_lo ? 0 : q_hi / kBM - qt0 + 1;
  const int n = grp * nqt;  // (q head, q tile) steps, head outer

  stage_rows<T, kBKV, DP>(ks, k + kvoff, k0, sk, kvrs, D, vec);
  stage_rows<T, kBKV, DP>(vs, v + kvoff, k0, sk, kvrs, D, vec);
  cp_async_commit();
  if (n > 0) {
    const int h = kvh * grp;
    stage_q_tile<T, DP>(qs, dos, r_lse, r_delta, q, dout, lse, delta,
                        (int64_t)b * sq * qrs + (int64_t)h * D,
                        ((int64_t)b * Hq + h) * sq, qt0 * kBM, sq, qrs, D,
                        vec);
  }
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  int de[2] = {kDsExpMax, kDsExpMax};  // fp16: the keys' dS exponents

  for (int it = 0; it < n; ++it) {
    const int h = kvh * grp + it / nqt, q0 = (qt0 + it % nqt) * kBM;
    const int buf = it & 1;
    cp_async_wait<0>();  // as in the forward: one barrier a tile
    __syncthreads();
    if (it + 1 < n) {
      const int h1 = kvh * grp + (it + 1) / nqt;
      const int nb = buf ^ 1;
      stage_q_tile<T, DP>(qs + nb * kBM * S, dos + nb * kBM * S,
                              r_lse + nb * kBM, r_delta + nb * kBM, q, dout,
                              lse, delta,
                              (int64_t)b * sq * qrs + (int64_t)h1 * D,
                              ((int64_t)b * Hq + h1) * sq,
                              (qt0 + (it + 1) % nqt) * kBM, sq, qrs, D, vec);
    }
    cp_async_commit();
    const float al2 = (slopes ? slopes[h] : 0.f) * kLog2e;
    const T* qt_ = qs + buf * kBM * S;
    const T* dot_ = dos + buf * kBM * S;
    const float* lt = r_lse + buf * kBM;
    const float* dt = r_delta + buf * kBM;
#pragma unroll 1
    for (int c = 0; c < kBM; c += kQC) {
      const int c0 = q0 + c;  // the chunk's first query
      bool live = kw0 < sk && c0 < sq;
      if (causal)
        live = live && c0 + kQC - 1 + off >= kw0 &&
               (window <= 0 || kw0 + 15 > c0 + off - window);
      if (!live) continue;
      float st[kQC / 8][4], dpt[kQC / 8][4];  // [key][query]
#pragma unroll
      for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ak[4], av[4];
        load_a<S>(ak, ks, warp * 16, kd * 16, lane);
        load_a<S>(av, vs, warp * 16, kd * 16, lane);
#pragma unroll
        for (int nj = 0; nj < kQC / 16; ++nj) {
          uint32_t bq[4], bo[4];
          load_b<S>(bq, qt_, c + nj * 16, kd * 16, lane);
          load_b<S>(bo, dot_, c + nj * 16, kd * 16, lane);
          Tc<T>::mma(st[2 * nj], ak, bq);
          Tc<T>::mma(st[2 * nj + 1], ak, bq + 2);
          Tc<T>::mma(dpt[2 * nj], av, bo);
          Tc<T>::mma(dpt[2 * nj + 1], av, bo + 2);
        }
      }
      const bool full =
          kw0 + 16 <= sk && c0 + kQC <= sq &&
          (!causal || (kw0 + 15 <= c0 + off &&
                       (window <= 0 || kw0 > c0 + kQC - 1 + off - window)));
      // P^T into st, dS^T = P^T (dP^T - delta) scale into dpt
#pragma unroll
      for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c + 8 * j + 2 * t + e % 2;
          const int row = q0 + qi, col = kw0 + g + (e / 2) * 8;
          const float x =
              st[j][e] * sl2 + al2 * (kf + (float)((e / 2) * 8));
          const float p = (full || visible(row, col, sq, sk, causal, window))
                              ? ex2(x - lt[qi] * kLog2e) : 0.f;
          st[j][e] = kP * p;
          dpt[j][e] = p * (dpt[j][e] - dt[qi]) * scale;
        }
      if constexpr (Tc<T>::kScaleDs) {
        float factor[2], sc[2];
        ds_rescale<kQC / 8>(dpt, de, factor, sc);
        scale_rows<NT>(dk_acc, factor);
#pragma unroll
        for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpt[j][e] *= sc[e / 2];
      }
      // dv += P^T dO and dk += dS^T Q over the chunk's queries
#pragma unroll
      for (int kk = 0; kk < kQC / 16; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        Tc<T>::split(st[2 * kk][0], st[2 * kk][1], ph[0], pl[0]);
        Tc<T>::split(st[2 * kk][2], st[2 * kk][3], ph[1], pl[1]);
        Tc<T>::split(st[2 * kk + 1][0], st[2 * kk + 1][1], ph[2], pl[2]);
        Tc<T>::split(st[2 * kk + 1][2], st[2 * kk + 1][3], ph[3], pl[3]);
        Tc<T>::split(dpt[2 * kk][0], dpt[2 * kk][1], dh[0], dl[0]);
        Tc<T>::split(dpt[2 * kk][2], dpt[2 * kk][3], dh[1], dl[1]);
        Tc<T>::split(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1], dh[2], dl[2]);
        Tc<T>::split(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3], dh[3], dl[3]);
#pragma unroll
        for (int nd = 0; nd < NT / 2; ++nd) {
          uint32_t bo[4], bq[4];
          load_bt<S>(bo, dot_, c + kk * 16, nd * 16, lane);
          Tc<T>::mma(dv_acc[2 * nd], pl, bo);
          Tc<T>::mma(dv_acc[2 * nd], ph, bo);
          Tc<T>::mma(dv_acc[2 * nd + 1], pl, bo + 2);
          Tc<T>::mma(dv_acc[2 * nd + 1], ph, bo + 2);
          load_bt<S>(bq, qt_, c + kk * 16, nd * 16, lane);
          Tc<T>::mma(dk_acc[2 * nd], dl, bq);
          Tc<T>::mma(dk_acc[2 * nd], dh, bq);
          Tc<T>::mma(dk_acc[2 * nd + 1], dl, bq + 2);
          Tc<T>::mma(dk_acc[2 * nd + 1], dh, bq + 2);
        }
      }
    }
  }
  cp_async_wait<0>();  // with no live q tile the K/V copies are in flight
  if constexpr (Tc<T>::kScaleDs) {
    const float f[2] = {pow2(-de[0]), pow2(-de[1])};
    scale_rows<NT>(dk_acc, f);
  }
  if constexpr (kP != 1.f) {
    const float f[2] = {1.f / kP, 1.f / kP};
    scale_rows<NT>(dv_acc, f);
  }
  store_frag<T, DP>(dk + kvoff, dk_acc, kw0 + g, sk, kvrs, D, t, vec);
  store_frag<T, DP>(dv + kvoff, dv_acc, kw0 + g, sk, kvrs, D, t, vec);
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

template <int DP>
cudaError_t run_fwd(const Args& a, cudaStream_t st) {
  static bool configured = false;
  auto kern = flash_fwd_kernel<DP>;
  if (!configured) {
    cudaError_t e = allow_smem(kern, Smem<DP>::fwd);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.sq + kTile - 1) / kTile, a.Hq, a.B);
  kern<<<grid, kThreads, Smem<DP>::fwd, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.slopes),
      static_cast<float*>(a.out), static_cast<float*>(a.lse), a.Hq, a.Hkv, a.sq,
      a.sk, a.D, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t run_dq(const Args& a, cudaStream_t st) {
  static bool configured = false;
  auto kern = flash_bwd_dq_kernel<DP>;
  if (!configured) {
    cudaError_t e = allow_smem(kern, Smem<DP>::dq);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.sq + kTile - 1) / kTile, a.Hq, a.B);
  kern<<<grid, kThreads, Smem<DP>::dq, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.slopes), static_cast<float*>(a.dq),
      static_cast<float*>(a.delta), a.Hq, a.Hkv, a.sq, a.sk, a.D, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t run_dkv(const Args& a, cudaStream_t st) {
  static bool configured = false;
  auto kern = flash_bwd_dkv_kernel<DP>;
  if (!configured) {
    cudaError_t e = allow_smem(kern, Smem<DP>::dkv);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.sk + kTile - 1) / kTile, a.Hkv, a.B);
  kern<<<grid, kThreads, Smem<DP>::dkv, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.slopes), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Hq, a.Hkv, a.sq, a.sk, a.D, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <int DP>
cudaError_t run(int pass, const Args& a, cudaStream_t st) {
  if (pass == kFwd) return run_fwd<DP>(a, st);
  if (pass == kDq) return run_dq<DP>(a, st);
  return run_dkv<DP>(a, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tensor-core route of one pass for input type T at padded head dim DP.
template <typename T, int DP>
cudaError_t run_mma(int pass, const Args& a, cudaStream_t st) {
  // 16-byte copies need rows of whole 16-byte chunks at 16-byte addresses
  int vec = a.D % 8 == 0;
  const void* ptrs[] = {a.q, a.k, a.v, a.o, a.dout, a.out, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (p && !aligned16(p)) vec = 0;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* slopes = static_cast<const float*>(a.slopes);
  if (pass == kFwd) {
    static bool configured = false;
    auto kern = flash_fwd_mma_kernel<T, DP>;
    if (!configured) {
      cudaError_t e = allow_smem(kern, Cfg<DP>::fwd_smem);
      if (e != cudaSuccess) return e;
      configured = true;
    }
    dim3 grid((a.sq + kBQ - 1) / kBQ, a.Hq, a.B);
    kern<<<grid, kMmaThreads, Cfg<DP>::fwd_smem, st>>>(
        q, k, v, slopes, static_cast<T*>(a.out), static_cast<float*>(a.lse),
        a.Hq, a.Hkv, a.sq, a.sk, a.D, a.scale, a.causal, a.window, vec);
  } else if (pass == kDq) {
    static bool configured = false;
    auto kern = flash_bwd_dq_mma_kernel<T, DP>;
    if (!configured) {
      cudaError_t e = allow_smem(kern, Cfg<DP>::dq_smem);
      if (e != cudaSuccess) return e;
      configured = true;
    }
    dim3 grid((a.sq + kBQ - 1) / kBQ, a.Hq, a.B);
    kern<<<grid, kMmaThreads, Cfg<DP>::dq_smem, st>>>(
        q, k, v, static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), slopes, static_cast<T*>(a.dq),
        static_cast<float*>(a.delta), a.Hq, a.Hkv, a.sq, a.sk, a.D, a.scale,
        a.causal, a.window, vec);
  } else {
    static bool configured = false;
    auto kern = flash_bwd_dkv_mma_kernel<T, DP>;
    if (!configured) {
      cudaError_t e = allow_smem(kern, Cfg<DP>::dkv_smem);
      if (e != cudaSuccess) return e;
      configured = true;
    }
    dim3 grid((a.sk + kBKV - 1) / kBKV, a.Hkv, a.B);
    kern<<<grid, kMmaThreads, Cfg<DP>::dkv_smem, st>>>(
        q, k, v, static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        slopes, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Hq, a.Hkv,
        a.sq, a.sk, a.D, a.scale, a.causal, a.window, vec);
  }
  return cudaGetLastError();
}

int dispatch(int pass, const Args& a, int dtype, void* stream) {
  if (a.B <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv || a.sq <= 0 ||
      a.sk <= 0 || a.D <= 0 || a.D > 128 || a.B > 65535 || a.Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = a.D > 64;
  if (dtype == 0)
    return (int)(wide ? run<128>(pass, a, st) : run<64>(pass, a, st));
  if (dtype == 1)
    return (int)(wide ? run_mma<__nv_bfloat16, 128>(pass, a, st)
                      : run_mma<__nv_bfloat16, 64>(pass, a, st));
  if (dtype == 2)
    return (int)(wide ? run_mma<__half, 128>(pass, a, st)
                      : run_mma<__half, 64>(pass, a, st));
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

// Dynamic shared memory of one block of a pass at head dim D: pass 0 fwd,
// 1 dq, 2 dk/dv on the tensor-core route (bf16, fp16); kFp32Route + the
// same passes on the fp32 route (FP32_ROUTE_PASS in the Python wrapper).
// ptxas -v does not see dynamic shared memory.
constexpr int kFp32Route = 3;

extern "C" int ds_flash_smem_bytes(int pass, int D) {
  if (pass >= kFp32Route) {
    pass -= kFp32Route;
    if (D > 64)
      return pass == kFwd ? Smem<128>::fwd : pass == kDq ? Smem<128>::dq
                                                         : Smem<128>::dkv;
    return pass == kFwd ? Smem<64>::fwd : pass == kDq ? Smem<64>::dq
                                                      : Smem<64>::dkv;
  }
  if (D > 64)
    return pass == kFwd ? Cfg<128>::fwd_smem
                        : pass == kDq ? Cfg<128>::dq_smem : Cfg<128>::dkv_smem;
  return pass == kFwd ? Cfg<64>::fwd_smem
                      : pass == kDq ? Cfg<64>::dq_smem : Cfg<64>::dkv_smem;
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
