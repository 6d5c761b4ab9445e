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
// input type (fp32, bf16 or fp16); dbias is written in fp32 and cast to
// the bias's type by the caller.
//
// Two routes, chosen by the input type in dispatch(); no fallback between
// them (a launch that fails returns its error).
//
// bf16 and fp16 (the training paths): the tensor cores, with the pieces
// of B1 (csrc/flash_attention.cu) in mma_common.cuh.  S = Q K^T and dP =
// dO V^T are mma.sync.m16n8k16 on the exact bf16/fp16 inputs (at D = 32
// two k-steps) with fp32 accumulation.  P and dS stay fp32 values and
// enter P V, dS K, P^T dO and dS^T Q as hi + lo in the input type; in fp16
// P enters as P * 2^15 and each dS row as dS * 2^e (ds_exp), as in B1.
// dbias takes the fp32 dS directly: no product consumes it.  Scores keep
// the reference's rounding order above; each exponential is one
// ex2.approx of (s - m) * log2(e), the product taken after the
// difference, so that a row masked whole (s = m = -1e9 to the last bit)
// gives exp(0) = 1 as the reference does (log2(e) folded into scale would
// round -1e9 differently from the saved lse).  Blocks are 4 warps of 16
// query rows (or keys) each; tiles stay in the input type in shared
// memory, rows padded by 16 bytes, filled by cp.async (16-byte copies, or
// 4-byte ones for odd row strides such as H * D * 2 = 72 bytes) into a
// double-buffered ring whose next slot is in flight while the current one
// is multiplied, one barrier a tile.  The bias type is a template parameter
// (the input type or fp32); its tile rides in the ring beside K/V (or
// Q/dO) and is read in the C-fragment layout, two neighbouring keys a
// 4-byte (fp32: 8-byte) shared-memory load; the mask row (64 floats)
// rides with it.  A warp whose 16 x 64 tile is visible whole (every tile
// of a non-causal call whose lengths are multiples of 64) takes a copy of
// the score code without the per-element visibility tests.
// - Forward: a block per (64 query rows, head, batch); online softmax over
//   the live 64-key tiles with the Q fragments in registers; the score
//   C fragments are P's A fragments.
// - dq: the same grid; the block first forms delta = rowsum(dO * O) for
//   its rows (written out for the other two passes), then per key tile S,
//   dP, P from the saved lse, dS = P (dP - delta) scale, dq += dS K.
// - dk/dv: a block per (64 keys, head, batch) over the live 64-row q
//   tiles, 32 queries at a time, forming S^T = K Q^T and dP^T = V dO^T
//   directly; the bias tile [q][k] is read transposed from shared memory.
// - dbias: a block per (64 x 64 bias tile, bias head, bias batch, chunk).
//   The TPU kernel carries its sum across the sequential group axes; here
//   each bias tile's Gb * Gh group members are split into `splits` chunks
//   of consecutive members (a count from the shapes alone, computed by the
//   wrapper), so that the grid covers the card several times over.  A
//   block walks its chunk in order, summing dS into fp32 registers (one
//   rounded add a member), and writes one partial plane into scratch;
//   fb_dbias_reduce_kernel then sums the partials in chunk order.  No
//   atomics anywhere: two runs, on any card, give the same bits.
// The tensor-core route pads the head dim to 32, 64 or 128.
//
// fp32 (no training path runs it on the card): the CUDA cores, as before.
// Every block has 256 threads as a 16 x 16 grid (ty, tx) over a 64 x 64
// score tile: thread (ty, tx) owns rows ty + 16i and columns tx + 16j (i, j
// < 4).  Tiles live in shared memory as fp32 rows of DP + 4 floats, DP the
// head dim rounded up to 16, 32, 64 or 128; products are fp32 FMA; the
// bias is read through a runtime switch of its type; dbias is one block a
// bias tile over all its group members.
//
// What bounds it on an H100.  At D = 32 the products are small (2 * 32
// flops a score each) and the call's bytes (q, k, v, o, the bias and
// their gradients) set the bound of max(bytes, flops), about 0.12 ms for
// the forward at AlphaFold2's MSA-row shape.  Below that sit the
// exponentials: one a score in each of the four kernels (each recomputes
// P), at the 16-a-clock MUFU rate, about 0.14 ms a kernel at that shape.
// What the kernels spend beyond both is instruction issue: some twenty
// fp32 and integer operations a score (scale, bias and mask adds, the
// bias's bf16 unpacking, max, sums, the hi/lo split) against two or three
// MMAs per 16 x 8 x 16 step, and the copies' address arithmetic; TMA
// tile loads and a bias kept in fp32 registers across a block's batch
// members are the levers left.  The split products (hi + lo) double the
// tensor-core work of P V and of the backward's products that take P or
// dS.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "mma_common.cuh"

namespace {

// ========================================== fp32 route (the CUDA cores)

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = 80;        // row stride (floats) of the P / dS tiles
constexpr int kBS = 65;        // row stride of the staged bias tile (odd)

template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
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

// ===================================== tensor-core route (bf16 and fp16)

constexpr int kBQ = 64;   // fwd, dq, dbias: query rows a block, 16 a warp
constexpr int kBN = 64;   // fwd, dbias: keys a tile
constexpr int kBKV = 64;  // dk/dv: keys a block, 16 a warp
constexpr int kBM = 64;   // dk/dv: query rows a ring slot
constexpr int kQC = 32;   // dk/dv: queries a warp takes at once
constexpr int kBPad = 8;  // row padding of the bias tiles (elements)

// The C interface's type codes (0 fp32, 1 bf16, 2 fp16) as types.  The
// kernels are templated on the codes, so that their names say what they
// run (read by chip_smoke.py from the SASS).
template <int C>
struct TypeOf;
template <>
struct TypeOf<0> {
  using type = float;
};
template <>
struct TypeOf<1> {
  using type = __nv_bfloat16;
};
template <>
struct TypeOf<2> {
  using type = __half;
};

// Two neighbouring bias elements as fp32: one 4-byte load in bf16/fp16,
// one 8-byte load in fp32 (p at an even element).
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// The exponent (x - m) * log2(e) of exp(x - m) for ex2, the difference
// first, each step rounded on its own: x == m gives exactly 0.
__device__ __forceinline__ float exp2_arg(float x, float m) {
  return __fmul_rn(__fsub_rn(x, m), kLog2e);
}

// Rows [row0, row0 + R) x columns [col0, col0 + C) of a [sq, sk] bias
// plane → dst [R][C + kBPad]; past the plane, zeros.  copy: kCopy16
// (sk * sizeof(BT) % 16 == 0), kCopy4 (% 4 == 0) or kCopyElem.
template <typename BT, int R, int C>
__device__ __forceinline__ void stage_bias(BT* dst,
                                           const BT* __restrict__ plane,
                                           int row0, int col0, int sq,
                                           int sk, int copy) {
  constexpr int S = C + kBPad;
  const BT* base = plane + (int64_t)row0 * sk + col0;
  const int rows = sq - row0, cols = sk - col0;
  if (copy == kCopy16) {
    constexpr int E = 16 / sizeof(BT), CH = C / E;
    static_assert(R * CH % kMmaThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < R * CH / kMmaThreads; ++i) {
      const int idx = threadIdx.x + i * kMmaThreads;
      const int r = idx / CH, c = (idx % CH) * E;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * S + c, base + (ok ? r * sk + c : 0), ok);
    }
  } else if (copy == kCopy4) {
    constexpr int E = 4 / sizeof(BT), CH = C / E;
#pragma unroll 4
    for (int i = 0; i < R * CH / kMmaThreads; ++i) {
      const int idx = threadIdx.x + i * kMmaThreads;
      const int r = idx / CH, c = (idx % CH) * E;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * S + c, base + (ok ? r * sk + c : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += kMmaThreads) {
      const int r = idx / C, c = idx % C;
      dst[r * S + c] = r < rows && c < cols ? base[r * sk + c]
                                            : Cvt<BT>::from_f(0.f);
    }
  }
}

// N fp32 values src[i0 .. i0 + N) → dst, zeros at i >= n, one 4-byte
// copy each by threads [first, first + N).
template <int N>
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int i0, int n, int first = 0) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < N) {
    const bool ok = i0 + i < n;
    cp_async4(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// Per padded head dim DP: dq's keys a tile, and the blocks an SM holds at
// once (the register cap follows: 65536 / (128 x blocks)).
template <int DP>
struct FbCfg {
  static constexpr int row = (DP + 8) * 2;  // bytes of a q/k/v/dO tile row
  static constexpr int dq_kn = DP == 128 ? 32 : 64;
  static constexpr int fwd_blocks = DP == 128 ? 2 : DP == 64 ? 3 : 4;
  static constexpr int dq_blocks = DP == 128 ? 2 : DP == 64 ? 3 : 4;
  static constexpr int dkv_blocks = DP == 128 ? 1 : DP == 64 ? 2 : 4;
  static constexpr int dbias_blocks = DP == 128 ? 1 : DP == 64 ? 2 : 3;
};

template <typename BT, int R, int C>
constexpr int bias_bytes() {
  return R * (C + kBPad) * (int)sizeof(BT);
}

// Shared-memory layouts, byte offsets (each a multiple of 16): the block's
// own tiles, then two ring slots of `slot` bytes at `ring`, with offsets
// inside a slot.
template <typename BT, int DP>
struct FwdLayout {  // q | k, v, bias [kBQ][kBN], mask [kBN]
  static constexpr int R = FbCfg<DP>::row;
  static constexpr int ring = kBQ * R;
  static constexpr int k = 0, v = kBN * R, bias = 2 * kBN * R;
  static constexpr int mask = bias + bias_bytes<BT, kBQ, kBN>();
  static constexpr int slot = mask + kBN * 4;
  static constexpr int total = ring + 2 * slot;
};

template <typename BT, int DP>
struct DqLayout {  // q, dO, lse, delta | k, v, bias [kBQ][KN], mask [KN]
  static constexpr int R = FbCfg<DP>::row, KN = FbCfg<DP>::dq_kn;
  static constexpr int dO = kBQ * R, lse = 2 * kBQ * R;
  static constexpr int delta = lse + kBQ * 4, ring = delta + kBQ * 4;
  static constexpr int k = 0, v = KN * R, bias = 2 * KN * R;
  static constexpr int mask = bias + bias_bytes<BT, kBQ, KN>();
  static constexpr int slot = mask + KN * 4;
  static constexpr int total = ring + 2 * slot;
};

template <typename BT, int DP>
struct DkvLayout {  // k, v | q, dO, bias [kBM][kBKV], lse, delta
  static constexpr int R = FbCfg<DP>::row;
  static constexpr int v = kBKV * R, ring = 2 * kBKV * R;
  static constexpr int q = 0, dO = kBM * R, bias = 2 * kBM * R;
  static constexpr int lse = bias + bias_bytes<BT, kBM, kBKV>();
  static constexpr int delta = lse + kBM * 4;
  static constexpr int slot = delta + kBM * 4;
  static constexpr int total = ring + 2 * slot;
};

template <typename BT, int DP>
struct DbiasLayout {  // bias [kBQ][kBN] | q, dO, k, v, lse, delta, mask
  static constexpr int R = FbCfg<DP>::row;
  static constexpr int ring = bias_bytes<BT, kBQ, kBN>();
  static constexpr int q = 0, dO = kBQ * R, k = 2 * kBQ * R;
  static constexpr int v = k + kBN * R, lse = v + kBN * R;
  static constexpr int delta = lse + kBQ * 4, mask = delta + kBQ * 4;
  static constexpr int slot = mask + kBN * 4;
  static constexpr int total = ring + 2 * slot;
};

// S = Q K^T for a warp's 16 rows against NK keys of a [NK][DP + 8] tile:
// the C fragments s[NK / 8][4], from A fragments qa (KD = DP / 16).
template <typename T, int DP, int NK>
__device__ __forceinline__ void score_frags(float (*s)[4],
                                            const uint32_t (*qa)[4],
                                            const T* kt, int lane) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd)
#pragma unroll
    for (int nj = 0; nj < NK / 16; ++nj) {
      uint32_t bf[4];
      load_b<S>(bf, kt, nj * 16, kd * 16, lane);
      Tc<T>::mma(s[2 * nj], qa[kd], bf);
      Tc<T>::mma(s[2 * nj + 1], qa[kd], bf + 2);
    }
}

// acc += X B for a warp's 16 rows, X fp32 C fragments x[NX / 8][4] over
// NX columns (keys or queries) fed as hi + lo (x already scaled), B rows
// k0.. of a [*][DP + 8] tile stored [k][n].
template <typename T, int DP, int NX>
__device__ __forceinline__ void split_product(float (*acc)[4],
                                              const float (*x)[4],
                                              const T* bt, int k0,
                                              int lane) {
  constexpr int S = DP + 8, NT = DP / 8;
#pragma unroll
  for (int kk = 0; kk < NX / 16; ++kk) {
    uint32_t xh[4], xl[4];
    Tc<T>::split(x[2 * kk][0], x[2 * kk][1], xh[0], xl[0]);
    Tc<T>::split(x[2 * kk][2], x[2 * kk][3], xh[1], xl[1]);
    Tc<T>::split(x[2 * kk + 1][0], x[2 * kk + 1][1], xh[2], xl[2]);
    Tc<T>::split(x[2 * kk + 1][2], x[2 * kk + 1][3], xh[3], xl[3]);
#pragma unroll
    for (int nd = 0; nd < NT / 2; ++nd) {
      uint32_t bf[4];
      load_bt<S>(bf, bt, k0 + kk * 16, nd * 16, lane);
      Tc<T>::mma(acc[2 * nd], xl, bf);
      Tc<T>::mma(acc[2 * nd], xh, bf);
      Tc<T>::mma(acc[2 * nd + 1], xl, bf + 2);
      Tc<T>::mma(acc[2 * nd + 1], xh, bf + 2);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (*x)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// fp16: dS rows (of x, NX / 8 fragments) scaled by 2^e with e from the
// rows' largest |dS| so far (de), the accumulator rescaled when e falls
// (B1's design, mma_common.cuh).  bf16: nothing.
template <typename T, int NT, int NX>
__device__ __forceinline__ void scale_ds(float (*x)[4], float (*acc)[4],
                                         int* de) {
  if constexpr (Tc<T>::kScaleDs) {
    float factor[2], sc[2];
    ds_rescale<NX / 8>(x, de, factor, sc);
    scale_rows<NT>(acc, factor);
#pragma unroll
    for (int j = 0; j < NX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] *= sc[e / 2];
  }
}

// s = ((s * scale) + bias) + mask where (row, key) is visible, else -inf,
// for a warp's 16 x NK score fragments: the thread's rows r0 and r0 + 8,
// keys k0 + 8j + 2t (+1); brow points at the warp's first row of a bias
// tile with row stride BS (keys from k0); mt at the tile's mask values
// (nullptr: no mask).  kFull: every pair is visible, no test.
template <bool kFull, int NK, int BS, typename BT>
__device__ __forceinline__ void bias_scores(float (*s)[4], const BT* brow,
                                            const float* mt,
                                            const Params& a, int r0, int k0,
                                            int g, int t) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const float2 mk = mt ? *reinterpret_cast<const float2*>(mt + 8 * j +
                                                            2 * t)
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 bv = pair_f(brow + (g + 8 * i) * BS + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * i + c, col = k0 + 8 * j + 2 * t + c;
        const float x = logit(s[j][e], a.scale, c ? bv.y : bv.x,
                              c ? mk.y : mk.x);
        s[j][e] = (kFull || visible(r0 + 8 * i, col, a.sq, a.sk, a.causal))
                      ? x : -INFINITY;
      }
    }
  }
}

// The same for dk/dv's transposed fragments s^T[key][query] of a warp's
// 16 keys (kw = warp's first key within the block's tile at k0) against
// queries c.. of the q tile at q0: the bias tile [q][k] (row stride BS)
// read transposed, one element at a time; mk the thread's two keys' mask
// values.
template <bool kFull, int BS, typename BT>
__device__ __forceinline__ void bias_scores_t(float (*st)[4], const BT* bt,
                                              const float* mk,
                                              const Params& a, int q0,
                                              int c, int k0, int kw, int g,
                                              int t) {
#pragma unroll
  for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = c + 8 * j + 2 * t + e % 2;
      const int kl = kw + g + (e / 2) * 8;  // key within the tile
      const float x = logit(st[j][e], a.scale,
                            Cvt<BT>::to_f(bt[qi * BS + kl]), mk[e / 2]);
      st[j][e] = (kFull || visible(q0 + qi, k0 + kl, a.sq, a.sk, a.causal))
                     ? x : -INFINITY;
    }
}

// ------------------------------------------------------------ forward
template <int TC, int BC, int DP>
__global__ void __launch_bounds__(kMmaThreads, FbCfg<DP>::fwd_blocks)
fb_fwd_mma_kernel(Params a, int copy, int bcopy) {
  using T = typename TypeOf<TC>::type;
  using BT = typename TypeOf<BC>::type;
  using Ly = FwdLayout<BT, DP>;
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8, BS = kBN + kBPad;
  constexpr float kP = Tc<T>::kPScale;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kBQ, off = a.sk - a.sq;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int r0 = w0 + g;          // the thread's rows: r0 and r0 + 8
  const int64_t rs = (int64_t)a.H * a.D;
  const Where w(a, b, h);
  const T* kb = static_cast<const T*>(a.k) + w.kv;
  const T* vb = static_cast<const T*>(a.v) + w.kv;
  const BT* plane = static_cast<const BT*>(a.bias) + w.bias;
  const float* mrow = w.mask >= 0 ? a.mask + w.mask : nullptr;

  int k_hi = a.sk - 1;
  if (a.causal) k_hi = min(k_hi, q0 + kBQ - 1 + off);
  const int n = k_hi < 0 ? 0 : k_hi / kBN + 1;
  auto slot = [&](int it) { return smem + Ly::ring + (it & 1) * Ly::slot; };
  auto stage = [&](int it) {
    unsigned char* sl = slot(it);
    const int k0 = it * kBN;
    stage_rows<T, kBN, DP>(reinterpret_cast<T*>(sl + Ly::k), kb, k0, a.sk, rs,
                           a.D, copy);
    stage_rows<T, kBN, DP>(reinterpret_cast<T*>(sl + Ly::v), vb, k0, a.sk, rs,
                           a.D, copy);
    stage_bias<BT, kBQ, kBN>(reinterpret_cast<BT*>(sl + Ly::bias), plane, q0,
                             k0, a.sq, a.sk, bcopy);
    if (mrow)
      stage_vec<kBN>(reinterpret_cast<float*>(sl + Ly::mask), mrow, k0,
                     a.sk);
  };

  stage_rows<T, kBQ, DP>(qs, static_cast<const T*>(a.q) + w.q, q0, a.sq, rs,
                         a.D, copy);
  cp_async_commit();
  if (n > 0) stage(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    load_a<S>(qa[kd], qs, warp * 16, kd * 16, lane);

  // m: the rows' running max of s in natural units (the reference's)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
  zero_frags<NT>(acc);

  for (int it = 0; it < n; ++it) {
    const int k0 = it * kBN;
    const unsigned char* sl = slot(it);
    const T* kt = reinterpret_cast<const T*>(sl + Ly::k);
    const T* vt = reinterpret_cast<const T*>(sl + Ly::v);
    const BT* brow = reinterpret_cast<const BT*>(sl + Ly::bias) +
                     warp * 16 * BS;
    const float* mt =
        mrow ? reinterpret_cast<const float*>(sl + Ly::mask) : nullptr;
    cp_async_wait<0>();  // tile it has landed (this thread's copies)
    // every thread's copies have landed, and every warp is done with tile
    // it - 1, whose slot the next copies refill while tile it is used
    __syncthreads();
    if (it + 1 < n) stage(it + 1);
    cp_async_commit();
    if (w0 >= a.sq || (a.causal && k0 > w0 + 15 + off)) continue;
    float s[kBN / 8][4];
    score_frags<T, DP, kBN>(s, qa, kt, lane);
    // every (row, key) pair of the warp and the tile visible: no tests
    if (k0 + kBN <= a.sk && w0 + 15 < a.sq &&
        (!a.causal || k0 + kBN - 1 <= w0 + off))
      bias_scores<true, kBN, BS>(s, brow, mt, a, r0, k0, g, t);
    else
      bias_scores<false, kBN, BS>(s, brow, mt, a, r0, k0, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float alpha[2], msafe[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      msafe[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = m[i] == -INFINITY ? 0.f : ex2(exp2_arg(m[i], msafe[i]));
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(exp2_arg(s[j][e], msafe[e / 2]));  // masked: 0
        rsum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = alpha[i] * l[i] + rsum[i];
    }
    scale_rows<NT>(acc, alpha);
    // o += P V with P = hi + lo of P * kP: the score fragments of keys
    // 16kk.. are the A fragment of that depth step
    if constexpr (kP != 1.f) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= kP;
    }
    split_product<T, DP, kBN>(acc, s, vt, 0, lane);
  }

  float den[2];  // l * kP: acc holds kP * sum P V (exact scalings)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    den[i] = lsafe * kP;
    const int row = r0 + 8 * i;
    if (t == 0 && row < a.sq)
      a.lse_out[w.rowvec + row] =
          m[i] == -INFINITY ? kDeadRowLse : m[i] + logf(lsafe);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] /= den[0];
    acc[nt][1] /= den[0];
    acc[nt][2] /= den[1];
    acc[nt][3] /= den[1];
  }
  store_frag<T, DP>(static_cast<T*>(a.out) + w.q, acc, r0, a.sq, rs, a.D, t,
                    copy != kCopyElem);
}

// ------------------------------------------------------------- dq pass
template <int TC, int BC, int DP>
__global__ void __launch_bounds__(kMmaThreads, FbCfg<DP>::dq_blocks)
fb_dq_mma_kernel(Params a, int copy, int bcopy) {
  using T = typename TypeOf<TC>::type;
  using BT = typename TypeOf<BC>::type;
  using Ly = DqLayout<BT, DP>;
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8;
  constexpr int KN = FbCfg<DP>::dq_kn, BS = KN + kBPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + Ly::dO);
  float* r_lse = reinterpret_cast<float*>(smem + Ly::lse);
  float* r_delta = reinterpret_cast<float*>(smem + Ly::delta);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kBQ, off = a.sk - a.sq;
  const int w0 = q0 + warp * 16, r0 = w0 + g;
  const int64_t rs = (int64_t)a.H * a.D;
  const Where w(a, b, h);
  const T* kb = static_cast<const T*>(a.k) + w.kv;
  const T* vb = static_cast<const T*>(a.v) + w.kv;
  const BT* plane = static_cast<const BT*>(a.bias) + w.bias;
  const float* mrow = w.mask >= 0 ? a.mask + w.mask : nullptr;

  int k_hi = a.sk - 1;
  if (a.causal) k_hi = min(k_hi, q0 + kBQ - 1 + off);
  const int n = k_hi < 0 ? 0 : k_hi / KN + 1;
  auto slot = [&](int it) { return smem + Ly::ring + (it & 1) * Ly::slot; };
  auto stage = [&](int it) {
    unsigned char* sl = slot(it);
    const int k0 = it * KN;
    stage_rows<T, KN, DP>(reinterpret_cast<T*>(sl + Ly::k), kb, k0, a.sk, rs,
                          a.D, copy);
    stage_rows<T, KN, DP>(reinterpret_cast<T*>(sl + Ly::v), vb, k0, a.sk, rs,
                          a.D, copy);
    stage_bias<BT, kBQ, KN>(reinterpret_cast<BT*>(sl + Ly::bias), plane, q0,
                            k0, a.sq, a.sk, bcopy);
    if (mrow)
      stage_vec<KN>(reinterpret_cast<float*>(sl + Ly::mask), mrow, k0, a.sk);
  };

  stage_rows<T, kBQ, DP>(qs, static_cast<const T*>(a.q) + w.q, q0, a.sq, rs,
                         a.D, copy);
  stage_rows<T, kBQ, DP>(dos, static_cast<const T*>(a.dout) + w.q, q0, a.sq,
                         rs, a.D, copy);
  cp_async_commit();
  if (n > 0) stage(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // delta = rowsum(dO * O) over the warp's own 16 rows, from o as stored
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, s = q0 + r;
    float d = 0.f;
    if (s < a.sq) {
      const T* orow = static_cast<const T*>(a.o) + w.q + (int64_t)s * rs;
      for (int c = lane; c < a.D; c += 32)
        d += Cvt<T>::to_f(dos[r * S + c]) * Cvt<T>::to_f(orow[c]);
    }
    d = warp_sum(d);
    if (lane == 0) {
      r_delta[r] = d;
      r_lse[r] = s < a.sq ? a.lse[w.rowvec + s] : 0.f;
      if (s < a.sq) a.delta_out[w.rowvec + s] = d;
    }
  }
  __syncwarp();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = r_lse[warp * 16 + g + 8 * i];
    delta_r[i] = r_delta[warp * 16 + g + 8 * i];
  }

  float acc[NT][4];
  zero_frags<NT>(acc);
  int de[2] = {kDsExpMax, kDsExpMax};  // fp16: the rows' dS exponents

  for (int it = 0; it < n; ++it) {
    const int k0 = it * KN;
    const unsigned char* sl = slot(it);
    const T* kt = reinterpret_cast<const T*>(sl + Ly::k);
    const T* vt = reinterpret_cast<const T*>(sl + Ly::v);
    const BT* bt = reinterpret_cast<const BT*>(sl + Ly::bias);
    const float* mt = reinterpret_cast<const float*>(sl + Ly::mask);
    cp_async_wait<0>();  // as in the forward: one barrier a tile
    __syncthreads();
    if (it + 1 < n) stage(it + 1);
    cp_async_commit();
    if (w0 >= a.sq || (a.causal && k0 > w0 + 15 + off)) continue;
    float s[KN / 8][4], dp[KN / 8][4];
    {
      uint32_t fa[KD][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        load_a<S>(fa[kd], qs, warp * 16, kd * 16, lane);
      score_frags<T, DP, KN>(s, fa, kt, lane);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        load_a<S>(fa[kd], dos, warp * 16, kd * 16, lane);
      score_frags<T, DP, KN>(dp, fa, vt, lane);
    }
    const BT* brow = bt + warp * 16 * BS;
    if (k0 + KN <= a.sk && w0 + 15 < a.sq &&
        (!a.causal || k0 + KN - 1 <= w0 + off))
      bias_scores<true, KN, BS>(s, brow, mrow ? mt : nullptr, a, r0, k0, g,
                                t);
    else
      bias_scores<false, KN, BS>(s, brow, mrow ? mt : nullptr, a, r0, k0, g,
                                 t);
    // dS = P (dP - delta) scale, in place of s (masked: P = 0)
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(exp2_arg(s[j][e], lse_r[e / 2]));
        s[j][e] = __fmul_rn(
            __fmul_rn(p, __fsub_rn(dp[j][e], delta_r[e / 2])), a.scale);
      }
    scale_ds<T, NT, KN>(s, acc, de);
    split_product<T, DP, KN>(acc, s, kt, 0, lane);  // dq += dS K
  }
  if constexpr (Tc<T>::kScaleDs) {
    const float f[2] = {pow2(-de[0]), pow2(-de[1])};
    scale_rows<NT>(acc, f);
  }
  store_frag<T, DP>(static_cast<T*>(a.dq) + w.q, acc, r0, a.sq, rs, a.D, t,
                    copy != kCopyElem);
}

// ---------------------------------------------------------- dk/dv pass
template <int TC, int BC, int DP>
__global__ void __launch_bounds__(kMmaThreads, FbCfg<DP>::dkv_blocks)
fb_dkv_mma_kernel(Params a, int copy, int bcopy) {
  using T = typename TypeOf<TC>::type;
  using BT = typename TypeOf<BC>::type;
  using Ly = DkvLayout<BT, DP>;
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8, BS = kBKV + kBPad;
  constexpr float kP = Tc<T>::kPScale;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + Ly::v);

  const int kt = blockIdx.x;  // the first k tiles see the most queries
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = kt * kBKV, off = a.sk - a.sq;
  const int kw0 = k0 + warp * 16;  // the warp's first key
  const int64_t rs = (int64_t)a.H * a.D;
  const Where w(a, b, h);
  const T* qb = static_cast<const T*>(a.q) + w.q;
  const T* dob = static_cast<const T*>(a.dout) + w.q;
  const BT* plane = static_cast<const BT*>(a.bias) + w.bias;
  // the thread's keys kw0 + g and kw0 + g + 8: their mask values
  float mk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) mk[i] = mask_at(a, w, kw0 + g + 8 * i);

  const int q_lo = a.causal ? max(0, k0 - off) : 0;
  const int qt0 = q_lo / kBM;
  const int n = q_lo >= a.sq ? 0 : (a.sq - 1) / kBM - qt0 + 1;
  auto slot = [&](int it) { return smem + Ly::ring + (it & 1) * Ly::slot; };
  auto stage = [&](int it) {
    unsigned char* sl = slot(it);
    const int q0 = (qt0 + it) * kBM;
    stage_rows<T, kBM, DP>(reinterpret_cast<T*>(sl + Ly::q), qb, q0, a.sq,
                           rs, a.D, copy);
    stage_rows<T, kBM, DP>(reinterpret_cast<T*>(sl + Ly::dO), dob, q0, a.sq,
                           rs, a.D, copy);
    stage_bias<BT, kBM, kBKV>(reinterpret_cast<BT*>(sl + Ly::bias), plane,
                              q0, k0, a.sq, a.sk, bcopy);
    stage_vec<kBM>(reinterpret_cast<float*>(sl + Ly::lse), a.lse + w.rowvec,
                   q0, a.sq);
    stage_vec<kBM>(reinterpret_cast<float*>(sl + Ly::delta),
                   a.delta + w.rowvec, q0, a.sq, kBM);
  };

  stage_rows<T, kBKV, DP>(ks, static_cast<const T*>(a.k) + w.kv, k0, a.sk,
                          rs, a.D, copy);
  stage_rows<T, kBKV, DP>(vs, static_cast<const T*>(a.v) + w.kv, k0, a.sk,
                          rs, a.D, copy);
  cp_async_commit();
  if (n > 0) stage(0);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
  zero_frags<NT>(dk_acc);
  zero_frags<NT>(dv_acc);
  int de[2] = {kDsExpMax, kDsExpMax};  // fp16: the keys' dS exponents

  for (int it = 0; it < n; ++it) {
    const int q0 = (qt0 + it) * kBM;
    const unsigned char* sl = slot(it);
    const T* qt_ = reinterpret_cast<const T*>(sl + Ly::q);
    const T* dot_ = reinterpret_cast<const T*>(sl + Ly::dO);
    const BT* bt = reinterpret_cast<const BT*>(sl + Ly::bias);
    const float* lt = reinterpret_cast<const float*>(sl + Ly::lse);
    const float* dt = reinterpret_cast<const float*>(sl + Ly::delta);
    cp_async_wait<0>();  // as in the forward: one barrier a tile
    __syncthreads();
    if (it + 1 < n) stage(it + 1);
    cp_async_commit();
#pragma unroll 1
    for (int c = 0; c < kBM; c += kQC) {
      const int c0 = q0 + c;  // the chunk's first query
      if (kw0 >= a.sk || c0 >= a.sq || (a.causal && c0 + kQC - 1 + off < kw0))
        continue;
      float st[kQC / 8][4], dpt[kQC / 8][4];  // [key][query]
      zero_frags<kQC / 8>(st);
      zero_frags<kQC / 8>(dpt);
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
      // s^T with the bias tile [q][k] read transposed; masked: -inf
      if (kw0 + 16 <= a.sk && c0 + kQC <= a.sq &&
          (!a.causal || kw0 + 15 <= c0 + off))
        bias_scores_t<true, BS>(st, bt, mk, a, q0, c, k0, warp * 16, g, t);
      else
        bias_scores_t<false, BS>(st, bt, mk, a, q0, c, k0, warp * 16, g, t);
      // P^T (times kP) into st, dS^T = P^T (dP^T - delta) scale into dpt
#pragma unroll
      for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c + 8 * j + 2 * t + e % 2;
          const float p = ex2(exp2_arg(st[j][e], lt[qi]));
          st[j][e] = kP * p;
          dpt[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpt[j][e], dt[qi])),
                                a.scale);
        }
      scale_ds<T, NT, kQC>(dpt, dk_acc, de);
      split_product<T, DP, kQC>(dv_acc, st, dot_, c, lane);  // P^T dO
      split_product<T, DP, kQC>(dk_acc, dpt, qt_, c, lane);  // dS^T Q
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
  store_frag<T, DP>(static_cast<T*>(a.dk) + w.kv, dk_acc, kw0 + g, a.sk, rs,
                    a.D, t, copy != kCopyElem);
  store_frag<T, DP>(static_cast<T*>(a.dv) + w.kv, dv_acc, kw0 + g, a.sk, rs,
                    a.D, t, copy != kCopyElem);
}

// ----------------------------------------------------------- dbias pass
// One block per (64 x 64 bias tile, bias head, bias batch x chunk): the
// sum of dS over the chunk's group members [m0, m1), member m = batch
// member m / Gh (outer) and head member m % Gh (inner), added in that
// order, into `out` (dbias when splits == 1, else the chunk's partial
// plane of the scratch [splits, Bb, Hb, sq, sk]).
template <int TC, int BC, int DP>
__global__ void __launch_bounds__(kMmaThreads, FbCfg<DP>::dbias_blocks)
fb_dbias_mma_kernel(Params a, int copy, int bcopy, int splits,
                    float* __restrict__ out) {
  using T = typename TypeOf<TC>::type;
  using BT = typename TypeOf<BC>::type;
  using Ly = DbiasLayout<BT, DP>;
  constexpr int S = DP + 8, KD = DP / 16, BS = kBN + kBPad;
  extern __shared__ __align__(16) unsigned char smem[];
  BT* bs = reinterpret_cast<BT*>(smem);

  const int nk = (a.sk + kBN - 1) / kBN;
  const int q0 = (blockIdx.x / nk) * kBQ, k0 = (blockIdx.x % nk) * kBN;
  const int hb = blockIdx.y, bb = blockIdx.z / splits;
  const int chunk = blockIdx.z % splits;
  const int gb = a.B / a.Bb, gh = a.H / a.Hb, G = gb * gh;
  const int m0 = (int)((int64_t)chunk * G / splits);
  const int m1 = (int)((int64_t)(chunk + 1) * G / splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = a.sk - a.sq;
  const int w0 = q0 + warp * 16, r0 = w0 + g;
  const int64_t rs = (int64_t)a.H * a.D;
  const int64_t plane = ((int64_t)bb * a.Hb + hb) * a.sq * a.sk;

  // a tile above the causal diagonal sees no key: its sum stays 0
  const bool live = !a.causal || k0 <= q0 + kBQ - 1 + off;
  const int n = live ? m1 - m0 : 0;
  auto slot = [&](int it) { return smem + Ly::ring + (it & 1) * Ly::slot; };
  auto stage = [&](int it) {
    unsigned char* sl = slot(it);
    const int m = m0 + it;
    const Where w(a, bb * gb + m / gh, hb * gh + m % gh);
    stage_rows<T, kBQ, DP>(reinterpret_cast<T*>(sl + Ly::q),
                           static_cast<const T*>(a.q) + w.q, q0, a.sq, rs,
                           a.D, copy);
    stage_rows<T, kBQ, DP>(reinterpret_cast<T*>(sl + Ly::dO),
                           static_cast<const T*>(a.dout) + w.q, q0, a.sq, rs,
                           a.D, copy);
    stage_rows<T, kBN, DP>(reinterpret_cast<T*>(sl + Ly::k),
                           static_cast<const T*>(a.k) + w.kv, k0, a.sk, rs,
                           a.D, copy);
    stage_rows<T, kBN, DP>(reinterpret_cast<T*>(sl + Ly::v),
                           static_cast<const T*>(a.v) + w.kv, k0, a.sk, rs,
                           a.D, copy);
    stage_vec<kBQ>(reinterpret_cast<float*>(sl + Ly::lse), a.lse + w.rowvec,
                   q0, a.sq);
    stage_vec<kBQ>(reinterpret_cast<float*>(sl + Ly::delta),
                   a.delta + w.rowvec, q0, a.sq, kBQ);
    if (w.mask >= 0)
      stage_vec<kBN>(reinterpret_cast<float*>(sl + Ly::mask), a.mask + w.mask,
                     k0, a.sk);
  };

  if (n > 0) {
    // this tile's bias: the same for every group member
    stage_bias<BT, kBQ, kBN>(bs, static_cast<const BT*>(a.bias) + plane, q0,
                             k0, a.sq, a.sk, bcopy);
    stage(0);
  }
  cp_async_commit();

  float acc[kBN / 8][4];
  zero_frags<kBN / 8>(acc);
  for (int it = 0; it < n; ++it) {
    const unsigned char* sl = slot(it);
    const T* qt_ = reinterpret_cast<const T*>(sl + Ly::q);
    const T* dot_ = reinterpret_cast<const T*>(sl + Ly::dO);
    const T* kt = reinterpret_cast<const T*>(sl + Ly::k);
    const T* vt = reinterpret_cast<const T*>(sl + Ly::v);
    const float* lt = reinterpret_cast<const float*>(sl + Ly::lse);
    const float* dt = reinterpret_cast<const float*>(sl + Ly::delta);
    const float* mt = reinterpret_cast<const float*>(sl + Ly::mask);
    cp_async_wait<0>();  // one barrier a member
    __syncthreads();
    if (it + 1 < n) stage(it + 1);
    cp_async_commit();
    if (w0 >= a.sq || (a.causal && k0 > w0 + 15 + off)) continue;
    float s[kBN / 8][4], dp[kBN / 8][4];
    {
      uint32_t fa[KD][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        load_a<S>(fa[kd], qt_, warp * 16, kd * 16, lane);
      score_frags<T, DP, kBN>(s, fa, kt, lane);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        load_a<S>(fa[kd], dot_, warp * 16, kd * 16, lane);
      score_frags<T, DP, kBN>(dp, fa, vt, lane);
    }
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_r[i] = lt[warp * 16 + g + 8 * i];
      delta_r[i] = dt[warp * 16 + g + 8 * i];
    }
    const BT* brow = bs + warp * 16 * BS;
    if (k0 + kBN <= a.sk && w0 + 15 < a.sq &&
        (!a.causal || k0 + kBN - 1 <= w0 + off))
      bias_scores<true, kBN, BS>(s, brow, a.Bm ? mt : nullptr, a, r0, k0, g,
                                 t);
    else
      bias_scores<false, kBN, BS>(s, brow, a.Bm ? mt : nullptr, a, r0, k0,
                                  g, t);
    // acc += P (dP - delta), one rounded add a member (masked: P = 0)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(exp2_arg(s[j][e], lse_r[e / 2]));
        acc[j][e] = __fadd_rn(
            acc[j][e], __fmul_rn(p, __fsub_rn(dp[j][e], delta_r[e / 2])));
      }
  }
  cp_async_wait<0>();
  float* dst = splits > 1
                   ? out + (int64_t)chunk * a.Bb * a.Hb * a.sq * a.sk + plane
                   : out + plane;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e / 2) * 8, col = k0 + 8 * j + 2 * t + e % 2;
      if (row < a.sq && col < a.sk) dst[(int64_t)row * a.sk + col] = acc[j][e];
    }
}

// dbias[i] = sum over chunks c (in order) of part[c][i].
__global__ void fb_dbias_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ dbias, int64_t n,
                                       int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int c = 1; c < splits; ++c) s += part[c * n + i];
    dbias[i] = s;
  }
}

// The tensor-core route of one pass: input type code TC, bias type code
// BC (TC or 0), padded head dim DP.
template <int TC, int BC, int DP>
cudaError_t run_mma(int pass, const Params& a, int copy, int bcopy,
                    int splits, float* part, cudaStream_t st) {
  using BT = typename TypeOf<BC>::type;
  static bool configured[4] = {false, false, false, false};
  const int nq = (a.sq + kBQ - 1) / kBQ, nk = (a.sk + kBN - 1) / kBN;
  cudaError_t e = cudaSuccess;
  if (pass == kFwd) {
    constexpr int bytes = FwdLayout<BT, DP>::total;
    auto kern = fb_fwd_mma_kernel<TC, BC, DP>;
    if (!configured[kFwd] && (e = allow_smem(kern, bytes)) != cudaSuccess)
      return e;
    kern<<<dim3(nq, a.H, a.B), kMmaThreads, bytes, st>>>(a, copy, bcopy);
  } else if (pass == kDq) {
    constexpr int bytes = DqLayout<BT, DP>::total;
    auto kern = fb_dq_mma_kernel<TC, BC, DP>;
    if (!configured[kDq] && (e = allow_smem(kern, bytes)) != cudaSuccess)
      return e;
    kern<<<dim3(nq, a.H, a.B), kMmaThreads, bytes, st>>>(a, copy, bcopy);
  } else if (pass == kDkv) {
    constexpr int bytes = DkvLayout<BT, DP>::total;
    auto kern = fb_dkv_mma_kernel<TC, BC, DP>;
    if (!configured[kDkv] && (e = allow_smem(kern, bytes)) != cudaSuccess)
      return e;
    kern<<<dim3((a.sk + kBKV - 1) / kBKV, a.H, a.B), kMmaThreads, bytes,
           st>>>(a, copy, bcopy);
  } else {
    constexpr int bytes = DbiasLayout<BT, DP>::total;
    auto kern = fb_dbias_mma_kernel<TC, BC, DP>;
    if (!configured[kDbias] && (e = allow_smem(kern, bytes)) != cudaSuccess)
      return e;
    kern<<<dim3(nq * nk, a.Hb, a.Bb * splits), kMmaThreads, bytes, st>>>(
        a, copy, bcopy, splits, splits > 1 ? part : a.dbias);
    if (splits > 1) {
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      const int64_t n = (int64_t)a.Bb * a.Hb * a.sq * a.sk;
      const int blocks = (int)std::min<int64_t>((n + 255) / 256, 132 * 16);
      fb_dbias_reduce_kernel<<<blocks, 256, 0, st>>>(part, a.dbias, n,
                                                     splits);
    }
  }
  configured[pass] = true;
  return cudaGetLastError();
}

template <int TC, int BC>
cudaError_t run_mma_d(int pass, const Params& a, int copy, int bcopy,
                      int splits, float* part, cudaStream_t st) {
  if (a.D <= 32) return run_mma<TC, BC, 32>(pass, a, copy, bcopy, splits,
                                            part, st);
  if (a.D <= 64) return run_mma<TC, BC, 64>(pass, a, copy, bcopy, splits,
                                            part, st);
  return run_mma<TC, BC, 128>(pass, a, copy, bcopy, splits, part, st);
}

// How the rows of the tensors a pass touches can be copied (kCopy16,
// kCopy4 or kCopyElem), from the head dim and the pointers.
int row_copy(const Params& a) {
  const void* ptrs[] = {a.q, a.k, a.v, a.o, a.dout, a.out, a.dq, a.dk, a.dv};
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  if (a.D % 8 == 0 && (any & 15) == 0) return kCopy16;
  if (a.D % 2 == 0 && (any & 3) == 0) return kCopy4;
  return kCopyElem;
}

// ... and of the bias plane's rows, `size` bytes an element.
int bias_copy(const Params& a, int size) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.bias);
  const int64_t row = (int64_t)a.sk * size;
  if (row % 16 == 0 && (p & 15) == 0) return kCopy16;
  if (row % 4 == 0 && (p & 3) == 0) return kCopy4;
  return kCopyElem;
}

template <int TC>
cudaError_t run_tc(int pass, const Params& a, int splits, float* part,
                   cudaStream_t st) {
  const int copy = row_copy(a);
  if (a.bias_code == 0)
    return run_mma_d<TC, 0>(pass, a, copy, bias_copy(a, 4), splits, part,
                            st);
  return run_mma_d<TC, TC>(pass, a, copy, bias_copy(a, 2), splits, part, st);
}

int dispatch(int pass, const Params& a, int dtype, void* stream,
             int splits = 1, float* part = nullptr) {
  if (a.B <= 0 || a.H <= 0 || a.sq <= 0 || a.sk <= 0 || a.D <= 0 ||
      a.D > 128 || a.Bb <= 0 || a.Hb <= 0 || a.B % a.Bb || a.H % a.Hb ||
      a.Bm < 0 || (a.Bm && a.B % a.Bm) || a.B > 65535 || a.H > 65535 ||
      a.bias_code < 0 || a.bias_code > 2 ||
      (int64_t)((a.sq + kTile - 1) / kTile) * ((a.sk + kTile - 1) / kTile) >
          0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_d<float>(pass, a, st);
  // the tensor-core route takes a bias in the input type or in fp32
  if ((dtype != 1 && dtype != 2) ||
      (a.bias_code != 0 && a.bias_code != dtype) || splits < 1 ||
      (splits > 1 && !part) || (int64_t)a.Bb * splits > 65535 ||
      splits > (a.B / a.Bb) * (a.H / a.Hb))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)run_tc<1>(pass, a, splits, part, st);
  return (int)run_tc<2>(pass, a, splits, part, st);
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
// 2 = float16); bias: [Bb, Hb, sq, sk] in bias_dtype (same codes; with
// bf16/fp16 inputs the input type or float32); mask: float32
// [Bm, 1, 1, sk] or NULL with Bm = 0; lse, delta: [B, H, sq] float32;
// dbias: float32 [Bb, Hb, sq, sk].  causal: 0/1.  Each returns a
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
// members in a fixed order.  bf16/fp16: the members are split into
// `splits` chunks (1 <= splits <= the group's size, from the shapes
// alone); with splits > 1 `scratch` is float32 [splits, Bb, Hb, sq, sk]
// for the chunks' partial sums, which a second kernel sums in order.
// fp32 (the CUDA-core route): one chunk; splits and scratch are ignored.
extern "C" int ds_flash_bias_bwd_dbias(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* bias, const void* mask,
                                       void* dbias, void* scratch,
                                       int splits, FB_DIMS) {
  Params a = FB_MAKE;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const float*>(mask);
  a.dbias = static_cast<float*>(dbias);
  return dispatch(kDbias, a, dtype, stream, splits,
                  static_cast<float*>(scratch));
}

// Dynamic shared memory of one block at head dim D: pass % 4 is the pass
// (0 fwd, 1 dq, 2 dk/dv, 3 dbias), pass / 4 the route: 0 the tensor cores
// with a bf16/fp16 bias, 1 the tensor cores with an fp32 bias, 2 the fp32
// route (FP32_ROUTE_PASS in the Python wrapper).  ptxas -v does not see
// dynamic shared memory.
template <typename BT, int DP>
int mma_smem(int pass) {
  return pass == kFwd   ? FwdLayout<BT, DP>::total
         : pass == kDq  ? DqLayout<BT, DP>::total
         : pass == kDkv ? DkvLayout<BT, DP>::total
                        : DbiasLayout<BT, DP>::total;
}

template <typename BT>
int mma_smem_d(int pass, int D) {
  if (D <= 32) return mma_smem<BT, 32>(pass);
  if (D <= 64) return mma_smem<BT, 64>(pass);
  return mma_smem<BT, 128>(pass);
}

extern "C" int ds_flash_bias_smem_bytes(int pass, int D) {
  const int route = pass / 4;
  pass %= 4;
  if (route == 0) return mma_smem_d<__nv_bfloat16>(pass, D);
  if (route == 1) return mma_smem_d<float>(pass, D);
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
