// Block-sparse flash attention (forward) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel of deepspeed_tpu/ops/pallas/
// block_sparse_attention.py: `block_sparse_flash_attention` (:135), whose
// `_kernel` (:36, via `_fwd` :78) is launched at :102 behind the custom VJP
// `_bs_flash` (:114).  Semantics are the kernel's:
// - q, k, v: [B, S, H, D] (any strides with d contiguous); o contiguous
//   [B, S, H, D];
// - for each q block, only its live k/v blocks: fp32 scores
//   s = (q . k) * scale, the mask of `_score_mask` (causal: row >= col,
//   sq = sk), an online softmax from -inf; a row that sees no key gives 0;
// - every accumulator is fp32; o is rounded once to the input type (fp32,
//   bf16 or fp16).
// There is no backward kernel, as in JAX (`_bs_bwd` :123 differentiates the
// gather formulation).
//
// Two routes, chosen by the input type; no fallback between them.
//
// bf16 and fp16: the tensor cores, with the pieces of B1 and B10 in
// mma_common.cuh.  A block is 4 warps of 16 query rows each (64 rows,
// kMmaThreads) and walks one key list:
// - Row groups.  The wrapper builds on the host, once per layout and
//   block, a table of row groups (`row_group_tables` in ops/kernels/
//   block_sparse_attention.py): each names its head, the first row of each
//   warp's 16 (or -1: the warp has no rows) and a key list of live k
//   blocks in ascending order, each with a 4-bit mask of the warps that
//   see it.  A group is 64 / block consecutive q blocks (block 16: a q
//   block a warp; 32: two warps a q block; 64: one q block; 128: half a q
//   block, so two groups share one list), and its list is the union of
//   its members' lists.  Under DeepSpeed's "fixed" layout the q blocks of
//   a local window see the same local and global blocks, so at block 16
//   one K/V load serves 64 rows where one q block's list would serve 16.
//   Rule: where the union is more than twice the longest member list
//   (rows that share few keys, e.g. BigBird's random blocks at block 16
//   or 32), the group is split into one group per member q block, whose
//   other warps hold no rows; the causal "fixed" layout's windows share
//   their globals and stay whole.  Groups run longest list first.
// - Passes of 64 keys.  Key t of the list is row slot[t / block] * block
//   + t % block; a pass's rows are computed two passes ahead into a ring
//   of row tables in shared memory, and its K and V rows are staged with
//   16-byte cp.async copies (stage_rows_at; 4-byte or element copies for
//   odd strides) into a double-buffered ring, one barrier a pass.
// - Products on mma.sync.m16n8k16 with fp32 accumulation: S = Q K^T from
//   the exact bf16/fp16 inputs (Q fragments kept in registers); P is an
//   fp32 value fed to P V as hi + lo in the input type (P * 2^15 in fp16),
//   straight from the score fragments, as in B1: rounding P once breaks
//   the kernel's tolerances against the reference's fp32 P (the CPU
//   emulation in tests/test_torch_sparse_attention.py shows both).
// - Masks.  A warp skips a pass none of whose keys it sees.  A pass whose
//   64 keys the warp sees whole (every slot its bit, no key past its
//   first row when causal) takes score code without per-element tests;
//   others test each score: the slot's warp bit, and row >= col when
//   causal.  Exponentials are ex2((s - m) * log2 e), the product taken
//   after the difference, as B10 does.
//
// fp32: the CUDA cores (the first version of this kernel, unchanged).
// 256 threads as a 16 x 16 grid (ty, tx) over an R x 64 score tile,
// R = 16 * RI rows: thread (ty, tx) owns rows ty + 16i (i < RI) and
// columns tx + 16j (j < 4).  One block per (row group, head, batch): R = min(block, 64)
// query rows of one q block; it walks only that q block's live slots
// (the idx/cnt tables of `layout_gather_tables`), 64 keys a pass, as fp32
// tiles of DP + 4 floats (DP the head dim rounded up to 16, 32, 64 or
// 128); products are fp32 FMA.
//
// What bounds it on an H100.  Counting each input read once, the call
// moves q, o and the k/v blocks some row uses, and does two products over
// the live (row, key) pairs: at BigBird's width (block 64, D = 64) bytes
// at 3.35 TB/s and operations at 989 TFLOP/s take about the same time;
// the "fixed" layouts at block 16 are bound by operations.  Here each
// live k/v block is read from L2 once per row group (64 rows), the split
// P V doubles that product's tensor-core work, and the exponentials and
// masks are a few dozen instructions a score beside two or three mmas
// per 16 x 8 x 16 step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_common.cuh"

namespace {

// ========================================== fp32 route (the CUDA cores)

constexpr int kKeys = 64;      // keys per pass
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = 80;        // row stride (floats) of the P tile

template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

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

// Shared-memory bytes of one block: the q tile (R rows), the k and v
// tiles (64 rows), the P tile and the 64 key rows of a pass.
template <int DP, int RI>
struct Smem {
  static constexpr int kST = DP + 4;
  static constexpr int bytes =
      (16 * RI * kST + 2 * kKeys * kST + 16 * RI * kPS) * 4 + kKeys * 4;
};

// s[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]; A, B padded tiles.
template <int DP, int RI>
__device__ inline void dot_nt(const float* A, const float* B,
                              float s[RI][4], int ty, int tx) {
  constexpr int ST = DP + 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[RI], b[4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ST + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ST + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
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

// acc[i][:] += sum_c P[ty + 16i][c] * V[c][this thread's columns]; P an
// [R][kPS] tile, V a padded [64][DP + 4] tile.
template <int DP, int RI>
__device__ inline void dot_nn(const float* P, const float* V,
                              float acc[RI][Cols<DP>::N], int ty, int tx) {
  constexpr int ST = DP + 4, VW = Cols<DP>::VW, NJ = Cols<DP>::NJ;
#pragma unroll 2
  for (int c = 0; c < kKeys; c += 4) {
    float4 p[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* vr = V + (c + cc) * ST + VW * tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v[VW];
        load_vec<VW>(vr + 16 * VW * j, v);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pv = comp(p[i], cc);
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][j * VW + e] = fmaf(pv, v[e], acc[i][j * VW + e]);
        }
      }
    }
  }
}

struct Params {
  const void *q, *k, *v;
  void* o;
  const int *idx, *cnt;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;  // element strides
  int S, H, D, block, nq, maxk, causal;
  float scale;
};

template <typename T, int DP, int RI>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(Params a) {
  constexpr int R = 16 * RI, ST = DP + 4, NC = Cols<DP>::N;
  constexpr int VW = Cols<DP>::VW, NJ = Cols<DP>::NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + R * ST;
  float* vs = ks + kKeys * ST;
  float* ps = vs + kKeys * ST;
  int* krow = reinterpret_cast<int*>(ps + R * kPS);

  const int groups = a.block / R;            // row groups of a q block
  const int h = blockIdx.y, b = blockIdx.z;
  const int iq = blockIdx.x / groups;
  const int r0 = iq * a.block + (blockIdx.x % groups) * R;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t row = (int64_t)h * a.nq + iq;
  const int* slots = a.idx + row * a.maxk;
  const int live = a.cnt[row] * a.block;     // live keys, in slot order

  const T* qp = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_b + h * a.k_h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_b + h * a.v_h;
  for (int e = tid; e < R * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    qs[r * ST + d] =
        d < a.D ? Cvt<T>::to_f(qp[(int64_t)(r0 + r) * a.q_s + d]) : 0.f;
  }

  float m[RI], l[RI], acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < live; t0 += kKeys) {
    __syncthreads();  // the previous pass's readers are done
    if (tid < kKeys) {
      const int t = t0 + tid;
      krow[tid] = t < live ? slots[t / a.block] * a.block + t % a.block : -1;
    }
    __syncthreads();
    for (int e = tid; e < kKeys * DP; e += kThreads) {
      const int r = e / DP, d = e % DP, kr = krow[r];
      float kx = 0.f, vx = 0.f;
      if (kr >= 0 && d < a.D) {
        kx = Cvt<T>::to_f(kp[(int64_t)kr * a.k_s + d]);
        vx = Cvt<T>::to_f(vp[(int64_t)kr * a.v_s + d]);
      }
      ks[r * ST + d] = kx;
      vs[r * ST + d] = vx;
    }
    __syncthreads();
    float s[RI][4];
    dot_nt<DP, RI>(qs, ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qrow = r0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = krow[tx + 16 * j];
        const bool seen = kr >= 0 && (!a.causal || qrow >= kr);
        s[i][j] = seen ? s[i][j] * a.scale : -INFINITY;
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
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    dot_nn<DP, RI>(ps, vs, acc, ty, tx);
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* orow = op + (((int64_t)b * a.S + r0 + ty + 16 * i) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = VW * tx + 16 * VW * j + e;
        if (d < a.D) orow[d] = Cvt<T>::from_f(acc[i][j * VW + e] / den);
      }
  }
}

template <typename T, int DP, int RI>
cudaError_t run(const Params& a, int B, cudaStream_t st) {
  constexpr int bytes = Smem<DP, RI>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsa_fwd_kernel<T, DP, RI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int groups = a.block / (16 * RI);
  bsa_fwd_kernel<T, DP, RI>
      <<<dim3(a.nq * groups, a.H, B), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t run_rows(const Params& a, int B, cudaStream_t st) {
  if (a.block == 16) return run<T, DP, 1>(a, B, st);
  if (a.block == 32) return run<T, DP, 2>(a, B, st);
  return run<T, DP, 4>(a, B, st);            // 64 and 128
}

template <typename T>
cudaError_t run_d(const Params& a, int B, cudaStream_t st) {
  if (a.D <= 16) return run_rows<T, 16>(a, B, st);
  if (a.D <= 32) return run_rows<T, 32>(a, B, st);
  if (a.D <= 64) return run_rows<T, 64>(a, B, st);
  return run_rows<T, 128>(a, B, st);
}


// ================================ tensor-core route (bf16 and fp16)

constexpr int kRows = 64;   // query rows a block: 4 warps of 16
constexpr int kPass = 64;   // keys a pass
constexpr int kGroupInts = 8;  // a row group: head, list offset, slots,
                               // the 4 warps' first rows, 0

// Blocks an SM holds (B1's forward's choice at each width) and shared
// memory: Q | K, V ring | 3 row tables and warp masks of 64 keys.
template <int DP>
struct MmaCfg {
  static constexpr int kS = DP + 8;
  static constexpr int blocks = DP <= 64 ? 3 : 2;
  static constexpr int smem = (kRows + 4 * kPass) * kS * 2 + 6 * kPass * 4;
};

struct MmaParams {
  const void *q, *k, *v;
  void* o;
  const int *groups, *keys;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;  // element strides
  int S, H, D, log2_block, causal, copy, ovec;
  float scale;
};

// The rows and warp masks of pass p (keys 64p..) of a list of `slots`
// k-block entries (block | warp mask << 24): row -1 and mask 0 past it.
__device__ __forceinline__ void pass_rows(const int* __restrict__ list,
                                          int slots, int lb, int p,
                                          int* rows, int* bits) {
  if (threadIdx.x < kPass) {
    const int t = p * kPass + threadIdx.x, slot = t >> lb;
    int row = -1, bit = 0;
    if (slot < slots) {
      const int e = __ldg(list + slot);
      row = ((e & 0xffffff) << lb) + (t & ((1 << lb) - 1));
      bit = e >> 24;
    }
    rows[threadIdx.x] = row;
    bits[threadIdx.x] = bit;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaCfg<DP>::blocks)
bsa_fwd_mma_kernel(MmaParams a) {
  constexpr int S = DP + 8, KD = DP / 16, NT = DP / 8;
  constexpr float kP = Tc<T>::kPScale;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kRows * S;  // [2][kPass][S]
  T* vs = ks + 2 * kPass * S;
  int* rows = reinterpret_cast<int*>(vs + 2 * kPass * S);  // [3][kPass]
  int* bits = rows + 3 * kPass;                             // [3][kPass]

  const int* grp = a.groups + (int64_t)blockIdx.x * kGroupInts;
  const int h = grp[0], slots = grp[2];
  const int* list = a.keys + grp[1];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = grp[3 + warp];  // the warp's first row (-1: none)
  const int lb = a.log2_block;
  const int n = ((slots << lb) + kPass - 1) / kPass;  // passes
  const T* qb = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_b + h * a.k_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_b + h * a.v_h;

  // Q's rows (the ring's third table holds them until pass 2 is planned)
  if (threadIdx.x < kRows) {
    const int r0 = grp[3 + threadIdx.x / 16];
    rows[2 * kPass + threadIdx.x] = r0 < 0 ? -1 : r0 + threadIdx.x % 16;
  }
  pass_rows(list, slots, lb, 0, rows, bits);
  __syncthreads();
  stage_rows_at<T, kRows, DP>(qs, qb, rows + 2 * kPass, a.q_s, a.D, a.copy);
  if (n > 0) {
    stage_rows_at<T, kPass, DP>(ks, kb, rows, a.k_s, a.D, a.copy);
    stage_rows_at<T, kPass, DP>(vs, vb, rows, a.v_s, a.D, a.copy);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q, pass 0 landed; the Q row table is free
  pass_rows(list, slots, lb, 1, rows + kPass, bits + kPass);
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
    const T* kt = ks + (it & 1) * kPass * S;
    const T* vt = vs + (it & 1) * kPass * S;
    const int* kr = rows + (it % 3) * kPass;
    const int* kbit = bits + (it % 3) * kPass;
    cp_async_wait<0>();  // pass it has landed (this thread's copies)
    // every thread's copies have landed, every warp is done with pass
    // it - 1 (whose K/V slot and row table the next writes refill), and
    // pass it + 1's row table is written
    __syncthreads();
    if (it + 1 < n) {
      const int* nr = rows + ((it + 1) % 3) * kPass;
      stage_rows_at<T, kPass, DP>(ks + ((it + 1) & 1) * kPass * S, kb, nr,
                                  a.k_s, a.D, a.copy);
      stage_rows_at<T, kPass, DP>(vs + ((it + 1) & 1) * kPass * S, vb, nr,
                                  a.v_s, a.D, a.copy);
    }
    cp_async_commit();
    if (it + 2 < n)
      pass_rows(list, slots, lb, it + 2, rows + ((it + 2) % 3) * kPass,
                bits + ((it + 2) % 3) * kPass);
    if (w0 < 0) continue;
    // which of the pass's 64 keys this warp sees: lanes hold keys lane and
    // lane + 32
    const bool see0 = (kbit[lane] >> warp) & 1;
    const bool see1 = (kbit[lane + 32] >> warp) & 1;
    if (!__any_sync(0xffffffffu, see0 || see1)) continue;
    const bool full = __all_sync(
        0xffffffffu, see0 && see1 &&
                         (!a.causal || (kr[lane] <= w0 && kr[lane + 32] <= w0)));
    float s[kPass / 8][4];
#pragma unroll
    for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int nj = 0; nj < kPass / 16; ++nj) {
        uint32_t bf[4];
        load_b<S>(bf, kt, nj * 16, kd * 16, lane);
        Tc<T>::mma(s[2 * nj], qa[kd], bf);
        Tc<T>::mma(s[2 * nj + 1], qa[kd], bf + 2);
      }
    float mx[2] = {-INFINITY, -INFINITY};
    if (full) {
#pragma unroll
      for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= a.scale;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
    } else {
      const int row = w0 + g;  // and row + 8
#pragma unroll
      for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c, key = kr[col];
          const bool see = (kbit[col] >> warp) & 1;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool ok = see && (!a.causal || row + 8 * i >= key);
            float& x = s[j][2 * i + c];
            x = ok ? x * a.scale : -INFINITY;
            mx[i] = fmaxf(mx[i], x);
          }
        }
    }
    float alpha[2], msafe[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      msafe[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - msafe[i]) * kLog2e);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked: 2^-inf = 0
        s[j][e] = ex2((s[j][e] - msafe[e / 2]) * kLog2e);
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
    for (int kk = 0; kk < kPass / 16; ++kk) {
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
  if (w0 < 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = (l[i] == 0.f ? 1.f : l[i]) * kP;  // acc holds kP P V
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][2 * i] /= den;
      acc[nt][2 * i + 1] /= den;
    }
  }
  const int64_t ors = (int64_t)a.H * a.D;
  store_frag<T, DP>(static_cast<T*>(a.o) + ((int64_t)b * a.S + w0) * ors +
                        (int64_t)h * a.D,
                    acc, g, 16, ors, a.D, t, a.ovec);
}

template <typename T, int DP>
cudaError_t run_mma(const MmaParams& a, int ngroups, int B, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsa_fwd_mma_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MmaCfg<DP>::smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  bsa_fwd_mma_kernel<T, DP>
      <<<dim3(ngroups, B), kMmaThreads, MmaCfg<DP>::smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mma_d(const MmaParams& a, int ngroups, int B,
                      cudaStream_t st) {
  if (a.D <= 16) return run_mma<T, 16>(a, ngroups, B, st);
  if (a.D <= 32) return run_mma<T, 32>(a, ngroups, B, st);
  if (a.D <= 64) return run_mma<T, 64>(a, ngroups, B, st);
  return run_mma<T, 128>(a, ngroups, B, st);
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// The copy mode of the tensor-core route: 16-byte copies need D, every
// stride and every base pointer in whole 16-byte chunks, 4-byte copies in
// whole pairs of elements.
int copy_mode(const void* const* ptrs, const long long* strides, int D) {
  bool c16 = D % 8 == 0, c4 = D % 2 == 0;
  for (int i = 0; i < 3; ++i) {
    c16 = c16 && aligned(ptrs[i], 16);
    c4 = c4 && aligned(ptrs[i], 4);
  }
  for (int i = 0; i < 9; ++i) {
    c16 = c16 && strides[i] % 8 == 0;
    c4 = c4 && strides[i] % 2 == 0;
  }
  return c16 ? kCopy16 : c4 ? kCopy4 : kCopyElem;
}

}  // namespace

// q, k, v: [B, S, H, D] of dtype (0 float32, 1 bfloat16, 2 float16) with
// the given element strides of b, s and h (d contiguous); o: contiguous
// [B, S, H, D] of the same dtype; all on the card.  block in {16, 32, 64,
// 128}, S = nq * block, 0 < D <= 128.
// fp32 reads idx: int32 [H, nq, maxk] live k blocks and cnt: int32 [H, nq]
// live slots of each row (a prefix of its idx row).  bf16/fp16 read the
// row-group tables: groups int32 [ngroups, 8] and keys int32 (see the note
// at the top).  Returns a cudaError_t (0 = launched).
extern "C" int ds_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* idx,
    const int* cnt, const int* groups, const int* keys, int ngroups, int B,
    int S, int H, int D, int block, int nq, int maxk, long long q_b,
    long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, float scale, int causal,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > 128 || nq <= 0 || maxk <= 0 ||
      (block != 16 && block != 32 && block != 64 && block != 128) ||
      (int64_t)nq * block != S || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 || dtype == 2) {
    if (ngroups <= 0 || !groups || !keys) return (int)cudaErrorInvalidValue;
    MmaParams a{};
    a.q = q; a.k = k; a.v = v; a.o = o; a.groups = groups; a.keys = keys;
    a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
    a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
    a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
    a.S = S; a.H = H; a.D = D; a.causal = causal; a.scale = scale;
    a.log2_block = block == 16 ? 4 : block == 32 ? 5 : block == 64 ? 6 : 7;
    const void* ptrs[] = {q, k, v};
    const long long strides[] = {q_b, q_s, q_h, k_b, k_s, k_h,
                                 v_b, v_s, v_h};
    a.copy = copy_mode(ptrs, strides, D);
    a.ovec = D % 2 == 0 && aligned(o, 4);
    if (dtype == 1) return (int)run_mma_d<__nv_bfloat16>(a, ngroups, B, st);
    return (int)run_mma_d<__half>(a, ngroups, B, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Params a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.idx = idx; a.cnt = cnt;
  a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
  a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
  a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
  a.S = S; a.H = H; a.D = D; a.block = block; a.nq = nq; a.maxk = maxk;
  a.causal = causal; a.scale = scale;
  return (int)run_d<float>(a, B, st);
}

// Dynamic shared memory of one block for a layout block and head dim:
// the fp32 route's (mma 0) or the tensor-core route's (mma 1).
extern "C" int ds_block_sparse_attention_smem_bytes(int block, int D,
                                                    int mma) {
#define BSA_SMEM(DP)                                                   \
  (mma ? MmaCfg<DP>::smem                                              \
       : block == 16 ? Smem<DP, 1>::bytes                              \
                     : block == 32 ? Smem<DP, 2>::bytes : Smem<DP, 4>::bytes)
  if (D <= 16) return BSA_SMEM(16);
  if (D <= 32) return BSA_SMEM(32);
  if (D <= 64) return BSA_SMEM(64);
  return BSA_SMEM(128);
#undef BSA_SMEM
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
