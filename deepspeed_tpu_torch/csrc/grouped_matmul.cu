// Grouped (MoE expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/grouped_matmul.py
// (gmm :80, kernel body _gmm_kernel :37): y[i] = x[i] @ w[g(i)] for x [T, K]
// whose rows are sorted by group, w [E, K, N] and group_sizes [E] int32 on
// the device; the product accumulates in fp32 and each output is rounded
// once to x's dtype (lax.ragged_dot's semantics).  Rows past the sum of the
// group sizes are left to the caller (the wrapper hands in a zeroed y).
//
// Tile map.  The Pallas kernel pads every group to a multiple of block_m
// by scattering x into a padded copy, so that each row tile belongs to one
// expert.  Here no copy is made: a block of the grid is one (row tile,
// column tile) of the static bound ceil(T / BM) + E row tiles, and finds
// its expert and row range itself from group_sizes (a serial scan over E
// by one thread; the sizes never reach the host, so a caller pays no
// sync).  Tiles past the live ones exit at once.  The row tile is the
// grid's fastest dimension, so the row tiles of one expert that share a
// weight slab run together and the slab comes from HBM about once.
//
// Routes.  The caller names the route (ops/kernels/grouped_matmul.py:
// gmm_route, the one statement of the rule, fixes it on the host from
// shapes, dtype and alignment; never a retry after a failure); a launch
// refuses a route whose kernel cannot take the arguments:
// - kRouteTma, kRouteTma64 (bf16/fp16, K % 64 == 0, N % 8 == 0, x and w at
//   16-byte aligned addresses): warp-specialised wgmma fed by TMA.  A block
//   is NC consumer warpgroups and one producer warp of one more, over a
//   BM x BN = 64 NC x 128 NC tile: 128 x 256 (kRouteTma), or 64 x 128
//   (kRouteTma64, two blocks an SM) for the decode shapes, T <= 64,
//   whose few rows an expert would leave a 128-row box mostly zeros.  The
//   producer keeps a ring of 4 stages in flight with cp.async.bulk.tensor
//   on mbarriers: an x box [BM x 64] from the map of x as [T, K] and BN /
//   64 w boxes [64 x 64] from the map of w viewed as [E K, N] (a box never
//   straddles two experts because K % 64 == 0), all with the 128-byte
//   swizzle; rows past T arrive as zeros.  Each consumer warpgroup runs
//   wgmma.m64nBNk16 on its 64 rows, A K-major and B MN-major (w lies
//   [k][n]: the transpose flag, no copy of w), one wgmma group in flight,
//   and hands a stage back on its empty barrier when the group that read
//   it has completed; setmaxnreg moves registers from the producer to the
//   consumers (128 x 256: 128 fp32 accumulators a thread; a 128 x 128
//   tile would move 1.5 x the L2 -> SM bytes a flop).
//   An x box may run past its group into the next expert's rows: those
//   rows are computed and not stored; the epilogue rounds and stores only
//   the tile's own rows.
// - kRouteMma (bf16/fp16 shapes TMA cannot take: K not a multiple of 64,
//   N not of 8, an unaligned base): mma.sync m16n8k16 over 64x128 tiles
//   in k steps of 32, a 2-deep cp.async ring (16-byte copies when K and N
//   are multiples of 8, element copies otherwise), ldmatrix(.trans) from
//   rows padded by 16 bytes; each of 4 warps holds a 32x64 accumulator.
// - kRouteFp32: CUDA-core FMA over 64x64 tiles (16x16 threads, 4x4 each).
//
// What bounds it on an H100: decode (a few rows per expert) reads every
// active expert's K x N weights once for a handful of rows, so it is bound
// by those bytes at 3.35 TB/s; prefill (hundreds of rows per expert) does
// 2 * rows flops per weight element, at Mixtral's prefill shapes close to
// both the byte and the bf16 tensor-rate bound.  The TMA route moves the
// weights with no thread spending an instruction on them and keeps the
// tensor cores on wgmma (the only path to their full rate); the epilogue
// stores straight from registers, 4 bytes a thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBM = 64;   // rows of a tile (the static tile bound uses it)
constexpr int kBN = 128;  // columns of a tensor-core tile
constexpr int kBK = 32;   // depth of one k step
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;  // shared-memory row strides (elements),
constexpr int kBStride = kBN + 8;  // padded by 16 bytes
constexpr int kDwAStride = kBM + 8;  // dw's x tile [32 rows][64 k]

struct Tile {
  int expert, row0, rows;
};

// Row tile t of the static bound of bm-row tiles: its expert, first row
// and row count (rows <= 0: a dead tile).
__device__ Tile find_tile(const int* group_sizes, int E, int T, int t,
                          int bm) {
  int start = 0;
  for (int e = 0; e < E; ++e) {
    const int sz = max(group_sizes[e], 0);
    const int nt = (sz + bm - 1) / bm;
    if (t < nt) {
      const int row0 = start + t * bm;
      return {e, row0, min(min(bm, sz - t * bm), T - row0)};
    }
    t -= nt;
    start += sz;
  }
  return {0, 0, 0};
}

__device__ void load_tile_info(const int* group_sizes, int E, int T,
                               Tile* s_tile) {
  if (threadIdx.x == 0)
    *s_tile = find_tile(group_sizes, E, T, blockIdx.x, kBM);
  __syncthreads();
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ static void run(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
  __device__ static uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  __device__ static void run(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static __half from_f(float x) { return __float2half_rn(x); }
  __device__ static __half zero() { return __float2half_rn(0.f); }
  __device__ static uint32_t pack2(float a, float b) {
    const __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

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

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the x tile [64 x 32] and the weight tile [32 x 128] of k step k0.
template <typename T, bool kVec>
__device__ void load_stage(const T* __restrict__ x, const T* __restrict__ we,
                           T* As, T* Bs, const Tile& tile, int k0, int n0,
                           int K, int N) {
  const int tid = threadIdx.x;
  if (kVec) {
    // x: 64 rows x 4 vectors of 8; w: 32 rows x 16 vectors of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / 4, c = (v % 4) * 8;
      const bool ok = r < tile.rows && k0 + c < K;
      const T* src = ok ? x + (size_t)(tile.row0 + r) * K + k0 + c : x;
      cp_async16(As + r * kAStride + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / 16, c = (v % 16) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      const T* src = ok ? we + (size_t)(k0 + r) * N + n0 + c : we;
      cp_async16(Bs + r * kBStride + c, src, ok);
    }
  } else {
    for (int v = tid; v < kBM * kBK; v += kThreads) {
      const int r = v / kBK, c = v % kBK;
      As[r * kAStride + c] = (r < tile.rows && k0 + c < K)
                                 ? x[(size_t)(tile.row0 + r) * K + k0 + c]
                                 : Mma<T>::zero();
    }
    for (int v = tid; v < kBK * kBN; v += kThreads) {
      const int r = v / kBN, c = v % kBN;
      Bs[r * kBStride + c] = (k0 + r < K && n0 + c < N)
                                 ? we[(size_t)(k0 + r) * N + n0 + c]
                                 : Mma<T>::zero();
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ group_sizes, T* __restrict__ y,
                   int T_, int K, int N, int E) {
  __shared__ Tile s_tile;
  // raw 16-bit storage, viewed as T (a __shared__ array of a class type
  // would need a trivial constructor)
  __shared__ __align__(16) uint16_t a_raw[2][kBM * kAStride];
  __shared__ __align__(16) uint16_t b_raw[2][kBK * kBStride];
  T* const As = reinterpret_cast<T*>(&a_raw[0][0]);
  T* const Bs = reinterpret_cast<T*>(&b_raw[0][0]);
  constexpr int kAStage = kBM * kAStride, kBStage = kBK * kBStride;
  load_tile_info(group_sizes, E, T_, &s_tile);
  const Tile tile = s_tile;
  if (tile.rows <= 0) return;

  const int n0 = blockIdx.y * kBN;
  const T* we = w + (size_t)tile.expert * K * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_stage<T, kVec>(x, we, As, Bs, tile, 0, n0, K, N);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % 2;
    if (kt + 1 < nk) {
      load_stage<T, kVec>(x, we, As + (buf ^ 1) * kAStage,
                          Bs + (buf ^ 1) * kBStage, tile,
                          (kt + 1) * kBK, n0, K, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a_s = As + buf * kAStage;
    const T* b_s = Bs + buf * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // matrices: rows 0-7 / 8-15 of the 16-row tile, k 0-7 / 8-15
        const int r = wm + mi * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int c = kk + (lane / 16) * 8;
        ldmatrix_x4(a[mi], a_s + r * kAStride + c);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // matrices: k 0-7 / 8-15 of n 0-7, then of n 8-15; .trans turns
        // the [k][n] rows into the column-major B fragment
        const int m = lane / 8;
        const int r = kk + (lane % 8) + (m % 2) * 8;
        const int c = wn + nj * 16 + (m / 2) * 8;
        uint32_t t[4];
        ldmatrix_x4_trans(t, b_s + r * kBStride + c);
        b[2 * nj][0] = t[0];
        b[2 * nj][1] = t[1];
        b[2 * nj + 1][0] = t[2];
        b[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) Mma<T>::run(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // accumulator fragment: c0/c1 at (row g, cols 2*tig, +1), c2/c3 at row g+8
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + mi * 16 + g + half * 8;
      if (r >= tile.rows) continue;
      T* yr = y + (size_t)(tile.row0 + r) * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn + ni * 8 + tig * 2;
        if (col < N) yr[col] = Mma<T>::from_f(acc[mi][ni][half * 2]);
        if (col + 1 < N) yr[col + 1] = Mma<T>::from_f(acc[mi][ni][half * 2 + 1]);
      }
    }
}

constexpr int kFBN = 64, kFBK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    gmm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ group_sizes, float* __restrict__ y,
                    int T_, int K, int N, int E) {
  __shared__ Tile s_tile;
  __shared__ float As[kFBK][kBM + 4];   // transposed: [k][row]
  __shared__ float Bs[kFBK][kFBN + 4];  // [k][col]
  load_tile_info(group_sizes, E, T_, &s_tile);
  const Tile tile = s_tile;
  if (tile.rows <= 0) return;

  const int n0 = blockIdx.y * kFBN;
  const float* we = w + (size_t)tile.expert * K * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFBK) {
    for (int v = tid; v < kBM * kFBK; v += kFThreads) {
      const int r = v / kFBK, c = v % kFBK;
      As[c][r] = (r < tile.rows && k0 + c < K)
                     ? x[(size_t)(tile.row0 + r) * K + k0 + c]
                     : 0.f;
    }
    for (int v = tid; v < kFBK * kFBN; v += kFThreads) {
      const int r = v / kFBN, c = v % kFBN;
      Bs[r][c] = (k0 + r < K && n0 + c < N) ? we[(size_t)(k0 + r) * N + n0 + c]
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= tile.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) y[(size_t)(tile.row0 + r) * N + col] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch_mma(const void* x, const void* w, const int* gs, void* y,
                       int T_, int K, int N, int E, cudaStream_t st) {
  dim3 grid((T_ + kBM - 1) / kBM + E, (N + kBN - 1) / kBN);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    gmm_mma_kernel<T, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), gs,
        static_cast<T*>(y), T_, K, N, E);
  else
    gmm_mma_kernel<T, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), gs,
        static_cast<T*>(y), T_, K, N, E);
  return cudaGetLastError();
}


// ===================================== wgmma + TMA route (bf16 and fp16)

constexpr int kRouteFp32 = 0, kRouteMma = 1, kRouteTma = 2, kRouteTma64 = 3;

// Band size of the backward's tile orders, dx's and dw's (row tiles a
// band; on an H100 bands of 4, 8 and 16 ran within the card's spread)
constexpr int kBand = 8;

// Tile `lin` of a rows x cols grid of tiles, in bands of `band` rows: a
// band walks all its tiles, rows fastest, before the next band starts, so
// the tiles in flight together share a few rows' and columns' operands in
// L2.  Returns (row tile, column tile).
__device__ __forceinline__ int2 banded(int lin, int rows, int cols,
                                       int band) {
  const int b = lin / (band * cols), r0 = b * band;
  const int in_band = min(band, rows - r0);
  const int idx = lin - r0 * cols;
  return make_int2(r0 + idx % in_band, idx / in_band);
}

// NC consumer warpgroups: a BM x BN = 64 NC x 128 NC tile (128 x 256, one
// block an SM; 64 x 128, two), and a ring of 4 stages of 48 or 24 KB.
template <int NC>
struct TmaCfg {
  static constexpr int BM = 64 * NC, BN = 128 * NC, BK = 64;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBlocks = 3 - NC;
  static constexpr int kStages = 4;
  static constexpr int XB = BM * BK * 2;  // bytes of an x box
  static constexpr int WB = BK * 64 * 2;  // bytes of one 64-column w box
  static constexpr int kStageBytes = XB + (BN / 64) * WB;
  // the ring (1024-byte aligned: the swizzle's period) and 2 barriers a
  // stage
  static constexpr int smem = 1024 + kStages * kStageBytes + 16 * kStages;
};

// kDx false: the forward, y [T, N] = x [T, K] @ w[g] (xmap: x; w's boxes
// [64 k x 64 n], B MN-major).  kDx true: the input gradient, y = dx [T, K]
// = dy [T, N] @ w[g]^T (xmap: dy; one w box [BN k x 64 n] a stage: the
// contraction runs along w's contiguous dimension, so w as it lies is a
// K-major B operand, read with no transposed copy).  K, N: the forward's
// dimensions in both cases; the contraction is K (forward) or N (dx), the
// output width N or K.
template <typename T, int NC, bool kDx>
__global__ void __launch_bounds__(TmaCfg<NC>::kThreads, TmaCfg<NC>::kBlocks)
    gmm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const int* __restrict__ group_sizes, T* __restrict__ y,
                   int T_, int K, int N, int E) {
  using C = TmaCfg<NC>;
  const int n_out = kDx ? K : N;
  constexpr int kAcc = C::BN / 2;  // accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages *
                                               C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  __shared__ Tile s_tile;
  int row_tile = blockIdx.x, col_tile = blockIdx.y;
  if constexpr (kDx) {
    // dy's rows are the streamed operand here: bands of row tiles walk
    // every column tile while their dy stays in L2
    const int2 rc = banded(blockIdx.x + blockIdx.y * gridDim.x, gridDim.x,
                           gridDim.y, kBand);
    row_tile = rc.x;
    col_tile = rc.y;
  }
  if (threadIdx.x == 0) {
    s_tile = find_tile(group_sizes, E, T_, row_tile, C::BM);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const Tile tile = s_tile;
  if (tile.rows <= 0) return;
  const int n0 = col_tile * C::BN;
  const int nk = kDx ? (N + C::BK - 1) / C::BK : K / C::BK;
  const int wg = threadIdx.x / 128;

  if (wg == NC) {
    // ---- producer: one thread keeps the ring full
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      const int wrow = tile.expert * K;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::kStages, round = kt / C::kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* st = ring + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
        tma_load_2d(st, &xmap, &full[s], kt * C::BK, tile.row0);
        if constexpr (kDx) {
          // rows n0.. of w[g] (output columns), 64 of its columns (the
          // contraction); rows past the expert are computed, not stored
          tma_load_2d(st + C::XB, &wmap, &full[s], kt * C::BK, wrow + n0);
        } else {
#pragma unroll
          for (int c = 0; c < C::BN / 64; ++c)
            tma_load_2d(st + C::XB + c * C::WB, &wmap, &full[s],
                        n0 + 64 * c, wrow + kt * C::BK);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg.. of the tile
    if constexpr (NC == 2) setmaxnreg_inc<232>();
    float d[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % C::kStages;
      mbar_wait(&full[s], (kt / C::kStages) & 1);
      const unsigned char* st = ring + s * C::kStageBytes;
      // A: this warpgroup's 64 rows of 128 bytes (8-row groups 1024 B
      // apart), 32 bytes a k step; B: 64-column chunks 8 KB apart, 16 k
      // rows (2 KB) a k step
      const unsigned char* a0 = st + wg * 64 * 128;
      const unsigned char* b0 = st + C::XB;
      fence_regs<kAcc>(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        if constexpr (kDx)  // B K-major: BN rows of 128 bytes, as A
          Wgmma<T, C::BN, 0>::run(d, wgmma_desc(a0 + kk * 32, 16, 1024),
                                  wgmma_desc(b0 + kk * 32, 16, 1024), 1);
        else
          Wgmma<T, C::BN, 1>::run(d, wgmma_desc(a0 + kk * 32, 16, 1024),
                                  wgmma_desc(b0 + kk * 2048, C::WB, 1024), 1);
      }
      wgmma_commit();
      fence_regs<kAcc>(d);
      // the previous step's products are done: hand its stage back
      wgmma_wait<1>();
      fence_regs<kAcc>(d);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % C::kStages]);
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(d);
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + g + 8 * i;
      if (r >= tile.rows) continue;
      T* yr = y + (size_t)(tile.row0 + r) * n_out;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        // n_out % 8 == 0: col + 1 < n_out too
        const int col = n0 + 8 * j + 2 * t;
        if (col < n_out)
          *reinterpret_cast<uint32_t*>(yr + col) =
              Mma<T>::pack2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
    }
  }
}

// kDx false: x [T, K] -> y [T, N]; true: x is dy [T, N], y is dx [T, K].
template <typename T, int NC, bool kDx = false>
cudaError_t launch_tma(const void* x, const void* w, const int* gs, void* y,
                       int T_, int K, int N, int E, cudaStream_t st) {
  using C = TmaCfg<NC>;
  CUtensorMap xmap, wmap;
  // forward: a box of w must not straddle two experts (K % 64); dx: the
  // output width K in whole 16 bytes for the paired stores; the encoder
  // refuses an unaligned base or a row that is not whole 16 bytes
  const bool ok =
      kDx ? (K % 8 == 0 &&
             make_tensor_map_2d(&xmap, x, TmaType<T>::value, T_, N, N, C::BM,
                                C::BK) &&
             make_tensor_map_2d(&wmap, w, TmaType<T>::value,
                                (uint64_t)E * K, N, N, C::BN, C::BK))
          : (K % C::BK == 0 &&
             make_tensor_map_2d(&xmap, x, TmaType<T>::value, T_, K, K, C::BM,
                                C::BK) &&
             make_tensor_map_2d(&wmap, w, TmaType<T>::value,
                                (uint64_t)E * K, N, N, C::BK, 64));
  if (!ok) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_tma_kernel<T, NC, kDx>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_out = kDx ? K : N;
  dim3 grid((T_ + C::BM - 1) / C::BM + E, (n_out + C::BN - 1) / C::BN);
  gmm_tma_kernel<T, NC, kDx><<<grid, C::kThreads, C::smem, st>>>(
      xmap, wmap, gs, static_cast<T*>(y), T_, K, N, E);
  return cudaGetLastError();
}

// ============================================ backward: dx and dw kernels
//
// The gradient of y = gmm(x, w, group_sizes) (lax.ragged_dot's transpose):
// dx[i] = dy[i] @ w[g(i)]^T, and dw[e] = x_e^T @ dy_e over expert e's own
// rows, fp32 accumulation rounded once to w's dtype; an expert with no
// rows gets dw[e] = 0.  Both find their expert's row range from
// group_sizes on the device, as the forward's blocks do.
//
// What bounds them on an H100: each does 2 T K N flops, at Mixtral's
// training shapes (T = 16,384 token copies) 1.95 ms of the bf16 tensor
// rate; their bytes (T K + T N + E K N) take a quarter of that, if each is
// read about once.
// - dx (bf16/fp16 where TMA takes the shapes): the forward's wgmma + TMA
//   kernel with w as a K-major B operand (gmm_tma_kernel<.., kDx = true>).
//   In the forward's order (row tiles fastest) a wave of 132 blocks is one
//   output column tile over every row tile, so each wave would read all of
//   dy (0.47 GB for w1's dx, past the 50 MB L2) again: ~7.5 GB, above the
//   flop bound.  So dx takes its blocks in bands of kBand row tiles that
//   walk every column tile: dy comes from device memory about once, w once
//   a band.  (dx on dw's persistent kernel below, pairs of
//   column tiles sharing dy, ran no faster.)  Otherwise the CUDA-core
//   route below.
// - dw (bf16/fp16, K and N multiples of 8, 16-byte aligned x and dy):
//   gmm_dw_tma_kernel, wgmma fed by TMA with the expert's ragged tail
//   zeroed in shared memory (the notes at the kernel); other 16-bit
//   shapes mma.sync over 64 x 128 tiles (kRouteMma, ~0.2 of the rate);
//   fp32 the CUDA cores.

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// [row0, row1) of expert e's rows (clamped to T)
__device__ __forceinline__ int2 expert_rows(const int* group_sizes, int e,
                                            int T) {
  int start = 0;
  for (int i = 0; i < e; ++i) start += max(group_sizes[i], 0);
  const int end = start + max(group_sizes[e], 0);
  return make_int2(min(start, T), min(end, T));
}

// dx on the CUDA cores (fp32, or 16-bit shapes TMA cannot take): a block
// is a 64-row tile of the static bound (as the forward's) x 64 columns of
// dx; dy's tile [64 x 16] and w[g]'s [64 k x 16 n] per contraction step.
template <typename T>
__global__ void __launch_bounds__(kFThreads)
    gmm_dx_simt_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                       const int* __restrict__ group_sizes,
                       T* __restrict__ dx, int T_, int K, int N, int E) {
  __shared__ Tile s_tile;
  __shared__ float As[kFBK][kBM + 4];   // [n][row]
  __shared__ float Bs[kFBK][kFBN + 4];  // [n][k]
  load_tile_info(group_sizes, E, T_, &s_tile);
  const Tile tile = s_tile;
  if (tile.rows <= 0) return;
  const int k0 = blockIdx.y * kFBN;
  const T* we = w + (size_t)tile.expert * K * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int c0 = 0; c0 < N; c0 += kFBK) {
    for (int v = tid; v < kBM * kFBK; v += kFThreads) {
      const int r = v / kFBK, c = v % kFBK;
      As[c][r] = (r < tile.rows && c0 + c < N)
                     ? to_f(dy[(size_t)(tile.row0 + r) * N + c0 + c])
                     : 0.f;
    }
    for (int v = tid; v < kFBK * kFBN; v += kFThreads) {
      const int j = v / kFBK, c = v % kFBK;  // consecutive threads: along n
      Bs[c][j] = (k0 + j < K && c0 + c < N)
                     ? to_f(we[(size_t)(k0 + j) * N + c0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kFBK; ++cc) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[cc][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[cc][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= tile.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (col < K)
        dx[(size_t)(tile.row0 + r) * K + col] = from_f<T>(acc[i][j]);
    }
  }
}

// dw on the CUDA cores: a block is 64 x 64 of dw[e] ([K, N]); the
// contraction runs over the expert's rows in steps of 16.
template <typename T>
__global__ void __launch_bounds__(kFThreads)
    gmm_dw_simt_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const int* __restrict__ group_sizes,
                       T* __restrict__ dw, int T_, int K, int N, int E) {
  __shared__ float As[kFBK][kBM + 4];   // [row][k]
  __shared__ float Bs[kFBK][kFBN + 4];  // [row][n]
  const int e = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kFBN;
  const int2 rows = expert_rows(group_sizes, e, T_);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int r0 = rows.x; r0 < rows.y; r0 += kFBK) {
    for (int v = tid; v < kFBK * kBM; v += kFThreads) {
      const int r = v / kBM, c = v % kBM;
      As[r][c] = (r0 + r < rows.y && m0 + c < K)
                     ? to_f(x[(size_t)(r0 + r) * K + m0 + c])
                     : 0.f;
    }
    for (int v = tid; v < kFBK * kFBN; v += kFThreads) {
      const int r = v / kFBN, c = v % kFBN;
      Bs[r][c] = (r0 + r < rows.y && n0 + c < N)
                     ? to_f(dy[(size_t)(r0 + r) * N + n0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kFBK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[(size_t)m * N + col] = from_f<T>(acc[i][j]);
    }
  }
}

// dw with mma.sync m16n8k16: a block is 64 (k) x 128 (n) of dw[e], 4 warps
// of 32 x 64; the contraction runs over the expert's rows 32 at a time
// through a 2-deep cp.async ring.  A = x_e^T is stored as x's rows
// ([row][k], k contiguous) and read with ldmatrix.trans; B = dy_e as
// [row][n], read with ldmatrix.trans as the forward's B.  Rows past the
// expert arrive as zeros (cp.async with 0 source bytes).
template <typename T, bool kVec>
__device__ void load_dw_stage(const T* __restrict__ x,
                              const T* __restrict__ dy, T* As, T* Bs,
                              int r0, int r1, int m0, int n0, int K, int N) {
  const int tid = threadIdx.x;
  if (kVec) {
    // x: 32 rows x 8 vectors of 8; dy: 32 rows x 16 vectors of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / 8, c = (v % 8) * 8;
      const bool ok = r0 + r < r1 && m0 + c < K;
      const T* src = ok ? x + (size_t)(r0 + r) * K + m0 + c : x;
      cp_async16(As + r * kDwAStride + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / 16, c = (v % 16) * 8;
      const bool ok = r0 + r < r1 && n0 + c < N;
      const T* src = ok ? dy + (size_t)(r0 + r) * N + n0 + c : dy;
      cp_async16(Bs + r * kBStride + c, src, ok);
    }
  } else {
    for (int v = tid; v < kBK * kBM; v += kThreads) {
      const int r = v / kBM, c = v % kBM;
      As[r * kDwAStride + c] = (r0 + r < r1 && m0 + c < K)
                                   ? x[(size_t)(r0 + r) * K + m0 + c]
                                   : Mma<T>::zero();
    }
    for (int v = tid; v < kBK * kBN; v += kThreads) {
      const int r = v / kBN, c = v % kBN;
      Bs[r * kBStride + c] = (r0 + r < r1 && n0 + c < N)
                                 ? dy[(size_t)(r0 + r) * N + n0 + c]
                                 : Mma<T>::zero();
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_mma_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const int* __restrict__ group_sizes,
                      T* __restrict__ dw, int T_, int K, int N, int E) {
  __shared__ __align__(16) uint16_t a_raw[2][kBK * kDwAStride];
  __shared__ __align__(16) uint16_t b_raw[2][kBK * kBStride];
  T* const As = reinterpret_cast<T*>(&a_raw[0][0]);
  T* const Bs = reinterpret_cast<T*>(&b_raw[0][0]);
  constexpr int kAStage = kBK * kDwAStride, kBStage = kBK * kBStride;
  const int e = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int2 rows = expert_rows(group_sizes, e, T_);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = (rows.y - rows.x + kBK - 1) / kBK;
  if (nk > 0) {
    load_dw_stage<T, kVec>(x, dy, As, Bs, rows.x, rows.y, m0, n0, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % 2;
    if (kt + 1 < nk) {
      load_dw_stage<T, kVec>(x, dy, As + (buf ^ 1) * kAStage,
                             Bs + (buf ^ 1) * kBStage,
                             rows.x + (kt + 1) * kBK, rows.y, m0, n0, K, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a_s = As + buf * kAStage;
    const T* b_s = Bs + buf * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15) of the 16 x 16 A tile,
        // each 8 x 8 stored k-major: .trans hands out the row fragment
        const int q = lane / 8;
        const int r = kk + (lane % 8) + (q / 2) * 8;
        const int c = wm + mi * 16 + (q % 2) * 8;
        ldmatrix_x4_trans(a[mi], a_s + r * kDwAStride + c);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int m = lane / 8;
        const int r = kk + (lane % 8) + (m % 2) * 8;
        const int c = wn + nj * 16 + (m / 2) * 8;
        uint32_t t[4];
        ldmatrix_x4_trans(t, b_s + r * kBStride + c);
        b[2 * nj][0] = t[0];
        b[2 * nj][1] = t[1];
        b[2 * nj + 1][0] = t[2];
        b[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) Mma<T>::run(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // every block stores its tile: an expert with no rows gets zeros
  T* out = dw + (size_t)e * K * N;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= K) continue;
      T* yr = out + (size_t)m * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn + ni * 8 + tig * 2;
        if (col < N) yr[col] = Mma<T>::from_f(acc[mi][ni][half * 2]);
        if (col + 1 < N)
          yr[col + 1] = Mma<T>::from_f(acc[mi][ni][half * 2 + 1]);
      }
    }
}

// dw on wgmma fed by TMA (bf16/fp16; K and N multiples of 8, x and dy
// 16-byte aligned): the forward's warp-specialised block (one producer
// warp, two consumer warpgroups) on a 128 (k) x 256 (n) tile of dw[e], 128
// fp32 accumulators a thread.  A stage is the contraction's next 64 rows
// of the expert: two x boxes [64 rows x 64 k] (one a consumer warpgroup)
// and four dy boxes [64 rows x 64 n], 128-byte swizzled, each from the
// expert's own first row (TMA takes any row coordinate; rows past T
// arrive as zeros).  A = x_e^T is MN-major (x's rows as they lie, k
// contiguous: the transpose flag, no copy), B = dy_e MN-major as the
// forward's B.
//
// The ragged tail: the expert's last box runs past its rows into the next
// expert's.  Those are contraction rows, so they must add nothing: the
// consumers overwrite them with zeros in all six boxes (x and dy both,
// since 0 * inf is NaN: a neighbour's non-finite dy must not reach this
// expert) after the stage has landed, fence the async proxy (wgmma reads
// through it) and meet on a named barrier before the first wgmma of the
// step.  A swizzled box's row is its own 128 bytes, so a whole row is
// zeroed whatever the swizzle.  Only the last step of a tile pays it.
//
// Pairs: the two blocks of a cluster take the row tiles 2p and 2p + 1 of
// one expert at one column tile, which read the same dy boxes: each loads
// two of the four and multicasts them into both, so a block reads 32 KB a
// stage from L2 instead of 48.  A stage is free again only when both
// blocks' consumers have released it (its empty barrier counts the warps
// of both).
//
// Persistent: the clusters the card holds walk the pairs of tiles p =
// cluster, + clusters, ... over every expert (an expert's in bands of
// kBand pairs of row tiles that walk all column tiles, so the band's x
// columns and the column tiles' dy stay in L2); the producer runs ahead
// into the next tile.  The epilogue does not hold the tensor cores:
// each consumer warpgroup rounds its 64 x 256 accumulators into four
// swizzled boxes in shared memory and one thread hands them to TMA stores,
// which drain while the next tile's products run; a tile's store waits
// only for the previous tile's to have read those boxes.  So the ring is 3
// stages (144 KB) beside the 64 KB staged tile.  An expert with no rows
// loads nothing and stores zeros.  No atomics, and each tile sums its
// expert's rows in one fixed order: reruns are bit-equal.
struct DwCfg {
  static constexpr int BM = 128, BN = 256, BK = 64;
  static constexpr int kThreads = 384;   // 2 consumer warpgroups + 1
  static constexpr int kStages = 3;
  static constexpr int kBox = 64 * 64 * 2;  // one [64 x 64] 16-bit box
  static constexpr int kStageBytes = 6 * kBox;  // 2 x boxes, 4 dy boxes
  static constexpr int kOutBytes = 8 * kBox;    // the rounded tile
  static constexpr int smem =
      1024 + kStages * kStageBytes + kOutBytes + 16 * kStages;
};

template <typename T>
__global__ void __launch_bounds__(DwCfg::kThreads, 1)
    gmm_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap dwmap,
                      const int* __restrict__ group_sizes, int T_, int K,
                      int N, int E) {
  using C = DwCfg;
  constexpr int kAcc = C::BN / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staged = ring + C::kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + C::kOutBytes);
  uint64_t* empty = full + C::kStages;
  const uint32_t rank = cluster_ctarank();  // 0 or 1: the pair's row tile
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);  // one arrival a consumer warp of the pair
    }
    mbar_init_fence();
  }
  // both blocks' barriers are set before either multicasts or arrives
  cluster_sync();
  const int tm = (K + C::BM - 1) / C::BM, tn = (N + C::BN - 1) / C::BN;
  const int tp = (tm + 1) / 2, pairs = E * tp * tn;
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full across tiles
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int it = 0;  // k steps issued, over all of this block's tiles
      for (int p = cluster; p < pairs; p += clusters) {
        const int e = p / (tp * tn);
        const int2 mn = banded(p - e * tp * tn, tp, tn, kBand);
        const int m0 = (2 * mn.x + rank) * C::BM;
        const int2 rows = expert_rows(group_sizes, e, T_);
        const int nk = (rows.y - rows.x + C::BK - 1) / C::BK;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % C::kStages, round = it / C::kStages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          unsigned char* st = ring + s * C::kStageBytes;
          const int r = rows.x + kt * C::BK;
          // all six boxes land here: this block's x boxes, its two dy
          // boxes and the pair's other two
          mbar_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma_load_2d(st + c * C::kBox, &xmap, &full[s], m0 + 64 * c, r);
#pragma unroll
          for (int c = 2 * rank; c < 2 * rank + 2; ++c)
            tma_load_2d_multicast(st + (2 + c) * C::kBox, &dymap, &full[s],
                                  mn.y * C::BN + 64 * c, r, 0x3);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns dw rows (k) 64 wg.. of the tile
    setmaxnreg_inc<232>();
    const int wtid = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int warp = wtid / 32;
    unsigned char* out = staged + wg * 4 * C::kBox;  // this warpgroup's
    float d[kAcc];
    int it = 0;
    for (int p = cluster; p < pairs; p += clusters) {
      const int e = p / (tp * tn);
      const int2 mn = banded(p - e * tp * tn, tp, tn, kBand);
      const int m0 = (2 * mn.x + rank) * C::BM;
      const int2 rows = expert_rows(group_sizes, e, T_);
      const int nk = (rows.y - rows.x + C::BK - 1) / C::BK;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % C::kStages;
        mbar_wait(&full[s], (it / C::kStages) & 1);
        unsigned char* st = ring + s * C::kStageBytes;
        const int valid = rows.y - rows.x - kt * C::BK;
        if (valid < C::BK) {
          // rows valid..63 of every box are the next expert's (or past
          // the groups): zero them, 16 bytes a store, in all six boxes
          const int per_box = (C::BK - valid) * 8;
          for (int c = threadIdx.x; c < 6 * per_box; c += 256) {
            const int b = c / per_box, q = c - b * per_box;
            *reinterpret_cast<uint4*>(st + b * C::kBox +
                                      (valid + q / 8) * 128 + (q % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          named_barrier_sync(1, 256);
        }
        // A: this warpgroup's x box, B: the four dy boxes (8 KB apart);
        // both MN-major, 16 contraction rows (2 KB) a k step
        const unsigned char* a0 = st + wg * C::kBox;
        const unsigned char* b0 = st + 2 * C::kBox;
        fence_regs<kAcc>(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk)
          Wgmma<T, C::BN, 1, 1>::run(
              d, wgmma_desc(a0 + kk * 2048, C::kBox, 1024),
              wgmma_desc(b0 + kk * 2048, C::kBox, 1024), 1);
        wgmma_commit();
        fence_regs<kAcc>(d);
        // the previous step's products are done: hand its stage back to
        // both blocks' producers (each multicasts into it)
        wgmma_wait<1>();
        fence_regs<kAcc>(d);
        if (kt > 0 && lane == 0)
          for (uint32_t c = 0; c < 2; ++c)
            mbar_arrive_cluster(&empty[(it - 1) % C::kStages], c);
      }
      wgmma_wait<0>();
      fence_regs<kAcc>(d);
      if (nk > 0 && lane == 0)
        for (uint32_t c = 0; c < 2; ++c)
          mbar_arrive_cluster(&empty[(it - 1) % C::kStages], c);
      // the previous tile's stores have read the staged boxes
      if (wtid == 0) bulk_wait_read<0>();
      named_barrier_sync(2 + wg, 128);
      // d[4j + 2i + c] is row 16 warp + lane / 4 + 8i, column 8j + 2 (lane
      // % 4) + c: column chunk j % 8 of box j / 8, swizzled by the row
      const int g = lane / 4, q = lane % 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              out + (j / 8) * C::kBox + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
              q * 4) = Mma<T>::pack2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
      fence_proxy_async();
      named_barrier_sync(2 + wg, 128);
      if (wtid == 0) {
        // rows past K and columns past N are clipped by the map
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_store_3d(&dwmap, out + c * C::kBox, mn.y * C::BN + 64 * c,
                       m0 + 64 * wg, e);
        bulk_commit();
      }
    }
    if (wtid == 0) bulk_wait<0>();
  }
  // no block leaves while its pair may still arrive on its barriers
  cluster_sync();
}

// x [T, K], dy [T, N] -> dw [E, K, N] on gmm_dw_tma_kernel: clusters of 2
// blocks, as many as the card holds at once (at most one a pair of tiles).
// The encoder refuses an unaligned base or rows that are not whole 16
// bytes (K or N not a multiple of 8), and T = 0.
template <typename T>
cudaError_t launch_dw_tma(const void* x, const void* dy, const int* gs,
                          void* dw, int T_, int K, int N, int E,
                          cudaStream_t st) {
  using C = DwCfg;
  CUtensorMap xmap, dymap, dwmap;
  if (!(make_tensor_map_2d(&xmap, x, TmaType<T>::value, T_, K, K, 64,
                           C::BK) &&
        make_tensor_map_2d(&dymap, dy, TmaType<T>::value, T_, N, N, 64,
                           C::BK) &&
        make_tensor_map_3d(&dwmap, dw, TmaType<T>::value, E, K, N, 64, 64)))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_dw_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;  // clusters the card holds at once
  if (!resident) {
    cfg.gridDim = dim3(2);
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &resident, gmm_dw_tma_kernel<T>, &cfg);
    if (e != cudaSuccess) return e;
    if (resident <= 0) return cudaErrorInvalidConfiguration;
  }
  const long pairs = (long)E * ((K + 2 * C::BM - 1) / (2 * C::BM)) *
                     ((N + C::BN - 1) / C::BN);
  if (pairs > INT_MAX / 2) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(2 * (int)(pairs < resident ? pairs : resident));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gmm_dw_tma_kernel<T>, xmap,
                                           dymap, dwmap, gs, T_, K, N, E);
  return e != cudaSuccess ? e : cudaGetLastError();
}

constexpr int kRouteSimt = 4;  // backward only: CUDA cores, any dtype

template <typename T>
cudaError_t launch_dx(int route, const void* dy, const void* w,
                      const int* gs, void* dx, int T_, int K, int N, int E,
                      cudaStream_t st) {
  if (route == kRouteSimt) {
    dim3 grid((T_ + kBM - 1) / kBM + E, (K + kFBN - 1) / kFBN);
    gmm_dx_simt_kernel<T><<<grid, kFThreads, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(w), gs,
        static_cast<T*>(dx), T_, K, N, E);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {
    if (route == kRouteTma)
      return launch_tma<T, 2, true>(dy, w, gs, dx, T_, K, N, E, st);
    if (route == kRouteTma64)
      return launch_tma<T, 1, true>(dy, w, gs, dx, T_, K, N, E, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dw(int route, const void* x, const void* dy,
                      const int* gs, void* dw, int T_, int K, int N, int E,
                      cudaStream_t st) {
  if (route == kRouteSimt) {
    dim3 grid((K + kBM - 1) / kBM, (N + kFBN - 1) / kFBN, E);
    gmm_dw_simt_kernel<T><<<grid, kFThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), gs,
        static_cast<T*>(dw), T_, K, N, E);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {
    if (route == kRouteTma)
      return launch_dw_tma<T>(x, dy, gs, dw, T_, K, N, E, st);
    if (route == kRouteMma) {
      dim3 grid((K + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);
      const bool vec = K % 8 == 0 && N % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0;
      if (vec)
        gmm_dw_mma_kernel<T, true><<<grid, kThreads, 0, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy), gs,
            static_cast<T*>(dw), T_, K, N, E);
      else
        gmm_dw_mma_kernel<T, false><<<grid, kThreads, 0, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy), gs,
            static_cast<T*>(dw), T_, K, N, E);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_16bit(int route, const void* x, const void* w,
                         const int* gs, void* y, int T_, int K, int N, int E,
                         cudaStream_t st) {
  if (route == kRouteTma) return launch_tma<T, 2>(x, w, gs, y, T_, K, N, E, st);
  if (route == kRouteTma64)
    return launch_tma<T, 1>(x, w, gs, y, T_, K, N, E, st);
  return launch_mma<T>(x, w, gs, y, T_, K, N, E, st);
}

}  // namespace

// x [T, K], w [E, K, N], group_sizes [E] int32, y [T, N]; dtype 0 fp32,
// 1 bf16, 2 fp16; route 0 fp32 (CUDA cores, fp32 only), 1 mma.sync, 2
// wgmma + TMA (128-row tiles), 3 wgmma + TMA (64-row tiles), the last three
// bf16/fp16 only.  Returns a cudaError_t code (0: launched).
extern "C" int ds_gmm(const void* x, const void* w, const void* group_sizes,
                      void* y, int T_, int K, int N, int E, int dtype,
                      int route, void* stream) {
  const bool fp32 = dtype == 0 && route == kRouteFp32;
  const bool half = (dtype == 1 || dtype == 2) && route >= kRouteMma &&
                    route <= kRouteTma64;
  if (T_ < 0 || K <= 0 || N <= 0 || E <= 0 || !(fp32 || half))
    return (int)cudaErrorInvalidValue;
  if (T_ == 0) return 0;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_16bit<__nv_bfloat16>(route, x, w, gs, y, T_, K, N, E,
                                            st);
  if (dtype == 2)
    return (int)launch_16bit<__half>(route, x, w, gs, y, T_, K, N, E, st);
  dim3 grid((T_ + kBM - 1) / kBM + E, (N + kFBN - 1) / kFBN);
  gmm_fp32_kernel<<<grid, kFThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gs,
      static_cast<float*>(y), T_, K, N, E);
  return (int)cudaGetLastError();
}

// The backward of ds_gmm.  dx: dy [T, N], w [E, K, N] -> dx [T, K]
// (rows past the sum of the sizes left to the caller); routes 2, 3 (wgmma
// + TMA, 16-bit) or 4 (CUDA cores, any dtype).  dw: x [T, K], dy [T, N]
// -> dw [E, K, N] (every expert written, zeros where it has no rows);
// routes 2 (wgmma + TMA, 16-bit, T > 0), 1 (mma.sync, 16-bit) or 4.
// Returns a cudaError_t code.
extern "C" int ds_gmm_dx(const void* dy, const void* w,
                         const void* group_sizes, void* dx, int T_, int K,
                         int N, int E, int dtype, int route, void* stream) {
  if (T_ < 0 || K <= 0 || N <= 0 || E <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (T_ == 0) return 0;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_dx<__nv_bfloat16>(route, dy, w, gs, dx, T_, K, N, E,
                                         st);
  if (dtype == 2)
    return (int)launch_dx<__half>(route, dy, w, gs, dx, T_, K, N, E, st);
  return (int)launch_dx<float>(route, dy, w, gs, dx, T_, K, N, E, st);
}

extern "C" int ds_gmm_dw(const void* x, const void* dy,
                         const void* group_sizes, void* dw, int T_, int K,
                         int N, int E, int dtype, int route, void* stream) {
  if (T_ < 0 || K <= 0 || N <= 0 || E <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_dw<__nv_bfloat16>(route, x, dy, gs, dw, T_, K, N, E,
                                         st);
  if (dtype == 2)
    return (int)launch_dw<__half>(route, x, dy, gs, dw, T_, K, N, E, st);
  return (int)launch_dw<float>(route, x, dy, gs, dw, T_, K, N, E, st);
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
