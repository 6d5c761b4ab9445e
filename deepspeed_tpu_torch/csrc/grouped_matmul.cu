// Grouped (MoE expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/grouped_matmul.py
// (gmm :80, kernel body _gmm_kernel :37): y[i] = x[i] @ w[g(i)] for x [T, K]
// whose rows are sorted by group, w [E, K, N] and group_sizes [E] int32 on
// the device; the product accumulates in fp32 and each output is rounded
// once to x's dtype (lax.ragged_dot's semantics).  Rows past the sum of the
// group sizes are left to the caller (the wrapper hands in a zeroed y).
//
// Design.  The Pallas kernel pads every group to a multiple of block_m by
// scattering x into a padded copy, so that each row tile belongs to one
// expert.  Here no copy is made: a block of the grid is one (row tile,
// column tile) of the static bound ceil(T/64) + E row tiles, and finds its
// expert and row range itself from group_sizes (a serial scan over E by one
// thread; the sizes never reach the host, so a caller pays no sync).  Tiles
// past the live ones exit at once.  Rows, K and N are masked at the edges,
// so any K and N work.
//
// bf16/fp16: tensor cores through mma.sync m16n8k16 (fp32 accumulate).  A
// block of 4 warps computes a 64x128 tile in steps of k = 32; the x tile
// (64x32) and the weight tile (32x128, row-major [k][n] as w lies) are
// staged in shared memory, double-buffered with cp.async (16-byte copies
// when K and N are multiples of 8, element copies otherwise), rows padded
// by 16 bytes so that ldmatrix (.trans for the weight) reads without bank
// conflicts.  Each warp holds a 32x64 fp32 accumulator.
// fp32: CUDA-core FMA over 64x64 tiles (16x16 threads, 4x4 outputs each).
//
// What bounds it on an H100: decode (a few rows per expert) reads every
// active expert's K x N weights once for a handful of rows, so it is bound
// by those bytes at 3.35 TB/s; prefill (hundreds of rows per expert) does
// 2*rows flops per weight element and is bound by the bf16 tensor rate.
// This first version uses neither wgmma nor TMA, nor split-K for the
// few-tile decode case: those are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // rows of a tile (the static tile bound uses it)
constexpr int kBN = 128;  // columns of a tensor-core tile
constexpr int kBK = 32;   // depth of one k step
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;  // shared-memory row strides (elements),
constexpr int kBStride = kBN + 8;  // padded by 16 bytes

struct Tile {
  int expert, row0, rows;
};

// Row tile t of the static bound: its expert, first row and row count
// (rows <= 0: a dead tile).
__device__ Tile find_tile(const int* group_sizes, int E, int T, int t) {
  int start = 0;
  for (int e = 0; e < E; ++e) {
    const int sz = max(group_sizes[e], 0);
    const int nt = (sz + kBM - 1) / kBM;
    if (t < nt) {
      const int row0 = start + t * kBM;
      return {e, row0, min(min(kBM, sz - t * kBM), T - row0)};
    }
    t -= nt;
    start += sz;
  }
  return {0, 0, 0};
}

__device__ void load_tile_info(const int* group_sizes, int E, int T,
                               Tile* s_tile) {
  if (threadIdx.x == 0) *s_tile = find_tile(group_sizes, E, T, blockIdx.x);
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

}  // namespace

// x [T, K], w [E, K, N], group_sizes [E] int32, y [T, N]; dtype 0 fp32,
// 1 bf16, 2 fp16.  Returns a cudaError_t code (0: launched).
extern "C" int ds_gmm(const void* x, const void* w, const void* group_sizes,
                      void* y, int T_, int K, int N, int E, int dtype,
                      void* stream) {
  if (T_ < 0 || K <= 0 || N <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  if (T_ == 0) return 0;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_mma<__nv_bfloat16>(x, w, gs, y, T_, K, N, E, st);
  if (dtype == 2) return (int)launch_mma<__half>(x, w, gs, y, T_, K, N, E, st);
  if (dtype == 0) {
    dim3 grid((T_ + kBM - 1) / kBM + E, (N + kFBN - 1) / kFBN);
    gmm_fp32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), gs,
        static_cast<float*>(y), T_, K, N, E);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
