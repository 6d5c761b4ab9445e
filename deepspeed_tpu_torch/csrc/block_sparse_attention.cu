// Block-sparse flash attention (forward) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel of deepspeed_tpu/ops/pallas/
// block_sparse_attention.py: `block_sparse_flash_attention` (:135), whose
// `_kernel` (:36, via `_fwd` :78) is launched at :102 behind the custom VJP
// `_bs_flash` (:114).  Semantics are the kernel's:
// - q, k, v: [B, S, H, D] (any strides with d contiguous); the layout's
//   tables idx [H, nq, maxk] (the live k blocks of each q block, in
//   ascending order) and cnt [H, nq] (how many; the valid slots of
//   `layout_gather_tables` are a prefix of each row);
// - for each q block, only its live k/v blocks: fp32 scores
//   s = (q . k) * scale, the mask of `_score_mask` (causal: row >= col,
//   sq = sk), an online softmax from -inf; a row that sees no key gives 0;
// - every accumulator is fp32; o is rounded once to the input type (fp32,
//   bf16 or fp16), written contiguous [B, S, H, D].
// There is no backward kernel, as in JAX (`_bs_bwd` :123 differentiates the
// gather formulation).
//
// Design (the tile code of csrc/flash_bias.cu, kernel B10).  256 threads
// as a 16 x 16 grid (ty, tx) over an R x 64 score tile, R = 16 * RI rows:
// thread (ty, tx) owns rows ty + 16i (i < RI) and columns tx + 16j
// (j < 4), so a row is one half-warp and its reductions are shuffles.
// - One block per (row group, head, batch): R = min(block, 64) query rows
//   (layout blocks of 16 and 32 are one group each; 64 one; 128 two).
// - The block walks only its q block's live slots: the live keys of the
//   row, cnt * block of them in slot order, are taken 64 at a time.  Each
//   pass first turns its 64 positions into key rows (slot t / block of the
//   idx table, offset t % block) in shared memory, then loads those K and
//   V rows as fp32 tiles.  A layout block of 16 thus gives a pass of four
//   live blocks; a block of 128, two passes per live block.  JAX's grid
//   walks all maxk slots; here a row stops at its own count, which
//   matters for BigBird, whose global rows make maxk the whole row while
//   most rows hold a handful of blocks.
// - Tiles are fp32 rows of DP + 4 floats in shared memory, DP the head
//   dim rounded up to 16, 32, 64 or 128 (zero-filled past D), so D = 64
//   does half the work of a 128-wide tile.  Products are fp32 FMA on the
//   CUDA cores.
//
// What bounds it on an H100.  Counting each input read once, the call
// moves q, o and the k/v blocks that some row uses, and does two products
// over the live (q block, k block) pairs: at BigBird's width (block 64,
// D = 64) the two take about the same time, bytes at 3.35 TB/s and
// operations at the bf16 tensor-core rate (989 TFLOP/s).  This kernel
// runs the products on the fp32 FMA units (67 TFLOP/s, about 20 flops a
// byte of HBM), so the operations bind it, far above that bound; it also
// reads each live k/v block once per q row group from L2 (a group of 16
// rows for layout block 16).  mma.sync/wgmma with fp32 accumulation and,
// for small layout blocks, row groups of several q blocks sharing their
// k blocks are the levers for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kKeys = 64;      // keys per pass
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = 80;        // row stride (floats) of the P tile

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

}  // namespace

// q, k, v: [B, S, H, D] of dtype (0 float32, 1 bfloat16, 2 float16) with
// the given element strides of b, s and h (d contiguous); o: contiguous
// [B, S, H, D] of the same dtype; idx: int32 [H, nq, maxk] live k blocks;
// cnt: int32 [H, nq] live slots of each row (a prefix of its idx row),
// all on the card.  block in {16, 32, 64, 128}, S = nq * block,
// 0 < D <= 128.  Returns a cudaError_t (0 = launched).
extern "C" int ds_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* idx,
    const int* cnt, int B, int S, int H, int D, int block, int nq, int maxk,
    long long q_b, long long q_s, long long q_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h, float scale,
    int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > 128 || nq <= 0 || maxk <= 0 ||
      (block != 16 && block != 32 && block != 64 && block != 128) ||
      (int64_t)nq * block != S || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.idx = idx; a.cnt = cnt;
  a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
  a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
  a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
  a.S = S; a.H = H; a.D = D; a.block = block; a.nq = nq; a.maxk = maxk;
  a.causal = causal; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_d<float>(a, B, st);
  if (dtype == 1) return (int)run_d<__nv_bfloat16>(a, B, st);
  if (dtype == 2) return (int)run_d<__half>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block for a layout block and head dim.
extern "C" int ds_block_sparse_attention_smem_bytes(int block, int D) {
#define BSA_SMEM(DP) \
  (block == 16 ? Smem<DP, 1>::bytes \
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
