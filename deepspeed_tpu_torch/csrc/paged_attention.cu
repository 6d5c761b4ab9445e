// Paged (blocked-KV) attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py
// (paged_attention :29, paged_attention_atoms :120, kernel body
// _atom_kernel :41).  Semantics are _atom_kernel's: an "atom tile" is `atom`
// consecutive query rows of one sequence, pages are streamed through the
// block table of the tile's FIRST row, each row masks keys by its own
// position (col <= pos, and col > pos - window when window > 0), GQA is in
// the index math, scores are fp32 (q.k)*scale, the online softmax runs in
// fp32 from -inf and a row that saw no key writes 0 (the l_safe rule).
//
// The rows of a (tile, kv head) are its M = atom*g query heads that share
// the kv head (g = H / Hkv), row r = (a, gi) with r = a*g + gi.  A block
// walks only the tile's LIVE keys: from the first key the sliding window
// reaches for the tile's smallest position to its largest position, where
// the TPU grid walks every table column.
//
// Three routes, chosen on the host from shapes alone (`launch_plan` in
// ops/kernels/paged_attention.py, the rule's one statement); the entry
// takes the route and refuses one its kernel cannot take.
//
// decode_split (bf16/fp16, atom 1) and atom_mma (bf16/fp16, atom > 1):
// one tensor-core kernel, paged_attention_mma_kernel<T, DH, RT, PAD>.
// - Grid (tiles, Hkv, row groups x splits).  A block holds 16*RT rows of
//   its (tile, kv head): RT in {1, 2, 4, 8} row tiles of 16, the smallest
//   power of two that covers M (rows past M are zero rows, masked), so
//   every row sharing a kv head is served by ONE read of each K/V tile up
//   to M = 128; beyond that the rows come in groups of 128.
// - Split-KV.  Decode has one row per sequence: 8-16 rows give only
//   256-512 (row, kv head) blocks, each walking its whole context alone.
//   The host splits the table's maxb pages into `splits` spans of `span`
//   pages (from T, Hkv, maxb and M only: no device value, no sync), for
//   decode up to 4096 blocks, for atoms up to one wave (264);
//   each block walks its span and writes its unnormalised fp32 state (acc,
//   m, l) to scratch, or an empty state (m = -inf, l = 0; acc not written)
//   where the span lies past its live keys.  paged_attention_merge_kernel
//   then combines each row's states in split order, skipping empty ones:
//   no atomics, so reruns are bit-equal.  With one split (a prefill of
//   many tiles, decode at T*Hkv >= 4096) the block writes the output.
// - Keys stream in tiles of 64 through a two-slot cp.async ring (16-byte
//   copies, zero-filled past the span): a table of the tile's 64 cache rows
//   (the first row's table, page by page) is built two tiles ahead, the
//   next tile's K and V rows are copied while this one is computed, one
//   barrier a tile.  K is staged [keys][Dh] and read with ldmatrix (load_b),
//   V the same and read with ldmatrix.trans (load_bt); rows padded by 16 B.
// - Products on mma.sync.m16n8k16, fp32 accumulation, with B1's pieces
//   (csrc/mma_common.cuh): Q as A fragments kept in registers, S = Q K^T
//   from the exact inputs, exponentials ex2((s - m) * log2 e), and P fed to
//   P V as hi + lo in the input type (P * 2^15 in fp16): the reference's P
//   is fp32, and a P rounded once breaks the card tolerance in bf16 (the
//   CPU emulation, _emulate_split_kv_tensor_cores, shows both).
// - Warps: max(4, RT).  The kWarps / RT warps of a row tile split each
//   staged tile's 64 keys (RT = 1: 16 keys a warp; RT = 2: 32), each with
//   its own (m, l, acc); at the end they merge in warp order through shared
//   memory (the ring, free by then).
// - Blocks an SM holds: Dh = 128, 2 (73-86 KB of shared memory and up to
//   255 registers a thread; at 3 a block, 170 registers, 1-2 row tiles
//   spill), or 1 at RT = 8 (256 threads of ~250 registers, 104 KB); Dh =
//   64, 3 (39-46 KB, at most 170 registers), or 1 at RT = 8.  Decode keeps
//   a 34 KB tile in flight a block while it computes the other.
//   chip_smoke.py stage 2 prints each instantiation's registers, spills,
//   shared memory and the runtime's count of blocks an SM.
//
// Head widths.  Each kernel is instantiated for tiles 64 and 128 columns
// wide; a head of Dh columns (even, at most 128) runs in the 64-wide tile
// when Dh <= 64, else in the 128-wide one.  Where Dh is narrower than its
// tile (80, 96, 100, 112, ...), the `PAD` instantiation reads the true Dh
// at run time: copies are 16 bytes where Dh % 8 == 0, else 8 or 4 bytes,
// the tile's columns past Dh are zero-filled (so they add nothing to q.k),
// only Dh columns are stored, and the scale is the caller's (Dh^-0.5).
// Where Dh fills its tile, the kernels are the ones without padding.
//
// fp32: the CUDA cores (the first version of this kernel,
// paged_attention_kernel<float>): one block per (tile, kv head, group of
// RM query rows), four warps splitting the keys with synchronous 16-byte
// loads, fp32 FMA, and a merge of the warps' states at the end.
//
// What bounds it on an H100: the bytes of the live K/V pages.  Decode
// reads each live page once per (token, kv head) and does 4*Dh flops per
// key and query row, far below the ~295 flops a byte where bf16 compute
// would bind; a prefill atom reuses each page for atom*g rows, which still
// leaves it under the line at atom 16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "mma_common.cuh"

namespace {

constexpr int round16(int x) { return (x + 15) / 16 * 16; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Route codes of the C entry (ROUTES in ops/kernels/paged_attention.py).
constexpr int kRouteFp32 = 0, kRouteDecodeSplit = 1, kRouteAtomMma = 2;

// ============================================ fp32 route (the CUDA cores)

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerStep = kWarps * 32;
constexpr int kPerVec = 4;  // fp32 elements in 16 bytes

__device__ inline void unpack(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// N consecutive elements (N = 2 or 4)
template <int N>
__device__ inline void load_f(const float* p, float* f) {
  if constexpr (N == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  } else {
    float2 t = *reinterpret_cast<const float2*>(p);
    f[0] = t.x; f[1] = t.y;
  }
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared-memory layout, in bytes.
template <int DH, int RM>
struct Layout {
  static constexpr int kKStride = DH + kPerVec;  // K row + 16 bytes of padding
  static constexpr int q_off = 0;                                  // f32 [RM][DH]
  static constexpr int pos_off = q_off + RM * DH * 4;              // int [RM] + min/max
  static constexpr int p_off = pos_off + round16((RM + 2) * 4);    // f32 [W][RM][32]
  static constexpr int kv_off = p_off + kWarps * RM * 32 * 4;
  static constexpr int k_warp = 32 * kKStride * 4;
  static constexpr int v_warp = 32 * DH * 4;
  static constexpr int kv_bytes = kWarps * (k_warp + v_warp);
  static constexpr int merge_bytes = kWarps * RM * (DH + 2) * 4;   // reuses K/V
  static constexpr int total = kv_off + cmax(kv_bytes, merge_bytes);
};

template <int DH, int RM, bool PAD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                       const float* __restrict__ vc,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, float* __restrict__ out,
                       int H, int Hkv, int dh_arg, int bs, int maxb, int atom,
                       int window, float scale) {
  using L = Layout<DH, RM>;
  const int dh = PAD ? dh_arg : DH;   // the head's columns (<= DH)
  constexpr int kVPR = DH / kPerVec;  // 16-byte vectors in one K/V row
  constexpr int kDPL = DH / 32;       // output dims per lane

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  int* rpos = reinterpret_cast<int*>(smem + L::pos_off);
  float* ps = reinterpret_cast<float*>(smem + L::p_off);

  const int tile = blockIdx.x, kh = blockIdx.y, rg = blockIdx.z;
  const int g = H / Hkv;
  const int M = atom * g;             // query rows of this (tile, kv head)
  const int first = tile * atom;      // first buffer row of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // query rows → shared memory; row r = (a, gi) with r = a*g + gi
  for (int idx = threadIdx.x; idx < RM * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = rg * RM + r;
    float v = 0.f;
    if (row < M && (!PAD || d < dh)) {
      const int tok = first + row / g, head = kh * g + row % g;
      v = q[((int64_t)tok * H + head) * dh + d];
    }
    qs[idx] = v;
  }
  if (threadIdx.x < RM) {
    const int row = rg * RM + threadIdx.x;
    rpos[threadIdx.x] = row < M ? pos[first + row / g] : -1;  // -1: no key
  }
  if (threadIdx.x == 0) {  // the tile's position range bounds its live pages
    int lo = INT_MAX, hi = INT_MIN;
    for (int a = 0; a < atom; ++a) {
      const int p = pos[first + a];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    rpos[RM] = lo;
    rpos[RM + 1] = hi;
  }
  __syncthreads();

  const int key_lo = window > 0 ? max(0, rpos[RM] - window + 1) : 0;
  const int page_hi = min(rpos[RM + 1] / bs, maxb - 1);
  const int k_begin = (key_lo / bs) * bs;
  const int k_end = (page_hi + 1) * bs;
  const int* trow = tables + (int64_t)first * maxb;  // the first row's table
  const int64_t row_stride = (int64_t)Hkv * dh;       // between cache rows

  float* ks = reinterpret_cast<float*>(smem + L::kv_off + warp * (L::k_warp + L::v_warp));
  float* vs = ks + 32 * L::kKStride;
  float* pw = ps + warp * RM * 32;

  float m_r[RM], l_r[RM], acc[RM][kDPL];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  for (int c0 = k_begin + warp * 32; c0 < k_end; c0 += kKeysPerStep) {
    // this warp's 32 keys: K and V rows of kv head kh → shared memory
    for (int idx = lane; idx < 32 * kVPR; idx += 32) {
      const int r = idx / kVPR, v = idx % kVPR, key = c0 + r;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (key < k_end) {
        const int blk = trow[key / bs];
        const int64_t off = ((int64_t)blk * bs + key % bs) * row_stride +
                            (int64_t)kh * dh;
        if (!PAD) {
          kval = reinterpret_cast<const uint4*>(kc + off)[v];
          vval = reinterpret_cast<const uint4*>(vc + off)[v];
        } else {  // element copies, zeros past dh
          uint32_t* kw = reinterpret_cast<uint32_t*>(&kval);
          uint32_t* vw = reinterpret_cast<uint32_t*>(&vval);
#pragma unroll
          for (int e = 0; e < kPerVec; ++e) {
            const int d = v * kPerVec + e;
            if (d < dh) {
              kw[e] = __float_as_uint(kc[off + d]);
              vw[e] = __float_as_uint(vc[off + d]);
            }
          }
        }
      }
      reinterpret_cast<uint4*>(ks + r * L::kKStride)[v] = kval;
      reinterpret_cast<uint4*>(vs + r * DH)[v] = vval;
    }
    __syncwarp();

    // scores: lane = key
    const int key = c0 + lane;
    float s[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) s[r] = 0.f;
    const uint4* krow = reinterpret_cast<const uint4*>(ks + lane * L::kKStride);
#pragma unroll 4
    for (int v = 0; v < kVPR; ++v) {
      float kf[kPerVec];
      unpack(krow[v], kf);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + r * DH + v * kPerVec);
        s[r] = fmaf(qq.x, kf[0], s[r]);
        s[r] = fmaf(qq.y, kf[1], s[r]);
        s[r] = fmaf(qq.z, kf[2], s[r]);
        s[r] = fmaf(qq.w, kf[3], s[r]);
      }
    }

    // masked online softmax, per row, over this warp's 32 keys
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int p = rpos[r];
      const bool ok = key < k_end && key <= p && (window <= 0 || key > p - window);
      const float sc = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(sc));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float pr = ok ? expf(sc - m_safe) : 0.f;
      const float alpha = m_r[r] == -INFINITY ? 0.f : expf(m_r[r] - m_safe);
      l_r[r] = alpha * l_r[r] + warp_sum(pr);
      m_r[r] = m_new;
      pw[r * 32 + lane] = pr;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // P·V: lane = kDPL consecutive output dims
#pragma unroll 4
    for (int c = 0; c < 32; ++c) {
      float vf[kDPL];
      load_f<kDPL>(vs + c * DH + lane * kDPL, vf);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float pr = pw[r * 32 + c];
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(pr, vf[i], acc[r][i]);
      }
    }
    __syncwarp();
  }

  // merge the warps' softmax states (the K/V slices are free now)
  __syncthreads();
  float* mg_acc = reinterpret_cast<float*>(smem + L::kv_off);  // [W][RM][DH]
  float* mg_m = mg_acc + kWarps * RM * DH;                     // [W][RM]
  float* mg_l = mg_m + kWarps * RM;                            // [W][RM]
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int i = 0; i < kDPL; ++i)
      mg_acc[(warp * RM + r) * DH + lane * kDPL + i] = acc[r][i];
    if (lane == 0) {
      mg_m[warp * RM + r] = m_r[r];
      mg_l[warp * RM + r] = l_r[r];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RM * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = rg * RM + r;
    if (row >= M || (PAD && d >= dh)) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg_m[w * RM + r]);
    const float ms = mx == -INFINITY ? 0.f : mx;
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mg_m[w * RM + r];
      const float f = mw == -INFINITY ? 0.f : expf(mw - ms);
      l += f * mg_l[w * RM + r];
      a += f * mg_acc[(w * RM + r) * DH + d];
    }
    const int tok = first + row / g, head = kh * g + row % g;
    out[((int64_t)tok * H + head) * dh + d] = l == 0.f ? 0.f : a / l;
  }
}

template <int DH, int RM, bool PAD>
cudaError_t launch_fp32(const void* q, const void* kc, const void* vc,
                        const int* tables, const int* pos, void* out, int T_,
                        int H, int Hkv, int dh, int bs, int maxb, int atom,
                        int window, float scale, cudaStream_t stream) {
  using L = Layout<DH, RM>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<DH, RM, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int M = atom * (H / Hkv);
  dim3 grid(T_ / atom, Hkv, (M + RM - 1) / RM);
  paged_attention_kernel<DH, RM, PAD><<<grid, kThreads, L::total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), tables, pos, static_cast<float*>(out),
      H, Hkv, dh, bs, maxb, atom, window, scale);
  return cudaGetLastError();
}

template <int DH, bool PAD>
cudaError_t dispatch_fp32(const void* q, const void* kc, const void* vc,
                          const int* tables, const int* pos, void* out,
                          int T_, int H, int Hkv, int dh, int bs, int maxb,
                          int atom, int window, float scale,
                          cudaStream_t stream) {
  const int M = atom * (H / Hkv);
  if (M == 1)
    return launch_fp32<DH, 1, PAD>(q, kc, vc, tables, pos, out, T_, H, Hkv,
                                   dh, bs, maxb, atom, window, scale, stream);
  if (M <= 4)
    return launch_fp32<DH, 4, PAD>(q, kc, vc, tables, pos, out, T_, H, Hkv,
                                   dh, bs, maxb, atom, window, scale, stream);
  return launch_fp32<DH, 16, PAD>(q, kc, vc, tables, pos, out, T_, H, Hkv,
                                  dh, bs, maxb, atom, window, scale, stream);
}

// ============================ tensor-core route (bf16 and fp16, split-KV)

constexpr int kKT = 64;  // keys a staged tile

template <int RT>
struct MmaShape {
  static constexpr int kWarps = RT > 4 ? RT : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kSlices = kWarps / RT;   // warps sharing a row tile
  static constexpr int kKeys = kKT / kSlices;   // keys a warp takes a tile
  static constexpr int kRows = 16 * RT;         // rows a block
};

// Blocks an SM must hold (launch bounds): at Dh = 128 three would cap a
// thread at 170 registers, and 1-2 row tiles then spill; 256 threads of
// 8 row tiles take ~250 registers each.
constexpr int min_blocks(int DH, int RT) {
  return RT == 8 ? 1 : DH == 128 ? 2 : 3;
}

// Dynamic shared memory, in bytes: Q | the K, V ring (two slots; at the
// end the warps' states) | three 64-key row tables | q row indices |
// positions and the tile's lowest and highest.
template <int DH, int RT>
struct MmaSmem {
  using Sh = MmaShape<RT>;
  static constexpr int S = DH + 8;  // row stride, elements (16 B padding)
  static constexpr int DS = DH + 2;  // a dumped state: acc, m, l (fp32)
  static constexpr int q_off = 0;
  static constexpr int kv_off = q_off + Sh::kRows * S * 2;
  static constexpr int kv_bytes = 2 * 2 * kKT * S * 2;
  static constexpr int dump_bytes = Sh::kWarps * 16 * DS * 4;
  static constexpr int rows_off = kv_off + cmax(kv_bytes, dump_bytes);
  static constexpr int qrow_off = rows_off + 3 * kKT * 4;
  static constexpr int pos_off = qrow_off + Sh::kRows * 4;
  static constexpr int total = pos_off + round16((Sh::kRows + 2) * 4);
};

struct MmaParams {
  const void *q, *kc, *vc;
  const int *tables, *pos;
  void* out;
  float* part;  // [splits][T][H][Dh + 2]: acc, m, l (splits > 1)
  int T, H, Hkv, dh, bs, maxb, atom, window, splits, span;  // dh: Dh
  float scale;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// Rows [0, R) of dst ([R][DP + 8]) = rows rows[r] (row stride rs elements)
// of src, or zeros where rows[r] < 0: 16-byte cp.async copies by NTHR
// threads (stage_rows_at of mma_common.cuh for a block of any size).
// PAD: a row holds dh <= DP columns, copied in `cb`-byte pieces (16 where
// dh % 8 == 0, else 8 or 4), zeros past dh.
template <typename T, int R, int DP, int NTHR, bool PAD>
__device__ __forceinline__ void gather_rows(T* dst, const T* __restrict__ src,
                                            const int* rows, int64_t rs,
                                            int dh, int cb) {
  constexpr int S = DP + 8, CH = DP / 8;
  static_assert(R * CH % NTHR == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < R * CH / NTHR; ++i) {
    const int idx = threadIdx.x + i * NTHR;
    const int r = idx / CH, c = (idx % CH) * 8, row = rows[r];
    if (!PAD) {
      cp_async16(dst + r * S + c, src + (row >= 0 ? row * rs + c : 0),
                 row >= 0);
      continue;
    }
    const T* s = src + (row >= 0 ? row * rs : 0);
    if (cb == 16) {
      cp_async16(dst + r * S + c, s + c, row >= 0 && c < dh);
    } else if (cb == 8) {
#pragma unroll
      for (int e = c; e < c + 8; e += 4)
        cp_async8(dst + r * S + e, s + e, row >= 0 && e < dh);
    } else {
#pragma unroll
      for (int e = c; e < c + 8; e += 2)
        cp_async4(dst + r * S + e, s + e, row >= 0 && e < dh);
    }
  }
}

// The cache rows of keys k0 .. k0 + 63 through the table `trow` (-1 at and
// past k_stop)
__device__ __forceinline__ void tile_rows(const int* __restrict__ trow,
                                          int bs, int k0, int k_stop,
                                          int* rows) {
  if (threadIdx.x < kKT) {
    const int key = k0 + threadIdx.x;
    rows[threadIdx.x] =
        key < k_stop ? __ldg(trow + key / bs) * bs + key % bs : -1;
  }
}

template <typename T, int DH, int RT, bool PAD>
__global__ void __launch_bounds__(MmaShape<RT>::kThreads,
                                  min_blocks(DH, RT))
paged_attention_mma_kernel(MmaParams a) {
  using Sh = MmaShape<RT>;
  using L = MmaSmem<DH, RT>;
  constexpr int S = L::S, DS = L::DS, KD = DH / 16, NT = DH / 8;
  constexpr int NJ = Sh::kKeys / 8, NTHR = Sh::kThreads, ROWS = Sh::kRows;
  constexpr float kP = Tc<T>::kPScale;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::kv_off);  // [2][kKT][S]
  T* vs = ks + 2 * kKT * S;                         // [2][kKT][S]
  int* rows = reinterpret_cast<int*>(smem + L::rows_off);  // [3][kKT]
  int* qrow = reinterpret_cast<int*>(smem + L::qrow_off);  // [ROWS]
  int* rpos = reinterpret_cast<int*>(smem + L::pos_off);   // [ROWS] lo hi

  const int tile = blockIdx.x, kh = blockIdx.y;
  const int split = blockIdx.z % a.splits, rg = blockIdx.z / a.splits;
  const int g = a.H / a.Hkv, first = tile * a.atom;
  const int row0 = rg * ROWS;                       // the block's first row
  const int nrows = min(ROWS, a.atom * g - row0);   // its live rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int rt = warp / Sh::kSlices;                // the warp's row tile
  const int c0 = (warp % Sh::kSlices) * Sh::kKeys;  // its keys in a tile
  const int dh = PAD ? a.dh : DH;                   // the head's columns
  const int cb = dh % 8 == 0 ? 16 : dh % 4 == 0 ? 8 : 4;  // copy bytes

  for (int r = threadIdx.x; r < ROWS; r += NTHR) {
    const int row = row0 + r, tok = first + row / g;
    qrow[r] = r < nrows ? tok * a.H + kh * g + row % g : -1;
    rpos[r] = r < nrows ? a.pos[tok] : -1;  // -1: sees no key
  }
  if (threadIdx.x == 0) {  // the tile's position range bounds its live keys
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = 0; i < a.atom; ++i) {
      const int p = a.pos[first + i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    rpos[ROWS] = lo;
    rpos[ROWS + 1] = hi;
  }
  __syncthreads();

  // this split's live keys [k_start, k_stop): its span of pages, cut to the
  // window's first key and the tile's last position
  const int lo = rpos[ROWS], hi = rpos[ROWS + 1];
  const int key_lo = a.window > 0 ? max(0, lo - a.window + 1) : 0;
  const int page_lo = max(key_lo / a.bs, split * a.span);
  const int page_hi =
      min(min(hi / a.bs, a.maxb - 1), (split + 1) * a.span - 1);
  const int k_start = max(page_lo * a.bs, key_lo);
  const int k_stop = min((page_hi + 1) * a.bs, hi + 1);
  const int n = k_stop > k_start ? (k_stop - k_start + kKT - 1) / kKT : 0;

  if (n == 0) {  // no key here: an empty state, or 0 where nothing merges
    for (int idx = threadIdx.x; idx < nrows * dh; idx += NTHR) {
      const int r = idx / dh, d = idx % dh, qr = qrow[r];
      if (a.splits == 1) {
        static_cast<T*>(a.out)[(int64_t)qr * dh + d] = Cvt<T>::from_f(0.f);
      } else if (d < 2) {
        const int tok = qr / a.H, head = qr % a.H;
        a.part[((int64_t)(split * a.T + tok) * a.H + head) * (dh + 2) + dh +
               d] = d == 0 ? -INFINITY : 0.f;
      }
    }
    return;
  }

  const T* kb = static_cast<const T*>(a.kc) + kh * dh;
  const T* vb = static_cast<const T*>(a.vc) + kh * dh;
  const int64_t rs = (int64_t)a.Hkv * dh;  // between cache rows
  const int* trow = a.tables + (int64_t)first * a.maxb;  // first row's table

  tile_rows(trow, a.bs, k_start, k_stop, rows);
  __syncthreads();
  gather_rows<T, ROWS, DH, NTHR, PAD>(qs, static_cast<const T*>(a.q), qrow,
                                      dh, dh, cb);
  gather_rows<T, kKT, DH, NTHR, PAD>(ks, kb, rows, rs, dh, cb);
  gather_rows<T, kKT, DH, NTHR, PAD>(vs, vb, rows, rs, dh, cb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q and tile 0 landed
  if (n > 1) tile_rows(trow, a.bs, k_start + kKT, k_stop, rows + kKT);
  const bool live = rt * 16 < nrows;  // a warp of zero rows only stages
  uint32_t qa[KD][4];
  if (live) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      load_a<S>(qa[kd], qs, rt * 16, kd * 16, lane);
  }
  const int p0 = rpos[rt * 16 + gq], p1 = rpos[rt * 16 + gq + 8];

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const T* kt = ks + (it & 1) * kKT * S;
    const T* vt = vs + (it & 1) * kKT * S;
    cp_async_wait<0>();  // tile it has landed (this thread's copies)
    // every thread's copies have landed, every warp is done with tile
    // it - 1 (whose slot the next copies refill), and tile it + 1's row
    // table is written
    __syncthreads();
    if (it + 1 < n) {
      const int* nr = rows + ((it + 1) % 3) * kKT;
      gather_rows<T, kKT, DH, NTHR, PAD>(ks + ((it + 1) & 1) * kKT * S, kb,
                                         nr, rs, dh, cb);
      gather_rows<T, kKT, DH, NTHR, PAD>(vs + ((it + 1) & 1) * kKT * S, vb,
                                         nr, rs, dh, cb);
    }
    cp_async_commit();
    if (it + 2 < n)
      tile_rows(trow, a.bs, k_start + (it + 2) * kKT, k_stop,
                rows + ((it + 2) % 3) * kKT);
    if (!live) continue;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int nj = 0; nj < NJ / 2; ++nj) {
        uint32_t bf[4];
        load_b<S>(bf, kt, c0 + nj * 16, kd * 16, lane);
        Tc<T>::mma(s[2 * nj], qa[kd], bf);
        Tc<T>::mma(s[2 * nj + 1], qa[kd], bf + 2);
      }
    const int k0 = k_start + it * kKT + c0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t4 + c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = i ? p1 : p0;
          const bool ok = key < k_stop && key <= p &&
                          (a.window <= 0 || key > p - a.window);
          float& x = s[j][2 * i + c];
          x = ok ? x * a.scale : -INFINITY;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    float alpha[2], msafe[2], rsum[2] = {0.f, 0.f};
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
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked: 2^-inf = 0
        s[j][e] = ex2((s[j][e] - msafe[e / 2]) * kLog2e);
        rsum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = alpha[i] * l[i] + rsum[i];
    }
    scale_rows<NT>(acc, alpha);
    // o += P V, P = hi + lo (of P * kP): the score fragments of keys
    // c0 + 16kk.. are the A fragment of that depth step
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
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
        load_bt<S>(bf, vt, c0 + kk * 16, nd * 16, lane);
        Tc<T>::mma(acc[2 * nd], pl, bf);
        Tc<T>::mma(acc[2 * nd], ph, bf);
        Tc<T>::mma(acc[2 * nd + 1], pl, bf + 2);
        Tc<T>::mma(acc[2 * nd + 1], ph, bf + 2);
      }
    }
  }

  // the warps' states → shared memory (the ring is free once every warp is
  // past its last tile), acc unscaled by kP (a power of two: exact)
  __syncthreads();
  float* dump = reinterpret_cast<float*>(smem + L::kv_off);  // [W][16][DS]
  float* mine = dump + warp * 16 * DS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* drow = mine + (gq + 8 * i) * DS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      drow[8 * nt + 2 * t4] = acc[nt][2 * i] * (1.f / kP);
      drow[8 * nt + 2 * t4 + 1] = acc[nt][2 * i + 1] * (1.f / kP);
    }
    if (t4 == 0) {
      drow[DH] = m[i];
      drow[DH + 1] = l[i];
    }
  }
  __syncthreads();
  // each row: its row tile's warps merged in warp order; then the output
  // (one split) or this split's state
  for (int idx = threadIdx.x; idx < nrows * dh; idx += NTHR) {
    const int r = idx / dh, d = idx % dh;
    const float* w0 = dump + ((r / 16) * Sh::kSlices * 16 + r % 16) * DS;
    float mxr = -INFINITY;
#pragma unroll
    for (int w = 0; w < Sh::kSlices; ++w) mxr = fmaxf(mxr, w0[w * 16 * DS + DH]);
    float lr = 0.f, ar = 0.f;
#pragma unroll
    for (int w = 0; w < Sh::kSlices; ++w) {
      const float* st = w0 + w * 16 * DS;
      const float f = st[DH] == -INFINITY ? 0.f : ex2((st[DH] - mxr) * kLog2e);
      lr += f * st[DH + 1];
      ar += f * st[d];
    }
    const int qr = qrow[r];
    if (a.splits == 1) {
      static_cast<T*>(a.out)[(int64_t)qr * dh + d] =
          Cvt<T>::from_f(lr == 0.f ? 0.f : ar / lr);
    } else {
      const int tok = qr / a.H, head = qr % a.H;
      float* pr =
          a.part + ((int64_t)(split * a.T + tok) * a.H + head) * (dh + 2);
      pr[d] = ar;
      if (d == 0) {
        pr[dh] = mxr;
        pr[dh + 1] = lr;
      }
    }
  }
}

// out[tok, head] = the merge of the row's `splits` states in split order;
// empty states (m = -inf) are skipped, a row with none writes 0.  One block
// per (token, head), one thread per output dim.
template <typename T>
__global__ void __launch_bounds__(128)
paged_attention_merge_kernel(const float* __restrict__ part,
                             T* __restrict__ out, int T_, int H, int DH,
                             int splits) {
  const int tok = blockIdx.x, head = blockIdx.y, d = threadIdx.x;
  const int64_t row = (int64_t)tok * H + head;
  const int64_t stride = (int64_t)T_ * H * (DH + 2);  // between splits
  const float* p = part + row * (DH + 2);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[s * stride + DH]);
  float l = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ms = p[s * stride + DH];
      if (ms == -INFINITY) continue;
      const float f = ex2((ms - mx) * kLog2e);
      l += f * p[s * stride + DH + 1];
      acc += f * p[s * stride + d];
    }
  }
  out[row * DH + d] = Cvt<T>::from_f(l == 0.f ? 0.f : acc / l);
}

template <typename T, int DH, int RT, bool PAD>
cudaError_t configure_mma() {
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_mma_kernel<T, DH, RT, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MmaSmem<DH, RT>::total);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

template <typename T, int DH, int RT, bool PAD>
cudaError_t launch_mma(const MmaParams& a, cudaStream_t st) {
  using Sh = MmaShape<RT>;
  cudaError_t e = configure_mma<T, DH, RT, PAD>();
  if (e != cudaSuccess) return e;
  const int groups = (a.atom * (a.H / a.Hkv) + Sh::kRows - 1) / Sh::kRows;
  if ((int64_t)groups * a.splits > 65535) return cudaErrorInvalidValue;
  paged_attention_mma_kernel<T, DH, RT, PAD>
      <<<dim3(a.T / a.atom, a.Hkv, groups * a.splits), Sh::kThreads,
         MmaSmem<DH, RT>::total, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  paged_attention_merge_kernel<T><<<dim3(a.T, a.H), a.dh, 0, st>>>(
      a.part, static_cast<T*>(a.out), a.T, a.H, a.dh, a.splits);
  return cudaGetLastError();
}

template <typename T, int DH, bool PAD>
cudaError_t dispatch_mma(const MmaParams& a, int row_tiles, cudaStream_t st) {
  switch (row_tiles) {
    case 1: return launch_mma<T, DH, 1, PAD>(a, st);
    case 2: return launch_mma<T, DH, 2, PAD>(a, st);
    case 4: return launch_mma<T, DH, 4, PAD>(a, st);
    case 8: return launch_mma<T, DH, 8, PAD>(a, st);
  }
  return cudaErrorInvalidValue;
}

// The head widths of Dh: its tile (64 or 128) pads it, or it fills it.
template <typename T>
cudaError_t dispatch_mma_dh(const MmaParams& a, int row_tiles,
                            cudaStream_t st) {
  if (a.dh == 128) return dispatch_mma<T, 128, false>(a, row_tiles, st);
  if (a.dh == 64) return dispatch_mma<T, 64, false>(a, row_tiles, st);
  if (a.dh > 64) return dispatch_mma<T, 128, true>(a, row_tiles, st);
  return dispatch_mma<T, 64, true>(a, row_tiles, st);
}

// A head width the kernels take: even, 2 to 128.
bool takes_dh(int Dh) { return Dh >= 2 && Dh <= 128 && Dh % 2 == 0; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int DH, int RT, bool PAD>
int blocks_per_sm() {
  int n = -1;
  if (configure_mma<T, DH, RT, PAD>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, paged_attention_mma_kernel<T, DH, RT, PAD>,
          MmaShape<RT>::kThreads, MmaSmem<DH, RT>::total) != cudaSuccess)
    return -1;
  return n;
}

template <typename T, int DH, bool PAD>
int mma_blocks_per_sm(int row_tiles) {
  switch (row_tiles) {
    case 1: return blocks_per_sm<T, DH, 1, PAD>();
    case 2: return blocks_per_sm<T, DH, 2, PAD>();
    case 4: return blocks_per_sm<T, DH, 4, PAD>();
    case 8: return blocks_per_sm<T, DH, 8, PAD>();
  }
  return -1;
}

template <typename T>
int mma_blocks_per_sm_dh(int Dh, int row_tiles) {
  if (!takes_dh(Dh)) return -1;
  if (Dh == 128) return mma_blocks_per_sm<T, 128, false>(row_tiles);
  if (Dh == 64) return mma_blocks_per_sm<T, 64, false>(row_tiles);
  if (Dh > 64) return mma_blocks_per_sm<T, 128, true>(row_tiles);
  return mma_blocks_per_sm<T, 64, true>(row_tiles);
}

template <int DH>
int mma_smem(int row_tiles) {
  return row_tiles == 1 ? MmaSmem<DH, 1>::total
       : row_tiles == 2 ? MmaSmem<DH, 2>::total
       : row_tiles == 4 ? MmaSmem<DH, 4>::total
       : row_tiles == 8 ? MmaSmem<DH, 8>::total : -1;
}

}  // namespace

// q [T, H, Dh]; k_cache, v_cache [num_blocks, bs, Hkv, Dh]; tables [T, maxb]
// int32; positions [T] int32; out [T, H, Dh].  All contiguous, on the card,
// q and the caches 16-byte aligned; Dh even, at most 128.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.  route: 0 fp32 (dtype 0), 1 decode_split (dtype 1 or 2,
// atom 1), 2 atom_mma (dtype 1 or 2, atom > 1).  The tensor-core routes
// take `splits` spans of `span` pages that cover the table's maxb pages
// (splits > 1: `part`, fp32 [splits, T, H, Dh + 2] scratch, and a merge
// kernel) and `row_tiles` (1, 2, 4 or 8) tiles of 16 rows a block.
// Returns a cudaError_t (0 = launched).
extern "C" int ds_paged_attention(const void* q, const void* k_cache,
                                  const void* v_cache, const void* tables,
                                  const void* positions, void* out,
                                  void* part, int T_, int H, int Hkv, int Dh,
                                  int bs, int maxb, int atom, int window,
                                  float scale, int dtype, int route,
                                  int splits, int span, int row_tiles,
                                  void* stream) {
  if (T_ <= 0 || atom <= 0 || T_ % atom || Hkv <= 0 || H % Hkv || bs <= 0 ||
      maxb <= 0 || Hkv > 65535 || !takes_dh(Dh))
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteFp32) {
    if (dtype != 0 || splits != 1) return (int)cudaErrorInvalidValue;
    if (Dh == 128 || Dh == 64)
      return (int)(Dh == 128 ? dispatch_fp32<128, false>
                             : dispatch_fp32<64, false>)(
          q, k_cache, v_cache, tb, ps, out, T_, H, Hkv, Dh, bs, maxb, atom,
          window, scale, st);
    return (int)(Dh > 64 ? dispatch_fp32<128, true> : dispatch_fp32<64, true>)(
        q, k_cache, v_cache, tb, ps, out, T_, H, Hkv, Dh, bs, maxb, atom,
        window, scale, st);
  }
  const bool takes = (route == kRouteDecodeSplit && atom == 1) ||
                     (route == kRouteAtomMma && atom > 1);
  if (!takes || (dtype != 1 && dtype != 2) || splits < 1 || span < 1 ||
      (int64_t)(splits - 1) * span >= maxb ||
      (int64_t)splits * span < maxb || (splits > 1 && !part) ||
      H > 65535 || !aligned16(q) || !aligned16(k_cache) ||
      !aligned16(v_cache))
    return (int)cudaErrorInvalidValue;
  MmaParams a{};
  a.q = q; a.kc = k_cache; a.vc = v_cache; a.tables = tb; a.pos = ps;
  a.out = out; a.part = static_cast<float*>(part);
  a.T = T_; a.H = H; a.Hkv = Hkv; a.dh = Dh; a.bs = bs; a.maxb = maxb;
  a.atom = atom;
  a.window = window; a.splits = splits; a.span = span; a.scale = scale;
  if (dtype == 1)
    return (int)dispatch_mma_dh<__nv_bfloat16>(a, row_tiles, st);
  return (int)dispatch_mma_dh<__half>(a, row_tiles, st);
}

// Dynamic shared memory of one block: the fp32 route's variant of `rows`
// query rows a block (1, 4 or 16), or a tensor-core route's of `rows` =
// row_tiles (1, 2, 4 or 8), for a head of Dh columns (its tile's); -1 for
// a variant that does not exist.  ptxas -v does not see dynamic shared
// memory, so the build report asks here.
extern "C" int ds_paged_attention_smem_bytes(int route, int Dh, int rows) {
  if (!takes_dh(Dh)) return -1;
  Dh = Dh > 64 ? 128 : 64;
  if (route == kRouteFp32) {
    if (Dh == 128)
      return rows == 1 ? Layout<128, 1>::total
           : rows == 4 ? Layout<128, 4>::total
           : rows == 16 ? Layout<128, 16>::total : -1;
    return rows == 1 ? Layout<64, 1>::total
         : rows == 4 ? Layout<64, 4>::total
         : rows == 16 ? Layout<64, 16>::total : -1;
  }
  return Dh == 128 ? mma_smem<128>(rows) : mma_smem<64>(rows);
}

// Blocks of the tensor-core kernel for (dtype 1 or 2, Dh, row_tiles) that
// one SM holds at once (the runtime's occupancy count); -1 on error.
extern "C" int ds_paged_attention_blocks_per_sm(int dtype, int Dh,
                                                int row_tiles) {
  if (dtype == 1) return mma_blocks_per_sm_dh<__nv_bfloat16>(Dh, row_tiles);
  if (dtype == 2) return mma_blocks_per_sm_dh<__half>(Dh, row_tiles);
  return -1;
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
