// Hopper (sm_90a) building blocks beyond mma.sync: TMA tile loads with
// mbarrier completion, warpgroup matrix multiply (wgmma) from shared
// memory, register rebalancing between warpgroups, and the host-side
// encoder of a TMA tensor map.  First used by csrc/grouped_matmul.cu (B7).
//
// - make_tensor_map_2d / _3d (host): a 2-D or 3-D row-major tensor map
//   with the 128-byte swizzle, encoded by the driver's
//   cuTensorMapEncodeTiled, which cudaGetDriverEntryPoint hands over: no
//   -lcuda at link time;
// - mbarriers: init, arrive, arrive with an expected transaction count,
//   and a parity wait that traps (rather than hangs the card) if a phase
//   never completes;
// - tma_load_2d: one box global -> shared, completing on an mbarrier;
//   elements past the tensor's edge arrive as zeros; tma_store_3d: one box
//   shared -> global in a bulk group (elements past the edge are not
//   written), with the group's commit and waits;
// - thread block clusters: a block's rank, the cluster-wide barrier, a
//   TMA load multicast into several blocks' shared memory, and an mbarrier
//   arrival on another block's barrier;
// - wgmma: the shared-memory descriptor of a 128-byte-swizzled tile, the
//   fence / commit / wait instructions, and m64n128k16 / m64n256k16 with
//   fp32 accumulation for bf16 and fp16 (A and B each K- or MN-major);
// - the proxy fence that orders threads' own shared-memory stores before
//   wgmma's reads of them, and a named barrier over some warps;
// - setmaxnreg in both directions.
// Device code is inline in an anonymous namespace, as in mma_common.cuh.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ host
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The driver's encoder on a tensor map of 16-bit elements, boxes `box`
// (innermost first), the 128-byte swizzle.  TMA asks for a 16-byte-aligned
// base and strides of whole 16 bytes.
inline bool encode_swizzled(CUtensorMap* map, const void* base,
                            CUtensorMapDataType type, cuuint32_t rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  for (cuuint32_t i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return false;
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of a row-major [rows, cols] matrix of 16-bit elements at
// `base` (row pitch `pitch` elements), read in boxes of [box_rows,
// box_cols] with the 128-byte swizzle (box_cols * 2 <= 128).
inline bool make_tensor_map_2d(CUtensorMap* map, const void* base,
                               CUtensorMapDataType type, uint64_t rows,
                               uint64_t cols, uint64_t pitch,
                               uint32_t box_rows, uint32_t box_cols) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return encode_swizzled(map, base, type, 2, dims, strides, box);
}

// A tensor map of a contiguous [d2, d1, d0] array of 16-bit elements (d0
// innermost, a multiple of 8), read or written in boxes of [1, box1,
// box0] with the 128-byte swizzle (box0 * 2 <= 128).
inline bool make_tensor_map_3d(CUtensorMap* map, const void* base,
                               CUtensorMapDataType type, uint64_t d2,
                               uint64_t d1, uint64_t d0, uint32_t box1,
                               uint32_t box0) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d1 * d0 * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  return encode_swizzled(map, base, type, 3, dims, strides, box);
}

template <typename T>
struct TmaType;
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<__half> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t sm90_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   sm90_smem(bar)),
               "r"(count)
               : "memory");
}

// make initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   sm90_smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(sm90_smem(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that outlives 2^28 polls (seconds) traps: the launch then fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = sm90_smem(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// Box (c0 inner, c1 outer) of a 2-D tensor map → shared memory at dst
// (1024-byte aligned for the 128-byte swizzle); completes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm90_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same box into the shared memory of every block of the cluster in
// `mask` (at dst's offset in each), completing on each one's barrier at
// bar's offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          sm90_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every non-exited thread of the cluster arrives and waits (release /
// acquire at cluster scope).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on the barrier at bar's offset in block `cta` of the cluster
// (this block's own rank included), with the default release at CTA
// scope: a consumer hands back a stage whose reads have completed (a
// release at cluster scope made each arrival wait, and dw twice as slow).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(sm90_smem(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// Box (c0 inner, c1, c2 outer) of a 3-D tensor map <- shared memory at src
// (1024-byte aligned, 128-byte swizzled), in this thread's bulk group;
// elements past the tensor's edge are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90_smem(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared
// memory (_read) or are still in flight at all
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets (PTX ISA, "matrix
// descriptor"; all in 16-byte units).  K-major: rows of 128 bytes, 8-row
// groups `sbo` apart (lbo unused).  MN-major: 64-element columns chunks
// `lbo` apart, 8-deep k groups `sbo` apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, int lbo,
                                               int sbo) {
  uint64_t d = (sm90_smem(smem) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

// Order this thread's generic-proxy stores to shared memory before later
// async-proxy accesses (wgmma's operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on barrier `id` (1-15; 0 is __syncthreads) of `threads`
// threads, a multiple of 32
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it does not know the instruction reads them later).
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

#define SM90_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D64(i)                                                     \
  SM90_D8(i), SM90_D8(i + 8), SM90_D8(i + 16), SM90_D8(i + 24),         \
      SM90_D8(i + 32), SM90_D8(i + 40), SM90_D8(i + 48), SM90_D8(i + 56)
#define SM90_R16(i)                                                     \
  " %" #i "0, %" #i "1, %" #i "2, %" #i "3, %" #i "4, %" #i "5, %" #i   \
  "6, %" #i "7, %" #i "8, %" #i "9,"
// "{%0, ..., %63}" and "{%0, ..., %127}" as PTX operand lists
#define SM90_REGS64                                                     \
  "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9," SM90_R16(1) SM90_R16(2)    \
      SM90_R16(3) SM90_R16(4) SM90_R16(5)                               \
  " %60, %61, %62, %63}"
#define SM90_REGS128                                                    \
  "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9," SM90_R16(1) SM90_R16(2)    \
      SM90_R16(3) SM90_R16(4) SM90_R16(5) SM90_R16(6) SM90_R16(7)        \
          SM90_R16(8) SM90_R16(9) SM90_R16(10) SM90_R16(11)              \
  " %120, %121, %122, %123, %124, %125, %126, %127}"
// the operands after the accumulators: A's and B's descriptors, the
// accumulate flag, A's and B's transpose flags
#define SM90_WGMMA(N, TYPE, REGS, DA, DB, ACC, TA, TB)                  \
  "{\n .reg .pred p;\n setp.ne.b32 p, " ACC ", 0;\n"                    \
  " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TYPE "." TYPE " "  \
  REGS ", " DA ", " DB ", p, 1, 1, " TA ", " TB ";\n}\n"

// d[N / 2] (+)= A[64 x 16] B[16 x N], fp32 accumulate, N = 128 or 256:
// the accumulator fragment of an m64nNk16 product (warp w of the
// warpgroup holds rows 16w.., as an m16n8 C fragment for each 8 columns:
// d[4j + 2i + c] is row 16w + lane / 4 + 8i, column 8j + 2 (lane % 4) +
// c).  accumulate 0 overwrites d; kTransB 1: B MN-major; kTransA 1: A
// MN-major (A's 64 rows contiguous, as B's columns are; 16-bit types
// only, which are all these take).
template <typename T, int N, int kTransB, int kTransA = 0>
struct Wgmma;

#define SM90_WGMMA_STRUCT(CT, TYPE)                                     \
  template <int kTransB, int kTransA>                                   \
  struct Wgmma<CT, 128, kTransB, kTransA> {                             \
    __device__ __forceinline__ static void run(float* d, uint64_t a,    \
                                               uint64_t b, int acc) {   \
      asm volatile(SM90_WGMMA(128, TYPE, SM90_REGS64, "%64", "%65",  \
                                           "%66", "%67", "%68")       \
                   : SM90_D64(0)                                        \
                   : "l"(a), "l"(b), "r"(acc), "n"(kTransA),            \
                     "n"(kTransB));                                     \
    }                                                                   \
  };                                                                    \
  template <int kTransB, int kTransA>                                   \
  struct Wgmma<CT, 256, kTransB, kTransA> {                             \
    __device__ __forceinline__ static void run(float* d, uint64_t a,    \
                                               uint64_t b, int acc) {   \
      asm volatile(SM90_WGMMA(256, TYPE, SM90_REGS128, "%128", "%129", \
                                           "%130", "%131", "%132")    \
                   : SM90_D64(0), SM90_D64(64)                          \
                   : "l"(a), "l"(b), "r"(acc), "n"(kTransA),            \
                     "n"(kTransB));                                     \
    }                                                                   \
  };

SM90_WGMMA_STRUCT(__nv_bfloat16, "bf16")
SM90_WGMMA_STRUCT(__half, "f16")

#undef SM90_WGMMA_STRUCT
#undef SM90_WGMMA
#undef SM90_REGS128
#undef SM90_REGS64
#undef SM90_R16
#undef SM90_D64
#undef SM90_D8

}  // namespace
