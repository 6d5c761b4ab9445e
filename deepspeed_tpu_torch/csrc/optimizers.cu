// Fused optimizer steps for Hopper (sm_90a), plain C interface: Adam(W)
// (kernel B2), Lion (B8) and the two phases of LAMB (B3).
//
// They replace the Pallas TPU kernels of deepspeed_tpu/ops/pallas/
// optimizers.py: `_adam_kernel` (:60, launched by `fused_adam_step` :79 at
// :100), `_lion_kernel` (:126, `fused_lion_step` :137 at :150) and
// `_lamb_phase1_kernel` (:173) / `_lamb_phase2_kernel` (:195), launched by
// `fused_lamb_step` (:202) at :224 and :250 with the trust ratio formed
// between them (:243-248).  Semantics and order of operations are theirs,
// every product and sum rounded to fp32 on its own (no contraction into
// FMAs), so the elementwise outputs equal the plain PyTorch versions bit for
// bit:
//
//   all:   g = grad * gscale   (gscale: clip coefficient / loss scale, or 1)
//   Adam:  g = g + wd * p                       (L2 mode only)
//          m = b1 * m + (1 - b1) * g
//          v = b2 * v + ((1 - b2) * g) * g
//          s = (m / c1) / (sqrt(v / c2) + eps)
//          s = s + wd * p                       (AdamW mode only)
//          p = p - lr * s
//   Lion:  p = p - lr * (sign(b1 * m + (1 - b1) * g) + wd * p)
//          m = b2 * m + (1 - b2) * g
//   LAMB phase 1:  m, v as Adam;  u = (m / c1) / (sqrt(v / c2) + eps) + wd * p
//          and, per leaf, sum(p * p) and sum(u * u) over the old p;
//   LAMB phase 2:  ratio = clip(|p| / |u|, min_coeff, max_coeff), 1 where
//          either norm is 0;  p = p - (lr * ratio) * u.
// Each writes the new master's low-precision copy (bf16 or fp16) in the
// same pass when asked.
//
// Design.  The engine lays every leaf's fp32 master, moments and gradient
// accumulator out in one flat buffer each (16-element aligned leaves, zero
// gaps between them), so Adam and Lion are one grid-stride launch over all
// leaves with no pointer table: 4-element vectors (16-byte fp32 loads), int64
// indices.  LAMB needs per-leaf norms, and 242 of GPT-2 350M's 388 leaves
// are 1024- or 4096-element biases and norm weights, so a block per leaf
// would leave most SMs idle behind the 51 M-element embedding.  Instead the
// wrapper cuts every leaf into chunks of at most kLambChunk elements and
// hands both phases a device table of (start, length, leaf) rows: one block
// per chunk, so the work is balanced whatever the leaf sizes.  Phase 1
// writes each chunk's fp32 partial sums of p*p and u*u (a fixed reduction
// tree inside the block, no atomics).  Phase 2's prologue reduces the
// partials of its chunk's leaf, again in a fixed order, so every block of a
// leaf forms the same ratio and two runs give the same bits; the block that
// owns a leaf's first chunk also writes (sum p*p, sum u*u, ratio) for the
// caller.  The ratio never goes through the host.  The gaps between leaves
// are in no chunk: they stay zero and add nothing to the norms.
//
// What bounds them on an H100: bytes.  Per element, with an fp32 gradient
// and a 2-byte copy: Adam reads g, p, m, v and writes p, m, v, copy (30 B);
// Lion reads g, p, m and writes p, m, copy (22 B); LAMB phase 1 reads g, p,
// m, v and writes m, v, u (28 B), phase 2 reads p, u and writes p, copy
// (14 B).  Each does tens of flops per element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------- load / store
__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f(__half x) { return __half2float(x); }

template <typename G>
__device__ inline float4 load4(const G* g, int64_t i4);

template <>
__device__ inline float4 load4<float>(const float* g, int64_t i4) {
  return reinterpret_cast<const float4*>(g)[i4];
}
template <>
__device__ inline float4 load4<__nv_bfloat16>(const __nv_bfloat16* g,
                                              int64_t i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[i4];
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <>
__device__ inline float4 load4<__half>(const __half* g, int64_t i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[i4];
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The low-precision copy: O is __nv_bfloat16 or __half (round to nearest).
__device__ inline void store1(__nv_bfloat16* o, int64_t i, float x) {
  o[i] = __float2bfloat16_rn(x);
}
__device__ inline void store1(__half* o, int64_t i, float x) {
  o[i] = __float2half_rn(x);
}
__device__ inline void store4(__nv_bfloat16* o, int64_t i4, float4 p) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(p.x, p.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(p.z, p.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(o)[i4] = raw;
}
__device__ inline void store4(__half* o, int64_t i4, float4 p) {
  __half2 lo = __floats2half2_rn(p.x, p.y);
  __half2 hi = __floats2half2_rn(p.z, p.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(o)[i4] = raw;
}

__device__ inline float comp(const float4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}
__device__ inline void set_comp(float4& a, int k, float x) {
  if (k == 0) a.x = x; else if (k == 1) a.y = x; else if (k == 2) a.z = x;
  else a.w = x;
}

int grid_for(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : want < 8LL * sms ? want : 8LL * sms);
}

// -------------------------------------------------------------------- Adam
struct AdamHyper {
  float lr, b1, b2, eps, wd, c1, c2;
};

template <bool kAdamW>
__device__ inline float adam1(float g, float& p, float& m, float& v,
                              const AdamHyper& h) {
  if (!kAdamW) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(__fsub_rn(1.f, h.b1), g));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.f, h.b2), g), g));
  float s = __fdiv_rn(__fdiv_rn(m, h.c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
  if (kAdamW) s = __fadd_rn(s, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, s));
  return p;
}

template <typename G, typename O, bool kAdamW>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const G* __restrict__ grad, float* __restrict__ p,
            float* __restrict__ m, float* __restrict__ v, O* __restrict__ out,
            const float* __restrict__ gscale, int64_t n, AdamHyper h) {
  const float gs = gscale ? *gscale : 1.f;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 g = load4<G>(grad, i);
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float pk = comp(pp, k), mk = comp(mm, k), vk = comp(vv, k);
      adam1<kAdamW>(__fmul_rn(comp(g, k), gs), pk, mk, vk, h);
      set_comp(pp, k, pk);
      set_comp(mm, k, mk);
      set_comp(vv, k, vk);
    }
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
    if (out) store4(out, i, pp);
  }
  // the last n % 4 elements
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n - 4 * n4) {
    const int64_t i = 4 * n4 + t;
    float pp = p[i], mm = m[i], vv = v[i];
    adam1<kAdamW>(__fmul_rn(to_f(grad[i]), gs), pp, mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (out) store1(out, i, pp);
  }
}

template <typename G, typename O>
cudaError_t launch_adam(const void* grad, void* p, void* m, void* v,
                        void* out, const void* gscale, int64_t n,
                        const AdamHyper& h, int adamw, cudaStream_t st) {
  const int blocks = grid_for(n);
  const G* g = static_cast<const G*>(grad);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  O* o = static_cast<O*>(out);
  const float* gs = static_cast<const float*>(gscale);
  if (adamw)
    adam_kernel<G, O, true><<<blocks, kThreads, 0, st>>>(g, pf, mf, vf, o, gs,
                                                         n, h);
  else
    adam_kernel<G, O, false><<<blocks, kThreads, 0, st>>>(g, pf, mf, vf, o,
                                                          gs, n, h);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- Lion
struct LionHyper {
  float lr, b1, b2, wd;
};

__device__ inline void lion1(float g, float& p, float& m, const LionHyper& h) {
  const float c = __fadd_rn(__fmul_rn(h.b1, m),
                            __fmul_rn(__fsub_rn(1.f, h.b1), g));
  const float sgn = c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f);
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(sgn, __fmul_rn(h.wd, p))));
  m = __fadd_rn(__fmul_rn(h.b2, m), __fmul_rn(__fsub_rn(1.f, h.b2), g));
}

template <typename G, typename O>
__global__ void __launch_bounds__(kThreads)
lion_kernel(const G* __restrict__ grad, float* __restrict__ p,
            float* __restrict__ m, O* __restrict__ out,
            const float* __restrict__ gscale, int64_t n, LionHyper h) {
  const float gs = gscale ? *gscale : 1.f;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 g = load4<G>(grad, i);
    float4 pp = p4[i], mm = m4[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float pk = comp(pp, k), mk = comp(mm, k);
      lion1(__fmul_rn(comp(g, k), gs), pk, mk, h);
      set_comp(pp, k, pk);
      set_comp(mm, k, mk);
    }
    p4[i] = pp;
    m4[i] = mm;
    if (out) store4(out, i, pp);
  }
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n - 4 * n4) {
    const int64_t i = 4 * n4 + t;
    float pp = p[i], mm = m[i];
    lion1(__fmul_rn(to_f(grad[i]), gs), pp, mm, h);
    p[i] = pp;
    m[i] = mm;
    if (out) store1(out, i, pp);
  }
}

template <typename G, typename O>
cudaError_t launch_lion(const void* grad, void* p, void* m, void* out,
                        const void* gscale, int64_t n, const LionHyper& h,
                        cudaStream_t st) {
  lion_kernel<G, O><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const G*>(grad), static_cast<float*>(p),
      static_cast<float*>(m), static_cast<O*>(out),
      static_cast<const float*>(gscale), n, h);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- LAMB
// One row of the chunk table: a leaf's elements [start, start + len) of the
// flat buffers (start a multiple of 4), and the leaf's index.
struct Chunk {
  int64_t start;
  int64_t len;
  int64_t leaf;
};

struct LambHyper {
  float b1, b2, eps, wd, c1, c2;
};

// Sum over the block in a fixed order: xor-shuffles within each warp, then
// thread 0 adds the 8 warp sums in warp order.  Every thread gets the sum.
__device__ inline float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                 // smem may hold an earlier sum
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = smem[0];
    for (int w = 1; w < kThreads / 32; ++w) s = __fadd_rn(s, smem[w]);
    smem[kThreads / 32] = s;
  }
  __syncthreads();
  return smem[kThreads / 32];
}

__device__ inline float lamb_u(float g, float p, float& m, float& v,
                               const LambHyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(__fsub_rn(1.f, h.b1), g));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.f, h.b2), g), g));
  const float s = __fdiv_rn(__fdiv_rn(m, h.c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
  return __fadd_rn(s, __fmul_rn(h.wd, p));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const G* __restrict__ grad, const float* __restrict__ p,
                   float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ u, const float* __restrict__ gscale,
                   const Chunk* __restrict__ chunks,
                   float* __restrict__ partials, LambHyper h) {
  __shared__ float smem[kThreads / 32 + 1];
  const Chunk c = chunks[blockIdx.x];
  const float gs = gscale ? *gscale : 1.f;
  float psq = 0.f, usq = 0.f;
  const int64_t n4 = c.len / 4, base4 = c.start / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4* u4 = reinterpret_cast<float4*>(u);
  for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
    const int64_t i = base4 + j;
    const float4 g = load4<G>(grad, i);
    const float4 pp = p4[i];
    float4 mm = m4[i], vv = v4[i], uu;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float mk = comp(mm, k), vk = comp(vv, k);
      const float pk = comp(pp, k);
      const float uk = lamb_u(__fmul_rn(comp(g, k), gs), pk, mk, vk, h);
      set_comp(mm, k, mk);
      set_comp(vv, k, vk);
      set_comp(uu, k, uk);
      psq = __fadd_rn(psq, __fmul_rn(pk, pk));
      usq = __fadd_rn(usq, __fmul_rn(uk, uk));
    }
    m4[i] = mm;
    v4[i] = vv;
    u4[i] = uu;
  }
  for (int64_t j = 4 * n4 + threadIdx.x; j < c.len; j += kThreads) {
    const int64_t i = c.start + j;
    float mk = m[i], vk = v[i];
    const float pk = p[i];
    const float uk = lamb_u(__fmul_rn(to_f(grad[i]), gs), pk, mk, vk, h);
    m[i] = mk;
    v[i] = vk;
    u[i] = uk;
    psq = __fadd_rn(psq, __fmul_rn(pk, pk));
    usq = __fadd_rn(usq, __fmul_rn(uk, uk));
  }
  psq = block_sum(psq, smem);
  usq = block_sum(usq, smem);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = psq;
    partials[2 * blockIdx.x + 1] = usq;
  }
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
lamb_phase2_kernel(float* __restrict__ p, const float* __restrict__ u,
                   O* __restrict__ out, const Chunk* __restrict__ chunks,
                   const int* __restrict__ leaf_chunks,
                   const float* __restrict__ partials,
                   float* __restrict__ leaf_stats, float lr, float max_coeff,
                   float min_coeff) {
  __shared__ float smem[kThreads / 32 + 1];
  const Chunk c = chunks[blockIdx.x];
  // the trust ratio of this chunk's leaf, from its chunks' partials, summed
  // in the same order by every block of the leaf
  const int first = leaf_chunks[c.leaf], last = leaf_chunks[c.leaf + 1];
  float psq = 0.f, usq = 0.f;
  for (int k = first + threadIdx.x; k < last; k += kThreads) {
    psq = __fadd_rn(psq, partials[2 * k]);
    usq = __fadd_rn(usq, partials[2 * k + 1]);
  }
  psq = block_sum(psq, smem);
  usq = block_sum(usq, smem);
  const float pn = __fsqrt_rn(psq), un = __fsqrt_rn(usq);
  float ratio = 1.f;
  if (pn > 0.f && un > 0.f)
    ratio = fminf(fmaxf(__fdiv_rn(pn, un), min_coeff), max_coeff);
  if (threadIdx.x == 0 && (int)blockIdx.x == first) {
    leaf_stats[3 * c.leaf] = psq;
    leaf_stats[3 * c.leaf + 1] = usq;
    leaf_stats[3 * c.leaf + 2] = ratio;
  }
  const float scaled = __fmul_rn(lr, ratio);
  const int64_t n4 = c.len / 4, base4 = c.start / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* u4 = reinterpret_cast<const float4*>(u);
  for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
    const int64_t i = base4 + j;
    float4 pp = p4[i];
    const float4 uu = u4[i];
    pp.x = __fsub_rn(pp.x, __fmul_rn(scaled, uu.x));
    pp.y = __fsub_rn(pp.y, __fmul_rn(scaled, uu.y));
    pp.z = __fsub_rn(pp.z, __fmul_rn(scaled, uu.z));
    pp.w = __fsub_rn(pp.w, __fmul_rn(scaled, uu.w));
    p4[i] = pp;
    if (out) store4(out, i, pp);
  }
  for (int64_t j = 4 * n4 + threadIdx.x; j < c.len; j += kThreads) {
    const int64_t i = c.start + j;
    const float pp = __fsub_rn(p[i], __fmul_rn(scaled, u[i]));
    p[i] = pp;
    if (out) store1(out, i, pp);
  }
}

}  // namespace

// Codes: grad_dtype 0 = float32, 1 = bfloat16, 2 = float16; out_dtype
// 1 = bfloat16, 2 = float16 (out NULL: no copy).  fp32 buffers are 16-byte
// aligned, 2-byte ones 8-byte aligned.  gscale: one fp32 on the card that
// multiplies the gradient, or NULL.  Each returns a cudaError_t (0 =
// launched).

#define DS_DISPATCH_G_O(G_CODE, O_CODE, CALL)                              \
  do {                                                                     \
    if ((G_CODE) == 0 && (O_CODE) != 2) { using G = float; using O = __nv_bfloat16; return (int)(CALL); } \
    if ((G_CODE) == 0) { using G = float; using O = __half; return (int)(CALL); } \
    if ((G_CODE) == 1 && (O_CODE) != 2) { using G = __nv_bfloat16; using O = __nv_bfloat16; return (int)(CALL); } \
    if ((G_CODE) == 1) { using G = __nv_bfloat16; using O = __half; return (int)(CALL); } \
    if ((G_CODE) == 2 && (O_CODE) != 2) { using G = __half; using O = __nv_bfloat16; return (int)(CALL); } \
    if ((G_CODE) == 2) { using G = __half; using O = __half; return (int)(CALL); } \
  } while (0)

static bool codes_ok(int grad_dtype, const void* out, int out_dtype) {
  if (grad_dtype < 0 || grad_dtype > 2) return false;
  return out == nullptr || out_dtype == 1 || out_dtype == 2;
}

// One Adam step over n elements, in place on master, exp_avg, exp_avg_sq
// (fp32); c1, c2 are the bias corrections 1 - b^count (1 when off).
extern "C" int ds_fused_adam(const void* grad, int grad_dtype, void* master,
                             void* exp_avg, void* exp_avg_sq, void* out,
                             int out_dtype, const void* gscale, long long n,
                             float lr, float beta1, float beta2, float eps,
                             float weight_decay, float c1, float c2,
                             int adam_w_mode, void* stream) {
  if (n <= 0 || !codes_ok(grad_dtype, out, out_dtype))
    return (int)cudaErrorInvalidValue;
  const AdamHyper h{lr, beta1, beta2, eps, weight_decay, c1, c2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DS_DISPATCH_G_O(grad_dtype, out_dtype,
                  (launch_adam<G, O>(grad, master, exp_avg, exp_avg_sq, out,
                                     gscale, n, h, adam_w_mode, st)));
  return (int)cudaErrorInvalidValue;
}

// One Lion step over n elements, in place on master and exp_avg (fp32).
extern "C" int ds_fused_lion(const void* grad, int grad_dtype, void* master,
                             void* exp_avg, void* out, int out_dtype,
                             const void* gscale, long long n, float lr,
                             float beta1, float beta2, float weight_decay,
                             void* stream) {
  if (n <= 0 || !codes_ok(grad_dtype, out, out_dtype))
    return (int)cudaErrorInvalidValue;
  const LionHyper h{lr, beta1, beta2, weight_decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DS_DISPATCH_G_O(grad_dtype, out_dtype,
                  (launch_lion<G, O>(grad, master, exp_avg, out, gscale, n, h,
                                     st)));
  return (int)cudaErrorInvalidValue;
}

// LAMB phase 1 over the n_chunks rows of `chunks` (int64 triples start,
// length, leaf; starts multiples of 4): m, v (fp32, in place) and u (fp32
// scratch) of every chunk's elements, and partials[2 c], partials[2 c + 1]
// = chunk c's fp32 sums of p*p and u*u (p: the master before the step).
extern "C" int ds_lamb_phase1(const void* grad, int grad_dtype,
                              const void* master, void* exp_avg,
                              void* exp_avg_sq, void* u, const void* gscale,
                              const void* chunks, int n_chunks,
                              void* partials, float beta1, float beta2,
                              float eps, float weight_decay, float c1,
                              float c2, void* stream) {
  if (n_chunks <= 0 || grad_dtype < 0 || grad_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const LambHyper h{beta1, beta2, eps, weight_decay, c1, c2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(master);
  float* m = static_cast<float*>(exp_avg);
  float* v = static_cast<float*>(exp_avg_sq);
  float* uf = static_cast<float*>(u);
  const float* gs = static_cast<const float*>(gscale);
  const Chunk* ch = static_cast<const Chunk*>(chunks);
  float* part = static_cast<float*>(partials);
  if (grad_dtype == 0)
    lamb_phase1_kernel<float><<<n_chunks, kThreads, 0, st>>>(
        static_cast<const float*>(grad), p, m, v, uf, gs, ch, part, h);
  else if (grad_dtype == 1)
    lamb_phase1_kernel<__nv_bfloat16><<<n_chunks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(grad), p, m, v, uf, gs, ch, part,
        h);
  else
    lamb_phase1_kernel<__half><<<n_chunks, kThreads, 0, st>>>(
        static_cast<const __half*>(grad), p, m, v, uf, gs, ch, part, h);
  return (int)cudaGetLastError();
}

// LAMB phase 2 over the same chunks: each leaf's trust ratio from the
// phase-1 partials of its chunks (leaf l owns chunks leaf_chunks[l] ..
// leaf_chunks[l + 1] - 1, int32), then master -= (lr * ratio) * u and the
// copy.  leaf_stats[3 l .. 3 l + 2] (fp32) gets leaf l's sum p*p, sum u*u
// and ratio.
extern "C" int ds_lamb_phase2(void* master, const void* u, void* out,
                              int out_dtype, const void* chunks,
                              int n_chunks, const void* leaf_chunks,
                              const void* partials, void* leaf_stats,
                              float lr, float max_coeff, float min_coeff,
                              void* stream) {
  if (n_chunks <= 0 || !codes_ok(0, out, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(master);
  const float* uf = static_cast<const float*>(u);
  const Chunk* ch = static_cast<const Chunk*>(chunks);
  const int* lc = static_cast<const int*>(leaf_chunks);
  const float* part = static_cast<const float*>(partials);
  float* stats = static_cast<float*>(leaf_stats);
  if (out_dtype == 2)
    lamb_phase2_kernel<__half><<<n_chunks, kThreads, 0, st>>>(
        p, uf, static_cast<__half*>(out), ch, lc, part, stats, lr, max_coeff,
        min_coeff);
  else
    lamb_phase2_kernel<__nv_bfloat16><<<n_chunks, kThreads, 0, st>>>(
        p, uf, static_cast<__nv_bfloat16*>(out), ch, lc, part, stats, lr,
        max_coeff, min_coeff);
  return (int)cudaGetLastError();
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
