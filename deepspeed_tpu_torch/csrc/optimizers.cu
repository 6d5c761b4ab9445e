// Multi-tensor Adam(W) step for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/optimizers.py
// `_adam_kernel` (:60, launched by `fused_adam_step` :79 at :100), which
// the JAX engine's `fusedadam` step computes leaf by leaf.  Semantics are
// `_adam_kernel`'s, in its order of operations, every product and sum
// rounded to fp32 on its own (no contraction into FMAs):
//
//   g  = grad * gscale            (gscale: the clip coefficient, or 1)
//   g  = g + wd * p               (L2 mode only)
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + ((1 - b2) * g) * g
//   s  = (m / c1) / (sqrt(v / c2) + eps)
//   s  = s + wd * p               (AdamW mode only)
//   p  = p - lr * s,  and its bf16 copy written in the same pass.
//
// Design.  The engine lays every leaf's fp32 master, m, v and gradient
// accumulator out in one flat buffer each (the module's parameters are
// views into one flat buffer of the compute type), so one launch covers
// all leaves with no pointer table: a grid-stride loop over 4-element
// vectors (16-byte fp32 loads and stores, 8-byte bf16), int64 indices (the
// 8-layer 7B-width model has 1.9 G elements).  The clip coefficient is read
// from device memory, so clipping costs no host synchronisation and no
// separate pass over the gradients.
//
// What bounds it on an H100: bytes.  Per element it reads the gradient and
// master/m/v and writes master/m/v and the bf16 copy: 30 bytes with an fp32
// gradient, for ~20 flops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, b2, eps, wd, c1, c2;
};

__device__ inline float load_g(const float* g, int64_t i) { return g[i]; }
__device__ inline float load_g(const __nv_bfloat16* g, int64_t i) {
  return __bfloat162float(g[i]);
}

__device__ inline float4 load_g4(const float* g, int64_t i4) {
  return reinterpret_cast<const float4*>(g)[i4];
}
__device__ inline float4 load_g4(const __nv_bfloat16* g, int64_t i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[i4];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <bool kAdamW>
__device__ inline float update(float g, float& p, float& m, float& v,
                               const Hyper& h) {
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

template <typename G, bool kAdamW>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const G* __restrict__ grad, float* __restrict__ p,
            float* __restrict__ m, float* __restrict__ v,
            __nv_bfloat16* __restrict__ out, const float* __restrict__ gscale,
            int64_t n, Hyper h) {
  const float gs = gscale ? *gscale : 1.f;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 g = load_g4(grad, i);
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    update<kAdamW>(__fmul_rn(g.x, gs), pp.x, mm.x, vv.x, h);
    update<kAdamW>(__fmul_rn(g.y, gs), pp.y, mm.y, vv.y, h);
    update<kAdamW>(__fmul_rn(g.z, gs), pp.z, mm.z, vv.z, h);
    update<kAdamW>(__fmul_rn(g.w, gs), pp.w, mm.w, vv.w, h);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
    if (out) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(pp.x, pp.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(pp.z, pp.w);
      uint2 raw;
      raw.x = *reinterpret_cast<const unsigned int*>(&lo);
      raw.y = *reinterpret_cast<const unsigned int*>(&hi);
      reinterpret_cast<uint2*>(out)[i] = raw;
    }
  }
  // the last n % 4 elements
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n - 4 * n4) {
    const int64_t i = 4 * n4 + t;
    float pp = p[i], mm = m[i], vv = v[i];
    update<kAdamW>(__fmul_rn(load_g(grad, i), gs), pp, mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (out) out[i] = __float2bfloat16_rn(pp);
  }
}

template <typename G>
cudaError_t launch(const void* grad, void* p, void* m, void* v, void* out,
                   const void* gscale, int64_t n, const Hyper& h, int adamw,
                   cudaStream_t st) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : want < 8LL * sms ? want : 8LL * sms);
  const G* g = static_cast<const G*>(grad);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const float* gs = static_cast<const float*>(gscale);
  if (adamw)
    adam_kernel<G, true><<<blocks, kThreads, 0, st>>>(g, pf, mf, vf, o, gs, n, h);
  else
    adam_kernel<G, false><<<blocks, kThreads, 0, st>>>(g, pf, mf, vf, o, gs, n, h);
  return cudaGetLastError();
}

}  // namespace

// One Adam step over n elements, in place: master, exp_avg, exp_avg_sq are
// fp32; grad is fp32 (grad_dtype 0) or bf16 (1); out (bf16, or NULL) gets
// the new master rounded to bf16; gscale (one fp32 on the card, or NULL)
// multiplies the gradient.  c1, c2 are the bias corrections 1 - b^count (1
// when off).  fp32 pointers 16-byte aligned, bf16 8-byte aligned.  Returns
// a cudaError_t (0 = launched).
extern "C" int ds_fused_adam(const void* grad, int grad_dtype, void* master,
                             void* exp_avg, void* exp_avg_sq, void* out,
                             const void* gscale, long long n, float lr,
                             float beta1, float beta2, float eps,
                             float weight_decay, float c1, float c2,
                             int adam_w_mode, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, beta1, beta2, eps, weight_decay, c1, c2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad_dtype == 0)
    return (int)launch<float>(grad, master, exp_avg, exp_avg_sq, out, gscale,
                              n, h, adam_w_mode, st);
  if (grad_dtype == 1)
    return (int)launch<__nv_bfloat16>(grad, master, exp_avg, exp_avg_sq, out,
                                      gscale, n, h, adam_w_mode, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
