// SIMD host optimizers for ZeRO-Offload — rebuild of the reference's
// csrc/adam/cpu_adam_impl.cpp, csrc/adagrad/cpu_adagrad.cpp and
// csrc/lion/cpu_lion.cpp (AVX via csrc/includes/simd.h).
//
// The offloaded fp32 master partition + optimizer moments live in host RAM
// (numpy); the engine calls these kernels instead of shipping the update to
// the TPU.  Vectorization comes from OpenMP `parallel for simd` + -O3
// -march=native (the compiler emits AVX/AVX-512 — same effect as the
// reference's hand-written SIMD wrappers, portable across hosts).
//
// All kernels also accept a bf16 (uint16) shadow "compute param" output so
// the updated weights can be sent back to device without a host-side fp32
// copy pass.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint16_t fp32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    // NaN must not round into inf: quiet it before the bias addition
    if ((x & 0x7FFFFFFFu) > 0x7F800000u) {
        return static_cast<uint16_t>((x >> 16) | 0x0040u);
    }
    // round-to-nearest-even
    uint32_t rounding_bias = 0x7FFF + ((x >> 16) & 1);
    return static_cast<uint16_t>((x + rounding_bias) >> 16);
}

}  // namespace

extern "C" {

// Adam / AdamW (adamw != 0 → decoupled weight decay).
// step is 1-based; bias correction matches torch.optim.Adam.
void ds_cpu_adam_step(float* param, const float* grad, float* exp_avg,
                      float* exp_avg_sq, int64_t n, float lr, float beta1,
                      float beta2, float eps, float weight_decay, int step,
                      int adamw, uint16_t* bf16_out) {
    const float bc1 = 1.0f - std::pow(beta1, step);
    const float bc2 = 1.0f - std::pow(beta2, step);
    const float step_size = lr / bc1;
    const float bc2_sqrt = std::sqrt(bc2);

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i];
        float p = param[i];
        if (weight_decay != 0.0f) {
            if (adamw) {
                p -= lr * weight_decay * p;
            } else {
                g += weight_decay * p;
            }
        }
        float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
        float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        p -= step_size * m / (std::sqrt(v) / bc2_sqrt + eps);
        param[i] = p;
        if (bf16_out) bf16_out[i] = fp32_to_bf16(p);
    }
}

// Adagrad (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_cpu_adagrad_step(float* param, const float* grad, float* state_sum,
                         int64_t n, float lr, float eps, float weight_decay,
                         uint16_t* bf16_out) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i];
        float p = param[i];
        if (weight_decay != 0.0f) g += weight_decay * p;
        float s = state_sum[i] + g * g;
        state_sum[i] = s;
        p -= lr * g / (std::sqrt(s) + eps);
        param[i] = p;
        if (bf16_out) bf16_out[i] = fp32_to_bf16(p);
    }
}

// Lion (reference csrc/lion/cpu_lion.cpp): sign-of-interpolation update.
void ds_cpu_lion_step(float* param, const float* grad, float* exp_avg,
                      int64_t n, float lr, float beta1, float beta2,
                      float weight_decay, uint16_t* bf16_out) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i];
        float p = param[i];
        float m = exp_avg[i];
        float c = beta1 * m + (1.0f - beta1) * g;
        p -= lr * weight_decay * p;  // lion uses decoupled decay
        p -= lr * (c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f));
        exp_avg[i] = beta2 * m + (1.0f - beta2) * g;
        param[i] = p;
        if (bf16_out) bf16_out[i] = fp32_to_bf16(p);
    }
}

// fused grad-norm-squared over a flat buffer (used by host-side clipping)
double ds_cpu_sq_norm(const float* grad, int64_t n) {
    double acc = 0.0;
#pragma omp parallel for simd reduction(+ : acc) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        acc += static_cast<double>(grad[i]) * static_cast<double>(grad[i]);
    }
    return acc;
}

}  // extern "C"
