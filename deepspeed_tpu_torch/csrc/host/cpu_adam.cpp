// Host-side vectorized Adam/AdamW for ZeRO-Offload.
//
// TPU-native equivalent of the reference's csrc/adam/cpu_adam.cpp +
// cpu_adam_impl.cpp (bound as `create_adam`/`adam_update` through pybind,
// csrc/adam/cpu_adam.cpp:10-15). Role is identical: when optimizer state is
// offloaded to host RAM (ZeRO-Offload) the parameter update runs on the host
// CPU, OpenMP-parallel and SIMD-vectorized, while the device only computes
// gradients. Differences from the reference, driven by the TPU stack:
//   * C ABI + ctypes instead of pybind11 (not available in this image).
//   * bf16 (not fp16) is the device compute dtype, so the fused copy-back
//     writes bfloat16 with round-to-nearest-even to match XLA casts.
//   * No hand-rolled AVX intrinsics: `#pragma omp simd` + -O3 lets g++ pick
//     the widest ISA available (AVX512 on typical TPU-VM hosts).
//
// All functions are thread-safe w.r.t. distinct optimizer ids.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "ds_host.h"

namespace {

struct AdamState {
    float lr;
    float beta1;
    float beta2;
    float eps;
    float weight_decay;
    bool adamw_mode;
    bool bias_correction;
};

std::mutex g_mu;
std::unordered_map<int, AdamState> g_optimizers;
std::atomic<int> g_next_id{1};

AdamState get_state(int id) {
    std::lock_guard<std::mutex> lock(g_mu);
    return g_optimizers.at(id);
}

}  // namespace

extern "C" {

int ds_adam_create(float lr, float beta1, float beta2, float eps,
                   float weight_decay, int adamw_mode, int bias_correction) {
    int id = g_next_id.fetch_add(1);
    std::lock_guard<std::mutex> lock(g_mu);
    g_optimizers[id] = AdamState{lr,  beta1, beta2, eps, weight_decay,
                                adamw_mode != 0, bias_correction != 0};
    return id;
}

void ds_adam_destroy(int id) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_optimizers.erase(id);
}

// Core update: fp32 params/moments, fp32 grads. step is 1-based.
// lr_override < 0 means "use the creation-time lr".
void ds_adam_update(int id, int64_t step, float lr_override, float* params,
                    const float* grads, float* exp_avg, float* exp_avg_sq,
                    int64_t n) {
    AdamState s = get_state(id);
    const float lr = lr_override >= 0.f ? lr_override : s.lr;
    const float b1 = s.beta1, b2 = s.beta2, eps = s.eps, wd = s.weight_decay;
    const bool adamw = s.adamw_mode;
    float bc1 = 1.f, bc2 = 1.f;
    if (s.bias_correction) {
        bc1 = 1.f - std::pow(b1, static_cast<float>(step));
        bc2 = 1.f - std::pow(b2, static_cast<float>(step));
    }
    const float inv_bc1 = 1.f / bc1;
    const float inv_bc2_sqrt = 1.f / std::sqrt(bc2);

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = params[i];
        float g = grads[i];
        if (wd != 0.f && !adamw) g += wd * p;
        float m = b1 * exp_avg[i] + (1.f - b1) * g;
        float v = b2 * exp_avg_sq[i] + (1.f - b2) * g * g;
        float update = (m * inv_bc1) / (std::sqrt(v) * inv_bc2_sqrt + eps);
        if (wd != 0.f && adamw) update += wd * p;
        params[i] = p - lr * update;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
    }
}

// Fused variant for the ZeRO-Offload hot path: gradients arrive from the
// device as bf16, updated params are written back out as bf16 for the
// host->device transfer, avoiding two extra fp32 passes over host RAM
// (same motivation as the reference's fp16 `params_half` copy,
// cpu_adam_impl.cpp Step_1 half-precision path).
void ds_adam_update_bf16(int id, int64_t step, float lr_override,
                         float* params, const uint16_t* grads_bf16,
                         float* exp_avg, float* exp_avg_sq,
                         uint16_t* params_out_bf16, int64_t n) {
    AdamState s = get_state(id);
    const float lr = lr_override >= 0.f ? lr_override : s.lr;
    const float b1 = s.beta1, b2 = s.beta2, eps = s.eps, wd = s.weight_decay;
    const bool adamw = s.adamw_mode;
    float bc1 = 1.f, bc2 = 1.f;
    if (s.bias_correction) {
        bc1 = 1.f - std::pow(b1, static_cast<float>(step));
        bc2 = 1.f - std::pow(b2, static_cast<float>(step));
    }
    const float inv_bc1 = 1.f / bc1;
    const float inv_bc2_sqrt = 1.f / std::sqrt(bc2);

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = params[i];
        float g = ds_host::bf16_to_f32(grads_bf16[i]);
        if (wd != 0.f && !adamw) g += wd * p;
        float m = b1 * exp_avg[i] + (1.f - b1) * g;
        float v = b2 * exp_avg_sq[i] + (1.f - b2) * g * g;
        float update = (m * inv_bc1) / (std::sqrt(v) * inv_bc2_sqrt + eps);
        if (wd != 0.f && adamw) update += wd * p;
        p -= lr * update;
        params[i] = p;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        params_out_bf16[i] = ds_host::f32_to_bf16(p);
    }
}

}  // extern "C"
