// Host-side vectorized Adagrad for ZeRO-Offload.
//
// TPU-native equivalent of the reference's csrc/adagrad/cpu_adagrad.cpp
// (bound as `create_adagrad`/`adagrad_update`). See cpu_adam.cpp for the
// design notes (C ABI, bf16 copy-back, OpenMP SIMD instead of hand-rolled
// intrinsics).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "ds_host.h"

namespace {

struct AdagradState {
    float lr;
    float eps;
    float weight_decay;
};

std::mutex g_mu;
std::unordered_map<int, AdagradState> g_optimizers;
std::atomic<int> g_next_id{1};

AdagradState get_state(int id) {
    std::lock_guard<std::mutex> lock(g_mu);
    return g_optimizers.at(id);
}

}  // namespace

extern "C" {

int ds_adagrad_create(float lr, float eps, float weight_decay) {
    int id = g_next_id.fetch_add(1);
    std::lock_guard<std::mutex> lock(g_mu);
    g_optimizers[id] = AdagradState{lr, eps, weight_decay};
    return id;
}

void ds_adagrad_destroy(int id) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_optimizers.erase(id);
}

void ds_adagrad_update(int id, float lr_override, float* params,
                       const float* grads, float* sum_sq, int64_t n) {
    AdagradState s = get_state(id);
    const float lr = lr_override >= 0.f ? lr_override : s.lr;
    const float eps = s.eps, wd = s.weight_decay;

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = params[i];
        float g = grads[i];
        if (wd != 0.f) g += wd * p;
        float ss = sum_sq[i] + g * g;
        params[i] = p - lr * g / (std::sqrt(ss) + eps);
        sum_sq[i] = ss;
    }
}

void ds_adagrad_update_bf16(int id, float lr_override, float* params,
                            const uint16_t* grads_bf16, float* sum_sq,
                            uint16_t* params_out_bf16, int64_t n) {
    AdagradState s = get_state(id);
    const float lr = lr_override >= 0.f ? lr_override : s.lr;
    const float eps = s.eps, wd = s.weight_decay;

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = params[i];
        float g = ds_host::bf16_to_f32(grads_bf16[i]);
        if (wd != 0.f) g += wd * p;
        float ss = sum_sq[i] + g * g;
        p -= lr * g / (std::sqrt(ss) + eps);
        params[i] = p;
        sum_sq[i] = ss;
        params_out_bf16[i] = ds_host::f32_to_bf16(p);
    }
}

}  // extern "C"
