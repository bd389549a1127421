// Host-side vectorized Lion for ZeRO-Offload.
//
// TPU-native equivalent of the reference's csrc/lion/cpu_lion.cpp +
// cpu_lion_impl.cpp (bound as `create_lion`/`lion_update`). See cpu_adam.cpp
// for the design notes.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "ds_host.h"

namespace {

struct LionState {
    float lr;
    float beta1;
    float beta2;
    float weight_decay;
};

std::mutex g_mu;
std::unordered_map<int, LionState> g_optimizers;
std::atomic<int> g_next_id{1};

LionState get_state(int id) {
    std::lock_guard<std::mutex> lock(g_mu);
    return g_optimizers.at(id);
}

static inline float sign_of(float x) { return (x > 0.f) - (x < 0.f); }

}  // namespace

extern "C" {

int ds_lion_create(float lr, float beta1, float beta2, float weight_decay) {
    int id = g_next_id.fetch_add(1);
    std::lock_guard<std::mutex> lock(g_mu);
    g_optimizers[id] = LionState{lr, beta1, beta2, weight_decay};
    return id;
}

void ds_lion_destroy(int id) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_optimizers.erase(id);
}

void ds_lion_update(int id, float lr_override, float* params,
                    const float* grads, float* exp_avg, int64_t n) {
    LionState s = get_state(id);
    const float lr = lr_override >= 0.f ? lr_override : s.lr;
    const float b1 = s.beta1, b2 = s.beta2, wd = s.weight_decay;

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = params[i];
        float g = grads[i];
        float m = exp_avg[i];
        float update = sign_of(b1 * m + (1.f - b1) * g);
        if (wd != 0.f) update += wd * p;
        params[i] = p - lr * update;
        exp_avg[i] = b2 * m + (1.f - b2) * g;
    }
}

void ds_lion_update_bf16(int id, float lr_override, float* params,
                         const uint16_t* grads_bf16, float* exp_avg,
                         uint16_t* params_out_bf16, int64_t n) {
    LionState s = get_state(id);
    const float lr = lr_override >= 0.f ? lr_override : s.lr;
    const float b1 = s.beta1, b2 = s.beta2, wd = s.weight_decay;

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = params[i];
        float g = ds_host::bf16_to_f32(grads_bf16[i]);
        float m = exp_avg[i];
        float update = sign_of(b1 * m + (1.f - b1) * g);
        if (wd != 0.f) update += wd * p;
        p -= lr * update;
        params[i] = p;
        exp_avg[i] = b2 * m + (1.f - b2) * g;
        params_out_bf16[i] = ds_host::f32_to_bf16(p);
    }
}

}  // extern "C"
