// Shared host-side helpers for deepspeed_tpu native ops.
//
// TPU-native analogue of the reference's csrc/includes/{simd.h,cpu_adam.h}:
// the reference hand-writes AVX512/AVX256 intrinsics; here the inner loops
// are written scalar with `#pragma omp simd` + `-O3 -march=native` so g++
// emits the same vector ISA the host supports, without per-ISA code paths.
// bf16 conversion helpers are needed because on TPU hosts the device-side
// compute dtype is bfloat16 (not fp16 as on CUDA).
#pragma once

#include <cstdint>
#include <cstring>

namespace ds_host {

// bfloat16 <-> float32. Round-to-nearest-even on the downcast, matching
// XLA's convert semantics so host-updated params match device casts bit-wise.
static inline float bf16_to_f32(uint16_t v) {
    uint32_t bits = static_cast<uint32_t>(v) << 16;
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

static inline uint16_t f32_to_bf16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof(bits));
    if ((bits & 0x7fffffffu) > 0x7f800000u) {  // NaN: keep quiet NaN payload
        return static_cast<uint16_t>((bits >> 16) | 0x0040u);
    }
    uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;  // round to nearest even
    return static_cast<uint16_t>(bits >> 16);
}

}  // namespace ds_host
