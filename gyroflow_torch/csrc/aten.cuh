// torch's float32 clamps on the card, for kernels that must give the bits of
// a plain torch version.
//
// ATen's clamp, clamp_min, clamp_max, maximum and minimum kernels return a
// NaN operand as NaN and send anything else through fmaxf / fminf; fmaxf and
// fminf alone return the operand that is not NaN.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gf {

__device__ __forceinline__ float clamp_min_t(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max_t(float x, float hi) {
    return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp_t(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum_t(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

}  // namespace gf
