// Shared __device__ sampling code: the coordinate guard and the separable
// LUT tap loop of the sampler kernel (sampler.cu), the fused projection +
// sampling kernel (fused.cu) and, for the guard, the EWA kernel (ewa.cu).
// One copy of the loop, so the fused and split kernels round alike.
//
// The tap loop is remap.sample_input's (gyroflow_torch/ops/remap.py, twin of
// the JAX remap.py:309-352) after its guard: quantize the phase as
// rint(u * 32) (round half to even), take the weights from the reference
// LUT (interpolation.COEFFS, 448 floats), sum the taps row by row with
// out-of-source-rect taps reading the background. Built with --fmad=false:
// every multiply and add rounds on its own, as the plain torch ops do.
//
// __constant__ memory belongs to its translation unit (the kernels are
// compiled without -rdc), so c_coeffs is declared static here and each .cu
// that samples uploads its own copy (gf_sampler_set_lut, gf_fused_set_lut).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gf {

constexpr int kLutSize = 448;
constexpr int kInterBits = 5;
constexpr int kInterTabSize = 1 << kInterBits;  // 32 phases

static __constant__ float c_coeffs[kLutSize];

// Tap layout of the LUT per interpolation (interpolation.INTERP_INFO).
template <int TAPS> struct Interp;
template <> struct Interp<2> { static constexpr int ind = 0, shift = 1; static constexpr float offset = 0.0f; };
template <> struct Interp<4> { static constexpr int ind = 64, shift = 2; static constexpr float offset = 1.0f; };
template <> struct Interp<8> { static constexpr int ind = 192, shift = 3; static constexpr float offset = 3.0f; };

// Background, clamp and source rect, passed to the kernels by value.
struct SamplerArgs {
    float bg[4];
    float limit;
    int src_rect[4];  // x, y, w, h
};

// _guard_uv (pallas_sampler.py:1067): non-finite -> 0, clip to +-32768.
__device__ __forceinline__ float guard_uv(float a) {
    a = fabsf(a) <= 3.402823466e+38f ? a : 0.0f;   // NaN and +-inf -> 0
    return fminf(fmaxf(a, -32768.0f), 32768.0f);
}

// The separable tap sum at (u, v), which the caller has already guarded and
// shifted by Interp<TAPS>::offset. total[c] gets the unclamped sum.
template <typename T, int C, int TAPS>
__device__ __forceinline__ void sample_taps(const T* __restrict__ img, int H, int W, float u,
                                            float v, const SamplerArgs& a, float* total) {
    const int sx0 = __float2int_rn(u * (float)kInterTabSize);  // rint: half to even
    const int sy0 = __float2int_rn(v * (float)kInterTabSize);
    const int sx = sx0 >> kInterBits;                           // arithmetic shift
    const int sy = sy0 >> kInterBits;
    const int base_x = Interp<TAPS>::ind + ((sx0 & (kInterTabSize - 1)) << Interp<TAPS>::shift);
    const int base_y = Interp<TAPS>::ind + ((sy0 & (kInterTabSize - 1)) << Interp<TAPS>::shift);
    const int srx = a.src_rect[0], sry = a.src_rect[1];
    const int srx1 = srx + a.src_rect[2], sry1 = sry + a.src_rect[3];

#pragma unroll
    for (int c = 0; c < C; ++c) total[c] = 0.0f;

#pragma unroll
    for (int yp = 0; yp < TAPS; ++yp) {
        const int yy = sy + yp;
        const bool row_ok = yy >= sry && yy < sry1;
        const int yc = yy < 0 ? 0 : (yy >= H ? H - 1 : yy);
        const T* src_row = img + (long long)yc * W * C;
        float xsum[C];
#pragma unroll
        for (int c = 0; c < C; ++c) xsum[c] = 0.0f;
#pragma unroll
        for (int xp = 0; xp < TAPS; ++xp) {
            const int xx = sx + xp;
            const bool ok = row_ok && xx >= srx && xx < srx1;
            const int xc = xx < 0 ? 0 : (xx >= W ? W - 1 : xx);
            const float cx = c_coeffs[base_x + xp];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float px = ok ? static_cast<float>(src_row[(long long)xc * C + c]) : a.bg[c];
                xsum[c] = xsum[c] + px * cx;
            }
        }
        const float cy = c_coeffs[base_y + yp];
#pragma unroll
        for (int c = 0; c < C; ++c) total[c] = total[c] + xsum[c] * cy;
    }
}

// Copies the 448-float host LUT into this translation unit's c_coeffs on
// the current device. Returns the cudaError_t of the copy (-1 for a wrong n).
// static: each translation unit keeps its own copy, bound to its own c_coeffs
// (an inline function would be merged across units at link time).
static int set_lut(const float* lut, int n) {
    if (n != kLutSize) return -1;
    return static_cast<int>(cudaMemcpyToSymbol(c_coeffs, lut, sizeof(float) * kLutSize));
}

}  // namespace gf
