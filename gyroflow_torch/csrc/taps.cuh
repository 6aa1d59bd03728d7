// Shared __device__ sampling code: the coordinate guard and the separable
// LUT tap loop of the sampler kernel (sampler.cu) and the fused projection +
// sampling kernel (fused.cu); the guard also serves the EWA kernel (ewa.cu).
// One copy of the loop, so the fused and split kernels round alike.
//
// The tap loop is remap.sample_input's (gyroflow_torch/ops/remap.py, twin of
// the JAX remap.py:309-352) after its guard: quantize the phase as
// rint(u * 32) (round half to even), take the weights from the reference
// LUT (interpolation.COEFFS), sum the taps row by row with out-of-source-rect
// taps reading the background. Built with --fmad=false: every multiply and
// add rounds on its own, as the plain torch ops do, and the sums run in the
// plain version's order (xsum from 0 over the columns, then total += xsum *
// cy over the rows), so kernel and plain version give the same bits.
//
// How it reads its inputs (sampler.cu's header says why):
// - Weights: the block stages its interpolation's LUT slice, 32 phases x
//   TAPS floats (1 KB for lanczos4), from device memory into shared memory
//   (stage_lut); each thread reads its TAPS x- and TAPS y-weights as float4s
//   (phase_weights). A warp's pixels have different x-phases, so the
//   per-thread addresses hit different banks instead of being served one
//   after another, as __constant__ memory serves them.
// - Taps: a stencil that lies wholly inside the plane and the source rect
//   (nearly every pixel of a frame) reads each of its rows with 16-byte
//   aligned loads (load_row) and needs no clamp or background select; the
//   other stencils (near the frame's or the source rect's edges) take the
//   checked loop, one tap at a time. Row loads cover the type/channel/tap
//   combinations whose row is 16 or 32 bytes (uint16 C=1 and C=2 lanczos4,
//   float32 C=1 lanczos4, ...); the others always take the checked loop.
//
// The experiments' float32 kernels (fused_bbox.cu, probe_sampler.cu) stage
// the LUT slice the same way and read a stencil's taps a pixel at a time
// (load_pixel): for float32 planes that beat the row loads (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gf {

constexpr int kInterBits = 5;
constexpr int kInterTabSize = 1 << kInterBits;  // 32 phases

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

// Floats in the LUT slice of a TAPS-tap interpolation: COEFFS[ind : ind +
// 32 * TAPS], phase p's weights at [p * TAPS, (p + 1) * TAPS).
template <int TAPS>
constexpr int kSliceSize = kInterTabSize * TAPS;

// Copies the slice (device memory, 16-byte aligned) into the block's shared
// s_lut. Every thread of the block must call it, before any returns.
template <int TAPS>
__device__ __forceinline__ void stage_lut(const float* __restrict__ lut, float* s_lut) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    for (int i = tid; i < kSliceSize<TAPS> / 4; i += nt)
        reinterpret_cast<float4*>(s_lut)[i] = __ldg(reinterpret_cast<const float4*>(lut) + i);
    __syncthreads();
}

// The TAPS weights of one phase from the staged slice.
template <int TAPS>
__device__ __forceinline__ void phase_weights(const float* s_lut, int phase, float* w) {
    if constexpr (TAPS == 2) {
        const float2 q = reinterpret_cast<const float2*>(s_lut)[phase];
        w[0] = q.x;
        w[1] = q.y;
    } else {
        const float4* q = reinterpret_cast<const float4*>(s_lut + phase * TAPS);
#pragma unroll
        for (int k = 0; k < TAPS / 4; ++k) {
            const float4 f = q[k];
            w[4 * k] = f.x;
            w[4 * k + 1] = f.y;
            w[4 * k + 2] = f.z;
            w[4 * k + 3] = f.w;
        }
    }
}

// Row loads for a stencil row of TAPS pixels of C channels of T.
template <typename T, int C, int TAPS>
struct RowLoad {
    static constexpr int kBytes = TAPS * C * static_cast<int>(sizeof(T));
    static constexpr bool kVector = kBytes == 16 || kBytes == 32;
    static constexpr int kWords = kBytes / 4;
    static constexpr int kChunks = kBytes / 16 + 1;  // an unaligned row spans one more
};

// Word j of a row as T values, converted to float exactly. uint16 and uint8
// go through the float 2^23 + x (its mantissa holds x) minus 2^23: a byte
// permute and an add, where a conversion instruction runs at a quarter of
// the add's rate.
template <typename T>
__device__ __forceinline__ void word_values(uint32_t w, float* out);

template <>
__device__ __forceinline__ void word_values<float>(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
}

template <>
__device__ __forceinline__ void word_values<uint16_t>(uint32_t w, float* out) {
    out[0] = __uint_as_float(__byte_perm(w, 0x4B00u, 0x5410)) - 8388608.0f;
    out[1] = __uint_as_float(__byte_perm(w, 0x4B00u, 0x5432)) - 8388608.0f;
}

template <>
__device__ __forceinline__ void word_values<uint8_t>(uint32_t w, float* out) {
    out[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388608.0f;
    out[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388608.0f;
    out[2] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388608.0f;
    out[3] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388608.0f;
}

// The TAPS * C values of the row that starts at p, as floats: aligned
// 16-byte loads, then shifted into place. Only chunks that hold a byte of
// the row are read (the last one only when p is not 16-byte aligned), so no
// load leaves the 16-byte aligned span of the row's own bytes.
template <typename T, int C, int TAPS>
__device__ __forceinline__ void load_row(const T* p, float* px) {
    using R = RowLoad<T, C, TAPS>;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const uint4* q = reinterpret_cast<const uint4*>(addr & ~static_cast<uintptr_t>(15));
    const int o = static_cast<int>(addr & 15);
    uint32_t w[4 * R::kChunks];
#pragma unroll
    for (int k = 0; k < R::kChunks; ++k) {
        const uint4 c = (k < R::kChunks - 1 || o != 0) ? __ldg(q + k) : make_uint4(0, 0, 0, 0);
        w[4 * k] = c.x;
        w[4 * k + 1] = c.y;
        w[4 * k + 2] = c.z;
        w[4 * k + 3] = c.w;
    }
    // shift by o bytes: whole words in two select steps, then a funnel shift
    uint32_t t[R::kWords + 2];
#pragma unroll
    for (int m = 0; m < R::kWords + 2; ++m) t[m] = (o & 8) ? w[m + 2] : w[m];
    uint32_t s[R::kWords + 1];
#pragma unroll
    for (int m = 0; m < R::kWords + 1; ++m) s[m] = (o & 4) ? t[m + 1] : t[m];
    constexpr int kPerWord = 4 / static_cast<int>(sizeof(T)) > 0 ? 4 / static_cast<int>(sizeof(T)) : 1;
#pragma unroll
    for (int m = 0; m < R::kWords; ++m)
        word_values<T>(__funnelshift_r(s[m], s[m + 1], (o & 3) * 8), px + m * kPerWord);
}

// Bytes a float32 pixel of C channels must be aligned to for load_pixel:
// one 8-byte load for C = 2, one 16-byte load for C = 4, else 4-byte loads.
template <int C>
constexpr int kPixelAlign = C == 2 ? 8 : (C == 4 ? 16 : 4);

// The C channels of the float32 pixel at p, which is kPixelAlign<C>-byte
// aligned, in one load (C = 1, 2, 4) or one a channel (C = 3).
template <int C>
__device__ __forceinline__ void load_pixel(const float* __restrict__ p, float* px) {
    if constexpr (C == 2) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(p));
        px[0] = f.x;
        px[1] = f.y;
    } else if constexpr (C == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p));
        px[0] = f.x;
        px[1] = f.y;
        px[2] = f.z;
        px[3] = f.w;
    } else {
#pragma unroll
        for (int c = 0; c < C; ++c) px[c] = __ldg(p + c);
    }
}

// The separable tap sum at (u, v), which the caller has already guarded and
// shifted by Interp<TAPS>::offset; s_lut is the block's staged LUT slice.
// total[c] gets the unclamped sum.
template <typename T, int C, int TAPS>
__device__ __forceinline__ void sample_taps(const T* __restrict__ img, int H, int W, float u,
                                            float v, const SamplerArgs& a, const float* s_lut,
                                            float* total) {
    const int sx0 = __float2int_rn(u * (float)kInterTabSize);  // rint: half to even
    const int sy0 = __float2int_rn(v * (float)kInterTabSize);
    const int sx = sx0 >> kInterBits;                           // arithmetic shift
    const int sy = sy0 >> kInterBits;
    float wx[TAPS], wy[TAPS];
    phase_weights<TAPS>(s_lut, sx0 & (kInterTabSize - 1), wx);
    phase_weights<TAPS>(s_lut, sy0 & (kInterTabSize - 1), wy);
    const int srx = a.src_rect[0], sry = a.src_rect[1];
    const int srx1 = srx + a.src_rect[2], sry1 = sry + a.src_rect[3];

#pragma unroll
    for (int c = 0; c < C; ++c) total[c] = 0.0f;

    if constexpr (RowLoad<T, C, TAPS>::kVector) {
        // the whole stencil inside the plane and the source rect, and the
        // last row's chunks inside the plane
        const bool inside = sx >= max(srx, 0) && sx + TAPS <= min(srx1, W) &&
                            sy >= max(sry, 0) && sy + TAPS <= min(sry1, H);
        if (inside) {
            const T* last = img + ((long long)(sy + TAPS - 1) * W + sx) * C;
            const uintptr_t end = reinterpret_cast<uintptr_t>(last + TAPS * C);
            const uintptr_t plane_end = reinterpret_cast<uintptr_t>(img + (long long)H * W * C);
            if (((end + 15) & ~static_cast<uintptr_t>(15)) <= plane_end) {
#pragma unroll
                for (int yp = 0; yp < TAPS; ++yp) {
                    float px[TAPS * C];
                    load_row<T, C, TAPS>(img + ((long long)(sy + yp) * W + sx) * C, px);
                    float xsum[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) xsum[c] = 0.0f;
#pragma unroll
                    for (int xp = 0; xp < TAPS; ++xp) {
#pragma unroll
                        for (int c = 0; c < C; ++c) xsum[c] = xsum[c] + px[xp * C + c] * wx[xp];
                    }
#pragma unroll
                    for (int c = 0; c < C; ++c) total[c] = total[c] + xsum[c] * wy[yp];
                }
                return;
            }
        }
    }

    // the checked loop: clamp each tap into the plane, background outside
    // the source rect
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
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float px = ok ? static_cast<float>(src_row[(long long)xc * C + c]) : a.bg[c];
                xsum[c] = xsum[c] + px * wx[xp];
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) total[c] = total[c] + xsum[c] * wy[yp];
    }
}

}  // namespace gf
