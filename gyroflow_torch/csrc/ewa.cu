// EWA kernel: elliptical weighted averaging (interpolation 10-13).
//
// Replaces gyroflow_tpu/ops/pallas_sampler.py::_ewa_kernel (:715), called by
// _ewa_call (:948, pl.pallas_call at :970) and sample_planes_ewa_t. Per
// output pixel it does what remap.ewa_jacobian followed by remap.sample_ewa
// (gyroflow_torch/ops/remap.py, twins of the JAX remap.py:842-845 and
// :374-465) do:
//   1. the finite-difference Jacobian from the stacked evals of the one
//      coords launch (3*oh rows: base, +eps in x, +eps in y): an invalid
//      +eps eval counts as source point 0, then (eval - base) / EWA_EPS;
//   2. guard u/v, the reference bbox (affine_bbox) and the clamped ellipse
//      (clamped_ellipse) from the Jacobian;
//   3. the Keys-cubic bc2 of sqrt(dr) over the taps of the 10x10 stencil
//      around floor(u, v) that lie inside the bbox, taps outside the source
//      rect reading the background, rows major and columns minor;
//   4. normalise by the weight sum and clamp at pixel_value_limit. Pixels
//      whose base eval is not valid get the background.
// Every multiply, add, division and square root runs in the plain version's
// order, under nvcc --fmad=false with IEEE division and square root, and
// each clamp_min / clamp_max / maximum is torch's own (a NaN stays NaN), so
// the kernel gives sample_plain's bits for planes of finite values.
//
// The stencil is the JAX package's top rung (cap 4). Its lower rungs
// (ewa_cap 2-3) and their cap-escalation check (remap.py:846-955) exist
// only to shrink the TPU's window DMA; they agree with cap 4 to within
// 0.25% of one tap weight by construction (remap.py:907-913), so only cap 4
// is computed here. The window ladder, plan_windows_t, the one-hot MXU
// column gather and its hi/lo bf16 split are likewise TPU-only.
//
// What bounds it on an H100: operations, at the rate this build can issue.
// A 4K frame's Y and UV planes, the three evals' u, v, valid and the
// outputs are ~0.355 GB (0.106 ms at 3.35 TB/s). Each pixel runs ~140 FP32
// operations of set-up (four IEEE divisions and three square roots among
// them), 7 for each tap of its bbox (~38 at a near-identity Jacobian) and
// ~14 more for each tap with a nonzero weight (~13): ~0.096 ms at 67
// TFLOP/s, the H100 SXM's FP32 peak, which chip_smoke.py's bound divides by
// (it prints the bound of this run's inputs). That peak counts a fused
// multiply-add as two operations; built with --fmad=false each multiply and
// add issues on its own, so this build reaches at most half of it, and the
// operations then take ~0.19 ms. The bound keeps its definition so that it
// compares across PRs.
//
// What the design does about it (each step measured by
// gyroflow_torch/experiments/ewa_bench.py on the card; PERF.md has the
// readings):
// - the Jacobian is formed here from the coords launch's stacked evals, so
//   no (oh, ow, 4) tensor is built (four where, four subtractions, four
//   divisions and a stack in eager torch) and read back;
// - each lane walks only the rows and columns of its own bbox inside the
//   stencil, not the fixed 10x10 with a per-tap mask: taps outside the bbox
//   add exactly nothing in the plain version;
// - a tap whose dr is not below 4 (or is NaN) skips the square root, the
//   cubic and the accumulation: the plain version gives it weight 0, since
//   a correctly rounded sqrt of dr >= 4 is >= 2, and bc2 is 0 there and at
//   NaN; adding k * px = 0 to a sum that started at +0 leaves its bits;
// - a stencil whose clipped taps lie wholly inside the plane and the source
//   rect (nearly every pixel) reads each tap without clamps or a background
//   select; uint16 and uint8 taps become floats exactly as (2^23 + x) - 2^23
//   (taps.cuh's conversion); the other stencils take the checked loop;
// - one thread per pixel on 32x8 blocks. Two rows a thread (the sampler's
//   layout) was 5% slower here, as were a per-row column range from the
//   ellipse's quadratic, 16-byte row loads of the 10-tap row (they walk all
//   10 columns again) and a twice-unrolled column loop; staging each block's
//   source footprint in shared memory was 8% slower (likely because the L1
//   already serves the taps that neighbouring pixels share).
#include <cuda_runtime.h>
#include <stdint.h>

#include "aten.cuh"
#include "taps.cuh"

constexpr int kEwaCap = 4;
constexpr int kTaps = 2 * kEwaCap + 2;  // 10 taps per axis

// Keys-cubic coefficients, background, clamp, the Jacobian's scale and the
// source rect, passed by value.
struct EwaArgs {
    float p[4];       // bc2 piece for x < 1
    float q[4];       // bc2 piece for 1 <= x < 2
    float bg[4];
    float limit;
    float inv_eps;    // float32(1 / float32(EWA_EPS)): the Jacobian's scale
    int src_rect[4];  // x, y, w, h
};

namespace {

using gf::guard_uv;   // taps.cuh

// One thread per output pixel, 32 x 8 pixels a block: a warp is 32
// neighbouring pixels of one row, whose bboxes and taps are alike.
constexpr int kBlockX = 32, kBlockY = 8;

// torch's float32 clamp_min, clamp_max and maximum on the card (aten.cuh):
// a NaN stays NaN
using gf::clamp_max_t;
using gf::clamp_min_t;
using gf::maximum_t;

// float -> int32 conversions saturate (cvt.rzi.s32.f32), as in remap._floor_i32.
__device__ __forceinline__ int floor_i32(float a) { return static_cast<int>(floorf(a)); }
__device__ __forceinline__ int ceil_i32(float a) { return static_cast<int>(ceilf(a)); }

// A tap as float, exactly: uint16 and uint8 through (2^23 + x) - 2^23, an
// OR and an add where a conversion instruction runs at a quarter rate.
template <typename T>
__device__ __forceinline__ float tap_value(T x) {
    if constexpr (sizeof(T) == 4) {
        return x;
    } else {
        return __uint_as_float(0x4B000000u | static_cast<uint32_t>(x)) - 8388608.0f;
    }
}

// bc2 (the Keys cubic) at x = sqrt(dr), for dr < 4 and not NaN, so that
// fmaxf is clamp_min here and x < 2: the correctly rounded sqrt of the
// largest float below 4 is the largest float below 2. p for x < 1, else q.
__device__ __forceinline__ float keys_weight(float dr, const EwaArgs& a) {
    const float x = sqrtf(fmaxf(dr, 0.0f));
    const bool lo = x < 1.0f;
    const float k0 = lo ? a.p[0] : a.q[0];
    const float k1 = lo ? a.p[1] : a.q[1];
    const float k2 = lo ? a.p[2] : a.q[2];
    const float k3 = lo ? a.p[3] : a.q[3];
    const float x2 = x * x;
    return k0 + k1 * x + k2 * x2 + k3 * x2 * x;
}

// The weighted sum over the taps (cx0..cx1) x (cy0..cy1), rows major and
// columns minor (remap.py:439-463). Checked: each tap is clamped into the
// plane and reads the background outside the source rect. Unchecked: the
// caller has shown that every tap lies inside both.
template <typename T, int C, bool kChecked>
__device__ __forceinline__ void tap_sum(const T* __restrict__ img, int H, int W, float u, float v,
                                        float abc_x, float abc_y, float abc_z, int cx0, int cx1,
                                        int cy0, int cy1, const EwaArgs& a, float* total,
                                        float& sum_div) {
    const int srx = a.src_rect[0], sry = a.src_rect[1];
    const int srx1 = srx + a.src_rect[2], sry1 = sry + a.src_rect[3];
#pragma unroll 1
    for (int in_y = cy0; in_y <= cy1; ++in_y) {
        const float fy = static_cast<float>(in_y) - v;
        const float fy2 = fy * abc_y;
        const float fy3 = fy * fy * abc_z;
        const bool row_ok = in_y >= sry && in_y < sry1;
        const int yc = kChecked ? (in_y < 0 ? 0 : (in_y >= H ? H - 1 : in_y)) : in_y;
        const T* src_row = img + (long long)yc * W * C;
#pragma unroll 1
        for (int in_x = cx0; in_x <= cx1; ++in_x) {
            const float fx = static_cast<float>(in_x) - u;
            const float dr = fx * fx * abc_x + fx * fy2 + fy3;
            if (!(dr < 4.0f)) continue;
            const float k = keys_weight(dr, a);
            if constexpr (kChecked) {
                const bool ok = row_ok && in_x >= srx && in_x < srx1;
                const int xc = in_x < 0 ? 0 : (in_x >= W ? W - 1 : in_x);
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float px = ok ? tap_value(src_row[(long long)xc * C + c]) : a.bg[c];
                    total[c] = total[c] + k * px;
                }
            } else {
                const T* p = src_row + (long long)in_x * C;
#pragma unroll
                for (int c = 0; c < C; ++c) total[c] = total[c] + k * tap_value(p[c]);
            }
            sum_div = sum_div + k;
        }
    }
}

// One output pixel i of n = oh * ow.
template <typename T, int C>
__device__ __forceinline__ void ewa_pixel(const T* __restrict__ img, int H, int W,
                                          const float* __restrict__ us,
                                          const float* __restrict__ vs,
                                          const float* __restrict__ u3,
                                          const float* __restrict__ v3,
                                          const uint8_t* __restrict__ valid3, long long n,
                                          long long i, const EwaArgs& a,
                                          float* __restrict__ out) {
    float* o = out + i * C;
    if (!valid3[i]) {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = a.bg[c];
        return;
    }

    // ewa_jacobian (remap.py): an invalid +eps eval counts as point 0; the
    // division by EWA_EPS is torch's on the card, a multiply by inv_eps
    const float u0 = u3[i], v0 = v3[i];
    const bool valid_x = valid3[n + i], valid_y = valid3[2 * n + i];
    const float jx = ((valid_x ? u3[n + i] : 0.0f) - u0) * a.inv_eps;
    const float jy = ((valid_y ? u3[2 * n + i] : 0.0f) - u0) * a.inv_eps;
    const float jz = ((valid_x ? v3[n + i] : 0.0f) - v0) * a.inv_eps;
    const float jw = ((valid_y ? v3[2 * n + i] : 0.0f) - v0) * a.inv_eps;

    const float u = guard_uv(us[i]);
    const float v = guard_uv(vs[i]);

    // affine_bbox (cpu_undistort.rs:272-277)
    const float tx = 2.0f * clamp_min_t(maximum_t(fabsf(jx + jy), fabsf(jx - jy)), 1.0f);
    const float ty = 2.0f * clamp_min_t(maximum_t(fabsf(jz + jw), fabsf(jz - jw)), 1.0f);
    const int x0 = floor_i32(u - tx), x1 = ceil_i32(u + tx);
    const int y0 = floor_i32(v - ty), y1 = ceil_i32(v + ty);

    // clamped_ellipse (cpu_undistort.rs:279-314)
    const float f0 = fabsf(jx * jw - jy * jz);
    const float f = clamp_min_t(f0 * f0, 0.1f);
    const float ea = (jz * jz + jw * jw) / f;
    const float eb = -2.0f * (jx * jz + jy * jw) / f;
    const float ec = (jx * jx + jy * jy) / f;
    const float vx = ec - ea;
    const float vy = -eb;
    const float lv = sqrtf(vx * vx + vy * vy);
    const float v0n = lv > 0.01f ? vx / (lv == 0.0f ? 1.0f : lv) : 1.0f;
    const float cc = sqrtf(clamp_min_t(1.0f + v0n, 0.0f) / 2.0f);
    float s = sqrtf(clamp_min_t(1.0f - v0n, 0.0f) / 2.0f);
    float a0 = ea * cc * cc - eb * cc * s + ec * s * s;
    float c0 = ea * s * s + eb * cc * s + ec * cc * cc;
    const float bt1 = eb * (cc * cc - s * s);
    const float bt2 = 2.0f * (ea - ec) * cc * s;
    float b0 = bt1 + bt2;
    const float b0v2 = bt1 - bt2;
    if (fabsf(b0) > fabsf(b0v2)) {
        s = -s;
        b0 = b0v2;
    }
    a0 = clamp_max_t(a0, 1.0f);
    c0 = clamp_max_t(c0, 1.0f);
    const float sn = -s;
    const float abc_x = a0 * cc * cc - b0 * cc * sn + c0 * sn * sn;
    const float abc_y = 2.0f * a0 * cc * sn + b0 * cc * cc - b0 * sn * sn - 2.0f * c0 * cc * sn;
    const float abc_z = a0 * sn * sn + b0 * cc * sn + c0 * cc * cc;

    // the 10x10 stencil at floor(u, v) - cap, clipped to the bbox
    const int base_x = floor_i32(u) - kEwaCap;
    const int base_y = floor_i32(v) - kEwaCap;
    const int cx0 = max(x0, base_x), cx1 = min(x1, base_x + kTaps - 1);
    const int cy0 = max(y0, base_y), cy1 = min(y1, base_y + kTaps - 1);

    float total[C];
#pragma unroll
    for (int c = 0; c < C; ++c) total[c] = 0.0f;
    float sum_div = 0.0f;
    const int srx = a.src_rect[0], sry = a.src_rect[1];
    const int srx1 = srx + a.src_rect[2], sry1 = sry + a.src_rect[3];
    const bool inside = cx0 >= max(srx, 0) && cx1 < min(srx1, W) &&
                        cy0 >= max(sry, 0) && cy1 < min(sry1, H);
    if (inside) {
        tap_sum<T, C, false>(img, H, W, u, v, abc_x, abc_y, abc_z, cx0, cx1, cy0, cy1, a, total,
                             sum_div);
    } else {
        tap_sum<T, C, true>(img, H, W, u, v, abc_x, abc_y, abc_z, cx0, cx1, cy0, cy1, a, total,
                            sum_div);
    }
    const float d = sum_div == 0.0f ? 1.0f : sum_div;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = clamp_max_t(total[c] / d, a.limit);
}

template <typename T, int C>
__global__ void __launch_bounds__(kBlockX * kBlockY)
ewa_kernel(const T* __restrict__ img, int H, int W, const float* __restrict__ us,
           const float* __restrict__ vs, const float* __restrict__ u3,
           const float* __restrict__ v3, const uint8_t* __restrict__ valid3, int oh, int ow,
           EwaArgs a, float* __restrict__ out) {
    const int col = blockIdx.x * kBlockX + threadIdx.x;
    const int row = blockIdx.y * kBlockY + threadIdx.y;
    if (col >= ow || row >= oh) return;
    ewa_pixel<T, C>(img, H, W, us, vs, u3, v3, valid3, (long long)oh * ow,
                    (long long)row * ow + col, a, out);
}

struct Launch {
    const void* img; int H, W;
    const void *u, *v, *u3, *v3, *valid3; int oh, ow;
    const EwaArgs* a; void* out; cudaStream_t s;
};

template <typename T, int C>
void launch(const Launch& l) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((l.ow + kBlockX - 1) / kBlockX, (l.oh + kBlockY - 1) / kBlockY);
    ewa_kernel<T, C><<<grid, block, 0, l.s>>>(
        static_cast<const T*>(l.img), l.H, l.W, static_cast<const float*>(l.u),
        static_cast<const float*>(l.v), static_cast<const float*>(l.u3),
        static_cast<const float*>(l.v3), static_cast<const uint8_t*>(l.valid3), l.oh, l.ow, *l.a,
        static_cast<float*>(l.out));
}

template <typename T>
bool dispatch_channels(int C, const Launch& l) {
    switch (C) {
        case 1: launch<T, 1>(l); return true;
        case 2: launch<T, 2>(l); return true;
        case 3: launch<T, 3>(l); return true;
        case 4: launch<T, 4>(l); return true;
        default: return false;
    }
}

}  // namespace

// img: (H, W, C) channels-last, dtype 0 = uint8, 1 = uint16, 2 = float32;
// u, v: float32 (oh, ow), the sampling positions; u3, v3: float32 and
// valid3: uint8/bool (3*oh, ow), the base eval and the +eps evals in x and
// in y after coords_post_uv (u, v may be the views of their first oh rows);
// out: float32 (oh, ow, C). Returns -1 for an unsupported dtype/C, else
// cudaGetLastError() after the launch.
extern "C" int gf_ewa(const void* img, int dtype, int H, int W, int C, const void* u,
                      const void* v, const void* u3, const void* v3, const void* valid3, int oh,
                      int ow, EwaArgs args, void* out, void* stream) {
    const Launch l{img, H, W, u, v, u3, v3, valid3, oh, ow, &args, out,
                   static_cast<cudaStream_t>(stream)};
    bool ok = false;
    switch (dtype) {
        case 0: ok = dispatch_channels<uint8_t>(C, l); break;
        case 1: ok = dispatch_channels<uint16_t>(C, l); break;
        case 2: ok = dispatch_channels<float>(C, l); break;
        default: break;
    }
    if (!ok) return -1;
    return static_cast<int>(cudaGetLastError());
}
