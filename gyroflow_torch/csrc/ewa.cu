// EWA kernel: elliptical weighted averaging (interpolation 10-13).
//
// Replaces gyroflow_tpu/ops/pallas_sampler.py::_ewa_kernel (:715, driven by
// _ewa_call :948 and sample_planes_ewa_t). Per output pixel it does what
// remap.sample_ewa (gyroflow_torch/ops/remap.py, twin of the JAX
// remap.sample_ewa, remap.py:374-465) does: guard u/v, take the reference
// bbox from the Jacobian (affine_bbox), build the clamped ellipse
// (clamped_ellipse), weight each tap of a fixed 10x10 stencil around
// floor(u, v) with the Keys-cubic bc2 of sqrt(dr), read the background for
// taps outside the source rect, normalise by the weight sum and clamp at
// pixel_value_limit. Pixels with valid == 0 get the background directly.
//
// The stencil is the JAX package's top rung (cap 4). Its lower rungs
// (ewa_cap 2-3) and their cap-escalation check (remap.py:846-955) exist
// only to shrink the TPU's window DMA; they agree with cap 4 to within
// 0.25% of one tap weight by construction (remap.py:907-913), so only cap 4
// is computed here. The window ladder, plan_windows_t, the one-hot MXU
// column gather and its hi/lo bf16 split are likewise TPU-only.
//
// What bounds it on an H100: arithmetic, not memory. A pixel visits up to
// 100 taps, each ~20 FP32 operations plus one IEEE sqrt (the SFU), while
// its loads are mostly L1/L2 hits (neighbouring pixels share their taps).
// Unlike the separable sampler (LUT weights, ~2 multiply-adds per tap) it is
// ALU/SFU-bound.
//
// What the simple design does about it: one thread per output pixel on 32x8
// blocks; the ellipse is computed once per pixel, fy*abc_y and fy^2*abc_z
// once per tap row, and every weight stays in registers (never stored).
// Rows and columns outside the reference bbox and taps of zero weight are
// skipped: they add exactly nothing in the plain version. bc2 selects its
// piece's coefficients before evaluating one cubic, which gives the same
// bits as evaluating both pieces and selecting. Every other multiply and add
// runs in the plain version's order, so with nvcc --fmad=false the kernel
// rounds as the plain version does. Shared-memory tiles, tensor cores and
// TMA are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

constexpr int kEwaCap = 4;
constexpr int kTaps = 2 * kEwaCap + 2;  // 10 taps per axis

// Keys-cubic coefficients, background, clamp and source rect, passed by value.
struct EwaArgs {
    float p[4];       // bc2 piece for x < 1
    float q[4];       // bc2 piece for 1 <= x < 2
    float bg[4];
    float limit;
    int src_rect[4];  // x, y, w, h
};

namespace {

using gf::guard_uv;   // taps.cuh

// float -> int32 conversions saturate (cvt.rzi.s32.f32), as in remap._floor_i32.
__device__ __forceinline__ int floor_i32(float a) { return static_cast<int>(floorf(a)); }
__device__ __forceinline__ int ceil_i32(float a) { return static_cast<int>(ceilf(a)); }

// The Keys cubic at x = sqrt(dr) >= 0: p for x < 1, q for x < 2, else 0.
__device__ __forceinline__ float bc2(float x, const EwaArgs& a) {
    const bool lo = x < 1.0f;
    const float k0 = lo ? a.p[0] : a.q[0];
    const float k1 = lo ? a.p[1] : a.q[1];
    const float k2 = lo ? a.p[2] : a.q[2];
    const float k3 = lo ? a.p[3] : a.q[3];
    const float x2 = x * x;
    const float r = k0 + k1 * x + k2 * x2 + k3 * x2 * x;
    return x < 2.0f ? r : 0.0f;
}

template <typename T, int C>
__global__ void __launch_bounds__(256)
ewa_kernel(const T* __restrict__ img, int H, int W, const float* __restrict__ us,
           const float* __restrict__ vs, const float* __restrict__ jac,
           const uint8_t* __restrict__ valid, int oh, int ow, EwaArgs a,
           float* __restrict__ out) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= ow || row >= oh) return;
    const long long i = (long long)row * ow + col;
    float* o = out + i * C;

    if (!valid[i]) {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = a.bg[c];
        return;
    }

    const float u = guard_uv(us[i]);
    const float v = guard_uv(vs[i]);
    const float jx = jac[i * 4 + 0], jy = jac[i * 4 + 1];
    const float jz = jac[i * 4 + 2], jw = jac[i * 4 + 3];

    // affine_bbox (cpu_undistort.rs:272-277)
    const float tx = 2.0f * fmaxf(fmaxf(fabsf(jx + jy), fabsf(jx - jy)), 1.0f);
    const float ty = 2.0f * fmaxf(fmaxf(fabsf(jz + jw), fabsf(jz - jw)), 1.0f);
    const int x0 = floor_i32(u - tx), x1 = ceil_i32(u + tx);
    const int y0 = floor_i32(v - ty), y1 = ceil_i32(v + ty);

    // clamped_ellipse (cpu_undistort.rs:279-314)
    const float f0 = fabsf(jx * jw - jy * jz);
    const float f = fmaxf(f0 * f0, 0.1f);
    const float ea = (jz * jz + jw * jw) / f;
    const float eb = -2.0f * (jx * jz + jy * jw) / f;
    const float ec = (jx * jx + jy * jy) / f;
    const float vx = ec - ea;
    const float vy = -eb;
    const float lv = sqrtf(vx * vx + vy * vy);
    const float v0 = lv > 0.01f ? vx / (lv == 0.0f ? 1.0f : lv) : 1.0f;
    const float cc = sqrtf(fmaxf(1.0f + v0, 0.0f) / 2.0f);
    float s = sqrtf(fmaxf(1.0f - v0, 0.0f) / 2.0f);
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
    a0 = fminf(a0, 1.0f);
    c0 = fminf(c0, 1.0f);
    const float sn = -s;
    const float abc_x = a0 * cc * cc - b0 * cc * sn + c0 * sn * sn;
    const float abc_y = 2.0f * a0 * cc * sn + b0 * cc * cc - b0 * sn * sn - 2.0f * c0 * cc * sn;
    const float abc_z = a0 * sn * sn + b0 * cc * sn + c0 * cc * cc;

    const int base_x = floor_i32(u) - kEwaCap;
    const int base_y = floor_i32(v) - kEwaCap;
    const int srx = a.src_rect[0], sry = a.src_rect[1];
    const int srx1 = srx + a.src_rect[2], sry1 = sry + a.src_rect[3];

    float total[C];
#pragma unroll
    for (int c = 0; c < C; ++c) total[c] = 0.0f;
    float sum_div = 0.0f;

    // row of taps major, column minor (remap.py:439-463)
#pragma unroll 1
    for (int typ = 0; typ < kTaps; ++typ) {
        const int in_y = base_y + typ;
        if (in_y < y0 || in_y > y1) continue;
        const float fy = static_cast<float>(in_y) - v;
        const float fy2 = fy * abc_y;
        const float fy3 = fy * fy * abc_z;
        const bool row_ok = in_y >= sry && in_y < sry1;
        const int yc = in_y < 0 ? 0 : (in_y >= H ? H - 1 : in_y);
        const T* src_row = img + (long long)yc * W * C;
#pragma unroll
        for (int txp = 0; txp < kTaps; ++txp) {
            const int in_x = base_x + txp;
            if (in_x < x0 || in_x > x1) continue;
            const float fx = static_cast<float>(in_x) - u;
            const float dr = fx * fx * abc_x + fx * fy2 + fy3;
            const float k = bc2(sqrtf(fmaxf(dr, 0.0f)), a);
            if (k == 0.0f) continue;
            const bool ok = row_ok && in_x >= srx && in_x < srx1;
            const int xc = in_x < 0 ? 0 : (in_x >= W ? W - 1 : in_x);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float px = ok ? static_cast<float>(src_row[(long long)xc * C + c]) : a.bg[c];
                total[c] = total[c] + k * px;
            }
            sum_div = sum_div + k;
        }
    }
    const float d = sum_div == 0.0f ? 1.0f : sum_div;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = fminf(total[c] / d, a.limit);
}

template <typename T, int C>
void launch(const void* img, int H, int W, const void* u, const void* v, const void* jac,
            const void* valid, int oh, int ow, const EwaArgs& a, void* out, cudaStream_t stream) {
    const dim3 block(32, 8);
    const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
    ewa_kernel<T, C><<<grid, block, 0, stream>>>(
        static_cast<const T*>(img), H, W, static_cast<const float*>(u),
        static_cast<const float*>(v), static_cast<const float*>(jac),
        static_cast<const uint8_t*>(valid), oh, ow, a, static_cast<float*>(out));
}

template <typename T>
bool dispatch_channels(int C, const void* img, int H, int W, const void* u, const void* v,
                       const void* jac, const void* valid, int oh, int ow, const EwaArgs& a,
                       void* out, cudaStream_t s) {
    switch (C) {
        case 1: launch<T, 1>(img, H, W, u, v, jac, valid, oh, ow, a, out, s); return true;
        case 2: launch<T, 2>(img, H, W, u, v, jac, valid, oh, ow, a, out, s); return true;
        case 3: launch<T, 3>(img, H, W, u, v, jac, valid, oh, ow, a, out, s); return true;
        case 4: launch<T, 4>(img, H, W, u, v, jac, valid, oh, ow, a, out, s); return true;
        default: return false;
    }
}

}  // namespace

// img: (H, W, C) channels-last, dtype 0 = uint8, 1 = uint16, 2 = float32;
// u, v: float32 (oh, ow); jac: float32 (oh, ow, 4) = du/dx, du/dy, dv/dx,
// dv/dy; valid: uint8/bool (oh, ow); out: float32 (oh, ow, C). Returns -1 for
// an unsupported dtype/C, else cudaGetLastError() after the launch.
extern "C" int gf_ewa(const void* img, int dtype, int H, int W, int C, const void* u,
                      const void* v, const void* jac, const void* valid, int oh, int ow,
                      EwaArgs args, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool ok = false;
    switch (dtype) {
        case 0: ok = dispatch_channels<uint8_t>(C, img, H, W, u, v, jac, valid, oh, ow, args, out, s); break;
        case 1: ok = dispatch_channels<uint16_t>(C, img, H, W, u, v, jac, valid, oh, ow, args, out, s); break;
        case 2: ok = dispatch_channels<float>(C, img, H, W, u, v, jac, valid, oh, ow, args, out, s); break;
        default: break;
    }
    if (!ok) return -1;
    return static_cast<int>(cudaGetLastError());
}
