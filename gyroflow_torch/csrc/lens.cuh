// Shared __device__ lens math for the gyroflow_torch kernels.
//
// The same float32 operations, in the same order, as
// gyroflow_tpu/ops/distortion_models.py (_atanf and every model's
// distort_xy) and gyroflow_tpu/ops/remap.py (_forward_refraction,
// rotate_and_distort_core), and as their torch twins in gyroflow_torch/ops/.
// Built without fast math and with --fmad=false, so every multiply and add
// rounds on its own, as the elementwise torch ops do: sqrtf and '/' are
// IEEE-exact. Where the torch twin divides by a Python number (a plane size,
// 1 + tan^2), torch on the card multiplies by the number's float32
// reciprocal, and so does the code here; a Python number is rounded to
// float32 from its double (f32 below), as torch and JAX round it.
//
// Each kernel is specialised on the main distortion model (MODEL, a ModelId:
// the id the fisheye render takes compiles to the code it always had), and
// its digital-lens form chooses the digital lens at run time with a switch
// (distort_xy_switch) that is uniform across the launch. The fused kernel's
// form for any lens chooses both at run time through distort_xy_any, the
// same switch kept out of line: inlined twice into each of its 36
// dtype/channel/tap instantiations it would multiply their build time. That
// call takes CoordParams by reference, so the kernel declares it
// __grid_constant__: otherwise each thread copies the struct to its stack
// (a digital step called that way made the coords kernel 6x slower, PERF.md).
//
// Sony mesh correction and focal-plane distortion (mesh_correction,
// focal_plane_distortion: gyroflow_tpu/ops/mesh.py and its torch twin
// gyroflow_torch/ops/mesh.py) run inside project_point's MESH form, after the
// lens centre and before the digital lens, inlined: the coords kernel's
// mesh form takes them, and no other kernel (the JAX package gates mesh
// out of its self-contained and fused kernels). They read the packed block
// that cuda_coords.pack_mesh appends to the frame's mesh buffer (MeshArgs):
// the launch-uniform constants, computed once on the host with the float32
// operations the plain stage runs, the focal-plane shears, and each x
// segment's grid rows as one 16-byte (a, b, c, d) load a row. The plain
// version sums one-hot segment terms; here segment fi is indexed directly
// and the sum's +0.0 (which turns -0.0 into +0.0) is added once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "aten.cuh"

namespace gf {

// KernelParamsFlags (gyroflow_torch/ops/kernel_params.py)
constexpr int HORIZONTAL_RS = 16;
constexpr int FRAMEBUFFER_INVERTED = 128;
constexpr int HAS_IBIS_DATA = 256;
constexpr int HAS_MESH_DATA = 512;
constexpr int HAS_FPD_DATA = 1024;
constexpr int ANY_UNDERWATER = 2048;
constexpr int kMaxGrid = 9;        // core/splines.py MAX_GRID_SIZE

// Distortion model ids: the JAX registry's order (distortion_models.py:691,
// MODEL_IDS; gyroflow_torch.ops.distortion_models.MODEL_IDS).
enum ModelId : int {
    kOpencvFisheye = 0,
    kOpencvStandard,
    kPoly3,
    kPoly5,
    kPtlens,
    kInsta360,
    kSony,
    kGenericPolynomial,
    kGopro,
    kGoproSuperview,
    kGopro6Superview,
    kGoproHyperview,
    kGoproWarp,
    kDigitalStretch,
    kNumModels,
    kAnyModel = -1,   // the main model chosen at run time
};

// Dynamic operands of the projection, in pallas_coords.pack_params order
// (k, f, c, translation3d[:3], r_limit, light_refraction_coefficient, input
// stretch h/v, digital_lens_params), then the plane sizes the digital models
// read (LensParams, remap.py:62-67). Passed to the kernel by value.
struct CoordParams {
    float k[12];
    float f[2];
    float c[2];
    float t3d[3];
    float r_limit;
    float lrc;
    float stretch_h;
    float stretch_v;
    float dlp[16];
    float width;
    float height;
    float output_width;
    float output_height;
};

// The mesh stage's operands (cuda_coords.mesh_args). data: the frame's
// packed mesh buffer on the card (cuda_coords.pack_mesh: the reference
// layout of core/splines.py, then at block_offset, 16-byte aligned, the
// block read here; the plain stage reads only the reference part); gw, gh:
// cfg.mesh_grid; mus: the natural-spline recurrence's mus for gh rows (they
// depend only on gh); inv_*: the float32 reciprocals torch multiplies by
// when it divides by a Python number (the grid's gw - 1 and gh - 1, the
// plane's width and height).
struct MeshArgs {
    const float* data;
    int block_offset;
    int gw, gh;
    float mus[kMaxGrid];
    float inv_gw1, inv_gh1;
    float inv_width, inv_height;
};

// The packed block, in float4s from data + block_offset:
//   [0] size_x, size_y, ox, oy       the mesh header
//   [1] span_x, span_y, band, h      (ox + crop_w) - ox, (oy + crop_h) - oy,
//                                    size_y / 8, size_y / (gh - 1)
//   [2] inv_h, alpha_h, h_3, three_h 1 / h, 3 * (1 / h), h / 3, 3 * h
//   [3 .. 6]                         the 8 focal-plane row shears (x, y)
//   [kMeshRows + (channel * (gw - 1) + fi) * gh + j]
//                                    a, b, c, d of grid row j's x spline on
//                                    segment fi
constexpr int kMeshShears = 3;
constexpr int kMeshRows = 7;

// A Python float as torch and JAX take it into float32 arithmetic.
__host__ __device__ constexpr float f32(double d) { return static_cast<float>(d); }

// Cephes-style float32 arctangent (distortion_models.py:64). Not atanf: the
// reference's numbers come from this polynomial.
__device__ __forceinline__ float atanf_cephes(float x) {
    const float sign = x < 0.0f ? -1.0f : 1.0f;
    const float ax = fabsf(x);
    const bool big = ax > 2.414213562373095f;           // tan(3*pi/8)
    const bool mid = (ax > 0.4142135623730950f) && !big;  // tan(pi/8)
    // -1 / ax above tan(3*pi/8), (ax - 1) / (ax + 1) above tan(pi/8): one
    // IEEE division for both, of the operands the range selects (the same
    // quotient bits as dividing each and selecting one)
    const float q = (big ? -1.0f : ax - 1.0f) / (big ? ax : ax + 1.0f);
    const float z = (big || mid) ? q : ax;
    const float y0 = big ? 1.57079632679489662f : (mid ? 0.785398163397448310f : 0.0f);
    const float z2 = z * z;
    const float p = ((8.05374449538e-2f * z2 - 1.38776856032e-1f) * z2
                     + 1.99777106478e-1f) * z2 - 3.33329491539e-1f;
    return sign * (y0 + (p * z2 * z + z));
}

__device__ __forceinline__ bool k4_zero(const float* k) {
    return k[0] == 0.0f && k[1] == 0.0f && k[2] == 0.0f && k[3] == 0.0f;
}

// ---- the physical models: (x, y, z) camera space -> normalised (u, v) ----

// OpenCV fisheye forward model (distortion_models.py:129).
__device__ __forceinline__ void fisheye_distort(float x, float y, float z, const float* k,
                                                float& u, float& v) {
    x = x / z;
    y = y / z;
    const float r = sqrtf(x * x + y * y);
    const float theta = atanf_cephes(r);
    const float theta2 = theta * theta;
    const float theta4 = theta2 * theta2;
    const float theta6 = theta4 * theta2;
    const float theta8 = theta4 * theta4;
    const float theta_d = theta * (1.0f + k[0] * theta2 + k[1] * theta4
                                   + k[2] * theta6 + k[3] * theta8);
    const bool k_zero = k[0] == 0.0f && k[1] == 0.0f && k[2] == 0.0f && k[3] == 0.0f;
    const float scale = (k_zero || r == 0.0f) ? 1.0f : theta_d / r;
    u = x * scale;
    v = y * scale;
}

// OpenCV standard (distortion_models.py:167).
__device__ __forceinline__ void opencv_standard_distort(float x, float y, float z,
                                                        const float* k, float& u, float& v) {
    x = x / z;
    y = y / z;
    const float r2 = x * x + y * y;
    const float r4 = r2 * r2;
    const float r6 = r4 * r2;
    const float a1 = 2.0f * x * y;
    const float a2 = r2 + 2.0f * x * x;
    const float a3 = r2 + 2.0f * y * y;
    const float cdist = 1.0f + k[0] * r2 + k[1] * r4 + k[4] * r6;
    const float icdist2 = 1.0f / (1.0f + k[5] * r2 + k[6] * r4 + k[7] * r6);
    u = x * cdist * icdist2 + k[2] * a1 + k[3] * a2 + k[8] * r2 + k[9] * r4;
    v = y * cdist * icdist2 + k[2] * a3 + k[3] * a1 + k[10] * r2 + k[11] * r4;
}

// LensFun poly3 (distortion_models.py:223).
__device__ __forceinline__ void poly3_distort(float x, float y, float z, const float* k,
                                              float& u, float& v) {
    x = x / z;
    y = y / z;
    const float poly2 = k[0] * (x * x + y * y) + 1.0f;
    u = x * poly2;
    v = y * poly2;
}

// LensFun poly5 (distortion_models.py:246).
__device__ __forceinline__ void poly5_distort(float x, float y, float z, const float* k,
                                              float& u, float& v) {
    x = x / z;
    y = y / z;
    const float ru2 = x * x + y * y;
    const float poly4 = 1.0f + k[0] * ru2 + k[1] * ru2 * ru2;
    u = x * poly4;
    v = y * poly4;
}

// LensFun ptlens (distortion_models.py:270).
__device__ __forceinline__ void ptlens_distort(float x, float y, float z, const float* k,
                                               float& u, float& v) {
    x = x / z;
    y = y / z;
    const float ru2 = x * x + y * y;
    const float r = sqrtf(ru2);
    const float poly3 = k[0] * ru2 * r + k[1] * ru2 + k[2] * r + 1.0f;
    u = x * poly3;
    v = y * poly3;
}

// Insta360 unified sphere (distortion_models.py:284).
__device__ __forceinline__ void insta360_distort(float x, float y, float z, const float* k,
                                                 float& u, float& v) {
    const float k1 = k[0], k2 = k[1], k3 = k[2], p1 = k[3], p2 = k[4], xi = k[5];
    const float ln = sqrtf(x * x + y * y + z * z);
    const float d = (z / ln) + xi;
    const float xs = (x / ln) / d;
    const float ys = (y / ln) / d;
    const float r2 = xs * xs + ys * ys;
    const float r4 = r2 * r2;
    const float r6 = r4 * r2;
    const float radial = 1.0f + k1 * r2 + k2 * r4 + k3 * r6;
    u = xs * radial + 2.0f * p1 * xs * ys + p2 * (r2 + 2.0f * xs * xs);
    v = ys * radial + 2.0f * p2 * xs * ys + p1 * (r2 + 2.0f * ys * ys);
}

// Sony: a polynomial in theta with k0 as scale (distortion_models.py:353).
__device__ __forceinline__ void sony_distort(float x, float y, float z, const float* k,
                                             float& u, float& v) {
    x = x / z;
    y = y / z;
    const float r = sqrtf(x * x + y * y);
    const float t = atanf_cephes(r);
    const float t2 = t * t;
    const float t3 = t2 * t;
    const float t4 = t2 * t2;
    const float t5 = t2 * t3;
    const float t6 = t3 * t3;
    const float theta_d = t * k[0] + t2 * k[1] + t3 * k[2] + t4 * k[3] + t5 * k[4] + t6 * k[5];
    const float scale = (k4_zero(k) || r == 0.0f) ? 1.0f : theta_d / r;
    u = x * scale;
    v = y * scale;
}

// Generic polynomial, theta^1..theta^12 (distortion_models.py:403); its
// zero test covers all 12 coefficients.
__device__ __forceinline__ void generic_poly_distort(float x, float y, float z, const float* k,
                                                     float& u, float& v) {
    x = x / z;
    y = y / z;
    const float r = sqrtf(x * x + y * y);
    const float t = atanf_cephes(r);
    float theta_d = 0.0f;
    float tp = t;
    bool k_zero = true;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
        theta_d = theta_d + tp * k[i];
        tp = tp * t;
        k_zero = k_zero && k[i] == 0.0f;
    }
    const float scale = (k_zero || r == 0.0f) ? 1.0f : theta_d / r;
    u = x * scale;
    v = y * scale;
}

// GoPro native POLY model (distortion_models.py:424-475): theta, then pp
// with POLY(pp) = theta by at most 10 Newton steps.
// _GOPRO_TMAX, math.tan(_GOPRO_TMAX) and the reciprocal of 1 + tan^2 (by
// which torch on the card multiplies where the model divides), as float32
constexpr double kGoproTanTmaxD = 57.14902157208012;
constexpr float kGoproTmax = f32(1.5533);
constexpr float kGoproTanTmax = f32(kGoproTanTmaxD);
constexpr float kGoproInvSec2 = 1.0f / f32(1.0 + kGoproTanTmaxD * kGoproTanTmaxD);

__device__ __forceinline__ float gopro_poly_eval(float pp, const float* k) {
    return k[0] + pp * (k[1] + pp * (k[2] + pp * (k[3] + pp * (k[4] + pp * (k[5] + pp * k[6])))));
}

__device__ __forceinline__ float gopro_poly_deriv(float pp, const float* k) {
    return k[1] + pp * (2.0f * k[2] + pp * (3.0f * k[3] + pp * (4.0f * k[4]
                                                             + pp * (5.0f * k[5] + pp * (6.0f * k[6])))));
}

__device__ __forceinline__ void gopro_distort(float x, float y, float z, const float* k,
                                              float& u, float& v) {
    x = x / z;
    y = y / z;
    const float r = sqrtf(x * x + y * y);
    const float tt = kGoproTanTmax;
    const float theta = r < tt ? atanf_cephes(clamp_max_t(r, tt))
                               : kGoproTmax + (r - tt) * kGoproInvSec2;
    // _gopro_poly_invert. A done lane's pp never changes again, so it leaves
    // the loop (a NaN lane is never done and runs all 10 steps): a warp runs
    // the steps of its slowest lane.
    float pp = (theta - k[0]) / k[1];
#pragma unroll 1
    for (int i = 0; i < 10; ++i) {
        const float d = gopro_poly_deriv(pp, k);
        const bool flat = fabsf(d) < f32(1e-12);
        if (flat) break;
        const float fix = (gopro_poly_eval(pp, k) - theta) / d;
        pp = pp - fix;
        if (fabsf(fix) < f32(1e-7)) break;
    }
    const float r_norm = k[1] * pp;
    const bool small = r < f32(1e-9);
    float scale = small ? 1.0f : r_norm / (small ? 1.0f : r);
    if (k[1] == 0.0f) scale = 1.0f;
    u = x * scale;
    v = y * scale;
}

// ---- the digital lenses: pixel coordinates -> pixel coordinates ----------

// _fixed_point_invert (distortion_models.py:483): at most 12 steps; a lane
// leaves once done (its p never changes again), a NaN lane runs all 12.
template <typename Fn>
__device__ __forceinline__ void fixed_point_invert(const Fn& fn, float tx, float ty, float& px,
                                                   float& py) {
    px = tx;
    py = ty;
#pragma unroll 1
    for (int i = 0; i < 12; ++i) {
        float fx, fy;
        fn(px, py, fx, fy);
        const float dx = fx - tx;
        const float dy = fy - ty;
        if (fabsf(dx) < f32(1e-6) && fabsf(dy) < f32(1e-6)) break;   // done: p stays
        px = px - dx;
        py = py - dy;
    }
}

struct SuperviewFn {   // _superview_fn
    __device__ void operator()(float x, float y, float& fx, float& fy) const {
        const float x2 = x * x;
        const float y2 = y * y;
        fx = x * (f32(1.2100393) + x2 * (f32(-1.2758402) + x2 * f32(1.7751845)));
        fy = y * (f32(0.9364505) + (f32(0.4465308) - f32(0.7683315) * y2) * y2
                  + (f32(-0.3574087) + f32(1.1584653) * y2 + f32(0.3529348) * x2) * x2);
    }
};

struct Superview6Fn {  // _superview6_fn
    __device__ void operator()(float x, float y, float& fx, float& fy) const {
        x = x * (1.0f - f32(0.48) * fabsf(x));
        fx = x * (f32(0.943396) * (1.0f + f32(0.157895) * fabsf(x)));
        fy = y * (f32(0.943396) * (1.0f + f32(0.060000) * fabsf(y * 2.0f)));
    }
};

struct HyperviewFn {   // _hyperview_fn
    __device__ void operator()(float x, float y, float& fx, float& fy) const {
        const float x2 = x * x;
        const float y2 = y * y;
        fx = x * (f32(1.5805143) + x2 * (f32(-8.1668825) + x2 * (f32(74.5198746) + x2 * (
                 f32(-451.5002441) + x2 * (f32(1551.2922363) + x2 * (f32(-2735.5422363)
                 + x2 * f32(1923.1572266)))))) + y2 * f32(-0.1086027));
        fy = y * (f32(1.0238225) + y2 * f32(-0.1025671) + x2 * (f32(-0.2639930)
                                                               + x2 * f32(0.2979266)));
    }
};

struct GoproWarpFn {   // _gopro_warp_fn(dl); torch's clamp keeps a NaN
    const float* dl;
    __device__ void operator()(float u, float v, float& fx, float& fy) const {
        const float x = clamp_t(u, -0.5f, 0.5f);
        const float y = clamp_t(v, -0.5f, 0.5f);
        const float x2 = x * x;
        const float y2 = y * y;
        const float poly_x = dl[0] + x2 * (dl[1] + x2 * (dl[2] + x2 * (dl[3] + x2 * (dl[4]
                             + x2 * (dl[5] + x2 * dl[6])))));
        fx = x * (poly_x + dl[7] * y2) + (u - x);
        fy = y * (dl[8] + dl[9] * y2 + dl[10] * y2 * y2 + x2 * (dl[11] + dl[12] * y2
                                                               + dl[13] * x2)) + (v - y);
    }
};

// superview / superview6 / hyperview distort_xy (distortion_models.py:513,
// :535, :559): centred unit coordinates, x scaled by x_mul (1: none), the
// fixed point of Fn, back to pixels.
template <typename Fn>
__device__ __forceinline__ void digital_distort(float x, float y, const CoordParams& p,
                                                float x_mul, float& u, float& v) {
    float cu = x * (1.0f / p.width) - 0.5f;
    const float cv = y * (1.0f / p.height) - 0.5f;
    if (x_mul != 1.0f) cu = cu * x_mul;
    float px, py;
    fixed_point_invert(Fn{}, cu, cv, px, py);
    u = (px + 0.5f) * p.width;
    v = (py + 0.5f) * p.height;
}

// gopro_warp (distortion_models.py:591): a point whose inverse misses by
// more than 0.02 gets the reference's -99999 sentinel (background).
__device__ __forceinline__ void gopro_warp_distort(float x, float y, const CoordParams& p,
                                                   float& u, float& v) {
    const float* dl = p.dlp;
    const float factor = dl[14] != 0.0f ? dl[14] : 1.0f;
    const float cu = x * (1.0f / p.width) - 0.5f;
    const float cv = y * (1.0f / p.height) - 0.5f;
    const GoproWarpFn fn{dl};
    const float tx = cu * factor;
    float px, py, rx, ry;
    fixed_point_invert(fn, tx, cv, px, py);
    fn(px, py, rx, ry);
    const bool bad = fabsf(rx - tx) > f32(0.02) || fabsf(ry - cv) > f32(0.02);
    u = bad ? -99999.0f : (px + 0.5f) * p.width;
    v = bad ? -99999.0f : (py + 0.5f) * p.height;
}

// ---- dispatch ------------------------------------------------------------

// model M's distort_xy(x, y, z, p) (distortion_models.py:674-689).
template <int M>
__device__ __forceinline__ void distort_xy(float x, float y, float z, const CoordParams& p,
                                           float& u, float& v) {
    static_assert(M >= 0 && M < kNumModels, "a ModelId");
    if constexpr (M == kOpencvFisheye) fisheye_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kOpencvStandard) opencv_standard_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kPoly3) poly3_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kPoly5) poly5_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kPtlens) ptlens_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kInsta360) insta360_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kSony) sony_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kGenericPolynomial) generic_poly_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kGopro) gopro_distort(x, y, z, p.k, u, v);
    else if constexpr (M == kGoproSuperview)
        digital_distort<SuperviewFn>(x, y, p, f32(1.333333333), u, v);
    else if constexpr (M == kGopro6Superview) digital_distort<Superview6Fn>(x, y, p, 1.0f, u, v);
    else if constexpr (M == kGoproHyperview)
        digital_distort<HyperviewFn>(x, y, p, f32(1.555555555), u, v);
    else if constexpr (M == kGoproWarp) gopro_warp_distort(x, y, p, u, v);
    else {   // kDigitalStretch
        u = x * p.dlp[0];
        v = y * p.dlp[1];
    }
}

// distort_xy of a model chosen at run time (any id, as get_model takes
// any).
__device__ __forceinline__ void distort_xy_switch(int model, float x, float y, float z,
                                                  const CoordParams& p, float& u, float& v) {
    switch (model) {   // aligned with distort_xy's chain, fisheye last
        case kOpencvStandard: distort_xy<kOpencvStandard>(x, y, z, p, u, v); break;
        case kPoly3: distort_xy<kPoly3>(x, y, z, p, u, v); break;
        case kPoly5: distort_xy<kPoly5>(x, y, z, p, u, v); break;
        case kPtlens: distort_xy<kPtlens>(x, y, z, p, u, v); break;
        case kInsta360: distort_xy<kInsta360>(x, y, z, p, u, v); break;
        case kSony: distort_xy<kSony>(x, y, z, p, u, v); break;
        case kGenericPolynomial: distort_xy<kGenericPolynomial>(x, y, z, p, u, v); break;
        case kGopro: distort_xy<kGopro>(x, y, z, p, u, v); break;
        case kGoproSuperview: distort_xy<kGoproSuperview>(x, y, z, p, u, v); break;
        case kGopro6Superview: distort_xy<kGopro6Superview>(x, y, z, p, u, v); break;
        case kGoproHyperview: distort_xy<kGoproHyperview>(x, y, z, p, u, v); break;
        case kGoproWarp: distort_xy<kGoproWarp>(x, y, z, p, u, v); break;
        case kDigitalStretch: distort_xy<kDigitalStretch>(x, y, z, p, u, v); break;
        default: distort_xy<kOpencvFisheye>(x, y, z, p, u, v); break;
    }
}

// The same, out of line: see the note at the top.
inline __device__ __noinline__ void distort_xy_any(int model, float x, float y, float z,
                                                   const CoordParams& p, float& u, float& v) {
    distort_xy_switch(model, x, y, z, p, u, v);
}

// Calls launch.run<M>() for M == model; false for an id out of range.
template <int M = 0, typename L>
bool with_model(int model, const L& launch) {
    if constexpr (M < kNumModels) {
        if (model == M) {
            launch.template run<M>();
            return true;
        }
        return with_model<M + 1>(model, launch);
    } else {
        return false;
    }
}

// ---- Sony mesh correction and focal-plane distortion ----------------------

// clip(floor(t) as int32, 0, n - 2): the cast saturates, NaN -> 0, as
// torch's clamped cast and XLA's do.
__device__ __forceinline__ int mesh_segment(float t, int n) {
    const int i = __float2int_rz(floorf(t));
    return i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
}

// The mesh block's launch-uniform constants (MeshArgs), three 16-byte
// loads that every thread of the launch makes at the same addresses.
struct MeshConsts {
    float4 hdr;     // size_x, size_y, ox, oy
    float4 span;    // span_x, span_y, band, h
    float4 spl;     // inv_h, alpha_h, h_3, three_h
};

__device__ __forceinline__ const float4* mesh_block(const MeshArgs& ma) {
    return reinterpret_cast<const float4*>(ma.data + ma.block_offset);
}

__device__ __forceinline__ MeshConsts mesh_consts(const MeshArgs& ma) {
    const float4* blk = mesh_block(ma);
    return {__ldg(blk), __ldg(blk + 1), __ldg(blk + 2)};
}

// The y spline's segment at the pixel's mesh y, the same for both channels
// (mesh.py _spline_eval: fi, the offset in the segment, the edge tests).
struct MeshSeg {
    float x;          // the pixel's mesh y
    float dx;         // x - size * fi / (n - 1)
    int fi;
    bool below;       // x <= 0: the first piece's line
    bool above;       // x >= size: the last piece's line (wins over below)
};

__device__ __forceinline__ MeshSeg mesh_seg(float x, float size, const MeshArgs& ma) {
    MeshSeg s;
    s.x = x;
    s.fi = mesh_segment((static_cast<float>(ma.gh - 1) * x) / size, ma.gh);
    s.dx = x - (size * static_cast<float>(s.fi)) * ma.inv_gh1;
    s.below = x <= 0.0f;
    s.above = x >= size;
    return s;
}

// One channel of BivariateSpline::interpolate (mesh.py _bivariate): the x
// splines' segment fi of each grid row at dx (rows: that segment's packed
// rows), then the natural spline through them over [0, size_y]
// (_solve_spline: mus from the host, then zs, then c backwards; b and d only
// of the piece read) evaluated at the y segment s (_spline_eval). The
// forward pass computes each row's a[j] as its row arrives and the
// recurrence's zs[j - 1] as soon as a[j] is known, and keeps only the a[j]
// an evaluation reads (segment fi's, and the edge pieces'); the backward
// pass keeps the c[j] the same way. Only a pixel beyond the grid's edge
// evaluates an edge piece. GH: the grid's height at compile time (no
// guard, the edge pieces at fixed rows), or 0 to take ma.gh at run time.
template <int GH>
__device__ __forceinline__ float mesh_channel(const MeshArgs& ma, const MeshConsts& k,
                                              const float4* rows, float dx, float dx2,
                                              const MeshSeg& s) {
    constexpr int N = GH > 0 ? GH : kMaxGrid;
    const int n = GH > 0 ? GH : ma.gh;
    const int fi = s.fi;
    const float h = k.span.w, inv_h = k.spl.x, alpha_h = k.spl.y, h_3 = k.spl.z,
                three_h = k.spl.w;
    float zs[kMaxGrid];
    zs[0] = 0.0f;
    float am2 = 0.0f, am1 = 0.0f;                 // a[j - 2], a[j - 1]
    float a_f = 0.0f, a_f1 = 0.0f;                // a[fi], a[fi + 1]
    float a_0 = 0.0f, a_1 = 0.0f;                 // a[0], a[1]
    float a_l = 0.0f, a_l1 = 0.0f;                // a[n - 2], a[n - 1]
#pragma unroll
    for (int j = 0; j < N; ++j) {
        if (GH > 0 || j < n) {
            const float4 q = __ldg(rows + j);
            const float aj = (q.x + q.y * dx + q.z * dx2 + q.w * dx2 * dx) + 0.0f;
            if (j >= 2) {      // _solve_spline's step i = j - 1
                const float alpha_i = alpha_h * ((aj - 2.0f * am1) + am2);
                zs[j - 1] = (alpha_i * inv_h - zs[j - 2]) * ma.mus[j - 1];
            }
            a_f = j == fi ? aj : a_f;
            a_f1 = j == fi + 1 ? aj : a_f1;
            if (j == 0) a_0 = aj;
            if (j == 1) a_1 = aj;
            a_l = j == n - 2 ? aj : a_l;
            a_l1 = j == n - 1 ? aj : a_l1;
            am2 = am1;
            am1 = aj;
        }
    }
    float cn = 0.0f;                              // c[j + 1]; c[n - 1] is 0
    float c_f = 0.0f, c_f1 = 0.0f;                // c[fi], c[fi + 1]
    float c_1 = 0.0f, c_l = 0.0f;                 // c[1], c[n - 2]
#pragma unroll
    for (int j = N - 2; j >= 0; --j) {
        if (GH > 0 || j <= n - 2) {
            const float cj = zs[j] - ma.mus[j] * cn;
            c_f1 = j == fi ? cn : c_f1;
            c_f = j == fi ? cj : c_f;
            c_l = j == n - 2 ? cj : c_l;
            if (j == 1) c_1 = cj;
            cn = cj;
        }
    }
    const float c_0 = cn;
    if (s.above) {       // piece n - 2's line beyond size_y
        const float c1 = 0.0f;
        const float bl = (a_l1 - a_l) * inv_h - h_3 * (c1 + 2.0f * c_l);
        const float dl = (c1 - c_l) / three_h;
        const float slope = bl + 2.0f * c_l * h + 3.0f * dl * h * h;
        return a_l1 + slope * (s.x - k.hdr.y);
    }
    if (s.below) {       // piece 0's line below 0
        const float b0 = (a_1 - a_0) * inv_h - h_3 * (c_1 + 2.0f * c_0);
        return a_0 + b0 * s.x;
    }
    // b[fi], d[fi] of splines.rs:117-121
    const float sb = (a_f1 - a_f) * inv_h - h_3 * (c_f1 + 2.0f * c_f);
    const float sd = (c_f1 - c_f) / three_h;
    const float dx_y = s.dx;
    return (a_f + sb * dx_y + c_f * dx_y * dx_y + sd * dx_y * dx_y * dx_y) + 0.0f;
}

template <int GH>
__device__ __forceinline__ void mesh_correction(float& u, float& v, const MeshArgs& ma,
                                                const MeshConsts& k, const CoordParams& p,
                                                int flags) {
    const float size_x = k.hdr.x, size_y = k.hdr.y, ox = k.hdr.z, oy = k.hdr.w;
    const float span_x = k.span.x, span_y = k.span.y;
    const bool inv = flags & FRAMEBUFFER_INVERTED;
    if (inv) v = p.height - v;
    const float mu = ((u - 0.0f) * span_x) * ma.inv_width + ox;
    const float mv = ((v - 0.0f) * span_y) * ma.inv_height + oy;
    const int fi = mesh_segment((static_cast<float>(ma.gw - 1) * mu) / size_x, ma.gw);
    const float dx = mu - (size_x * static_cast<float>(fi)) * ma.inv_gw1;
    const float dx2 = dx * dx;
    // the segment from the grid height read at run time: taken from GH, the
    // segments of the mesh form of 4 rows or more came out off the plain
    // version's on the card (the card tests hold every height)
    const MeshSeg s = mesh_seg(mv, size_y, ma);
    const int gh = GH > 0 ? GH : ma.gh;
    const float4* rows = mesh_block(ma) + kMeshRows + fi * gh;
    const float nx = mesh_channel<GH>(ma, k, rows, dx, dx2, s);
    const float ny = mesh_channel<GH>(ma, k, rows + (ma.gw - 1) * gh, dx, dx2, s);
    u = ((nx - ox) * p.width) / span_x + 0.0f;
    v = ((ny - oy) * p.height) / span_y + 0.0f;
    if (inv) v = p.height - v;
}

// apply_focal_plane_distortion (mesh.py) with sign -1: the row band's shear
// times its offset in the band, plus the full shear of every band above.
__device__ __forceinline__ void focal_plane_distortion(float& u, float& v, const MeshArgs& ma,
                                                       const MeshConsts& k,
                                                       const CoordParams& p, int flags) {
    const float ox = k.hdr.z, oy = k.hdr.w;
    const float span_x = k.span.x, span_y = k.span.y, band = k.span.z;
    const bool inv = flags & FRAMEBUFFER_INVERTED;
    if (inv) v = p.height - v;
    float mu = ((u - 0.0f) * span_x) * ma.inv_width + ox;
    float mv = ((v - 0.0f) * span_y) * ma.inv_height + oy;
    float t = clamp_t(floorf(mv / band), 0.0f, 7.0f);
    t = t != t ? 0.0f : t;
    const int idx = static_cast<int>(t);
    const float delta = mv - band * static_cast<float>(idx);
    const float4* sh4 = mesh_block(ma) + kMeshShears;
    const float* shear = reinterpret_cast<const float*>(sh4);
    float dx = 0.0f + __ldg(shear + 2 * idx) * delta;
    float dy = 0.0f + __ldg(shear + 2 * idx + 1) * delta;
    float sx[8], sy[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 s = __ldg(sh4 + q);
        sx[2 * q] = s.x;
        sy[2 * q] = s.y;
        sx[2 * q + 1] = s.z;
        sy[2 * q + 1] = s.w;
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) {
        if (j < idx) {
            dx = dx + sx[j] * band;
            dy = dy + sy[j] * band;
        }
    }
    mu = mu + -1.0f * dx;
    mv = mv + -1.0f * dy;
    u = ((mu - ox) * p.width) / span_x + 0.0f;
    v = ((mv - oy) * p.height) / span_y + 0.0f;
    if (inv) v = p.height - v;
}

// ---- the projection --------------------------------------------------------

// Underwater forward refraction scaling of w (remap.py:70).
__device__ __forceinline__ float forward_refraction(float x, float y, float w, float lrc) {
    const bool active = (lrc != 1.0f) && (lrc > 0.0f) && (w != 0.0f);
    const float w_safe = w == 0.0f ? 1.0f : w;
    const float r = sqrtf(x * x + y * y) / w_safe;
    const float s = (r / sqrtf(1.0f + r * r)) * lrc;
    const float d2 = 1.0f - s * s;
    const float denom = sqrtf(d2 > 1e-12f ? d2 : 1e-12f);
    const float r_d = s / denom;
    const float scale = (r_d != 0.0f && active) ? r / r_d : 1.0f;
    return w * scale;
}

// The 14 floats of a matrix row: seven 8-byte loads where the table starts
// on 8 bytes (every row then does: a row is 56 bytes), else fourteen
// (coords.cu, fused_bbox.cu).
__device__ __forceinline__ void load_matrix_row(const float* __restrict__ row, bool aligned8,
                                                float* m) {
    if (aligned8) {
        const float2* q = reinterpret_cast<const float2*>(row);
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            const float2 f = __ldg(q + j);
            m[2 * j] = f.x;
            m[2 * j + 1] = f.y;
        }
    } else {
#pragma unroll
        for (int j = 0; j < 14; ++j) m[j] = __ldg(row + j);
    }
}

// rotate_and_distort_core (remap.py:95): matrix row m (14 floats: 3x3
// inverse rotation-intrinsics, then IBIS/OIS shifts). MODEL is the main
// model's ModelId, or kAnyModel to take `model`; with DIGITAL, `digital`
// is the digital lens's ModelId (-1: none), applied after c and before the
// stretch (remap.py:146-147). With kAnyModel both go out of line. With
// MESH, the mesh and focal-plane stages of `flags` run after c and before
// the digital lens (remap.py:137-145), on `mesh`; GH > 0: the mesh's grid
// height at compile time (mesh_channel).
template <int MODEL, bool DIGITAL, bool MESH = false, int GH = 0>
__device__ __forceinline__ void project_point(float px, float py, const float* m,
                                              const CoordParams& p, int flags, float& u,
                                              float& v, bool& valid, int model = kOpencvFisheye,
                                              int digital = -1, const MeshArgs* mesh = nullptr) {
    const float x = px * m[0] + py * m[1] + m[2] + p.t3d[0];
    const float y = px * m[3] + py * m[4] + m[5] + p.t3d[1];
    float w = px * m[6] + py * m[7] + m[8] + p.t3d[2];

    valid = w > 0.0f;
    const float r_limit_sq = p.r_limit * p.r_limit;
    valid = valid && !((r_limit_sq > 0.0f) && ((x * x + y * y) > r_limit_sq * w));

    if (flags & ANY_UNDERWATER) w = forward_refraction(x, y, w, p.lrc);

    if constexpr (MODEL == kAnyModel) {
        distort_xy_any(model, x, y, valid ? w : 1.0f, p, u, v);
    } else {
        distort_xy<MODEL>(x, y, valid ? w : 1.0f, p, u, v);
    }
    u = u * p.f[0];
    v = v * p.f[1];

    if (flags & HAS_IBIS_DATA) {
        const bool any_is = m[9] != 0.0f || m[10] != 0.0f || m[11] != 0.0f ||
                            m[12] != 0.0f || m[13] != 0.0f;
        if (any_is) {
            const float cos_a = cosf(-m[11]);
            const float sin_a = sinf(-m[11]);
            const float u2 = cos_a * u - sin_a * v - m[9] + m[12];
            const float v2 = sin_a * u + cos_a * v - m[10] + m[13];
            u = u2;
            v = v2;
        }
    }

    u = u + p.c[0];
    v = v + p.c[1];
    if constexpr (MESH) {
        const MeshConsts k = mesh_consts(*mesh);
        if (flags & HAS_MESH_DATA) mesh_correction<GH>(u, v, *mesh, k, p, flags);
        if (flags & HAS_FPD_DATA) focal_plane_distortion(u, v, *mesh, k, p, flags);
    }
    if constexpr (DIGITAL) {
        if (digital >= 0) {
            if constexpr (MODEL == kAnyModel) {
                distort_xy_any(digital, u, v, 1.0f, p, u, v);
            } else {
                distort_xy_switch(digital, u, v, 1.0f, p, u, v);
            }
        }
    }
    // a division by a stretch of exactly 1 returns its dividend (IEEE
    // division is exact there), so it is left out
    if (p.stretch_h > 0.001f && p.stretch_h != 1.0f) u = u / p.stretch_h;
    if (p.stretch_v > 0.001f && p.stretch_v != 1.0f) v = v / p.stretch_v;
}

}  // namespace gf
