// Fused kernel: rolling-shutter projection and separable sampling in one pass.
//
// Replaces gyroflow_tpu/ops/pallas_fused.py::_fused_kernel (:57, driven by
// _fused_call :195 and remap_fused), which remap_plane_pallas(fused=True)
// takes for interpolation 2/4/8 with more than one matrix row, no mesh or
// FPD, no drawing and background mode 0-2. Per output pixel, from the
// (x, y, idx) of coords_pre, it does pallas_fused.py:98-186 without the TPU
// machinery:
//   1. read matrix row idx straight from the (rows, 14) table and run the
//      projection (project_point, lens.cuh) -> u, v, valid, for any
//      distortion model and digital lens: the fisheye render without a
//      digital lens (the default) takes an instantiation specialised on it,
//      every other lens the instantiation that chooses the model and the
//      digital lens at run time (distort_xy_any; specialising 14 models x 2
//      on top of the 36 dtype/channel/tap instantiations would build 1008
//      kernels). The projection's parameters are a __grid_constant__ kernel
//      parameter, so that out-of-line call reads them where they are, with
//      no copy to each thread's stack (one form for every lens, fisheye
//      included, read 7.5% slower on the fisheye render: PERF.md);
//   2. coords_post_uv (remap.py:255): input rotation (the rotated frame size
//      comes from the host), background modes 0-2, the source-rect map;
//   3. the guard (_guard_uv_kernel, pallas_fused.py:51), then the tap offset,
//      in the JAX package's order (pallas_fused.py:123-137 with prep_taps);
//   4. the separable LUT tap loop of taps.cuh at rint(u * 32) phases, shared
//      with the split sampler, then min(., pixel_value_limit); pixels with
//      valid == 0 get the background.
// The in-bounds background, limited range and the output cast stay in torch
// after the kernel, as in remap.py:731-739.
//
// Background: the TPU kernel folds the out-of-rect taps into one separable
// background weight (s + bg_weight * bg), which lets the MXU band matmul run
// on raw pixels. Here each tap that lies outside the source rect reads the
// background, as the split sampler does: the same function up to float
// rounding, and the fused and split paths give the same bits.
//
// Not ported (TPU window machinery): plan_fused and its window origins, the
// per-tile overflow check, plan_matrix_windows, the one-hot hi/lo MXU
// matrix gather, and the padded-tile mask (no padding on the (oh, ow)
// layout). There is no window, so nothing can overflow.
//
// What bounds it on an H100: the split pair's work without the u/v/valid
// round trip (9 B/px written by the coords kernel and read back by the
// sampler): x, y, idx in (12 B/px), the plane's taps (mostly L1/L2 hits), the
// float32 output. Per pixel it runs the ~60-operation projection chain and
// then the 64-tap lanczos4 loop, so one thread holds both the chain's
// registers and the tap loop's.
//
// What the design does about it: one thread per output pixel on 32x8
// blocks, the matrix row read with __ldg, and the
// split sampler's tap loop (taps.cuh): the interpolation's LUT slice staged
// in shared memory by each block and read as float4s at the pixel's phases,
// and the stencils that lie wholly inside the plane and the source rect
// read row by row with aligned 16-byte loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lens.cuh"
#include "post_uv.cuh"
#include "taps.cuh"

using gf::Interp;

namespace {

template <typename T, int C, int TAPS, bool ANY_LENS>
__global__ void fused_kernel(const T* __restrict__ img, int H, int W,
                             const float* __restrict__ xs, const float* __restrict__ ys,
                             const int32_t* __restrict__ idx, const float* __restrict__ mats,
                             int rows, const __grid_constant__ gf::CoordParams p, int flags,
                             int model, int digital,
                             const float* __restrict__ lut, FusedArgs a, int oh, int ow,
                             float* __restrict__ out) {
    __shared__ __align__(16) float s_lut[gf::kSliceSize<TAPS>];
    gf::stage_lut<TAPS>(lut, s_lut);

    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= ow || row >= oh) return;
    const long long i = (long long)row * ow + col;
    float* o = out + i * C;

    int r = idx[i];
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
    const float* mrow = mats + (long long)r * 14;
    float m[14];
#pragma unroll
    for (int j = 0; j < 14; ++j) m[j] = __ldg(mrow + j);

    float u, v;
    bool valid;
    if constexpr (ANY_LENS) {
        gf::project_point<gf::kAnyModel, true>(xs[i], ys[i], m, p, flags, u, v, valid, model,
                                               digital);
    } else {
        gf::project_point<gf::kOpencvFisheye, false>(xs[i], ys[i], m, p, flags, u, v, valid);
    }
    if (!valid) {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = a.s.bg[c];
        return;
    }
    gf::post_uv(u, v, a);
    // the JAX order: guard, then the tap offset (pallas_fused.py:123-137)
    const float su = gf::guard_uv(u) - Interp<TAPS>::offset;
    const float sv = gf::guard_uv(v) - Interp<TAPS>::offset;
    float total[C];
    gf::sample_taps<T, C, TAPS>(img, H, W, su, sv, a.s, s_lut, total);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = fminf(total[c], a.s.limit);
}

struct Launch {
    const void* img; int H, W;
    const void *x, *y, *idx, *mats; int rows;
    const gf::CoordParams* p; int flags, model, digital; const float* lut;
    const FusedArgs* a; int oh, ow; void* out; cudaStream_t s;
};

template <typename T, int C, int TAPS, bool ANY_LENS>
void launch_lens(const Launch& l) {
    const dim3 block(32, 8);
    const dim3 grid((l.ow + block.x - 1) / block.x, (l.oh + block.y - 1) / block.y);
    fused_kernel<T, C, TAPS, ANY_LENS><<<grid, block, 0, l.s>>>(
        static_cast<const T*>(l.img), l.H, l.W, static_cast<const float*>(l.x),
        static_cast<const float*>(l.y), static_cast<const int32_t*>(l.idx),
        static_cast<const float*>(l.mats), l.rows, *l.p, l.flags, l.model, l.digital, l.lut,
        *l.a, l.oh, l.ow, static_cast<float*>(l.out));
}

template <typename T, int C, int TAPS>
void launch(const Launch& l) {
    if (l.model == gf::kOpencvFisheye && l.digital < 0) {
        launch_lens<T, C, TAPS, false>(l);
    } else {
        launch_lens<T, C, TAPS, true>(l);
    }
}

template <typename T, int C>
bool dispatch_taps(int taps, const Launch& l) {
    switch (taps) {
        case 2: launch<T, C, 2>(l); return true;
        case 4: launch<T, C, 4>(l); return true;
        case 8: launch<T, C, 8>(l); return true;
        default: return false;
    }
}

template <typename T>
bool dispatch_channels(int C, int taps, const Launch& l) {
    switch (C) {
        case 1: return dispatch_taps<T, 1>(taps, l);
        case 2: return dispatch_taps<T, 2>(taps, l);
        case 3: return dispatch_taps<T, 3>(taps, l);
        case 4: return dispatch_taps<T, 4>(taps, l);
        default: return false;
    }
}

}  // namespace

// img: (H, W, C) channels-last, dtype 0 = uint8, 1 = uint16, 2 = float32;
// x, y: float32 (oh, ow) and idx: int32 (oh, ow) from coords_pre; mats:
// float32 (rows, 14); out: float32 (oh, ow, C). taps: 2, 4 or 8; lut: the
// interpolation's LUT slice, float32 COEFFS[ind : ind + 32 * taps], 16-byte
// aligned. model: the main model's ModelId (lens.cuh); digital: the digital
// lens's ModelId, or -1 for none. All device pointers, contiguous. Returns
// -1 for an unsupported dtype/C/taps or model id, else cudaGetLastError()
// after the launch.
extern "C" int gf_fused(const void* img, int dtype, int H, int W, int C, const void* x,
                        const void* y, const void* idx, const void* mats, int rows,
                        gf::CoordParams params, int flags, int model, int digital, int oh,
                        int ow, int taps, const void* lut, FusedArgs args, void* out,
                        void* stream) {
    if (model < 0 || model >= gf::kNumModels || digital >= gf::kNumModels) return -1;
    const Launch l{img, H, W, x, y, idx, mats, rows, &params, flags, model, digital,
                   static_cast<const float*>(lut), &args, oh, ow, out,
                   static_cast<cudaStream_t>(stream)};
    bool ok = false;
    switch (dtype) {
        case 0: ok = dispatch_channels<uint8_t>(C, taps, l); break;
        case 1: ok = dispatch_channels<uint16_t>(C, taps, l); break;
        case 2: ok = dispatch_channels<float>(C, taps, l); break;
        default: break;
    }
    if (!ok) return -1;
    return static_cast<int>(cudaGetLastError());
}
