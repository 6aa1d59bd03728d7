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
// then the 64-tap lanczos4 loop. Its first form ran both in one thread per
// pixel on 32x8 blocks: the thread held the chain's registers and the tap
// loop's together (72), each thread had one pixel's loads to overlap, and it
// read 0.3293 ms on 4K Y against the split pair's 0.0872 + 0.2083 ms
// (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).
//
// What the design does about it: the split sampler's shape. 32x4 threads
// cover a 32x8 tile, two rows a thread (rows r and r + 4 of the tile); a
// thread projects its first pixel and samples it, then its second, in a
// loop the compiler keeps rolled, so one pixel's chain and taps are live at
// a time. At the 72 registers of <uint16, C1, lanczos4> a SM holds 7 such
// blocks (28 warps), where it held 3 blocks of 32x8 threads (24 warps), and
// the block's LUT staging and index work serve twice the pixels a thread.
// The block stages its interpolation's LUT slice in shared memory and the
// taps are taps.cuh's (float4 weights at the pixel's phases, aligned
// 16-byte row loads for stencils wholly inside the plane and the source
// rect). Read one step at a time against the first form (sampler_bench.py,
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has the final reading): 4K Y+UV
// 0.4363 -> 0.3780 ms, below the split pair's 0.4040 in the same call.
// Rejected:
//   - two phases split by a barrier (each thread projects both pixels into
//     a shared tile of tap positions, then samples them): 0.4008 ms with
//     two rows a thread, and 0.4672 ms with one row a thread on 32x8
//     blocks, slower than the first form: the barrier holds a block's tap
//     loads back until all its chains are done;
//   - two chains unrolled side by side: more registers, 0.4179 ms against
//     0.4036 rolled (both with the barrier);
//   - four rows a thread: 0.4205 ms with the barrier, and 1% faster for
//     the fisheye form and 2% slower for the any-lens form without it;
//   - a 64-register cap (8 blocks a SM): 2% faster for the fisheye form,
//     which then spills 20 bytes, and 3% slower for the any-lens form (40
//     bytes of spills); one bound serves both forms;
//   - the block's source footprint staged in shared memory with cp.async
//     (16-byte copies of the tile's stencil bounding box, clipped to the
//     plane; 8 KB a block; a tile over the budget sampling from global
//     memory; it needs the two-phase split, for the tile's positions):
//     every fisheye tile and 82% of the any-lens tiles staged, and it read
//     7.8% slower than the same two-phase form without it (0.4293 against
//     0.3983 ms): the taps were L1 hits already, and the copy is extra work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lens.cuh"
#include "post_uv.cuh"
#include "taps.cuh"

using gf::Interp;

namespace {

// A block of 32 x 4 threads covers 32 x 8 output pixels: each thread takes
// two, rows r and r + 4 of the block's tile.
constexpr int kBlockX = 32, kBlockY = 4, kRowsPerThread = 2;
constexpr int kTileY = kBlockY * kRowsPerThread;

template <typename T, int C, int TAPS, bool ANY_LENS>
__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_kernel(const T* __restrict__ img, int H, int W, const float* __restrict__ xs,
             const float* __restrict__ ys, const int32_t* __restrict__ idx,
             const float* __restrict__ mats, int rows, const __grid_constant__ gf::CoordParams p,
             int flags, int model, int digital, const float* __restrict__ lut, FusedArgs a,
             int oh, int ow, float* __restrict__ out) {
    __shared__ __align__(16) float s_lut[gf::kSliceSize<TAPS>];
    gf::stage_lut<TAPS>(lut, s_lut);

    const int col = blockIdx.x * kBlockX + threadIdx.x;
    if (col >= ow) return;
#pragma unroll 1
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int row = blockIdx.y * kTileY + k * kBlockY + threadIdx.y;
        if (row >= oh) return;
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
            gf::project_point<gf::kAnyModel, true>(xs[i], ys[i], m, p, flags, u, v, valid,
                                                   model, digital);
        } else {
            gf::project_point<gf::kOpencvFisheye, false>(xs[i], ys[i], m, p, flags, u, v,
                                                         valid);
        }
        if (!valid) {
#pragma unroll
            for (int c = 0; c < C; ++c) o[c] = a.s.bg[c];
            continue;
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
}

struct Launch {
    const void* img; int H, W;
    const void *x, *y, *idx, *mats; int rows;
    const gf::CoordParams* p; int flags, model, digital; const float* lut;
    const FusedArgs* a; int oh, ow; void* out; cudaStream_t s;
};

template <typename T, int C, int TAPS, bool ANY_LENS>
void launch_lens(const Launch& l) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((l.ow + kBlockX - 1) / kBlockX, (l.oh + kTileY - 1) / kTileY);
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
