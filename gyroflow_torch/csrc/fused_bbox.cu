// Fused kernel with per-tile uv bounding boxes: rolling-shutter projection,
// coords_post_uv and separable sampling with one background weight.
//
// Replaces experiments/pallas_fused.py::_fused_kernel (:36, driven by
// _fused_call :154, pallas_call :185), the JAX package's earlier fused
// experiment. Per output pixel, from the (x, y, idx) of coords_pre:
//   1. read matrix row idx from the (rows, 14) table and run the projection
//      (project_point, lens.cuh, its opencv_fisheye instantiation: the
//      experiment's configuration) -> u, v, valid (:72-78);
//   2. coords_post_uv (post_uv.cuh), then non-finite -> 0 and clip to
//      +-32768 (:79-81);
//   3. the tap offset, rint((u - offset) * 32) phases, weights from the
//      reference LUT; a tap's weight is zeroed outside the source rect, and
//      the out-of-rect share goes to the background through ONE separable
//      weight, (1 - rowsum * colsum) * bg (:96-149). There is no
//      pixel_value_limit clamp and no valid mask on the output (as in the
//      experiment); valid is written as 0/1 float32;
//   4. per tile of tile_h x tile_w output pixels, the exact uv bbox over its
//      valid pixels: (umin, umax, vmin, vmax), (1e9, -1e9, 1e9, -1e9) for a
//      tile with none (:83-93).
//
// Not ported (TPU window machinery): the matrix and image window DMAs and
// their origins (m0s, y0s, x0s), the one-hot MXU gathers, the post-hoc
// overflow check (_posthoc_overflow :197) and the stale wrapper remap_fused
// (:215). There is no window, so every in-rect tap is read and nothing can
// overflow; the bbox stays an output.
//
// What bounds it on an H100: as fused.cu, the bytes of x, y, idx in, the
// plane's taps (mostly L1/L2 hits) and out + valid written (16 B/px for one
// channel), against ~60 operations of the projection chain and the tap loop
// per pixel; the bbox adds a block reduction per tile and 16 B per tile. The
// first form read the weights from the whole LUT in __constant__
// memory at each lane's own phase (the constant cache serves a warp's
// different addresses one after another) and each tap with a scalar load
// behind two tests; it read 0.5853 ms for the 4K Y+UV float32 planes
// against 0.3731 for fused.cu's uint16 planes (PERF.md, NVIDIA H100 80GB
// HBM3, 700.00 W), which runs the same projection and tap loop.
//
// What the design does about it (fused.cu's lessons; readings by
// gyroflow_torch.experiments.probe_bench, NVIDIA H100 80GB HBM3, 700.00 W,
// in PERF.md):
// - the block stages its interpolation's LUT slice (cuda_sampler.lut_slice)
//   in shared memory; each pixel reads its weights as float4s (taps.cuh
//   stage_lut, phase_weights);
// - a stencil wholly inside the source rect and the plane (99.7% of the 4K
//   Y plane's pixels, all of UV's) counts every tap and reads them with no
//   test, one load a pixel (taps.cuh load_pixel: a float, float2 or
//   float4); the other stencils take the checked loop, which skips the
//   taps outside the rect;
// - one block of 32 x 4 threads a tile: a warp covers 32 neighbouring
//   columns of a tile row, each thread walks rows r, r + 4, ... of the tile,
//   one pass a pixel in a rolled loop (one pixel's chain and taps live at a
//   time), the matrix row by seven 8-byte loads (lens.cuh load_matrix_row).
// 4K Y+UV went 0.5782 -> 0.3456 ms. Read and rejected: the stencil rows by
// aligned 16-byte loads (taps.cuh load_row; 0.4520, 80 registers); 32 x 8
// threads a block (UV 0.0914 against 0.1057, Y 0.2604 against 0.2400); 32 x
// 2 (0.4633 in the row-load form); a 64-register cap (0.3377, UV faster and
// Y slower, 52-72 bytes of spills) and a 73-register cap (0.3551).
// The bbox: the block covers its tile, so the min/max reduce with warp
// shuffles and one shared-memory step across the block's 4 warps, as
// before: no atomics, so the bbox is exact and the same on every run (an
// atomic min/max over an integer encoding would let blocks of any shape
// share a tile, but needs the tile's fill written first and care with -0
// and +0, and no block shape other than one a tile read faster).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lens.cuh"
#include "post_uv.cuh"
#include "taps.cuh"

using gf::Interp;

namespace {

constexpr int kBlockX = 32, kBlockY = 4;
constexpr int kWarps = kBlockX * kBlockY / 32;

template <int C, int TAPS>
__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_bbox_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ xs,
                  const float* __restrict__ ys, const int32_t* __restrict__ idx,
                  const float* __restrict__ mats, int rows, gf::CoordParams p, int flags,
                  const float* __restrict__ lut, FusedArgs a, int oh, int ow, int tile_h,
                  int tile_w, float* __restrict__ out, float* __restrict__ vout,
                  float* __restrict__ bbox) {
    __shared__ __align__(16) float s_lut[gf::kSliceSize<TAPS>];
    gf::stage_lut<TAPS>(lut, s_lut);

    const int nx = (ow + tile_w - 1) / tile_w;
    const int ty0 = (blockIdx.x / nx) * tile_h;
    const int tx0 = (blockIdx.x % nx) * tile_w;
    const int th = min(tile_h, oh - ty0);   // ragged tiles at the bottom and right edges
    const int tw = min(tile_w, ow - tx0);
    const int srx = a.s.src_rect[0], sry = a.s.src_rect[1];
    const int srx1 = srx + a.s.src_rect[2], sry1 = sry + a.s.src_rect[3];
    const int fx_lo = max(srx, 0), fx_hi = min(srx1, W) - TAPS;
    const int fy_lo = max(sry, 0), fy_hi = min(sry1, H) - TAPS;
    const bool aligned = (reinterpret_cast<uintptr_t>(img) & (gf::kPixelAlign<C> - 1)) == 0;
    const bool mats8 = (reinterpret_cast<uintptr_t>(mats) & 7) == 0;

    float umin = 1e9f, umax = -1e9f, vmin = 1e9f, vmax = -1e9f;
#pragma unroll 1
    for (int ry = threadIdx.y; ry < th; ry += kBlockY) {
#pragma unroll 1
        for (int rx = threadIdx.x; rx < tw; rx += kBlockX) {
            const long long i = (long long)(ty0 + ry) * ow + (tx0 + rx);

            int r = idx[i];
            r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
            float m[14];
            gf::load_matrix_row(mats + (long long)r * 14, mats8, m);

            float u, v;
            bool valid;
            gf::project_point<gf::kOpencvFisheye, false>(xs[i], ys[i], m, p, flags, u, v,
                                                         valid);
            gf::post_uv(u, v, a);
            u = gf::guard_uv(u);
            v = gf::guard_uv(v);
            if (valid) {
                umin = fminf(umin, u);
                umax = fmaxf(umax, u);
                vmin = fminf(vmin, v);
                vmax = fmaxf(vmax, v);
            }

            const int sx0 = __float2int_rn((u - Interp<TAPS>::offset) * (float)gf::kInterTabSize);
            const int sy0 = __float2int_rn((v - Interp<TAPS>::offset) * (float)gf::kInterTabSize);
            const int fx = sx0 >> gf::kInterBits;
            const int fy = sy0 >> gf::kInterBits;

            // weights zeroed outside the source rect, and their sums (:129-142)
            float wxm[TAPS], wym[TAPS];
            gf::phase_weights<TAPS>(s_lut, sx0 & (gf::kInterTabSize - 1), wxm);
            gf::phase_weights<TAPS>(s_lut, sy0 & (gf::kInterTabSize - 1), wym);
            float csum = 0.0f, rsum = 0.0f;
#pragma unroll
            for (int t = 0; t < TAPS; ++t) {
                const bool xok = fx + t >= srx && fx + t < srx1;
                const bool yok = fy + t >= sry && fy + t < sry1;
                wxm[t] = wxm[t] * (xok ? 1.0f : 0.0f);
                wym[t] = wym[t] * (yok ? 1.0f : 0.0f);
                csum = csum + wxm[t];
                rsum = rsum + wym[t];
            }

            // sum over rows of wy * (sum over columns of pixel * wx); a
            // zero-weight tap adds 0, so out-of-rect taps are not read
            float total[C];
#pragma unroll
            for (int c = 0; c < C; ++c) total[c] = 0.0f;
            if (aligned && fx >= fx_lo && fx <= fx_hi && fy >= fy_lo && fy <= fy_hi) {
#pragma unroll
                for (int ty = 0; ty < TAPS; ++ty) {
                    const float* src = img + ((long long)(fy + ty) * W + fx) * C;
                    float xsum[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) xsum[c] = 0.0f;
#pragma unroll
                    for (int tx = 0; tx < TAPS; ++tx) {
                        float px[C];
                        gf::load_pixel<C>(src + tx * C, px);
#pragma unroll
                        for (int c = 0; c < C; ++c) xsum[c] = xsum[c] + px[c] * wxm[tx];
                    }
#pragma unroll
                    for (int c = 0; c < C; ++c) total[c] = total[c] + wym[ty] * xsum[c];
                }
            } else {
#pragma unroll
                for (int ty = 0; ty < TAPS; ++ty) {
                    const int yy = fy + ty;
                    if (yy < sry || yy >= sry1) continue;
                    const float* src_row = img + (long long)yy * W * C;
                    float xsum[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) xsum[c] = 0.0f;
#pragma unroll
                    for (int tx = 0; tx < TAPS; ++tx) {
                        const int xx = fx + tx;
                        if (xx < srx || xx >= srx1) continue;
#pragma unroll
                        for (int c = 0; c < C; ++c)
                            xsum[c] = xsum[c] + __ldg(src_row + (long long)xx * C + c) * wxm[tx];
                    }
#pragma unroll
                    for (int c = 0; c < C; ++c) total[c] = total[c] + wym[ty] * xsum[c];
                }
            }
            const float bg_weight = 1.0f - rsum * csum;
#pragma unroll
            for (int c = 0; c < C; ++c) out[i * C + c] = total[c] + bg_weight * a.s.bg[c];
            vout[i] = valid ? 1.0f : 0.0f;
        }
    }

    // the tile's bbox: min/max within each warp, then across the warps
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        umin = fminf(umin, __shfl_xor_sync(0xffffffffu, umin, off));
        umax = fmaxf(umax, __shfl_xor_sync(0xffffffffu, umax, off));
        vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, off));
        vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    }
    __shared__ float part[4][kWarps];
    const int tid = threadIdx.y * kBlockX + threadIdx.x;
    const int warp = tid / 32;
    if ((tid & 31) == 0) {
        part[0][warp] = umin;
        part[1][warp] = umax;
        part[2][warp] = vmin;
        part[3][warp] = vmax;
    }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < kWarps; ++w) {
            umin = fminf(umin, part[0][w]);
            umax = fmaxf(umax, part[1][w]);
            vmin = fminf(vmin, part[2][w]);
            vmax = fmaxf(vmax, part[3][w]);
        }
        float* b = bbox + (long long)blockIdx.x * 4;
        b[0] = umin;
        b[1] = umax;
        b[2] = vmin;
        b[3] = vmax;
    }
}

struct Launch {
    const void* img; int H, W;
    const void *x, *y, *idx, *mats; int rows;
    const gf::CoordParams* p; int flags; const float* lut;
    const FusedArgs* a; int oh, ow, tile_h, tile_w;
    void *out, *valid, *bbox; cudaStream_t s;
};

template <int C, int TAPS>
void launch(const Launch& l) {
    const int ntiles = ((l.oh + l.tile_h - 1) / l.tile_h) * ((l.ow + l.tile_w - 1) / l.tile_w);
    fused_bbox_kernel<C, TAPS><<<ntiles, dim3(kBlockX, kBlockY), 0, l.s>>>(
        static_cast<const float*>(l.img), l.H, l.W, static_cast<const float*>(l.x),
        static_cast<const float*>(l.y), static_cast<const int32_t*>(l.idx),
        static_cast<const float*>(l.mats), l.rows, *l.p, l.flags, l.lut, *l.a, l.oh, l.ow,
        l.tile_h, l.tile_w, static_cast<float*>(l.out), static_cast<float*>(l.valid),
        static_cast<float*>(l.bbox));
}

template <int C>
bool dispatch_taps(int taps, const Launch& l) {
    switch (taps) {
        case 2: launch<C, 2>(l); return true;
        case 4: launch<C, 4>(l); return true;
        case 8: launch<C, 8>(l); return true;
        default: return false;
    }
}

bool dispatch_channels(int C, int taps, const Launch& l) {
    switch (C) {
        case 1: return dispatch_taps<1>(taps, l);
        case 2: return dispatch_taps<2>(taps, l);
        case 3: return dispatch_taps<3>(taps, l);
        case 4: return dispatch_taps<4>(taps, l);
        default: return false;
    }
}

}  // namespace

// img: float32 (H, W, C) channels-last;
// x, y: float32 (oh, ow) and idx: int32 (oh, ow) from coords_pre; mats:
// float32 (rows, 14); lut: the interpolation's LUT slice, float32
// COEFFS[ind : ind + 32 * taps] on the device, 16-byte aligned; out:
// float32 (oh, ow, C); valid: float32 (oh, ow); bbox: float32
// (ceil(oh / tile_h) * ceil(ow / tile_w), 4), tiles row-major. taps: 2, 4
// or 8. All device pointers, contiguous. Returns -1 for an unsupported
// C/taps, else cudaGetLastError() after the launch.
extern "C" int gf_fused_bbox(const void* img, int H, int W, int C, const void* x,
                             const void* y, const void* idx, const void* mats, int rows,
                             gf::CoordParams params, int flags, int oh, int ow, int tile_h,
                             int tile_w, int taps, const void* lut, FusedArgs args, void* out,
                             void* valid, void* bbox, void* stream) {
    const Launch l{img, H, W, x, y, idx, mats, rows, &params, flags,
                   static_cast<const float*>(lut), &args, oh, ow, tile_h, tile_w, out, valid,
                   bbox, static_cast<cudaStream_t>(stream)};
    if (!dispatch_channels(C, taps, l)) return -1;
    return static_cast<int>(cudaGetLastError());
}
