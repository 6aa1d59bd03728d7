// Sampler kernel: separable 2/4/8-tap bilinear/bicubic/lanczos4 sampling.
//
// Replaces gyroflow_tpu/ops/pallas_sampler.py::_sampler_kernel (driven by
// _sample_call and sample_planes_t, with prep_taps and tile_sample). Per
// output pixel it does what remap.sample_input (remap.py:309-352) does:
// subtract the tap offset, guard u/v, then the separable LUT tap loop of
// taps.cuh (rint(u * 32) phases, the weights of interpolation.COEFFS,
// out-of-source-rect taps read the background), and clamp at
// pixel_value_limit. Pixels with valid == 0 get the background.
//
// What bounds it on an H100: not the bytes. A 4K frame's Y and UV planes,
// maps and outputs are ~168 MB, 0.0501 ms at 3.35 TB/s; the plane is read
// in its native type (uint16 for 10-bit video), and neighbouring pixels
// share most of their taps, so the tap reads are L1/L2 hits. The cost is
// instructions per pixel: lanczos4 sums 64 taps per channel. Read one at a
// time, each tap is a 2-byte load with its own clamp and source-rect select
// and a conversion to float, and its weight was a __constant__ read at the
// pixel's own phase; the x-phase, rint(u * 32) & 31, differs in nearly
// every lane of a warp (u advances ~0.9 px per pixel), so the constant
// cache served the 32 lanes' addresses one after another.
//
// What the design does about it (the loop is taps.cuh's, shared with
// fused.cu):
// - the block stages its interpolation's LUT slice (1 KB for lanczos4) in
//   shared memory; each thread reads its 8 x- and 8 y-weights as four
//   float4s;
// - a stencil that lies wholly inside the plane and the source rect reads
//   each row with two (uint16 C=1) or three (uint16 C=2, float32 C=1)
//   aligned 16-byte loads, shifts the taps into place and converts them
//   with a byte permute and an add: no per-tap clamp, select or scalar
//   load. Every chunk it loads holds a byte of its row, and the last row's
//   chunks must end inside the plane, so no load reaches past the plane's
//   end; one may start up to 15 bytes before a plane that is not 16-byte
//   aligned, inside its allocation (allocations are at least 16-byte
//   aligned). Stencils near the plane's or the source rect's edge take the
//   checked loop, as do the type/channel combinations whose rows are not
//   16 or 32 bytes;
// - 32x4 threads cover a 32x8 tile of output pixels, two rows a thread: a
//   warp reads a contiguous ~40-pixel run of each source row, its maps and
//   output coalesce, and each thread has two pixels' loads to overlap.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, read by chip_smoke.py and
// sampler_bench.py), a 4K uint16 frame's Y+UV went from 1.0191 ms to
// 0.2960 ms (16.9% of the byte bound): shared-memory weights took the most,
// row loads the next, two rows a thread 15%; the block's shape alone (64x4
// against 32x8) changed nothing.
// The TPU kernel's window DMA plan, one-hot MXU band matrices and hi/lo bf16
// splits exist only because the TPU has no fast gather; none is needed here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

using gf::Interp;
using gf::SamplerArgs;

namespace {

// A block of 32 x 4 threads covers 32 x 8 output pixels: each thread takes
// two, rows r and r + 4 of the block's tile.
constexpr int kBlockX = 32, kBlockY = 4, kRowsPerThread = 2;

// One output pixel: the background if it is not valid, else the offset, the
// guard, the tap loop and the clamp.
template <typename T, int C, int TAPS>
__device__ __forceinline__ void sample_pixel(const T* __restrict__ img, int H, int W,
                                             const float* __restrict__ us,
                                             const float* __restrict__ vs,
                                             const uint8_t* __restrict__ valid, long long i,
                                             const SamplerArgs& a, const float* s_lut,
                                             float* __restrict__ out) {
    float* o = out + i * C;
    if (!valid[i]) {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = a.bg[c];
        return;
    }
    // the XLA sample_input order (remap.py:320-326): offset, then guard
    const float u = gf::guard_uv(us[i] - Interp<TAPS>::offset);
    const float v = gf::guard_uv(vs[i] - Interp<TAPS>::offset);
    float total[C];
    gf::sample_taps<T, C, TAPS>(img, H, W, u, v, a, s_lut, total);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = fminf(total[c], a.limit);
}

template <typename T, int C, int TAPS>
__global__ void __launch_bounds__(kBlockX * kBlockY)
sampler_kernel(const T* __restrict__ img, int H, int W, const float* __restrict__ us,
               const float* __restrict__ vs, const uint8_t* __restrict__ valid, int oh, int ow,
               const float* __restrict__ lut, SamplerArgs a, float* __restrict__ out) {
    __shared__ __align__(16) float s_lut[gf::kSliceSize<TAPS>];
    gf::stage_lut<TAPS>(lut, s_lut);

    const int col = blockIdx.x * kBlockX + threadIdx.x;
    if (col >= ow) return;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int row = (blockIdx.y * kRowsPerThread + k) * kBlockY + threadIdx.y;
        if (row >= oh) return;
        sample_pixel<T, C, TAPS>(img, H, W, us, vs, valid, (long long)row * ow + col, a, s_lut,
                                 out);
    }
}

struct Launch {
    const void* img; int H, W;
    const void *u, *v, *valid; int oh, ow;
    const float* lut; const SamplerArgs* a; void* out; cudaStream_t s;
};

template <typename T, int C, int TAPS>
void launch(const Launch& l) {
    constexpr int kTileY = kBlockY * kRowsPerThread;
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((l.ow + kBlockX - 1) / kBlockX, (l.oh + kTileY - 1) / kTileY);
    sampler_kernel<T, C, TAPS><<<grid, block, 0, l.s>>>(
        static_cast<const T*>(l.img), l.H, l.W, static_cast<const float*>(l.u),
        static_cast<const float*>(l.v), static_cast<const uint8_t*>(l.valid), l.oh, l.ow, l.lut,
        *l.a, static_cast<float*>(l.out));
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
// u, v: float32 (oh, ow); valid: uint8/bool (oh, ow); out: float32
// (oh, ow, C). taps: 2 (bilinear), 4 (bicubic) or 8 (lanczos4); lut: the
// interpolation's LUT slice, float32 COEFFS[ind : ind + 32 * taps] on the
// device, 16-byte aligned. Returns -1 for an unsupported dtype/C/taps, else
// cudaGetLastError() after the launch.
extern "C" int gf_sampler(const void* img, int dtype, int H, int W, int C, const void* u,
                          const void* v, const void* valid, int oh, int ow, int taps,
                          const void* lut, SamplerArgs args, void* out, void* stream) {
    const Launch l{img, H, W, u, v, valid, oh, ow, static_cast<const float*>(lut), &args, out,
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
