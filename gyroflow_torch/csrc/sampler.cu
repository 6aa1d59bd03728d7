// Sampler kernel: separable 2/4/8-tap bilinear/bicubic/lanczos4 sampling.
//
// Replaces gyroflow_tpu/ops/pallas_sampler.py::_sampler_kernel (driven by
// _sample_call and sample_planes_t, with prep_taps and tile_sample). Per
// output pixel it does what remap.sample_input (remap.py:309-352) does:
// subtract the tap offset, guard u/v, then the separable LUT tap loop of
// taps.cuh (rint(u * 32) phases, weights from interpolation.COEFFS in
// __constant__ memory, out-of-source-rect taps read the background), and
// clamp at pixel_value_limit. Pixels with valid == 0 get the background.
//
// What bounds it on an H100: memory latency of the tap loads. lanczos4 reads
// 64 source values per pixel (8 rows x 8 columns), almost all L1/L2 hits
// because neighbouring pixels share most of their taps; the ALU work is ~2
// multiply-adds per tap per channel. The plane is read in its native type
// (uint16 for 10-bit video: half the bytes of float32).
//
// What the simple design does about it: one thread per output pixel on
// 32x8 blocks, so a warp reads a contiguous 39-pixel run of each source row
// (coalesced, cached). The weights come from constant memory: a warp's
// pixels mostly share their phase, so the constant cache broadcasts. The
// TPU kernel's window DMA plan, one-hot MXU band matrices and hi/lo bf16
// splits exist only because the TPU has no fast gather; none is needed here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

using gf::Interp;
using gf::SamplerArgs;

namespace {

template <typename T, int C, int TAPS>
__global__ void sampler_kernel(const T* __restrict__ img, int H, int W,
                               const float* __restrict__ us, const float* __restrict__ vs,
                               const uint8_t* __restrict__ valid, int oh, int ow,
                               SamplerArgs a, float* __restrict__ out) {
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

    // the XLA sample_input order (remap.py:320-326): offset, then guard
    const float u = gf::guard_uv(us[i] - Interp<TAPS>::offset);
    const float v = gf::guard_uv(vs[i] - Interp<TAPS>::offset);
    float total[C];
    gf::sample_taps<T, C, TAPS>(img, H, W, u, v, a, total);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = fminf(total[c], a.limit);
}

template <typename T, int C, int TAPS>
void launch(const void* img, int H, int W, const void* u, const void* v, const void* valid,
            int oh, int ow, const SamplerArgs& a, void* out, cudaStream_t stream) {
    const dim3 block(32, 8);
    const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
    sampler_kernel<T, C, TAPS><<<grid, block, 0, stream>>>(
        static_cast<const T*>(img), H, W, static_cast<const float*>(u),
        static_cast<const float*>(v), static_cast<const uint8_t*>(valid), oh, ow, a,
        static_cast<float*>(out));
}

template <typename T, int C>
bool dispatch_taps(int taps, const void* img, int H, int W, const void* u, const void* v,
                   const void* valid, int oh, int ow, const SamplerArgs& a, void* out,
                   cudaStream_t s) {
    switch (taps) {
        case 2: launch<T, C, 2>(img, H, W, u, v, valid, oh, ow, a, out, s); return true;
        case 4: launch<T, C, 4>(img, H, W, u, v, valid, oh, ow, a, out, s); return true;
        case 8: launch<T, C, 8>(img, H, W, u, v, valid, oh, ow, a, out, s); return true;
        default: return false;
    }
}

template <typename T>
bool dispatch_channels(int C, int taps, const void* img, int H, int W, const void* u,
                       const void* v, const void* valid, int oh, int ow,
                       const SamplerArgs& a, void* out, cudaStream_t s) {
    switch (C) {
        case 1: return dispatch_taps<T, 1>(taps, img, H, W, u, v, valid, oh, ow, a, out, s);
        case 2: return dispatch_taps<T, 2>(taps, img, H, W, u, v, valid, oh, ow, a, out, s);
        case 3: return dispatch_taps<T, 3>(taps, img, H, W, u, v, valid, oh, ow, a, out, s);
        case 4: return dispatch_taps<T, 4>(taps, img, H, W, u, v, valid, oh, ow, a, out, s);
        default: return false;
    }
}

}  // namespace

// Copies the 448-float LUT (host pointer) into constant memory of the
// current device. Returns the cudaError_t of the copy.
extern "C" int gf_sampler_set_lut(const float* lut, int n) { return gf::set_lut(lut, n); }

// img: (H, W, C) channels-last, dtype 0 = uint8, 1 = uint16, 2 = float32;
// u, v: float32 (oh, ow); valid: uint8/bool (oh, ow); out: float32
// (oh, ow, C). taps: 2 (bilinear), 4 (bicubic) or 8 (lanczos4). Returns -1 for
// an unsupported dtype/C/taps, else cudaGetLastError() after the launch.
extern "C" int gf_sampler(const void* img, int dtype, int H, int W, int C, const void* u,
                          const void* v, const void* valid, int oh, int ow, int taps,
                          SamplerArgs args, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool ok = false;
    switch (dtype) {
        case 0: ok = dispatch_channels<uint8_t>(C, taps, img, H, W, u, v, valid, oh, ow, args, out, s); break;
        case 1: ok = dispatch_channels<uint16_t>(C, taps, img, H, W, u, v, valid, oh, ow, args, out, s); break;
        case 2: ok = dispatch_channels<float>(C, taps, img, H, W, u, v, valid, oh, ow, args, out, s); break;
        default: break;
    }
    if (!ok) return -1;
    return static_cast<int>(cudaGetLastError());
}
