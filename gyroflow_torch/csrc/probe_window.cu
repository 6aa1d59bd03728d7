// Window column sums: per tile, the column sums of an Sr x Sc window of a
// plane at the tile's origin (y0, x0).
//
// Replaces experiments/perf_probe3.py::make_win_kernel (:30, pallas_call
// :58, driven by main :15), the JAX package's probe of window DMAs at
// misaligned lane offsets: out[t, c] = sum over r < Sr of img[y0_t + r,
// x0_t + c]. The origins come from the caller (the probe's seeded origins,
// aligned to 8 rows and to 128, 32 or 8 columns); reads past the plane's
// edge count as 0 (the probe's origins never reach them).
//
// What bounds it on an H100: bytes. Each tile reads Sr * Sc floats (48 KB at
// 48 x 256) and writes Sc, with one add per float read: 512 tiles read 25.2
// MB, ~7.5 us at 3.35 TB/s. Misaligned origins cost whole 32-byte sectors
// at the window's left and right edges, the GPU's form of the TPU's
// misaligned-lane question.
//
// What the simple design does about it: one block per tile, one thread per
// window column, each thread walking down the Sr rows: every step of a warp
// reads 32 neighbouring floats of one row (coalesced), and the sum stays in
// a register, in row order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_colsum_kernel(const float* __restrict__ img, int H, int W,
                     const int32_t* __restrict__ y0s, const int32_t* __restrict__ x0s, int Sr,
                     int Sc, float* __restrict__ out) {
    const int t = blockIdx.x;
    const int y0 = y0s[t], x0 = x0s[t];
    for (int c = threadIdx.x; c < Sc; c += kThreads) {
        const int x = x0 + c;
        float s = 0.0f;
        if (x >= 0 && x < W) {
            for (int r = 0; r < Sr; ++r) {
                const int y = y0 + r;
                if (y >= 0 && y < H) s = s + __ldg(img + (long long)y * W + x);
            }
        }
        out[(long long)t * Sc + c] = s;
    }
}

}  // namespace

// img: float32 (H, W); y0s, x0s: int32 (ntiles,); out: float32 (ntiles, Sc).
// All device pointers, contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int gf_window_colsum(const void* img, int H, int W, const void* y0s, const void* x0s,
                                int ntiles, int Sr, int Sc, void* out, void* stream) {
    window_colsum_kernel<<<ntiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), H, W, static_cast<const int32_t*>(y0s),
        static_cast<const int32_t*>(x0s), Sr, Sc, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
