// Overlay kernel: the drawing overlay as the render's epilogue.
//
// Replaces the drawing stages of gyroflow_tpu/ops/remap.py::remap_plane_pallas
// (_draw_overlay_tiled, remap.py:1054): its two canvas fetches, which ride
// the Pallas sampler _sample_call (pallas_sampler.py:536) at bilinear phase 0
// through _canvas_fetch_t (remap.py:1014), and the blend and safe-area dim
// it runs in XLA (_blend_overlay_t, remap.py:1033-1075). For each output
// pixel of the (oh, ow, C) float32 plane, after the background, out-rect and
// colour-range steps and before the output cast:
//   - the input stage: the canvas byte at the source position (u, v),
//     canvas[floor(v / scale), floor(u / scale)] (0 outside the canvas),
//     blended where (u, v) lies inside the source rect and the byte's stage
//     bit is 0;
//   - the output stage: the byte at the output pixel (ox, oy), blended where
//     its stage bit is 1; oy is the absolute output row (oy0 + the row of a
//     band of output rows, as remap_plane_pallas adds oy0 at remap.py:709),
//     so a band draws what the same rows of the whole plane draw;
//   - the blend (spirv drawing.rs:37-49): COLORS[color][c] * max_pixel_value
//     at alpha 1 - 0.25 * alpha over the pixel;
//   - the safe-area dim (drawing.rs:52-69): 1 inside the rect, 0.25 in its
//     5-px border band, 0.5 outside.
// The plain version is gyroflow_torch/ops/remap.py::_draw_overlay; both
// round op by op (--fmad=false), so they give the same bits.
//
// What bounds it on an H100: bytes. It reads the float32 pixel and u, v and
// writes the pixel (16 B a pixel at C = 1), and reads the canvas (one byte
// per canvas pixel, from L2 after the first touch); a few dozen FP32
// operations a pixel.
//
// What the simple design does about it: one thread per output pixel on
// 32x8 blocks, so a warp reads 32 neighbouring pixels of one row (coalesced)
// and its canvas bytes are neighbours too. The TPU fetched the canvas
// through its sampler because it has no fast gather; here each fetch is one
// byte load. OverlayArgs is __grid_constant__: the colour table is indexed
// at run time and read in place.
#include <cuda_runtime.h>
#include <stdint.h>

// The overlay's constants (cuda_overlay.overlay_args).
struct OverlayArgs {
    float colors[32];   // core/drawing.py COLORS[1..8], RGBA, float32
    float maxv;         // max_pixel_value
    float scale;        // the canvas's scale (output pixels per canvas pixel)
    float src[4];       // source rect: x0, y0, x0 + w, y0 + h
    int safe;           // 1: dim outside the safe-area rect
    float rect[4];      // safe-area rect rx, ry, rz, rw
    float band[4];      // its border band: rx - 5, ry - 5, rz + 5, rw + 5
    int oy0;            // absolute output row of the plane's (or band's) first row
};

namespace {

// The canvas byte under (x, y), 0 outside the canvas (NaN included).
__device__ __forceinline__ int canvas_fetch(const uint8_t* __restrict__ canvas, int hc, int wc,
                                            float x, float y, float scale) {
    const float xi = floorf(x / scale);
    const float yi = floorf(y / scale);
    if (!(xi >= 0.0f && yi >= 0.0f && xi < static_cast<float>(wc)
          && yi < static_cast<float>(hc))) {
        return 0;
    }
    return __ldg(canvas + static_cast<long long>(yi) * wc + static_cast<long long>(xi));
}

// draw_pixel's blend of one packed canvas byte where `extra` holds.
template <int C>
__device__ __forceinline__ void blend(float (&px)[C], int data, bool extra,
                                      const OverlayArgs& a) {
    const int color = (data & 0xF8) >> 3;
    const int alpha_i = (data & 0x06) >> 1;
    if (!(data > 0 && color < 9 && extra)) return;
    const float alphaf = 1.0f - 0.25f * static_cast<float>(alpha_i);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float colorf = (color >= 1 ? a.colors[(color - 1) * 4 + c] : 0.0f) * a.maxv;
        px[c] = colorf * alphaf + px[c] * (1.0f - alphaf);
    }
}

template <int C>
__global__ void overlay_kernel(const float* __restrict__ pixel, const float* __restrict__ us,
                               const float* __restrict__ vs, const uint8_t* __restrict__ canvas,
                               int hc, int wc, int oh, int ow,
                               const __grid_constant__ OverlayArgs a, float* __restrict__ out) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= ow || row >= oh) return;
    const long long i = static_cast<long long>(row) * ow + col;

    float px[C];
#pragma unroll
    for (int c = 0; c < C; ++c) px[c] = pixel[i * C + c];
    const float u = us[i];
    const float v = vs[i];
    const float ox = static_cast<float>(col);
    const float oy = static_cast<float>(a.oy0 + row);

    const bool src_in = v >= a.src[1] && v < a.src[3] && u >= a.src[0] && u < a.src[2];
    const int d_in = canvas_fetch(canvas, hc, wc, u, v, a.scale);
    blend<C>(px, d_in, src_in && (d_in & 1) == 0, a);
    const int d_out = canvas_fetch(canvas, hc, wc, ox, oy, a.scale);
    blend<C>(px, d_out, (d_out & 1) == 1, a);
    if (a.safe) {
        const bool safe = ox >= a.rect[0] && ox <= a.rect[2] && oy >= a.rect[1]
                          && oy <= a.rect[3];
        const bool border = ox > a.band[0] && ox < a.band[2] && oy > a.band[1]
                            && oy < a.band[3];
        const float dim = safe ? 1.0f : (border ? 0.25f : 0.5f);
#pragma unroll
        for (int c = 0; c < C; ++c) px[c] = px[c] * dim;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) out[i * C + c] = px[c];
}

template <int C>
void launch(const void* pixel, const void* u, const void* v, const void* canvas, int hc, int wc,
            int oh, int ow, const OverlayArgs& a, void* out, cudaStream_t s) {
    const dim3 block(32, 8);
    const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
    overlay_kernel<C><<<grid, block, 0, s>>>(
        static_cast<const float*>(pixel), static_cast<const float*>(u),
        static_cast<const float*>(v), static_cast<const uint8_t*>(canvas), hc, wc, oh, ow, a,
        static_cast<float*>(out));
}

}  // namespace

// pixel, out: float32 (oh, ow, C), C = 1..4; u, v: float32 (oh, ow); canvas:
// uint8 (hc, wc). Device pointers, contiguous; out may be pixel. Launches on
// `stream`; returns -1 for an unsupported C, else cudaGetLastError().
extern "C" int gf_overlay(const void* pixel, const void* u, const void* v, const void* canvas,
                          int hc, int wc, int oh, int ow, int C, OverlayArgs args, void* out,
                          void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: launch<1>(pixel, u, v, canvas, hc, wc, oh, ow, args, out, s); break;
        case 2: launch<2>(pixel, u, v, canvas, hc, wc, oh, ow, args, out, s); break;
        case 3: launch<3>(pixel, u, v, canvas, hc, wc, oh, ow, args, out, s); break;
        case 4: launch<4>(pixel, u, v, canvas, hc, wc, oh, ow, args, out, s); break;
        default: return -1;
    }
    return static_cast<int>(cudaGetLastError());
}
