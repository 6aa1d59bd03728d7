// Shared __device__ coords_post_uv (remap.py:255) for the fused kernels
// (fused.cu, fused_bbox.cu), with its host-computed constants.
//
// The same float32 operations, in the same order, as the port's torch
// coords_post_uv on the card (gyroflow_torch/ops/remap.py), so a kernel and
// its plain version give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "taps.cuh"

// coords_post_uv's constants, computed on the host, and the sampler's.
struct FusedArgs {
    gf::SamplerArgs s;      // background, pixel_value_limit, source rect
    int rotate;             // input_rotation != 0
    float rot_cos, rot_sin; // float32 cos / sin of the input rotation
    float rot_o[2];         // rotation origin: the unrotated frame centre
    float rot_o2[2];        // the rotated frame centre
    int bg_mode;            // 0 edge, 1 repeat, 2 mirror
    float frame_w, frame_h; // frame size after the rotation
    float map_x[3];         // source-rect map: out_min, out_max - out_min, 1 / frame_w
    float map_y[3];
};

namespace gf {

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// remap.map_coord(x, 0, frame, out_min, out_max) as torch computes it on
// the card: the division by the host scalar is a multiply by its float32
// reciprocal (torch's CUDA true division by a CPU scalar).
__device__ __forceinline__ float map_src(float x, const float* m) {
    return ((x - 0.0f) * m[1]) * m[2] + m[0];
}

// coords_post_uv (remap.py:255) for background modes 0-2.
__device__ __forceinline__ void post_uv(float& u, float& v, const FusedArgs& a) {
    if (a.rotate) {
        const float du = u - a.rot_o[0];
        const float dv = v - a.rot_o[1];
        const float ru = a.rot_cos * du - a.rot_sin * dv + a.rot_o2[0];
        const float rv = a.rot_sin * du + a.rot_cos * dv + a.rot_o2[1];
        u = ru;
        v = rv;
    }
    if (a.bg_mode == 1) {           // repeat
        u = clamp_nan(u, 3.0f, a.frame_w - 3.0f);
        v = clamp_nan(v, 3.0f, a.frame_h - 3.0f);
    } else if (a.bg_mode == 2) {    // mirror
        const float rx = rintf(u), ry = rintf(v);
        const float w3 = a.frame_w - 3.0f, h3 = a.frame_h - 3.0f;
        if (rx > w3) u = w3 - (rx - w3);
        if (rx < 3.0f) u = (3.0f + a.frame_w) - (w3 + rx);
        if (ry > h3) v = h3 - (ry - h3);
        if (ry < 3.0f) v = (3.0f + a.frame_h) - (h3 + ry);
    }
    u = map_src(u, a.map_x);
    v = map_src(v, a.map_y);
}

}  // namespace gf
