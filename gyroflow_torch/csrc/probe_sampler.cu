// The sampler probes: the 8-tap lanczos4 sampler on tiled u/v with per-tile
// window origins, in four modes that split its cost, and three precisions
// of its column mix.
//
// Replaces the Pallas kernels of the JAX package's sampler probes:
//   - experiments/perf_probe4.py (main :21, pallas_call :97): k_noop :132,
//     k_nobuild :141, k_nomatmul :155 and k_dbuf :210 (the full sampler);
//   - experiments/perf_probe5.py (main :18, kern :118, pallas_call :203):
//     the rolled-window full sampler at tile 16x96;
//   - experiments/perf_probe6.py (main :18, make_kern :143, pallas_call
//     :247): the same with the column mix in bf16 ("default"), bf16 hi/lo
//     three-product ("high", "manual3") or float32 ("highest").
//
// Per tile t the caller gives a window origin (y0, x0) and a column offset
// xoff (the rolled probes' band start; 0 otherwise), the window's rows Sr,
// columns Sc and the compute width K (K = Sc, or 128 in the rolled probes).
// Per pixel, with u, v already coords_post_uv-mapped and guarded:
//   phases    sx0 = rint((u - 3) * 32), fx = sx0 >> 5, weights from the
//             reference LUT, each zeroed for a tap outside the frame
//             (0 <= fx + t < W, not the source rect), csum / rsum their sums;
//   full      sum over the taps that lie inside the window (rows y0 ..
//             y0 + Sr, columns x0 + xoff .. x0 + xoff + K) of
//             wy * (sum of pixel * wx), plus (1 - rsum * csum) * bg; the
//             column products in float32, with both operands rounded to bf16
//             (the TPU's default MXU pass), or as hi*hi + lo*hi + hi*lo with
//             hi = bf16(x), lo = bf16(x - hi) (the three-pass fix);
//   noop      img[y0, x0] + u;
//   nomatmul  C0 * 1e-6 + R0 + img[y0, x0] + csum + rsum, where C0 is the
//             weight of the tap at window column 0 (wxm[-fx_rel] when
//             0 <= -fx_rel < 8, else 0; fx_rel = fx - x0 - xoff) and R0 the
//             same for rows (perf_probe4.py:182-207);
//   nobuild   sum over r < Sr of (r * 1e-6) * sum over c < Sc of
//             win[r, c] * (c * 1e-6 + u * 1e-9): computed as its
//             factorisation, A[r] + (u * 1e-9) * B[r] with A[r] = sum of
//             win[r, c] * (c * 1e-6) and B[r] = sum of win[r, c], staged once
//             per tile in shared memory.
// Window reads past the frame are 0 (the TPU's zero padding). The TPU's
// window DMA, the one-hot band matrices (build8) and the lane roll are how
// the TPU gathers; here each tap is read where it lies.
//
// What bounds it on an H100: as sampler.cu, the tap loads (64 per pixel,
// mostly L1/L2 hits) against the u, v in and out written (12 B/px for one
// channel); noop and nomatmul move the same bytes with almost no tap work,
// which is the cost split the probe reads.
//
// What the simple design does about it: one block of 256 threads per tile,
// each thread walking the tile's pixels in steps of 256, taps read with
// __ldg, the weights from this unit's own LUT copy in constant memory
// (gf_probe_sampler_set_lut).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;   // nobuild's staged rows
constexpr int kTaps = 8;
constexpr int kLanczosInd = 192;

enum Mode { kNoop = 0, kNobuild = 1, kNomatmul = 2, kFull = 3 };
enum Precision { kFp32 = 0, kBf16 = 1, kBf16x3 = 2 };

}  // namespace

// Geometry and background, passed by value.
struct ProbeArgs {
    int H, W;        // frame: taps outside it weigh 0, window reads outside it are 0
    int Sr, Sc, K;   // window rows, window columns, compute width
    int P;           // pixels per tile
    float bg[4];
};

namespace {

__device__ __forceinline__ float bf16r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));   // round half to even
}

template <int C>
__device__ __forceinline__ float win_at(const float* __restrict__ img, const ProbeArgs& a, int y,
                                        int x, int c) {
    return (y >= 0 && y < a.H && x >= 0 && x < a.W)
               ? __ldg(img + ((long long)y * a.W + x) * C + c) : 0.0f;
}

template <int C, int MODE, int PREC>
__global__ void __launch_bounds__(kThreads)
probe_sampler_kernel(const float* __restrict__ img, const float* __restrict__ us,
                     const float* __restrict__ vs, const int32_t* __restrict__ y0s,
                     const int32_t* __restrict__ x0s, const int32_t* __restrict__ xoffs,
                     ProbeArgs a, float* __restrict__ out) {
    const int t = blockIdx.x;
    const int y0 = y0s[t], x0 = x0s[t], xoff = xoffs[t];
    const long long tb = (long long)t * a.P;

    __shared__ float stage[2][C][kMaxRows];   // nobuild: A[r], B[r] per channel
    if constexpr (MODE == kNobuild) {
        const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
        for (int r = warp; r < a.Sr; r += kWarps) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float sa = 0.0f, sb = 0.0f;
                for (int col = lane; col < a.Sc; col += 32) {
                    const float w = win_at<C>(img, a, y0 + r, x0 + col, c);
                    sa = sa + w * ((float)col * 1e-6f);
                    sb = sb + w;
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    sa = sa + __shfl_xor_sync(0xffffffffu, sa, off);
                    sb = sb + __shfl_xor_sync(0xffffffffu, sb, off);
                }
                if (lane == 0) {
                    stage[0][c][r] = sa;
                    stage[1][c][r] = sb;
                }
            }
        }
        __syncthreads();
    }

    for (int p = threadIdx.x; p < a.P; p += kThreads) {
        const float u = us[tb + p], v = vs[tb + p];
        float* o = out + (tb + p) * C;

        if constexpr (MODE == kNoop) {
#pragma unroll
            for (int c = 0; c < C; ++c) o[c] = win_at<C>(img, a, y0, x0, c) + u;
        } else if constexpr (MODE == kNobuild) {
            const float uc = u * 1e-9f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float s = 0.0f;
                for (int r = 0; r < a.Sr; ++r)
                    s = s + ((float)r * 1e-6f) * (stage[0][c][r] + uc * stage[1][c][r]);
                o[c] = s;
            }
        } else {
            const int sx0 = __float2int_rn((u - 3.0f) * (float)gf::kInterTabSize);
            const int sy0 = __float2int_rn((v - 3.0f) * (float)gf::kInterTabSize);
            const int fx = sx0 >> gf::kInterBits;
            const int fy = sy0 >> gf::kInterBits;
            const int base_x = kLanczosInd + ((sx0 & (gf::kInterTabSize - 1)) << 3);
            const int base_y = kLanczosInd + ((sy0 & (gf::kInterTabSize - 1)) << 3);
            float wxm[kTaps], wym[kTaps];
            float csum = 0.0f, rsum = 0.0f;
#pragma unroll
            for (int k = 0; k < kTaps; ++k) {
                const bool xok = fx + k >= 0 && fx + k < a.W;
                const bool yok = fy + k >= 0 && fy + k < a.H;
                wxm[k] = gf::c_coeffs[base_x + k] * (xok ? 1.0f : 0.0f);
                wym[k] = gf::c_coeffs[base_y + k] * (yok ? 1.0f : 0.0f);
                csum = csum + wxm[k];
                rsum = rsum + wym[k];
            }
            const int fx_rel = fx - x0 - xoff;
            const int fy_rel = fy - y0;

            if constexpr (MODE == kNomatmul) {
                float c0 = 0.0f, r0 = 0.0f;
#pragma unroll
                for (int k = 0; k < kTaps; ++k) {
                    if (k == -fx_rel) c0 = wxm[k];
                    if (k == -fy_rel) r0 = wym[k];
                }
#pragma unroll
                for (int c = 0; c < C; ++c)
                    o[c] = (((c0 * 1e-6f + r0) + win_at<C>(img, a, y0, x0, c)) + csum) + rsum;
            } else {
                float total[C];
#pragma unroll
                for (int c = 0; c < C; ++c) total[c] = 0.0f;
#pragma unroll
                for (int ty = 0; ty < kTaps; ++ty) {
                    const int r = fy_rel + ty;
                    const int yy = fy + ty;
                    // outside the window's rows, or a zero pad row of weight 0
                    if (r < 0 || r >= a.Sr || yy >= a.H) continue;
                    float s[C], s_lh[C], s_hl[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) s[c] = s_lh[c] = s_hl[c] = 0.0f;
#pragma unroll
                    for (int tx = 0; tx < kTaps; ++tx) {
                        const int cc = fx_rel + tx;
                        const int xx = fx + tx;
                        // outside the compute width, or a zero pad column of weight 0
                        if (cc < 0 || cc >= a.K || xx >= a.W) continue;
                        const float* px = img + ((long long)yy * a.W + xx) * C;
                        const float w = wxm[tx];
#pragma unroll
                        for (int c = 0; c < C; ++c) {
                            const float val = __ldg(px + c);
                            if constexpr (PREC == kFp32) {
                                s[c] = s[c] + val * w;
                            } else if constexpr (PREC == kBf16) {
                                s[c] = s[c] + bf16r(val) * bf16r(w);
                            } else {
                                const float vh = bf16r(val), wh = bf16r(w);
                                const float vl = bf16r(val - vh), wl = bf16r(w - wh);
                                s[c] = s[c] + vh * wh;
                                s_lh[c] = s_lh[c] + vl * wh;
                                s_hl[c] = s_hl[c] + vh * wl;
                            }
                        }
                    }
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const float colmix = PREC == kBf16x3 ? (s[c] + s_lh[c]) + s_hl[c] : s[c];
                        total[c] = total[c] + wym[ty] * colmix;
                    }
                }
                const float bg_weight = 1.0f - rsum * csum;
#pragma unroll
                for (int c = 0; c < C; ++c) o[c] = total[c] + bg_weight * a.bg[c];
            }
        }
    }
}

struct Launch {
    int ntiles;
    const void *img, *u, *v, *y0s, *x0s, *xoffs;
    const ProbeArgs* a;
    void* out;
    cudaStream_t s;
};

template <int C, int MODE, int PREC>
bool launch(const Launch& l) {
    probe_sampler_kernel<C, MODE, PREC><<<l.ntiles, kThreads, 0, l.s>>>(
        static_cast<const float*>(l.img), static_cast<const float*>(l.u),
        static_cast<const float*>(l.v), static_cast<const int32_t*>(l.y0s),
        static_cast<const int32_t*>(l.x0s), static_cast<const int32_t*>(l.xoffs), *l.a,
        static_cast<float*>(l.out));
    return true;
}

template <int C>
bool dispatch_mode(int mode, int precision, const Launch& l) {
    if (mode != kFull) {
        if (precision != kFp32) return false;
        switch (mode) {
            case kNoop: return launch<C, kNoop, kFp32>(l);
            case kNobuild: return launch<C, kNobuild, kFp32>(l);
            case kNomatmul: return launch<C, kNomatmul, kFp32>(l);
            default: return false;
        }
    }
    switch (precision) {
        case kFp32: return launch<C, kFull, kFp32>(l);
        case kBf16: return launch<C, kFull, kBf16>(l);
        case kBf16x3: return launch<C, kFull, kBf16x3>(l);
        default: return false;
    }
}

}  // namespace

// Copies the 448-float LUT (host pointer) into this unit's constant memory
// on the current device. Returns the cudaError_t of the copy.
extern "C" int gf_probe_sampler_set_lut(const float* lut, int n) { return gf::set_lut(lut, n); }

// img: float32 (H, W, C) channels-last; u, v: float32 (ntiles, P); y0s,
// x0s, xoffs: int32 (ntiles,); out: float32 (ntiles, P, C). mode: 0 noop,
// 1 nobuild, 2 nomatmul, 3 full; precision (full only): 0 float32, 1 bf16,
// 2 bf16 hi/lo three-product. All device pointers, contiguous. Returns -1
// for an unsupported C, mode or precision or more than 64 window rows in
// nobuild, else cudaGetLastError() after the launch.
extern "C" int gf_probe_sampler(const void* img, int C, const void* u, const void* v,
                                const void* y0s, const void* x0s, const void* xoffs, int ntiles,
                                ProbeArgs args, int mode, int precision, void* out,
                                void* stream) {
    if (mode == kNobuild && args.Sr > kMaxRows) return -1;
    const Launch l{ntiles, img, u, v, y0s, x0s, xoffs, &args, out,
                   static_cast<cudaStream_t>(stream)};
    bool ok = false;
    switch (C) {
        case 1: ok = dispatch_mode<1>(mode, precision, l); break;
        case 2: ok = dispatch_mode<2>(mode, precision, l); break;
        default: break;
    }
    if (!ok) return -1;
    return static_cast<int>(cudaGetLastError());
}
