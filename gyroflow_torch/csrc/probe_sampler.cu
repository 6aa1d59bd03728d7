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
// What bounds it on an H100: as sampler.cu, not the bytes (u, v in and the
// output written, 12 B a pixel for one channel, 0.0396 ms for probe 4's 4K
// Y plane at 3.35 TB/s) but the instructions a pixel: full sums 64 taps a
// channel. noop and nomatmul move the same bytes with almost no tap work,
// which is the cost split the probe reads. The first form ran as
// sampler.cu did before its redesign: the weights from the whole LUT in
// __constant__ memory at each lane's own phase (the x-phase differs in
// nearly every lane, so the constant cache served the 32 addresses one
// after another), one scalar load a tap with two tests a tap, and each of
// a tile block's 256 threads walking the tile's pixels one at a time. It
// read 0.6989 ms for probe 4's full mode against 0.2302 for sampler.cu on
// the same u/v (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): the probe cost
// three times the kernel it dissects.
//
// What the design does about it (for full and nomatmul; readings by
// gyroflow_torch.experiments.probe_bench, NVIDIA H100 80GB HBM3, 700.00 W,
// in PERF.md):
// - the block stages the lanczos4 slice of the LUT (1 KB,
//   cuda_sampler.lut_slice) in shared memory and each pixel reads its 8 x-
//   and 8 y-weights as float4s (taps.cuh stage_lut, phase_weights), as
//   sampler.cu does;
// - a stencil that lies wholly inside the tile's window (rows and compute
//   width) and the frame, 99.7-100% of the probes' pixels, counts every tap:
//   it reads them with no test, one load a pixel (taps.cuh load_pixel: a
//   float for C=1, a float2 for probe 5's C=2 UV plane). Every other
//   stencil takes the checked loop, which skips the taps outside the window
//   or the frame;
// - bf16 and bf16x3 round each weight (and split it into hi and lo) once a
//   pixel, not once a tap; the pixel values are rounded a tap, as before;
// - blocks of 128 threads each take 2 x 128 pixels of one tile, two a
//   thread (p and p + 128, unrolled), so a warp reads 32 neighbouring
//   pixels of a tile row and each thread has two pixels' loads in flight.
// Probe 4's full mode went 0.6968 -> 0.1672 ms, below sampler.cu's 0.2302
// on the same u/v (uint16 rows); nomatmul 0.3317 -> 0.0812. Read and
// rejected: the stencil rows by aligned 16-byte loads (taps.cuh load_row;
// full 0.2162, probe 5 UV 0.0825 against 0.0669 a pixel at a time); one
// pixel a thread (0.2234 against 0.2164 in that form); 256 threads a block
// (0.2409); four pixels a thread (full 4% faster, bf16x3 12% slower and
// nomatmul twice as slow); the two pixels in a rolled loop (full the same,
// nomatmul twice as slow); 64 threads a block (full 4% slower).
// noop and nobuild keep their first form: one block of 256 threads a tile
// (nobuild stages its per-tile row sums in shared memory once a tile).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

namespace {

constexpr int kTileThreads = 256;               // noop, nobuild: one block a tile
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kThreads = 128;                   // full, nomatmul
constexpr int kPixelsPerThread = 2;
constexpr int kPixelsPerBlock = kThreads * kPixelsPerThread;
constexpr int kMaxRows = 64;   // nobuild's staged rows
constexpr int kTaps = 8;

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

// noop and nobuild: one block a tile, each thread walking its pixels.
template <int C, int MODE>
__global__ void __launch_bounds__(kTileThreads)
probe_tile_kernel(const float* __restrict__ img, const float* __restrict__ us,
                  const int32_t* __restrict__ y0s, const int32_t* __restrict__ x0s,
                  ProbeArgs a, float* __restrict__ out) {
    const int t = blockIdx.x;
    const int y0 = y0s[t], x0 = x0s[t];
    const long long tb = (long long)t * a.P;

    __shared__ float stage[2][C][kMaxRows];   // nobuild: A[r], B[r] per channel
    if constexpr (MODE == kNobuild) {
        const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
        for (int r = warp; r < a.Sr; r += kTileWarps) {
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

    for (int p = threadIdx.x; p < a.P; p += kTileThreads) {
        const float u = us[tb + p];
        float* o = out + (tb + p) * C;
        if constexpr (MODE == kNoop) {
#pragma unroll
            for (int c = 0; c < C; ++c) o[c] = win_at<C>(img, a, y0, x0, c) + u;
        } else {
            const float uc = u * 1e-9f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float s = 0.0f;
                for (int r = 0; r < a.Sr; ++r)
                    s = s + ((float)r * 1e-6f) * (stage[0][c][r] + uc * stage[1][c][r]);
                o[c] = s;
            }
        }
    }
}

// A tap's column product into the column sums s (and s_lh, s_hl for
// bf16x3): w is the weight as the precision needs it (rounded to bf16 for
// bf16, its hi part for bf16x3), wl its lo part (bf16x3).
template <int PREC>
__device__ __forceinline__ void column_product(float val, float w, float wl, float& s,
                                               float& s_lh, float& s_hl) {
    if constexpr (PREC == kFp32) {
        s = s + val * w;
    } else if constexpr (PREC == kBf16) {
        s = s + bf16r(val) * w;
    } else {
        const float vh = bf16r(val);
        const float vl = bf16r(val - vh);
        s = s + vh * w;
        s_lh = s_lh + vl * w;
        s_hl = s_hl + vh * wl;
    }
}

// One pixel of nomatmul or full at (u, v) in the tile with window origin
// (y0, x0 + xoff).
template <int C, int MODE, int PREC>
__device__ __forceinline__ void probe_pixel(const float* __restrict__ img, bool aligned,
                                            float u, float v, int y0, int x0, int xoff,
                                            const ProbeArgs& a, const float* s_lut,
                                            float* __restrict__ o) {
    const int sx0 = __float2int_rn((u - 3.0f) * (float)gf::kInterTabSize);
    const int sy0 = __float2int_rn((v - 3.0f) * (float)gf::kInterTabSize);
    const int fx = sx0 >> gf::kInterBits;
    const int fy = sy0 >> gf::kInterBits;
    float wxm[kTaps], wym[kTaps];
    gf::phase_weights<kTaps>(s_lut, sx0 & (gf::kInterTabSize - 1), wxm);
    gf::phase_weights<kTaps>(s_lut, sy0 & (gf::kInterTabSize - 1), wym);
    float csum = 0.0f, rsum = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
        const bool xok = fx + k >= 0 && fx + k < a.W;
        const bool yok = fy + k >= 0 && fy + k < a.H;
        wxm[k] = wxm[k] * (xok ? 1.0f : 0.0f);
        wym[k] = wym[k] * (yok ? 1.0f : 0.0f);
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
        return;
    }

    // the column weights as the precision multiplies them, rounded once
    float wk[kTaps], wl[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
        if constexpr (PREC == kFp32) {
            wk[k] = wxm[k];
            wl[k] = 0.0f;
        } else {
            wk[k] = bf16r(wxm[k]);
            wl[k] = PREC == kBf16x3 ? bf16r(wxm[k] - wk[k]) : 0.0f;
        }
    }
    float total[C];
#pragma unroll
    for (int c = 0; c < C; ++c) total[c] = 0.0f;

    // the whole stencil inside the window and the frame (and the plane
    // aligned to a pixel): every tap counts, read with no test
    if (aligned && fy_rel >= 0 && fy_rel + kTaps <= a.Sr && fx_rel >= 0 &&
        fx_rel + kTaps <= a.K && fx >= 0 && fx + kTaps <= a.W && fy >= 0 && fy + kTaps <= a.H) {
#pragma unroll
        for (int ty = 0; ty < kTaps; ++ty) {
            const float* row = img + ((long long)(fy + ty) * a.W + fx) * C;
            float s[C], s_lh[C], s_hl[C];
#pragma unroll
            for (int c = 0; c < C; ++c) s[c] = s_lh[c] = s_hl[c] = 0.0f;
#pragma unroll
            for (int tx = 0; tx < kTaps; ++tx) {
                float px[C];
                gf::load_pixel<C>(row + tx * C, px);
#pragma unroll
                for (int c = 0; c < C; ++c)
                    column_product<PREC>(px[c], wk[tx], wl[tx], s[c], s_lh[c], s_hl[c]);
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float colmix = PREC == kBf16x3 ? (s[c] + s_lh[c]) + s_hl[c] : s[c];
                total[c] = total[c] + wym[ty] * colmix;
            }
        }
    } else {
#pragma unroll
        for (int ty = 0; ty < kTaps; ++ty) {
            const int r = fy_rel + ty;
            const int yy = fy + ty;
            // outside the window's rows, or a zero pad row of weight 0
            if (r < 0 || r >= a.Sr || yy < 0 || yy >= a.H) continue;
            float s[C], s_lh[C], s_hl[C];
#pragma unroll
            for (int c = 0; c < C; ++c) s[c] = s_lh[c] = s_hl[c] = 0.0f;
#pragma unroll
            for (int tx = 0; tx < kTaps; ++tx) {
                const int cc = fx_rel + tx;
                const int xx = fx + tx;
                // outside the compute width, or a zero pad column of weight 0
                if (cc < 0 || cc >= a.K || xx < 0 || xx >= a.W) continue;
                const float* px = img + ((long long)yy * a.W + xx) * C;
#pragma unroll
                for (int c = 0; c < C; ++c)
                    column_product<PREC>(__ldg(px + c), wk[tx], wl[tx], s[c], s_lh[c], s_hl[c]);
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float colmix = PREC == kBf16x3 ? (s[c] + s_lh[c]) + s_hl[c] : s[c];
                total[c] = total[c] + wym[ty] * colmix;
            }
        }
    }
    const float bg_weight = 1.0f - rsum * csum;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = total[c] + bg_weight * a.bg[c];
}

// nomatmul and full: blocks of kThreads take kPixelsPerBlock pixels of one
// tile, kPixelsPerThread a thread (p and p + kThreads).
template <int C, int MODE, int PREC>
__global__ void __launch_bounds__(kThreads)
probe_sampler_kernel(const float* __restrict__ img, const float* __restrict__ us,
                     const float* __restrict__ vs, const int32_t* __restrict__ y0s,
                     const int32_t* __restrict__ x0s, const int32_t* __restrict__ xoffs,
                     const float* __restrict__ lut, ProbeArgs a, int blocks_per_tile,
                     float* __restrict__ out) {
    __shared__ __align__(16) float s_lut[gf::kSliceSize<kTaps>];
    gf::stage_lut<kTaps>(lut, s_lut);

    const int t = blockIdx.x / blocks_per_tile;
    const int first = (blockIdx.x - t * blocks_per_tile) * kPixelsPerBlock + threadIdx.x;
    const int y0 = __ldg(y0s + t), x0 = __ldg(x0s + t), xoff = __ldg(xoffs + t);
    const long long tb = (long long)t * a.P;
    const bool aligned = (reinterpret_cast<uintptr_t>(img) & (gf::kPixelAlign<C> - 1)) == 0;
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
        const int p = first + k * kThreads;
        if (p >= a.P) return;
        probe_pixel<C, MODE, PREC>(img, aligned, us[tb + p], vs[tb + p], y0, x0, xoff, a, s_lut,
                                   out + (tb + p) * C);
    }
}

struct Launch {
    int ntiles;
    const void *img, *u, *v, *y0s, *x0s, *xoffs, *lut;
    const ProbeArgs* a;
    void* out;
    cudaStream_t s;
};

template <int C, int MODE>
bool launch_tile(const Launch& l) {
    probe_tile_kernel<C, MODE><<<l.ntiles, kTileThreads, 0, l.s>>>(
        static_cast<const float*>(l.img), static_cast<const float*>(l.u),
        static_cast<const int32_t*>(l.y0s), static_cast<const int32_t*>(l.x0s), *l.a,
        static_cast<float*>(l.out));
    return true;
}

template <int C, int MODE, int PREC>
bool launch(const Launch& l) {
    const int blocks_per_tile = (l.a->P + kPixelsPerBlock - 1) / kPixelsPerBlock;
    const long long blocks = (long long)l.ntiles * blocks_per_tile;
    if (blocks > 0x7fffffffLL) return false;
    probe_sampler_kernel<C, MODE, PREC><<<static_cast<unsigned>(blocks), kThreads, 0, l.s>>>(
        static_cast<const float*>(l.img), static_cast<const float*>(l.u),
        static_cast<const float*>(l.v), static_cast<const int32_t*>(l.y0s),
        static_cast<const int32_t*>(l.x0s), static_cast<const int32_t*>(l.xoffs),
        static_cast<const float*>(l.lut), *l.a, blocks_per_tile, static_cast<float*>(l.out));
    return true;
}

template <int C>
bool dispatch_mode(int mode, int precision, const Launch& l) {
    if (mode != kFull) {
        if (precision != kFp32) return false;
        switch (mode) {
            case kNoop: return launch_tile<C, kNoop>(l);
            case kNobuild: return launch_tile<C, kNobuild>(l);
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

// img: float32 (H, W, C) channels-last; u, v: float32 (ntiles, P); y0s,
// x0s, xoffs: int32 (ntiles,); lut: the lanczos4 slice of the LUT, float32
// COEFFS[192 : 448] on the device, 16-byte aligned (read by nomatmul and
// full); out: float32 (ntiles, P, C). mode: 0 noop, 1 nobuild, 2 nomatmul,
// 3 full; precision (full only): 0 float32, 1 bf16, 2 bf16 hi/lo
// three-product. All device pointers, contiguous. Returns -1 for an
// unsupported C, mode or precision, more than 64 window rows in nobuild or
// more blocks than a grid holds, else cudaGetLastError() after the launch.
extern "C" int gf_probe_sampler(const void* img, int C, const void* u, const void* v,
                                const void* y0s, const void* x0s, const void* xoffs, int ntiles,
                                const void* lut, ProbeArgs args, int mode, int precision,
                                void* out, void* stream) {
    if (mode == kNobuild && args.Sr > kMaxRows) return -1;
    const Launch l{ntiles, img, u, v, y0s, x0s, xoffs, lut, &args, out,
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
