// Coords kernel: per-pixel rolling-shutter matrix projection.
//
// Replaces gyroflow_tpu/ops/pallas_coords.py::_coords_kernel (driven by
// _coords_call and project_tiles). For each output pixel it fetches row
// idx of the (rows, 14) matrix table and runs rotate_and_distort_core
// (project_point, lens.cuh) -> u, v, valid, for every distortion model and
// digital lens of the reference: one instantiation per main model (the
// fisheye one is the code it always was), each in three forms: the plain
// form; the digital form, with the digital-lens step (its lens chosen at run
// time); and the mesh form, which adds the Sony mesh and focal-plane stages
// (lens.cuh, MeshArgs; gyroflow_tpu/ops/mesh.py, which the JAX package runs
// in XLA around its Pallas sampler: no TPU kernel of its own). Each form
// compiles only the stages it can run, so a frame without a mesh, and a
// digital lens above all, keeps the registers and the time of its own code.
//
// What bounds it on an H100: the float32 ALU chain per pixel (3x3 projection,
// two IEEE divisions and a sqrt, then the model: for fisheye the Cephes
// arctangent and the polynomial, ~60 dependent operations; gopro adds a
// 10-step Newton, a digital lens a 12-step fixed point; then f/c/stretch).
// The memory traffic is small: x, y, idx in (12 B) and u, v, valid out (9 B)
// per pixel, and the matrix table (121 KB at 4K) stays in L2.
//
// What the simple design does about it: one thread per output pixel on a
// 2-D grid of 32x8 blocks, so a warp covers 32 neighbouring pixels of one
// row (coalesced I/O, and the warp's rows of the table are the same or
// adjacent cache lines). The row is read straight from global memory: the
// TPU kernel's window DMA, one-hot MXU gather and overflow flag exist only
// because the TPU has no fast gather, and none of them is needed here.
// Nothing is staged in shared memory; occupancy hides the chain's latency.
//
// The iterative forms (gopro's Newton loop, a digital lens's fixed point)
// are bound by that chain times the steps a warp runs. A lane leaves its
// loop once it is done (its value never changes again, so the bits are the
// plain masked loop's; a NaN lane is never done and runs every step), so a
// warp runs its slowest lane's steps, not all 10 or 12: on chip_smoke.py's
// 4K phase 8 planes 3.0 of gopro's 10, 5.6-10.4 of a digital lens's 12 on
// the fisheye (the script prints each warp-max mean beside the lane mean).
//
// The mesh form is bound by instruction issue: at 9x9 each pixel runs two
// natural-spline solves (~490 FP32 operations in all, the projection
// included), 12 IEEE divisions, each with its range check, and the selects
// that read one segment's values out of registers. Its design:
// - the launch-uniform values (the crop header and spans, the FPD band, the
//   spline's h, 1 / h, 3 / h, h / 3, 3 h) come from the packed block the
//   host appends to the frame's mesh buffer (cuda_coords.pack_mesh), three
//   16-byte loads a thread, in place of a division and ~16 operations a
//   pixel and channel;
// - the y segment, its offset and the edge tests are computed once for both
//   channels;
// - each grid row of x segment fi is one 16-byte load (a, b, c, d);
// - the spline is streamed: a row's a[j] as it arrives, the recurrence's
//   zs[j - 1] once a[j] is known, and only the a[j] and c[j] the evaluation
//   reads are kept, so the form holds 48 registers with no spill;
// - only a pixel beyond the grid's edge evaluates an edge piece (a branch);
// - the Sony model's mesh form has an instantiation per grid height
//   (coords_mesh_kernel<sony, 2..9>): no row guard, the edge pieces at fixed
//   rows. Other models take the height at run time.
// Staging the mesh in shared memory lost 10% to __ldg; a per-warp hoist of
// segment fi's rows by shuffles would replace 9 loads a channel by 36
// shuffles of an issue-bound form, and was not tried.
//
// gf_coords_gen (coords_gen_kernel below) replaces
// gyroflow_tpu/ops/pallas_coords.py::_coords_kernel_gen (:257, driven by
// _coords_call_gen :351 and project_tiles_gen :396), the self-contained
// form: no x/y/idx input. Each thread takes its output pixel from its index
// (ox = column, oy = oy0 + row of the band; the TPU kernel's float floor-div
// over tile ids is not needed), then runs coords_pre's plain form
// (remap.py:187: the out-rect map, +translation2d; no lens-correction
// blend, so the wrapper refuses lens correction, mesh and digital lenses,
// as JAX gates project_tiles_gen; it admits every main model),
// the rolling-shutter probe through the centre matrix row, the row select
// min(where(pvalid, clip(rint(probe)), clip(rint(fallback))), rows - 1),
// and the projection through the selected row. The matrix-window DMA, its
// exact window check and overflow output, and project_tiles_gen's 6-point
// coarse window plan are TPU-only and not ported. It reads no x, y, idx
// and writes u, v, valid (9 B/px) while running two projection chains per
// pixel (the probe and the projection, ~170 FP32 operations). Its bytes are
// few (0.0279 ms on 4K Y+UV); what bounds it is instruction issue: each
// chain's IEEE divisions and square root, the accurate arctangent, and each
// multiply and add on its own (--fmad=false). Its first form issued ~498
// instructions a pixel (the SASS walk of sampler_bench.py), 1.13x the time
// the card needs to issue them (NVIDIA H100 80GB HBM3, 700.00 W: PERF.md),
// so the redesign cuts instructions, not bytes:
// - the probe keeps only the coordinate the row select reads (a branch on
//   the launch-uniform HORIZONTAL_RS flag picks an inlined copy that has
//   the other one's last steps, among them an IEEE division, left out);
// - the arctangent divides once (lens.cuh atanf_cephes), and a stretch of
//   exactly 1 divides not at all (project_point): the same bits, and every
//   kernel that projects gains them;
// - the out-rect map's "+ 0" is left out (gen_args sends t2d without -0);
// - both matrix rows come in seven 8-byte loads each (a row is 56 bytes, so
//   every row is 8-byte aligned when the table is).
// Read one at a time and rejected: two pixels a thread on 32x4 blocks (46-48
// registers against 32, fewer warps: 13% slower), the centre row staged in
// shared memory once a block (no gain over its loads: the barrier and the
// staging cost what the loads saved), and a pixel that selects the centre
// row keeping the probe's result (3% slower: the branch diverges, and the
// probe must then keep both coordinates). One thread a pixel on 32x8
// blocks, as before.
//
// gf_coords_gen_ewa (coords_gen_kernel_ewa) is its EWA form: the base eval
// and the two +eps evals of remap.ewa_stack, stacked as one gf_coords launch
// over ewa_stack's (3 * oh, ow) x, y, idx would write them. In place of
// three eager coords_pre passes, their concatenation and the stacked
// launch (63 B a pixel: x, y, idx in and u, v, valid out, for each eval),
// it reads nothing per pixel and writes 27 B. Being issue-bound like its
// one-eval form, it shares what the evals share: one out-rect position and
// one probe (the +eps evals take the base eval's row by default,
// ewa_stack's rs_idx), one load of the selected row, and the x (y) map of
// the y (x) eval; the three projections are what is left. On 4K Y+UV it
// takes 0.2815 ms, the stacked gf_coords launch alone 0.2951 (NVIDIA H100
// 80GB HBM3, 700.00 W: PERF.md). The ewa_ref_jac mode (a probe per eval)
// is a launch-uniform branch, not another instantiation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lens.cuh"

// The self-contained kernel's grid and coords_pre constants.
struct GenArgs {
    int oy0;          // absolute output row of the band's first row
    float pos_d[2];   // pos_dx, pos_dy added to ox, oy
    float map_x[3];   // out-rect map: in_min, out_max - out_min, 1 / (in_max - in_min)
    float map_y[3];
    float t2d[2];     // translation2d, -0 sent as +0
    float lim;        // RS row clip: width (horizontal RS) or height
};

namespace {

// One output pixel of the coords kernel's forms (below).
template <int MODEL, bool DIGITAL, bool MESH, int GH>
__device__ __forceinline__ void coords_pixel(const float* __restrict__ xs,
                                             const float* __restrict__ ys,
                                             const int32_t* __restrict__ idx,
                                             const float* __restrict__ mats, int rows,
                                             const gf::CoordParams& p, int flags, int digital,
                                             int oh, int ow, float* __restrict__ us,
                                             float* __restrict__ vs,
                                             uint8_t* __restrict__ valid_out,
                                             const gf::MeshArgs& mesh) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= ow || row >= oh) return;
    const long long i = (long long)row * ow + col;

    int r = idx[i];
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
    const float* mrow = mats + (long long)r * 14;
    float m[14];
#pragma unroll
    for (int j = 0; j < 14; ++j) m[j] = __ldg(mrow + j);

    float u, v;
    bool valid;
    gf::project_point<MODEL, DIGITAL, MESH, GH>(xs[i], ys[i], m, p, flags, u, v, valid, MODEL,
                                                digital, &mesh);
    us[i] = u;
    vs[i] = v;
    valid_out[i] = valid ? 1 : 0;
}

// The plain, digital and mesh forms of each main model (the mesh form's
// grid height read at run time).
template <int MODEL, bool DIGITAL, bool MESH>
__global__ void coords_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                              const int32_t* __restrict__ idx,
                              const float* __restrict__ mats, int rows,
                              gf::CoordParams p, int flags, int digital, int oh, int ow,
                              float* __restrict__ us, float* __restrict__ vs,
                              uint8_t* __restrict__ valid_out,
                              const __grid_constant__ gf::MeshArgs mesh) {
    coords_pixel<MODEL, DIGITAL, MESH, 0>(xs, ys, idx, mats, rows, p, flags, digital, oh, ow,
                                          us, vs, valid_out, mesh);
}

// The mesh form of a grid GH rows high, for the Sony model (the lens of the
// bodies that record a mesh): the spline's rows fixed at compile time.
template <int MODEL, int GH>
__global__ void coords_mesh_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                                   const int32_t* __restrict__ idx,
                                   const float* __restrict__ mats, int rows,
                                   gf::CoordParams p, int flags, int digital, int oh, int ow,
                                   float* __restrict__ us, float* __restrict__ vs,
                                   uint8_t* __restrict__ valid_out,
                                   const __grid_constant__ gf::MeshArgs mesh) {
    coords_pixel<MODEL, true, true, GH>(xs, ys, idx, mats, rows, p, flags, digital, oh, ow, us,
                                        vs, valid_out, mesh);
}

// remap._rint_index: rint, NaN -> 0, +inf -> lim, -inf -> 0, clip to [0, lim].
__device__ __forceinline__ int rint_index(float a, float lim) {
    float r = rintf(a);
    r = r != r ? 0.0f : r;
    r = fminf(fmaxf(r, 0.0f), lim);
    return static_cast<int>(r);
}

// The rolling-shutter probe's row: the point through the centre row, and
// of the projection only the coordinate the row select reads (the other
// one's last steps, among them an IEEE division, are left out: the kept
// coordinate's operations and their order are the projection's own).
template <int MODEL, bool HORIZONTAL>
__device__ __forceinline__ int probe_row(float x, float y, const float* mc,
                                         const gf::CoordParams& p, int flags, float lim) {
    float pu, pv;
    bool pvalid;
    gf::project_point<MODEL, false>(x, y, mc, p, flags, pu, pv, pvalid);
    return rint_index(pvalid ? (HORIZONTAL ? pu : pv) : (HORIZONTAL ? x : y), lim);
}

// The rolling-shutter row of the point (x, y) (remap.py:205-217): the probe
// through the centre matrix row, then min(where(pvalid, clip(rint(probe)),
// clip(rint(fallback))), rows - 1).
template <int MODEL>
__device__ __forceinline__ int gen_row(float x, float y, const float* __restrict__ mats, int rows,
                                       bool aligned8, const gf::CoordParams& p, int flags,
                                       float lim) {
    const bool horizontal = flags & gf::HORIZONTAL_RS;
    int sy;
    if (rows > 1) {
        float mc[14];
        gf::load_matrix_row(mats + (long long)(rows / 2) * 14, aligned8, mc);
        sy = horizontal ? probe_row<MODEL, true>(x, y, mc, p, flags, lim)
                        : probe_row<MODEL, false>(x, y, mc, p, flags, lim);
    } else {
        sy = rint_index(horizontal ? x : y, lim);
    }
    return sy < rows - 1 ? sy : rows - 1;
}

// The projection of (x, y) through matrix row m, written at j.
template <int MODEL>
__device__ __forceinline__ void project_store(float x, float y, const float* m,
                                              const gf::CoordParams& p, int flags, long long j,
                                              float* __restrict__ us, float* __restrict__ vs,
                                              uint8_t* __restrict__ valid_out) {
    float u, v;
    bool valid;
    gf::project_point<MODEL, false>(x, y, m, p, flags, u, v, valid);
    us[j] = u;
    vs[j] = v;
    valid_out[j] = valid ? 1 : 0;
}

template <int MODEL>
__global__ void coords_gen_kernel(const float* __restrict__ mats, int rows, gf::CoordParams p,
                                  int flags, GenArgs g, int out_rows, int ow,
                                  float* __restrict__ us, float* __restrict__ vs,
                                  uint8_t* __restrict__ valid_out) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= ow || row >= out_rows) return;
    const long long i = (long long)row * ow + col;

    // coords_pre (remap.py:185-188) on ox + pos_dx, oy + pos_dy. map_coord's
    // division by the out-rect size is a multiply by its float32 reciprocal,
    // as torch divides by a host scalar on the card.
    const float ox = static_cast<float>(col) + g.pos_d[0];
    const float oy = static_cast<float>(g.oy0 + row) + g.pos_d[1];
    // The map's "+ out_min" (0) is left out: the translation's add follows,
    // and (a + 0) + t has the bits of a + (t + 0) for every a and t; the
    // host sends t2d with its -0 made +0 (gen_args).
    const float x = ((ox - g.map_x[0]) * g.map_x[1]) * g.map_x[2] + g.t2d[0];
    const float y = ((oy - g.map_y[0]) * g.map_y[1]) * g.map_y[2] + g.t2d[1];

    const bool aligned8 = (reinterpret_cast<uintptr_t>(mats) & 7) == 0;
    const int r = gen_row<MODEL>(x, y, mats, rows, aligned8, p, flags, g.lim);
    float m[14];
    gf::load_matrix_row(mats + (long long)r * 14, aligned8, m);
    project_store<MODEL>(x, y, m, p, flags, i, us, vs, valid_out);
}

// The EWA form (remap.ewa_stack, remap.py:783-794): each thread computes its
// pixel's base eval and the +eps evals in x and in y, written at i, n + i
// and 2n + i (n = out_rows * ow), the stacked (3 * out_rows, ow) layout of
// one gf_coords launch over ewa_stack's x, y, idx. ox + eps and oy + eps
// are float32 adds, as torch adds a Python scalar. In the default same-row
// mode the +eps evals take the base eval's row (coords_pre's rs_idx): one
// probe and one row load serve three projections, and y (x) of the x (y)
// eval is the base eval's. With ref_jac (KernelConfig.ewa_ref_jac, uniform
// over the launch) each +eps eval probes its own row, as coords_pre does
// without rs_idx.
template <int MODEL>
__global__ void coords_gen_kernel_ewa(const float* __restrict__ mats, int rows,
                                      gf::CoordParams p, int flags, GenArgs g, float eps,
                                      int ref_jac, int out_rows, int ow,
                                      float* __restrict__ us, float* __restrict__ vs,
                                      uint8_t* __restrict__ valid_out) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= ow || row >= out_rows) return;
    const long long n = (long long)out_rows * ow;
    const long long i = (long long)row * ow + col;

    const float ox = static_cast<float>(col) + g.pos_d[0];
    const float oy = static_cast<float>(g.oy0 + row) + g.pos_d[1];
    const float x0 = ((ox - g.map_x[0]) * g.map_x[1]) * g.map_x[2] + g.t2d[0];
    const float y0 = ((oy - g.map_y[0]) * g.map_y[1]) * g.map_y[2] + g.t2d[1];
    const float x1 = (((ox + eps) - g.map_x[0]) * g.map_x[1]) * g.map_x[2] + g.t2d[0];
    const float y2 = (((oy + eps) - g.map_y[0]) * g.map_y[1]) * g.map_y[2] + g.t2d[1];

    const bool aligned8 = (reinterpret_cast<uintptr_t>(mats) & 7) == 0;
    float m[14];
    int r = gen_row<MODEL>(x0, y0, mats, rows, aligned8, p, flags, g.lim);
    gf::load_matrix_row(mats + (long long)r * 14, aligned8, m);
    project_store<MODEL>(x0, y0, m, p, flags, i, us, vs, valid_out);
    if (ref_jac) {
        r = gen_row<MODEL>(x1, y0, mats, rows, aligned8, p, flags, g.lim);
        gf::load_matrix_row(mats + (long long)r * 14, aligned8, m);
    }
    project_store<MODEL>(x1, y0, m, p, flags, n + i, us, vs, valid_out);
    if (ref_jac) {
        r = gen_row<MODEL>(x0, y2, mats, rows, aligned8, p, flags, g.lim);
        gf::load_matrix_row(mats + (long long)r * 14, aligned8, m);
    }
    project_store<MODEL>(x0, y2, m, p, flags, 2 * n + i, us, vs, valid_out);
}

// The launches of each entry point, for gf::with_model: run<M>() launches
// the instantiation of main model M.
struct CoordsLaunch {
    const void *x, *y, *idx, *mats;
    int rows;
    const gf::CoordParams* p;
    int flags, digital, oh, ow;
    void *u, *v, *valid;
    cudaStream_t s;
    const gf::MeshArgs* mesh;

    // coords_mesh_kernel<M, GH> for GH == mesh->gh
    template <int M, int GH>
    void run_mesh(dim3 grid, dim3 block, const float* xf, const float* yf, const int32_t* ii,
                  const float* mf, float* uf, float* vf, uint8_t* vo) const {
        if constexpr (GH <= gf::kMaxGrid) {
            if (mesh->gh == GH) {
                coords_mesh_kernel<M, GH><<<grid, block, 0, s>>>(
                    xf, yf, ii, mf, rows, *p, flags, digital, oh, ow, uf, vf, vo, *mesh);
                return;
            }
            run_mesh<M, GH + 1>(grid, block, xf, yf, ii, mf, uf, vf, vo);
        }
    }

    template <int M>
    void run() const {
        const dim3 block(32, 8);
        const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
        const auto* xf = static_cast<const float*>(x);
        const auto* yf = static_cast<const float*>(y);
        const auto* ii = static_cast<const int32_t*>(idx);
        const auto* mf = static_cast<const float*>(mats);
        auto* uf = static_cast<float*>(u);
        auto* vf = static_cast<float*>(v);
        auto* vo = static_cast<uint8_t*>(valid);
        if constexpr (M == gf::kSony) {
            if ((flags & gf::HAS_MESH_DATA) && mesh->gh >= 2 && mesh->gh <= gf::kMaxGrid) {
                run_mesh<M, 2>(grid, block, xf, yf, ii, mf, uf, vf, vo);
                return;
            }
        }
        if (flags & (gf::HAS_MESH_DATA | gf::HAS_FPD_DATA)) {
            coords_kernel<M, true, true><<<grid, block, 0, s>>>(
                xf, yf, ii, mf, rows, *p, flags, digital, oh, ow, uf, vf, vo, *mesh);
        } else if (digital >= 0) {
            coords_kernel<M, true, false><<<grid, block, 0, s>>>(
                xf, yf, ii, mf, rows, *p, flags, digital, oh, ow, uf, vf, vo, *mesh);
        } else {
            coords_kernel<M, false, false><<<grid, block, 0, s>>>(
                xf, yf, ii, mf, rows, *p, flags, -1, oh, ow, uf, vf, vo, *mesh);
        }
    }
};

struct CoordsGenLaunch {
    const void* mats;
    int rows;
    const gf::CoordParams* p;
    int flags;
    const GenArgs* g;
    int out_rows, ow;
    void *u, *v, *valid;
    cudaStream_t s;
    bool ewa;           // coords_gen_kernel_ewa with eps and ref_jac
    float eps;
    int ref_jac;

    template <int M>
    void run() const {
        const dim3 block(32, 8);
        const dim3 grid((ow + block.x - 1) / block.x, (out_rows + block.y - 1) / block.y);
        const auto* mf = static_cast<const float*>(mats);
        auto* uf = static_cast<float*>(u);
        auto* vf = static_cast<float*>(v);
        auto* vo = static_cast<uint8_t*>(valid);
        if (ewa) {
            coords_gen_kernel_ewa<M><<<grid, block, 0, s>>>(mf, rows, *p, flags, *g, eps, ref_jac,
                                                            out_rows, ow, uf, vf, vo);
        } else {
            coords_gen_kernel<M><<<grid, block, 0, s>>>(mf, rows, *p, flags, *g, out_rows, ow, uf,
                                                        vf, vo);
        }
    }
};

}  // namespace

// x, y: float32 (oh, ow); idx: int32 (oh, ow); mats: float32 (rows, 14);
// u, v: float32 (oh, ow); valid: uint8/bool (oh, ow). All device pointers,
// contiguous. model: the main model's ModelId (lens.cuh); digital: the
// digital lens's ModelId, or -1 for none; mesh: the mesh buffer and its
// constants, read when flags has HAS_MESH_DATA or HAS_FPD_DATA. Launches on
// `stream`; returns -1 for a model id out of range or a mesh flag without a
// mesh buffer, else cudaGetLastError().
extern "C" int gf_coords(const void* x, const void* y, const void* idx, const void* mats,
                         int rows, gf::CoordParams params, int flags, int model, int digital,
                         int oh, int ow, void* u, void* v, void* valid, void* stream,
                         gf::MeshArgs mesh) {
    if (digital >= gf::kNumModels) return -1;
    if ((flags & (gf::HAS_MESH_DATA | gf::HAS_FPD_DATA)) && mesh.data == nullptr) return -1;
    const CoordsLaunch l{x, y, idx, mats, rows, &params, flags, digital, oh, ow, u, v, valid,
                         static_cast<cudaStream_t>(stream), &mesh};
    if (!gf::with_model(model, l)) return -1;
    return static_cast<int>(cudaGetLastError());
}

// mats: float32 (rows, 14); u, v: float32 (out_rows, ow); valid: uint8/bool
// (out_rows, ow). Device pointers, contiguous. model: the main model's
// ModelId. Launches on `stream`; returns -1 for a model id out of range,
// else cudaGetLastError().
extern "C" int gf_coords_gen(const void* mats, int rows, gf::CoordParams params, int flags,
                             int model, GenArgs args, int out_rows, int ow, void* u, void* v,
                             void* valid, void* stream) {
    const CoordsGenLaunch l{mats, rows, &params, flags, &args, out_rows, ow, u, v, valid,
                            static_cast<cudaStream_t>(stream), false, 0.0f, 0};
    if (!gf::with_model(model, l)) return -1;
    return static_cast<int>(cudaGetLastError());
}

// The EWA form: u, v: float32 (3 * out_rows, ow); valid: uint8/bool
// (3 * out_rows, ow), the base eval's rows, then the +eps evals' in x, then
// in y. eps: remap.EWA_EPS as float32; ref_jac: nonzero for a row probe
// per eval. Otherwise as gf_coords_gen.
extern "C" int gf_coords_gen_ewa(const void* mats, int rows, gf::CoordParams params, int flags,
                                 int model, GenArgs args, float eps, int ref_jac, int out_rows,
                                 int ow, void* u, void* v, void* valid, void* stream) {
    const CoordsGenLaunch l{mats, rows, &params, flags, &args, out_rows, ow, u, v, valid,
                            static_cast<cudaStream_t>(stream), true, eps, ref_jac};
    if (!gf::with_model(model, l)) return -1;
    return static_cast<int>(cudaGetLastError());
}
