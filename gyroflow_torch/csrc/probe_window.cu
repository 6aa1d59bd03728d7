// Window column sums: per tile, the column sums of an Sr x Sc window of a
// plane at the tile's origin (y0, x0).
//
// Replaces experiments/perf_probe3.py::make_win_kernel (:30, pallas_call
// :58, driven by main :15), the JAX package's probe of window DMAs at
// misaligned lane offsets: out[t, c] = sum over r < Sr of img[y0_t + r,
// x0_t + c], summed in row order from row 0's value, reads past the plane's
// edge 0. The origins come from the caller (the probe's seeded origins,
// aligned to 8 rows and to 128, 32 or 8 columns).
//
// What bounds it on an H100: bytes. Each tile reads Sr * Sc floats (48 KB at
// 48 x 256) and writes Sc, one add per float read; the probe's 512 windows
// overlap, so a call must read their union once (12.3-17.2 MB a case, 3.8-
// 5.3 us at 3.35 TB/s). At float32 every probe origin is 32-byte aligned
// (8 columns), so the TPU's misaligned-lane question costs no sector here.
//
// The first form ran one block of 256 threads a tile, one thread a column
// walking the Sr rows with a bounds test and a dependent add a row: a few
// 4-byte loads in flight a thread, 96 idle threads at Sc = 160, and 13.1-
// 14.4 us a case whatever its bytes (11.4 us for a single tile: latency, not
// bandwidth).
//
// Designs, chosen by shape alone (window_path):
//   kPathTma      the card's form of the TPU kernel's window DMA: thread 0
//                 of a block a tile copies the window into shared memory as
//                 one TMA box (cp.async.bulk.tensor.2d), completing on an
//                 mbarrier. TMA fills what lies past the plane with +0, the
//                 plain version's value there, so the block sums each column
//                 in row order from shared memory with no test. Takes a
//                 16-byte aligned plane with W % 4 == 0 (TMA's row stride),
//                 Sr and Sc <= 256 (its box) and a window that fits shared
//                 memory; a tile whose origin column is not a multiple of 4
//                 sums as kPathChecked does. A call reads about the union of
//                 its windows (the L2 merges the overlapping boxes' misses):
//                 past the ~6.7 us a single tile takes, the probe's cases
//                 run at 91-93% of the HBM rate on the union.
//   kPathChecked  everything else: a thread a column, the rows that lie in
//                 the plane summed from row 0's value, each row skipped
//                 equal to adding +0.
// Read and rejected (PERF.md): 16-row boxes, so that a box's sums
// overlap the next box's copy (slower: each box waits on its own round
// trip); 64-column boxes, several blocks a tile (slower); an L2 promotion
// of 256 B (slower); float4 columns in registers, 16 rows of loads ahead of
// their adds (no faster than the first form: three round trips a tile).
// Both designs are bit-identical to window_colsum_plain (torch.equal, and
// the sign of a zero sum too): the adds of one column stay in one thread, in
// row order.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPathChecked = 0;
constexpr int kPathTma = 1;
constexpr int kThreads = 256;
constexpr int kMaxBoxDim = 256;           // TMA's largest box dimension
constexpr int kBarBytes = 128;            // the mbarrier, ahead of the box
constexpr int kMaxSmem = 232448;          // 227 KB: a block's shared memory on sm_90
// Returned for a TMA path that cannot start: cuTensorMapEncodeTiled missing.
constexpr int kErrNoEncode = -1000000;

// The column sum of rows [0, Sr) at column x, rows outside [0, H) and
// columns outside [0, W) 0, in the plain version's order: row 0's value,
// then + each row. Leading rows outside make the start +0 + the first row
// inside; trailing rows outside add one +0 (which turns a -0 sum into +0,
// as the plain version's adds of +0 do).
__device__ __forceinline__ float colsum_checked(const float* __restrict__ img, int H, int W,
                                                int y0, int x, int Sr) {
    if (x < 0 || x >= W) return 0.0f;
    const int lo = max(0, min(Sr, -y0));
    const int hi = max(0, min(Sr, H - y0));
    if (lo >= hi) return 0.0f;
    const float* p = img + (long long)(y0 + lo) * W + x;
    float s = __ldg(p);
    if (lo > 0) s = 0.0f + s;
    for (int r = 1; r < hi - lo; ++r) s = s + __ldg(p + (long long)r * W);
    if (hi < Sr) s = s + 0.0f;
    return s;
}

// A tile's column sums by the checked loop, a thread a column.
__device__ __forceinline__ void tile_checked(const float* __restrict__ img, int H, int W, int y0,
                                             int x0, int Sr, int Sc, float* __restrict__ row) {
    for (int c = threadIdx.x; c < Sc; c += blockDim.x)
        row[c] = colsum_checked(img, H, W, y0, x0 + c, Sr);
}

__global__ void __launch_bounds__(kThreads)
window_colsum_kernel(const float* __restrict__ img, int H, int W,
                     const int32_t* __restrict__ y0s, const int32_t* __restrict__ x0s, int Sr,
                     int Sc, float* __restrict__ out) {
    const int t = blockIdx.x;
    tile_checked(img, H, W, y0s[t], x0s[t], Sr, Sc, out + (long long)t * Sc);
}

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// Floats a row of the box: Sc rounded up to 16 bytes.
__host__ __device__ inline int tma_pitch(int Sc) { return (Sc + 3) / 4 * 4; }

// The block's dynamic shared memory: the mbarrier and the Sr x pitch box.
inline int tma_smem(int Sr, int Sc) { return kBarBytes + Sr * tma_pitch(Sc) * 4; }

// One block a tile. Thread 0 arms the mbarrier with the box's bytes (all of
// them: TMA counts the filled ones too) and starts the copy; each thread then
// waits and sums its columns. A tile whose origin column is not a multiple
// of 4 takes the checked loop: TMA starts a box on a 16-byte column only
// (error 715 otherwise).
__global__ void __launch_bounds__(kThreads)
window_colsum_tma_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ img,
                         int H, int W, const int32_t* __restrict__ y0s,
                         const int32_t* __restrict__ x0s, int Sr, int Sc,
                         float* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int t = blockIdx.x;
    const int y0 = y0s[t], x0 = x0s[t];
    float* row = out + (long long)t * Sc;
    if (x0 & 3) {
        tile_checked(img, H, W, y0, x0, Sr, Sc, row);
        return;
    }
    const uint32_t bar = smem_addr(smem);
    const float* box = reinterpret_cast<const float*>(smem + kBarBytes);
    const int pitch = tma_pitch(Sc);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(1) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(Sr * pitch * 4) : "memory");
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];\n"
            :: "r"(smem_addr(box)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(x0), "r"(y0),
               "r"(bar)
            : "memory");
    }
    __syncthreads();
    for (int c = threadIdx.x; c < Sc; c += blockDim.x) {
        while (!mbar_try_wait(bar, 0)) {}
        float s = box[c];
#pragma unroll 8
        for (int r = 1; r < Sr; ++r) s = s + box[r * pitch + c];
        row[c] = s;
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                               12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                      cudaEnableDefault, &q);
#endif
        return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

int window_path(const void* img, int W, int Sr, int Sc) {
    const bool tma = reinterpret_cast<uintptr_t>(img) % 16 == 0 && W % 4 == 0 &&
                     Sr <= kMaxBoxDim && Sc <= kMaxBoxDim && tma_smem(Sr, Sc) <= kMaxSmem;
    return tma ? kPathTma : kPathChecked;
}

}  // namespace

// The design gf_window_colsum takes for this plane and window (kPath*).
extern "C" int gf_window_colsum_path(const void* img, int W, int Sr, int Sc) {
    return window_path(img, W, Sr, Sc);
}

// img: float32 (H, W); y0s, x0s: int32 (ntiles,); out: float32 (ntiles, Sc).
// All device pointers, contiguous. Returns cudaGetLastError() after the
// launch, a negated CUresult if the tensor map could not be encoded, or
// kErrNoEncode if cuTensorMapEncodeTiled cannot be looked up.
extern "C" int gf_window_colsum(const void* img, int H, int W, const void* y0s, const void* x0s,
                                int ntiles, int Sr, int Sc, void* out, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* y = static_cast<const int32_t*>(y0s);
    const int32_t* x = static_cast<const int32_t*>(x0s);
    float* o = static_cast<float*>(out);
    if (window_path(img, W, Sr, Sc) == kPathChecked) {
        window_colsum_kernel<<<ntiles, kThreads, 0, st>>>(static_cast<const float*>(img), H, W,
                                                          y, x, Sr, Sc, o);
        return static_cast<int>(cudaGetLastError());
    }
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return kErrNoEncode;
    CUtensorMap map;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(tma_pitch(Sc)),
                               static_cast<cuuint32_t>(Sr)};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(img),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
    const int smem = tma_smem(Sr, Sc);
    const cudaError_t e = cudaFuncSetAttribute(window_colsum_tma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = Sc < kThreads ? (Sc + 31) / 32 * 32 : kThreads;
    window_colsum_tma_kernel<<<ntiles, threads, smem, st>>>(
        map, static_cast<const float*>(img), H, W, y, x, Sr, Sc, o);
    return static_cast<int>(cudaGetLastError());
}
