// l2_distance — (B, d) x (C, d) -> (B, C) squared L2 in the expanded form.
//
// Replaces: the Pallas kernel repro/kernels/l2_distance.py `l2_distance`
// (`_l2_kernel`), which computes a (bq, bc) tile as
// ||q||^2 + ||x||^2 - 2 q.x with the cross term on the MXU and f32
// accumulation.  As in the reference, no search path calls it: it is a
// standalone op (repro/kernels/ops.py, the kernel benches).
//
// Bound on an H100: operations.  2*B*C*d flops against (B + C)*d*4
// bytes in and B*C*4 out: at B = C = 4096, d = 768, 25.8 GFLOP against
// 92 MB (27 us).  In f32 outside the tensor cores that is 0.39 ms at
// 67 TFLOP/s; this kernel puts the cross term on the tensor cores in
// 3xTF32, three TF32 products, 77.3 GFLOP at 495 TFLOP/s: 0.16 ms.
//
// Design: a 3xTF32 tensor-core product with a cp.async ring.
//   * Numerics.  A single TF32 product keeps a 10-bit mantissa (about
//     5e-4 relative error a product), too coarse for the rtol/atol 1e-4
//     the reference holds the expanded form to.  Each f32 operand is
//     split as a = a_hi + a_lo: a_hi its top 10 mantissa bits (a mask),
//     a_lo the exact remainder, which the tensor core reads as TF32, so
//     a_lo keeps 11 more bits.  The cross term sums a_lo*b_hi +
//     a_hi*b_lo + a_hi*b_hi into one f32 accumulator (a_lo*b_lo is below
//     f32 rounding): about f32 accuracy from mma.sync.m16n8k8 TF32
//     instructions.  Rounding both parts with cvt.rna instead takes
//     more instructions an element, and the tolerance does not need it.
//   * Tiles.  A block of 8 warps owns a 128 x 128 output tile and walks
//     d in steps of 32; warps are 2 x 4 over it, each a 64 x 32 tile of
//     4 x 4 mma fragments (64 f32 accumulators a thread).
//   * Staging.  A and B tiles go global -> shared with 16-byte cp.async
//     into a 3-stage ring (one __syncthreads a step), so the next two
//     steps load while this one multiplies.  Fragments leave shared
//     memory by ldmatrix (four 8 x 4 tiles an instruction).  Rows are
//     padded to 36 floats, so its 8 row reads and the row-wise float4
//     norm loads hit distinct banks.  A d that is not a multiple of 4,
//     or an unaligned base, stages with 4-byte copies.
//   * Norms.  Every thread sums one staged row in plain f32 FMAs
//     (threads 0-127 the query rows, 128-255 the point rows), from the
//     f32 tiles and not from the TF32 parts.  The epilogue writes
//     (||q||^2 + ||x||^2) - 2 q.x, the reference's order of operations.
//   * Ragged B, C and d are masked here (copies outside the matrices
//     zero-fill, stores outside are skipped), where the reference pads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_optin.cuh"

namespace {

constexpr int kBM = 128;                // output rows of a block (queries)
constexpr int kBN = 128;                // output columns (points)
constexpr int kBK = 32;                 // slice of d a pipeline step
constexpr int kStages = 3;
constexpr int kLd = kBK + 4;            // padded row stride, in floats
constexpr int kThreads = 256;
constexpr int kWarpsN = 4;              // warps are 2 (rows) x 4 (columns)
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;   // mma tiles a warp
constexpr int kStageFloats = (kBM + kBN) * kLd;
constexpr size_t kSmemBytes =
    (size_t)kStages * kStageFloats * sizeof(float)
    + (size_t)(kBM + kBN) * sizeof(float);                  // 111,616

static_assert(kThreads == kBM + kBN, "one norm row per thread");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo: hi is x cut to TF32 (the top 10 mantissa bits), lo the
// exact f32 remainder, which the tensor core reads as TF32 in turn
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = x & 0xffffe000u;
    lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// four 8 x 4 f32 tiles from shared memory, a 32-bit word a thread a tile:
// thread (g = lane / 4, t = lane % 4) gets word t of row g, the mma
// fragment layout; lanes 8q..8q+7 give the row addresses of tile q
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [row0, row0 + kBM) x d-slice [k0, k0 + kBK) of an (n, d) matrix
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int n, int d, int row0, int k0,
                                           int tid) {
    if (kVec) {
        constexpr int kChunks = kBK / 4;               // 16-byte chunks a row
#pragma unroll
        for (int i = 0; i < kBM * kChunks / kThreads; ++i) {
            const int chunk = tid + i * kThreads;
            const int r = chunk / kChunks;
            const int kk = (chunk % kChunks) * 4;
            const bool ok = row0 + r < n && k0 + kk < d;
            cp_async16(dst + r * kLd + kk,
                       ok ? src + (long long)(row0 + r) * d + k0 + kk : src,
                       ok);
        }
    } else {
#pragma unroll 4
        for (int i = 0; i < kBM * kBK / kThreads; ++i) {
            const int e = tid + i * kThreads;
            const int r = e / kBK;
            const int kk = e % kBK;
            const bool ok = row0 + r < n && k0 + kk < d;
            cp_async4(dst + r * kLd + kk,
                      ok ? src + (long long)(row0 + r) * d + k0 + kk : src,
                      ok);
        }
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
l2_distance_kernel(const float* __restrict__ queries,
                   const float* __restrict__ points,
                   float* __restrict__ out, int b, int c, int d) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* norms = smem + kStages * kStageFloats;   // [||q||^2 | ||x||^2]

    const int row0 = blockIdx.y * kBM;
    const int col0 = blockIdx.x * kBN;
    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int wm = (warp / kWarpsN) * kWarpM;
    const int wn = (warp % kWarpsN) * kWarpN;
    // ldmatrix row addresses: tile q = lane / 8, its row lane % 8; A's
    // tiles are {a0..a3} (rows +8, then columns +4), B's {b0, b1} of two
    // column tiles (columns +4, then rows +8)
    const int sq = lane / 8, sr = lane % 8;
    const int a_off = (wm + sr + 8 * (sq & 1)) * kLd + 4 * (sq >> 1);
    const int b_off = (wn + sr + 8 * (sq >> 1)) * kLd + 4 * (sq & 1);
    const int nk = (d + kBK - 1) / kBK;

    auto stage = [&](int kt) {
        float* a = smem + (kt % kStages) * kStageFloats;
        stage_rows<kVec>(a, queries, b, d, row0, kt * kBK, tid);
        stage_rows<kVec>(a + kBM * kLd, points, c, d, col0, kt * kBK, tid);
    };

    float acc[kMT][kNT][4] = {};
    float norm = 0.0f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) stage(s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();        // this thread's step kt landed
        __syncthreads();                     // everyone's did; step kt-1 done
        if (kt + kStages - 1 < nk) stage(kt + kStages - 1);
        cp_async_commit();

        const float* a = smem + (kt % kStages) * kStageFloats;
        const float* x = a + kBM * kLd;
        {   // thread tid's row norm, from the f32 tile
            const float* row = a + tid * kLd;    // tid >= kBM: x's rows
#pragma unroll
            for (int kk = 0; kk < kBK; kk += 4) {
                const float4 v = *reinterpret_cast<const float4*>(row + kk);
                norm = fmaf(v.x, v.x, norm);
                norm = fmaf(v.y, v.y, norm);
                norm = fmaf(v.z, v.z, norm);
                norm = fmaf(v.w, v.w, norm);
            }
        }
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
            for (int nt = 0; nt < kNT; nt += 2) {
                uint32_t r[4];
                ldsm_x4(r, x + b_off + nt * 8 * kLd + kk);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    split_tf32(r[j], bh[nt + j / 2][j % 2],
                               bl[nt + j / 2][j % 2]);
            }
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
                uint32_t r[4], ah[4], al[4];
                ldsm_x4(r, a + a_off + mt * 16 * kLd + kk);
#pragma unroll
                for (int j = 0; j < 4; ++j) split_tf32(r[j], ah[j], al[j]);
                // small terms first; an accumulator's three products
                // are kNT instructions apart
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt)
                    mma_tf32(acc[mt][nt], al, bh[nt]);
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt)
                    mma_tf32(acc[mt][nt], ah, bl[nt]);
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt)
                    mma_tf32(acc[mt][nt], ah, bh[nt]);
            }
        }
    }
    cp_async_wait<0>();
    norms[tid] = norm;
    __syncthreads();

    const int g = lane / 4, t = lane % 4;            // accumulator coords

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {                // fragment rows g, g + 8
            const int lr = wm + mt * 16 + g + 8 * h;
            const int r = row0 + lr;
            if (r >= b) continue;
            float* o = out + (long long)r * c;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {        // columns 2t, 2t + 1
                    const int lc = wn + nt * 8 + 2 * t + j;
                    if (col0 + lc >= c) continue;
                    o[col0 + lc] = (norms[lr] + norms[kBM + lc])
                                   - 2.0f * acc[mt][nt][2 * h + j];
                }
            }
        }
    }
}

template <bool kVec>
cudaError_t launch(const float* queries, const float* points, float* out,
                   int b, int c, int d, cudaStream_t stream) {
    // the ring is 109 KB; two blocks fit an SM
    static size_t granted[64] = {};
    const cudaError_t err =
        smem_optin(l2_distance_kernel<kVec>, kSmemBytes, granted);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((c + kBN - 1) / kBN),
                    (unsigned)((b + kBM - 1) / kBM));
    l2_distance_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
        queries, points, out, b, c, d);
    return cudaGetLastError();
}

}  // namespace

extern "C" int launch_l2_distance(const float* queries, const float* points,
                                  float* out, int b, int c, int d,
                                  void* stream) {
    const bool vec = d % 4 == 0 && (uintptr_t)queries % 16 == 0
                     && (uintptr_t)points % 16 == 0;
    const cudaStream_t s = (cudaStream_t)stream;
    return (int)(vec ? launch<true>(queries, points, out, b, c, d, s)
                     : launch<false>(queries, points, out, b, c, d, s));
}
