// l2_distance — (B, d) x (C, d) -> (B, C) squared L2 in the expanded form.
//
// Replaces: the Pallas kernel repro/kernels/l2_distance.py `l2_distance`
// (`_l2_kernel`), which computes a (bq, bc) tile as
// ||q||^2 + ||x||^2 - 2 q.x with the cross term on the MXU and f32
// accumulation.  As in the reference, no search path calls it: it is a
// standalone op (repro/kernels/ops.py, the kernel benches).
//
// Bound on an H100: operations.  2*B*C*d flops against (B + C)*d*4
// bytes in and B*C*4 out: at B = C = 4096, d = 768, 25.8 GFLOP (0.39 ms
// at 67 TFLOP/s f32 outside the tensor cores) against 92 MB (27 us).
// Tensor cores (TF32 or bf16) would lift the ceiling; they change the
// numerics and are later work.
//
// Design: a shared-memory tiled f32 product.  A block of 256 threads
// owns a 64 x 64 output tile and walks d in steps of 16: it stages the
// 64 x 16 query and point slices in shared memory (transposed, so a
// thread's four rows sit side by side), and each thread accumulates a
// 4 x 4 patch of q.x with FMAs from registers.  Threads 0-63 also sum
// the squares of the staged query slice (their row's ||q||^2) and
// threads 64-127 those of the point slice, so the norms come out of the
// same loads.  The epilogue writes (||q||^2 + ||x||^2) - 2 q.x, the
// reference's order of operations.  Ragged B, C and d are masked here
// (loads outside the matrices read 0, stores outside are skipped), where
// the reference pads to its block sizes.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows and columns of one block
constexpr int kStep = 16;      // slice of d staged per iteration
constexpr int kPatch = 4;      // output rows and columns of one thread
constexpr int kThreads = (kTile / kPatch) * (kTile / kPatch);   // 256

__global__ void __launch_bounds__(kThreads)
l2_distance_kernel(const float* __restrict__ queries,
                   const float* __restrict__ points,
                   float* __restrict__ out, int b, int c, int d) {
    __shared__ float qs[kStep][kTile + 4];
    __shared__ float xs[kStep][kTile + 4];
    __shared__ float norms[2 * kTile];     // [||q||^2 | ||x||^2] of the tile

    const int row0 = blockIdx.y * kTile;
    const int col0 = blockIdx.x * kTile;
    const int tid = threadIdx.x;
    const int ty = tid / (kTile / kPatch);
    const int tx = tid % (kTile / kPatch);

    float acc[kPatch][kPatch] = {};
    float norm = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kStep) {
        for (int i = tid; i < kTile * kStep; i += kThreads) {
            const int r = i / kStep;
            const int kk = i % kStep;
            const int gk = k0 + kk;
            const int gq = row0 + r;
            const int gx = col0 + r;
            qs[kk][r] = (gq < b && gk < d)
                ? queries[(long long)gq * d + gk] : 0.0f;
            xs[kk][r] = (gx < c && gk < d)
                ? points[(long long)gx * d + gk] : 0.0f;
        }
        __syncthreads();
        if (tid < kTile) {
#pragma unroll
            for (int kk = 0; kk < kStep; ++kk)
                norm = fmaf(qs[kk][tid], qs[kk][tid], norm);
        } else if (tid < 2 * kTile) {
#pragma unroll
            for (int kk = 0; kk < kStep; ++kk)
                norm = fmaf(xs[kk][tid - kTile], xs[kk][tid - kTile], norm);
        }
#pragma unroll
        for (int kk = 0; kk < kStep; ++kk) {
            float a[kPatch], x[kPatch];
#pragma unroll
            for (int i = 0; i < kPatch; ++i) {
                a[i] = qs[kk][ty * kPatch + i];
                x[i] = xs[kk][tx * kPatch + i];
            }
#pragma unroll
            for (int i = 0; i < kPatch; ++i)
#pragma unroll
                for (int j = 0; j < kPatch; ++j)
                    acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
        }
        __syncthreads();
    }
    if (tid < 2 * kTile) norms[tid] = norm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
        const int r = row0 + ty * kPatch + i;
        if (r >= b) continue;
#pragma unroll
        for (int j = 0; j < kPatch; ++j) {
            const int cc = col0 + tx * kPatch + j;
            if (cc >= c) continue;
            out[(long long)r * c + cc] =
                (norms[ty * kPatch + i] + norms[kTile + tx * kPatch + j])
                - 2.0f * acc[i][j];
        }
    }
}

}  // namespace

extern "C" int launch_l2_distance(const float* queries, const float* points,
                                  float* out, int b, int c, int d,
                                  void* stream) {
    const dim3 grid((unsigned)((c + kTile - 1) / kTile),
                    (unsigned)((b + kTile - 1) / kTile));
    l2_distance_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        queries, points, out, b, c, d);
    return (int)cudaGetLastError();
}
