// gather_distance — batched squared L2 from each query to its gathered rows.
//
// Replaces: the Pallas kernel repro/kernels/gather_distance.py
// `gather_distance` (`_gather_kernel`), which scores one query against M
// rows fetched by scalar-prefetched ids.  The port batches it to
// (B, C): it is the on-card form of the reference's `l2_dist_fn`
// (core/beam_search.py) and `FusedL2Hop.__call__`, so it carries the
// composed (unfused) hop, the Vamana build's searches, the init merge
// and the catapult `won` scoring.
//
// Bound on an H100: memory.  Each valid id pulls one d-float row from
// the (N, d) table in device memory and does 3 flops per float, far
// below the ~20 flop/byte at which fp32 FMA throughput would bind
// (67 TFLOP/s over 3.35 TB/s).  B*C*d*4 bytes are gathered.
//
// Design: one warp per (query, candidate).  The warp reads its row with
// consecutive lanes on consecutive floats (128-byte transactions), the
// shared row_sqdist reduces it, lane 0 writes one float.  An id < 0
// writes +inf and loads nothing; an id >= N is clamped to N-1, as the
// reference's jnp gather clamps (torch indexing would fault instead).
// Thousands of independent warps keep many row loads in flight, which is
// what a gather-bound kernel needs; TMA/async copies come later.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_distance_kernel(const float* __restrict__ vectors,
                       const int* __restrict__ ids,
                       const float* __restrict__ queries,
                       float* __restrict__ out,
                       int n, int b, int c, int d) {
    const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (warp >= (long long)b * c) return;          // whole warp leaves
    const int id = ids[warp];
    if (id < 0) {
        if (lane == 0) out[warp] = CUDART_INF_F;
        return;
    }
    const int row = min(id, n - 1);
    const long long qrow = warp / c;
    const float s = row_sqdist(vectors + (long long)row * d,
                               queries + qrow * d, d, lane);
    if (lane == 0) out[warp] = s;
}

}  // namespace

extern "C" int launch_gather_distance(const float* vectors, const int* ids,
                                      const float* queries, float* out,
                                      int n, int b, int c, int d,
                                      void* stream) {
    const long long warps = (long long)b * c;
    const long long blocks = (warps + kWarps - 1) / kWarps;
    gather_distance_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(vectors, ids, queries,
                                                     out, n, b, c, d);
    return (int)cudaGetLastError();
}
