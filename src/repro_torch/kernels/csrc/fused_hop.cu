// fused_hop_l2 — one whole beam-search hop per launch.
//
// Replaces: the Pallas kernel repro/kernels/fused_hop.py `fused_hop_l2`
// (`_l2_hop_kernel`, `_gather_rows`, `_merge_into_beam`).  For each of B
// query lanes it gathers C candidate rows by id (-1 -> +inf), computes
// float32 squared L2 to the lane's query, dedups the candidates against
// the beam and against earlier candidates, takes the stable top-L of
// beam ∪ candidates (+inf slots become (-1, inf, expanded)) and counts
// the fresh distances.  The init hop of a search is the same kernel with
// the start set as candidates (C = bucket_capacity + 1 in catapult mode).
//
// Bound on an H100: memory.  B*C*d*4 bytes of gathered rows dominate:
// 805 MB a hop at B=4096, C=64, d=768, ~240 us at 3.35 TB/s.  The merge
// touches (L+C) entries per lane in shared memory and is noise beside it.
//
// Design: one block per lane, 8 warps.
//   1. hop_stage (hop_merge.cuh) puts the lane's [beam | candidates] in
//      shared memory; a lane with no valid candidate loads no row.
//   2. Warp w scores candidates w, w+8, ... with the shared row_sqdist,
//      so distances are bit-identical to gather_distance's.
//   3. hop_merge (hop_merge.cuh, shared with fused_hop_pq) dedups and
//      takes the stable top-L by rank selection.
// No grid-wide state: blocks are independent, so the TPU kernel's
// sequential grid maps onto 132 SMs without change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hop_merge.cuh"
#include "sqdist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_hop_l2_kernel(const float* __restrict__ vectors,
                    const int* __restrict__ cand_ids,
                    const float* __restrict__ queries,
                    const int* __restrict__ beam_ids,
                    const float* __restrict__ beam_dists,
                    const uint8_t* __restrict__ beam_exp,
                    int* __restrict__ out_ids,
                    float* __restrict__ out_dists,
                    uint8_t* __restrict__ out_exp,
                    int* __restrict__ out_fresh,
                    int n, int c, int l, int d) {
    extern __shared__ unsigned char smem[];
    const HopSmem s = hop_smem_layout(smem, c, l);
    const long long lane_idx = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int wl = threadIdx.x & 31;

    const bool any_valid = hop_stage(s, cand_ids, beam_ids, beam_dists,
                                     beam_exp, lane_idx, c, l);
    // one warp per candidate row
    if (any_valid) {
        const float* q = queries + lane_idx * d;
        for (int j = warp; j < c; j += kWarps) {
            const int id = s.ids[l + j];
            if (id < 0) continue;                         // warp-uniform
            const int row = min(id, n - 1);
            const float v = row_sqdist(vectors + (long long)row * d, q, d, wl);
            if (wl == 0) s.d[l + j] = v;
        }
    }
    hop_merge(s, out_ids, out_dists, out_exp, out_fresh, lane_idx, c, l);
}

}  // namespace

extern "C" size_t fused_hop_l2_smem_bytes(int c, int l) {
    return hop_smem_bytes(c, l);
}

extern "C" int launch_fused_hop_l2(const float* vectors, const int* cand_ids,
                                   const float* queries, const int* beam_ids,
                                   const float* beam_dists,
                                   const uint8_t* beam_exp, int* out_ids,
                                   float* out_dists, uint8_t* out_exp,
                                   int* out_fresh, int n, int b, int c, int l,
                                   int d, void* stream) {
    const size_t smem = fused_hop_l2_smem_bytes(c, l);
    fused_hop_l2_kernel<<<(unsigned)b, kThreads, smem,
                          (cudaStream_t)stream>>>(
        vectors, cand_ids, queries, beam_ids, beam_dists, beam_exp, out_ids,
        out_dists, out_exp, out_fresh, n, c, l, d);
    return (int)cudaGetLastError();
}
