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
//   1. The lane's candidate ids and beam go to shared memory, laid out
//      as the concatenation [beam | candidates] the merge ranks over.
//   2. A lane with no valid candidate (a converged lane in a divergent
//      batch) loads no row at all; its merge re-emits the beam, as the
//      Pallas kernel's pl.when skips the DMAs.
//   3. Warp w scores candidates w, w+8, ... with the shared row_sqdist,
//      so distances are bit-identical to gather_distance's.
//   4. Thread j marks candidate j a duplicate if it is in the beam or
//      equals an earlier candidate; duplicates and -1 ids score +inf.
//   5. Stable top-L as a rank selection: entry i goes to slot
//      rank_i = #{k : d_k < d_i} + #{k < i : d_k == d_i} when rank_i < L.
//      (d, index) is a total order, so every slot has exactly one
//      writer, and the order is that of a stable argsort — the order the
//      reference's first-minimum selection loop produces.
// No grid-wide state: blocks are independent, so the TPU kernel's
// sequential grid maps onto 132 SMs without change.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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
    const int m = l + c;
    int* cat_ids = reinterpret_cast<int*>(smem);                // (m,)
    float* cat_d = reinterpret_cast<float*>(cat_ids + m);       // (m,)
    int* n_fresh = reinterpret_cast<int*>(cat_d + m);           // (1,)
    uint8_t* cat_exp = reinterpret_cast<uint8_t*>(n_fresh + 1);  // (m,)

    const long long lane_idx = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wl = tid & 31;

    // 1. stage [beam | candidates]
    bool has_valid = false;
    for (int i = tid; i < m; i += kThreads) {
        if (i < l) {
            cat_ids[i] = beam_ids[lane_idx * l + i];
            cat_d[i] = beam_dists[lane_idx * l + i];
            cat_exp[i] = beam_exp[lane_idx * l + i] ? 1 : 0;
        } else {
            const int id = cand_ids[lane_idx * c + (i - l)];
            cat_ids[i] = id;
            cat_d[i] = CUDART_INF_F;
            cat_exp[i] = 0;
            has_valid |= id >= 0;
        }
    }
    if (tid == 0) *n_fresh = 0;
    // 2. an all -1 lane skips the gather entirely
    const bool any_valid = __syncthreads_or(has_valid);

    // 3. one warp per candidate row
    if (any_valid) {
        const float* q = queries + lane_idx * d;
        for (int j = warp; j < c; j += kWarps) {
            const int id = cat_ids[l + j];
            if (id < 0) continue;                         // warp-uniform
            const int row = min(id, n - 1);
            const float s = row_sqdist(vectors + (long long)row * d, q, d, wl);
            if (wl == 0) cat_d[l + j] = s;
        }
    }
    __syncthreads();

    // 4. dedup against the beam and earlier candidates
    int fresh_here = 0;
    for (int j = tid; j < c; j += kThreads) {
        const int id = cat_ids[l + j];
        bool dup = false;
        for (int k = 0; k < l; ++k) {
            const int b = cat_ids[k];
            dup |= (b == id) & (b >= 0);
        }
        for (int k = 0; k < j; ++k) dup |= cat_ids[l + k] == id;
        const bool fresh = !dup && id >= 0;
        if (!fresh) cat_d[l + j] = CUDART_INF_F;
        fresh_here += fresh ? 1 : 0;
    }
    if (fresh_here) atomicAdd(n_fresh, fresh_here);
    __syncthreads();

    // 5. stable rank selection of the L closest
    for (int i = tid; i < m; i += kThreads) {
        const float di = cat_d[i];
        int rank = 0;
        for (int k = 0; k < m; ++k) {
            const float dk = cat_d[k];
            rank += (dk < di) | ((k < i) & (dk == di));
        }
        if (rank < l) {
            const bool invalid = !isfinite(di);
            const long long o = lane_idx * l + rank;
            out_ids[o] = invalid ? -1 : cat_ids[i];
            out_dists[o] = di;
            out_exp[o] = invalid ? 1 : cat_exp[i];
        }
    }
    if (tid == 0) out_fresh[lane_idx] = *n_fresh;
}

}  // namespace

extern "C" size_t fused_hop_l2_smem_bytes(int c, int l) {
    const size_t m = (size_t)l + c;
    return m * (sizeof(int) + sizeof(float) + sizeof(uint8_t)) + sizeof(int);
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
