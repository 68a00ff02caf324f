// Shared staging and beam merge of the two fused hops (fused_hop.cu for
// L2, fused_hop_pq.cu for PQ-ADC).
//
// Replaces: `_merge_into_beam` of repro/kernels/fused_hop.py, which both
// Pallas hop kernels call after scoring their candidates.  One block
// handles one query lane; the caller scores the candidates between
// hop_stage and hop_merge, writing s.d[l + j] for every valid id j.
//
//   hop_stage: the lane's candidate ids and beam go to shared memory,
//     laid out as the concatenation [beam | candidates] the merge ranks
//     over; candidate distances start at +inf.  Returns, to every thread,
//     whether any candidate id is valid: a lane with none (a converged
//     lane in a divergent batch) loads no row at all and its merge
//     re-emits the beam, as the Pallas kernel's pl.when skips the DMAs.
//   hop_merge:
//     1. thread j marks candidate j a duplicate if it is in the beam or
//        equals an earlier candidate; duplicates and -1 ids score +inf;
//     2. stable top-L as a rank selection: entry i goes to slot
//        rank_i = #{k : d_k < d_i} + #{k < i : d_k == d_i} when
//        rank_i < L.  (d, index) is a total order, so every slot has
//        exactly one writer, and the order is that of a stable argsort
//        — the order the reference's first-minimum selection loop
//        produces.  +inf slots become (-1, inf, expanded).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

struct HopSmem {
    int* ids;        // (l + c,) [beam | candidates]
    float* d;        // (l + c,)
    int* n_fresh;    // (1,)
    uint8_t* exp;    // (l + c,)
};

inline size_t hop_smem_bytes(int c, int l) {
    const size_t m = (size_t)l + c;
    return m * (sizeof(int) + sizeof(float) + sizeof(uint8_t)) + sizeof(int);
}

__device__ __forceinline__ HopSmem hop_smem_layout(unsigned char* base,
                                                   int c, int l) {
    const int m = l + c;
    HopSmem s;
    s.ids = reinterpret_cast<int*>(base);
    s.d = reinterpret_cast<float*>(s.ids + m);
    s.n_fresh = reinterpret_cast<int*>(s.d + m);
    s.exp = reinterpret_cast<uint8_t*>(s.n_fresh + 1);
    return s;
}

__device__ __forceinline__ bool hop_stage(const HopSmem& s,
                                          const int* __restrict__ cand_ids,
                                          const int* __restrict__ beam_ids,
                                          const float* __restrict__ beam_dists,
                                          const uint8_t* __restrict__ beam_exp,
                                          long long lane, int c, int l) {
    const int m = l + c;
    bool has_valid = false;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        if (i < l) {
            s.ids[i] = beam_ids[lane * l + i];
            s.d[i] = beam_dists[lane * l + i];
            s.exp[i] = beam_exp[lane * l + i] ? 1 : 0;
        } else {
            const int id = cand_ids[lane * c + (i - l)];
            s.ids[i] = id;
            s.d[i] = CUDART_INF_F;
            s.exp[i] = 0;
            has_valid |= id >= 0;
        }
    }
    if (threadIdx.x == 0) *s.n_fresh = 0;
    return __syncthreads_or(has_valid);
}

__device__ __forceinline__ void hop_merge(const HopSmem& s,
                                          int* __restrict__ out_ids,
                                          float* __restrict__ out_dists,
                                          uint8_t* __restrict__ out_exp,
                                          int* __restrict__ out_fresh,
                                          long long lane, int c, int l) {
    const int m = l + c;
    __syncthreads();                 // the caller's distances are in s.d

    // 1. dedup against the beam and earlier candidates
    int fresh_here = 0;
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
        const int id = s.ids[l + j];
        bool dup = false;
        for (int k = 0; k < l; ++k) {
            const int b = s.ids[k];
            dup |= (b == id) & (b >= 0);
        }
        for (int k = 0; k < j; ++k) dup |= s.ids[l + k] == id;
        const bool fresh = !dup && id >= 0;
        if (!fresh) s.d[l + j] = CUDART_INF_F;
        fresh_here += fresh ? 1 : 0;
    }
    if (fresh_here) atomicAdd(s.n_fresh, fresh_here);
    __syncthreads();

    // 2. stable rank selection of the L closest
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const float di = s.d[i];
        int rank = 0;
        for (int k = 0; k < m; ++k) {
            const float dk = s.d[k];
            rank += (dk < di) | ((k < i) & (dk == di));
        }
        if (rank < l) {
            const bool invalid = !isfinite(di);
            const long long o = lane * l + rank;
            out_ids[o] = invalid ? -1 : s.ids[i];
            out_dists[o] = di;
            out_exp[o] = invalid ? 1 : s.exp[i];
        }
    }
    if (threadIdx.x == 0) out_fresh[lane] = *s.n_fresh;
}
