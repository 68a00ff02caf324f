// fused_hop_pq — one whole PQ beam-search hop per launch.
//
// Replaces: the Pallas kernel repro/kernels/fused_hop.py `fused_hop_pq`
// (`_pq_hop_kernel`, `_gather_rows`, `_merge_into_beam`).  For each of B
// lanes: gather the C candidates' (M,) int32 PQ code rows by id, score
// each as the ADC sum of the lane's (M, K) lookup table over them, dedup
// against the beam and earlier candidates, and keep the stable top-L.
// The init hop of a PQ search is the same kernel with the start set as
// candidates.
//
// Bound on an H100: memory.  Per lane: C*M*4 bytes of code rows (2 KB
// at C=64, M=8), the C*M LUT entries those codes touch (2 KB) and the
// beam.  At B=4096, C=64 that is ~8 MB of codes and ~7.5 MB of LUT
// entries, ~5 us at 3.35 TB/s, counting 4 bytes an entry; but entries
// come in 32-byte sectors, so LUTs that miss L2 cost nearer their whole
// 32 MB.  Beyond the bytes, a lane waits on a chain: ids, then code rows,
// then LUT entries, then the merge.
//
// Design: one warp per lane, four lanes a block, so all 4,096 lanes of a
// batch are resident at once (132 SMs x 64 warps) and their latency
// chains overlap.  No block-wide barrier: a warp synchronises with
// __syncwarp in its own slice of shared memory (warp_merge.cuh).
//   1. Thread t stages its candidates j = t, t + 32, ... (coalesced) and
//      the beam, then dedups its candidates (warp_merge.cuh): only fresh
//      ones are scored.
//   2. Scoring.  At M=8 a thread loads the code rows of two candidates as
//      four int4 (all in flight together, and during the dedup), marked
//      to leave L2 first (adc.cuh), then the 16 LUT entries of the fresh
//      ones;
//      other M go through row_adc, pq_adc's own sum, a code at a time.
//      LUT entries are read straight from device memory: the batch's
//      32 MB of LUTs can stay in the 50 MB L2 across the hops of a
//      batch, and nothing of the LUT is staged, so shared memory does not
//      depend on M or K.  (A lane's 64 codes touch ~28 of the 32 sectors
//      of each 1 KB LUT row, so reading entries instead of whole rows
//      saves few bytes.)  An id < 0 loads nothing; an id >= N is clamped
//      to N-1, as jnp's gather clamps.  The sums go in row_adc's m order
//      (adc.cuh), so every distance is bit-identical to pq_adc's.
//   3. warp_hop_merge (warp_merge.cuh): the stable top-L, hop_merge.cuh's
//      semantics: a ballot bisection picks the few entries that can take
//      a slot, and only those are rank-selected.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc.cuh"
#include "warp_merge.cuh"

namespace {

constexpr int kLanesPerBlock = 4;
constexpr size_t kSmemLimit = 48 * 1024;     // without the opt-in

// M = kM fixed and code rows 16-byte aligned: two candidates a round,
// their code rows loaded before any of their LUT entries.  The first
// round's code rows are in flight while the warp dedups; only fresh
// candidates read LUT entries.  Returns n_fresh.
template <int kM>
__device__ __forceinline__ int dedup_and_score_fixed(
        const WarpHop& s, const float* __restrict__ lut,
        const int* __restrict__ codes, int n, int c, int l, int k, int t) {
    const uint64_t evict_first = evict_first_policy();
    int4 v[2][kM / 4];
    auto load = [&](int j0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int j = j0 + 32 * u;
            const int id = j < c ? s.ids[l + j] : -1;
            const int4* row = reinterpret_cast<const int4*>(
                codes + (long long)min(max(id, 0), n - 1) * kM);
#pragma unroll
            for (int q = 0; q < kM / 4; ++q)
                v[u][q] = id >= 0 ? load_code_row(row + q, evict_first)
                                  : make_int4(0, 0, 0, 0);
        }
    };
    auto score = [&](int j0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int j = j0 + 32 * u;
            if (j < c && s.d[l + j] != CUDART_INF_F)
                s.d[l + j] = row_adc_fixed<kM>(lut, v[u], k);
        }
    };
    load(t);
    const int n_fresh = warp_hop_dedup(s, c, l, t);
    score(t);
    for (int j0 = t + 64; j0 < c; j0 += 64) {
        load(j0);
        score(j0);
    }
    return n_fresh;
}

__device__ __forceinline__ void score_any(const WarpHop& s,
                                          const float* __restrict__ lut,
                                          const int* __restrict__ codes,
                                          int n, int c, int l, int m, int k,
                                          int t) {
    for (int j = t; j < c; j += 32) {
        if (s.d[l + j] == CUDART_INF_F) continue;      // not fresh
        const long long row = min(s.ids[l + j], n - 1);
        s.d[l + j] = row_adc(lut, codes + row * m, m, k);
    }
}

template <int kM>        // 0: any M
__global__ void __launch_bounds__(kLanesPerBlock * 32)
fused_hop_pq_kernel(const float* __restrict__ luts,
                    const int* __restrict__ codes,
                    const int* __restrict__ cand_ids,
                    const int* __restrict__ beam_ids,
                    const float* __restrict__ beam_dists,
                    const uint8_t* __restrict__ beam_exp,
                    int* __restrict__ out_ids,
                    float* __restrict__ out_dists,
                    uint8_t* __restrict__ out_exp,
                    int* __restrict__ out_fresh,
                    int n, int b, int c, int l, int m, int k) {
    extern __shared__ float4 smem4[];
    const int t = threadIdx.x % 32;
    const int w = threadIdx.x / 32;
    const long long lane = (long long)blockIdx.x * (blockDim.x / 32) + w;
    if (lane >= b) return;                       // whole warps only
    const WarpHop s = warp_hop_layout(
        reinterpret_cast<unsigned char*>(smem4) + w * warp_hop_bytes(c, l),
        c, l);

    warp_hop_stage(s, cand_ids, beam_ids, beam_dists, beam_exp, lane, c, l,
                   t);
    const float* lut = luts + lane * m * k;
    int n_fresh;
    if constexpr (kM > 0) {
        n_fresh = dedup_and_score_fixed<kM>(s, lut, codes, n, c, l, k, t);
    } else {
        n_fresh = warp_hop_dedup(s, c, l, t);
        score_any(s, lut, codes, n, c, l, m, k, t);
    }
    warp_hop_merge(s, out_ids, out_dists, out_exp, out_fresh, n_fresh, lane,
                   c, l, t);
}

}  // namespace

// shared memory of one lane (the wrapper holds it to 48 KB)
extern "C" size_t fused_hop_pq_smem_bytes(int c, int l) {
    return warp_hop_bytes(c, l);
}

extern "C" int launch_fused_hop_pq(const float* luts, const int* codes,
                                   const int* cand_ids, const int* beam_ids,
                                   const float* beam_dists,
                                   const uint8_t* beam_exp, int* out_ids,
                                   float* out_dists, uint8_t* out_exp,
                                   int* out_fresh, int n, int b, int c, int l,
                                   int m, int k, void* stream) {
    const size_t per_lane = warp_hop_bytes(c, l);
    const size_t fit = kSmemLimit / per_lane;        // >= 1 (the wrapper)
    const int lanes = fit < kLanesPerBlock ? (fit ? (int)fit : 1)
                                           : kLanesPerBlock;
    const size_t smem = per_lane * lanes;
    const unsigned blocks = (unsigned)((b + lanes - 1) / lanes);
    const cudaStream_t s = (cudaStream_t)stream;
    if (m == 8 && (uintptr_t)codes % 16 == 0)      // code rows as two int4
        fused_hop_pq_kernel<8><<<blocks, lanes * 32, smem, s>>>(
            luts, codes, cand_ids, beam_ids, beam_dists, beam_exp, out_ids,
            out_dists, out_exp, out_fresh, n, b, c, l, m, k);
    else
        fused_hop_pq_kernel<0><<<blocks, lanes * 32, smem, s>>>(
            luts, codes, cand_ids, beam_ids, beam_dists, beam_exp, out_ids,
            out_dists, out_exp, out_fresh, n, b, c, l, m, k);
    return (int)cudaGetLastError();
}
