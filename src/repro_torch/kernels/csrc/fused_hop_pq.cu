// fused_hop_pq — one whole PQ beam-search hop per launch.
//
// Replaces: the Pallas kernel repro/kernels/fused_hop.py `fused_hop_pq`
// (`_pq_hop_kernel`, `_gather_rows`, `_merge_into_beam`).  The same hop
// as fused_hop_l2, with two differences: the rows gathered by candidate
// id are (M,) int32 PQ code rows, and the distance is the ADC sum of
// the lane's (M, K) lookup table over them.  The init hop of a PQ search
// is the same kernel with the start set as candidates.
//
// Bound on an H100: memory, and far less of it than the L2 hop.  Per
// lane: C*M*4 bytes of code rows (2 KB at C=64, M=8), the lane's LUT
// entries that those codes touch (at most the whole 8 KB LUT) and the
// beam.  At B=4096, C=64 that is ~8 MB of codes plus up to 32 MB of
// LUTs, ~10 us at 3.35 TB/s, against ~240 us for the L2 hop at d=768.
//
// Design: one block per lane, 256 threads.
//   1. hop_stage (hop_merge.cuh) puts the lane's [beam | candidates] in
//      shared memory; a lane with no valid candidate skips the rest of
//      its loads (the LUT and every code row).
//   2. The lane's LUT is staged in shared memory beside the merge
//      arrays; thread j scores candidate j through the shared row_adc,
//      so distances are bit-identical to pq_adc's.  An id < 0 loads
//      nothing; an id >= N is clamped to N-1, as jnp's gather clamps.
//   3. hop_merge (hop_merge.cuh, shared with fused_hop_l2) dedups and
//      takes the stable top-L by rank selection.
// The wrapper keeps M*K*4 plus the merge arrays within the 48 KB of
// static-size shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc.cuh"
#include "hop_merge.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
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
                    int n, int c, int l, int m, int k) {
    extern __shared__ unsigned char smem[];
    float* lut = reinterpret_cast<float*>(smem);                   // (m*k,)
    const HopSmem s = hop_smem_layout(smem + (size_t)m * k * sizeof(float),
                                      c, l);
    const long long lane = blockIdx.x;

    const bool any_valid = hop_stage(s, cand_ids, beam_ids, beam_dists,
                                     beam_exp, lane, c, l);
    if (any_valid) {                                   // block-uniform
        const float* src = luts + lane * m * k;
        for (int i = threadIdx.x; i < m * k; i += kThreads) lut[i] = src[i];
        __syncthreads();
        for (int j = threadIdx.x; j < c; j += kThreads) {
            const int id = s.ids[l + j];
            if (id < 0) continue;
            const int row = min(id, n - 1);
            s.d[l + j] = row_adc(lut, codes + (long long)row * m, m, k);
        }
    }
    hop_merge(s, out_ids, out_dists, out_exp, out_fresh, lane, c, l);
}

}  // namespace

extern "C" size_t fused_hop_pq_smem_bytes(int c, int l, int m, int k) {
    return (size_t)m * k * sizeof(float) + hop_smem_bytes(c, l);
}

extern "C" int launch_fused_hop_pq(const float* luts, const int* codes,
                                   const int* cand_ids, const int* beam_ids,
                                   const float* beam_dists,
                                   const uint8_t* beam_exp, int* out_ids,
                                   float* out_dists, uint8_t* out_exp,
                                   int* out_fresh, int n, int b, int c, int l,
                                   int m, int k, void* stream) {
    const size_t smem = fused_hop_pq_smem_bytes(c, l, m, k);
    fused_hop_pq_kernel<<<(unsigned)b, kThreads, smem,
                          (cudaStream_t)stream>>>(
        luts, codes, cand_ids, beam_ids, beam_dists, beam_exp, out_ids,
        out_dists, out_exp, out_fresh, n, c, l, m, k);
    return (int)cudaGetLastError();
}
