// pq_adc — batched PQ asymmetric distances from per-query lookup tables.
//
// Replaces: the Pallas kernel repro/kernels/pq_adc.py `pq_adc`
// (`_adc_kernel`), which scores (C, M) codes against one (M, K) LUT as
// a one-hot (C, M*K) x (M*K,) contraction on the MXU.  The port batches
// it to (B, M, K) LUTs, one per lane, in two forms:
//   * code rows: (B, C, M) int32 -> (B, C), the reference's contract;
//   * by id: an (N, M) int32 code table and (B, C) int32 ids -> (B, C).
//     The kernel reads each candidate's code row by id, as
//     gather_distance reads table rows: an id < 0 gives +inf and loads
//     nothing, an id >= N is clamped to N-1 (as jnp's gather clamps).
//     This is the whole of core/pq.ADCDist's call, so the unfused PQ
//     hop, the PQ init merge and the catapult `won` scoring each make one
//     launch, with no (B, C, M) gather written and read back.
// The TPU's one-hot MXU trick is not carried over: Hopper reads scattered
// 4-byte LUT entries through its read-only path at sector granularity.
//
// Bound on an H100: memory.  At B=4096, C=64, M=8, K=256 the ids form
// reads 1 MB of ids, the C*M code entries of each lane (8.4 MB, 32 bytes
// a candidate) and the LUT entries they touch (at most 2.1 M of 4 bytes
// in 33.5 MB of LUTs; a lane's 64 codes touch ~28 of the 32 sectors of
// each 1 KB LUT row), and writes 1 MB: ~5 us at 3.35 TB/s counting 4
// bytes an entry.  M adds a candidate (~0.03 flop/byte).
//
// Design: one thread per candidate over the flat B*C candidates, 256 a
// block, so a warp covers 32 candidates of one lane (two at a C that 32
// does not divide) and all 4,096 x 64 candidates of a batch are in flight
// in one wave.  Nothing is staged and there is no barrier: a thread
// loads its id, its code row as int4 and then the row's LUT entries
// straight from device memory: all M of them in flight together at M=8
// (row_adc_fixed; the 32-byte row marked to leave L2 first, since it is
// read once and the LUTs are read again by every hop of a batch), a code
// at a time otherwise (row_adc; int4 rows measured no faster at M=16, 32
// and 96).  The LUT lines stay in L2 across the calls of a batch at
// M=8 (33.5 MB of LUTs at B=4096); at M=96 (403 MB) they cannot, and
// reading each touched 32-byte sector costs about what staging a lane's
// whole LUT in shared memory (96 KB) costs, without needing the space.
// The sums go in row_adc's m order (adc.cuh), so every distance is
// bit-identical to fused_hop_pq's.  It uses no shared memory, so any LUT
// size runs.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "adc.cuh"

namespace {

constexpr int kThreads = 256;

// kFixed8: M == 8 and 16-byte aligned rows, two int4 a row
template <bool kFixed8>
__device__ __forceinline__ float candidate_adc(const float* __restrict__ lut,
                                               const int* __restrict__ code,
                                               int m, int k) {
    if constexpr (kFixed8) {
        const int4* row = reinterpret_cast<const int4*>(code);
        const uint64_t policy = evict_first_policy();
        const int4 v[2] = {load_code_row(row, policy),
                           load_code_row(row + 1, policy)};
        return row_adc_fixed<8>(lut, v, k);
    } else {
        return row_adc(lut, code, m, k);
    }
}

// ids == nullptr: candidate i's code row is row i of `codes` (the (B, C,
// M) form); otherwise row ids[i] of the (N, M) table
template <bool kFixed8, bool kIds>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ luts, const int* __restrict__ codes,
              const int* __restrict__ ids, float* __restrict__ out,
              long long total, int n, int c, int m, int k) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= total) return;
    long long row = i;
    if constexpr (kIds) {
        const int id = __ldg(ids + i);
        if (id < 0) {
            out[i] = CUDART_INF_F;
            return;
        }
        row = min(id, n - 1);
    }
    const long long lane = i / c;
    out[i] = candidate_adc<kFixed8>(luts + lane * m * k, codes + row * m, m,
                                    k);
}

template <bool kFixed8>
cudaError_t launch(const float* luts, const int* codes, const int* ids,
                   float* out, long long total, int n, int c, int m, int k,
                   cudaStream_t stream) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    if (ids != nullptr)
        pq_adc_kernel<kFixed8, true><<<blocks, kThreads, 0, stream>>>(
            luts, codes, ids, out, total, n, c, m, k);
    else
        pq_adc_kernel<kFixed8, false><<<blocks, kThreads, 0, stream>>>(
            luts, codes, ids, out, total, n, c, m, k);
    return cudaGetLastError();
}

}  // namespace

// ids == nullptr: codes is (B, C, M); otherwise codes is (N, M) and ids
// (B, C).  B * C > 0 (the wrapper returns before launching otherwise).
extern "C" int launch_pq_adc(const float* luts, const int* codes,
                             const int* ids, float* out, int n, int b, int c,
                             int m, int k, void* stream) {
    const long long total = (long long)b * c;
    const cudaStream_t s = (cudaStream_t)stream;
    if (m == 8 && (uintptr_t)codes % 16 == 0)
        return (int)launch<true>(luts, codes, ids, out, total, n, c, m, k, s);
    return (int)launch<false>(luts, codes, ids, out, total, n, c, m, k, s);
}
