// pq_adc — batched PQ asymmetric distances from per-query lookup tables.
//
// Replaces: the Pallas kernel repro/kernels/pq_adc.py `pq_adc`
// (`_adc_kernel`), which scores (C, M) codes against one (M, K) LUT as
// a one-hot (C, M*K) x (M*K,) contraction on the MXU.  The port batches
// it to (B, M, K) LUTs x (B, C, M) codes -> (B, C): it is the on-card
// body of the composed PQ dist_fn (core/pq.ADCDist: the code rows are
// gathered by torch indexing, ids < 0 masked to +inf after), so it
// carries the unfused PQ hop, the PQ init merge and the catapult `won`
// scoring.
//
// Bound on an H100: memory.  Per lane the kernel reads C*M*4 bytes of
// codes and at most min(C*M, M*K) LUT entries, and does M adds per
// candidate (~0.03 flop/byte).  At B=4096, C=64, M=8, K=256: 8.4 MB of
// codes, up to 8.4 MB of LUT entries, 1 MB out -> ~5 us at 3.35 TB/s.
//
// Design: one block per lane.  The lane's whole (M, K) LUT is staged in
// shared memory (8 KB at M=8, K=256) with coalesced loads; then thread
// j sums candidate j's M entries through the shared row_adc, a direct
// shared-memory gather.  The TPU's one-hot MXU trick is not carried
// over: Hopper's shared memory serves scattered reads at full rate
// (bank conflicts aside), so the gather is the natural form.  A LUT
// above 48 KB (M*K*4, e.g. M=96, K=256: 96 KB) takes the dynamic shared
// memory opt-in, up to the 227 KB a block can have; the wrapper raises
// above that.
#include <cuda_runtime.h>

#include "adc.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ luts, const int* __restrict__ codes,
              float* __restrict__ out, int c, int m, int k) {
    extern __shared__ float lut[];
    const long long lane = blockIdx.x;
    const float* src = luts + lane * m * k;
    for (int i = threadIdx.x; i < m * k; i += kThreads) lut[i] = src[i];
    __syncthreads();
    for (int j = threadIdx.x; j < c; j += kThreads) {
        const long long row = lane * c + j;
        out[row] = row_adc(lut, codes + row * m, m, k);
    }
}

}  // namespace

extern "C" size_t pq_adc_smem_bytes(int m, int k) {
    return (size_t)m * k * sizeof(float);
}

extern "C" int launch_pq_adc(const float* luts, const int* codes, float* out,
                             int b, int c, int m, int k, void* stream) {
    static size_t granted[64] = {};
    const size_t smem = pq_adc_smem_bytes(m, k);
    const cudaError_t err = smem_optin(pq_adc_kernel, smem, granted);
    if (err != cudaSuccess) return (int)err;
    pq_adc_kernel<<<(unsigned)b, kThreads, smem, (cudaStream_t)stream>>>(
        luts, codes, out, c, m, k);
    return (int)cudaGetLastError();
}
