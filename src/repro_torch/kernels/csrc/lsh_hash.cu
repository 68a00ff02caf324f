// lsh_hash — random-hyperplane LSH bucket codes.
//
// Replaces: the Pallas kernel repro/kernels/lsh_hash.py `lsh_hash`
// (`_lsh_kernel`), which projects a (B, d) query block onto (L, d)
// hyperplanes on the MXU and packs the sign bits (proj >= 0) as
// sum_i bit_i * 2^i into a (B,) int32 code.  In the port it is the
// body of core/lsh.hash_codes, which Algorithm 2 (core/catapult.py)
// calls once per query batch.
//
// Bound on an H100: memory.  The queries are read once (B*d*4 bytes);
// the hyperplanes are L*d*4 bytes (24 KiB at L=8, d=768) and stay in
// L1/L2.  2*L*d flops per query is ~4 flop/byte at L=8 — below the fp32
// ridge — so a tensor-core product would buy nothing here.
//
// Design: one warp per query.  For each hyperplane the lanes take a
// strided slice of d, a __shfl_xor_sync butterfly sums the 32 partials,
// and every lane sets the same bit; lane 0 writes the packed code.  The
// wrapper rejects L > 30 (bucket tables hold 2^L rows and the code is a
// non-negative int32).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
lsh_hash_kernel(const float* __restrict__ queries,
                const float* __restrict__ hyperplanes,
                int* __restrict__ out, int b, int l, int d) {
    const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (warp >= b) return;
    const float* q = queries + warp * d;
    int code = 0;
    for (int i = 0; i < l; ++i) {
        const float* h = hyperplanes + (long long)i * d;
        float acc = 0.0f;
#pragma unroll 4
        for (int j = lane; j < d; j += 32) {
            acc = fmaf(__ldg(q + j), __ldg(h + j), acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        }
        code |= (acc >= 0.0f ? 1 : 0) << i;
    }
    if (lane == 0) out[warp] = code;
}

}  // namespace

extern "C" int launch_lsh_hash(const float* queries, const float* hyperplanes,
                               int* out, int b, int l, int d, void* stream) {
    const long long blocks = ((long long)b + kWarps - 1) / kWarps;
    lsh_hash_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        queries, hyperplanes, out, b, l, d);
    return (int)cudaGetLastError();
}
