// lsh_hash — random-hyperplane LSH bucket codes.
//
// Replaces: the Pallas kernel repro/kernels/lsh_hash.py `lsh_hash`
// (`_lsh_kernel`), which projects a (B, d) query block onto (L, d)
// hyperplanes on the MXU and packs the sign bits (proj >= 0) as
// sum_i bit_i * 2^i into a (B,) int32 code.  In the port it is the
// body of core/lsh.hash_codes, which Algorithm 2 (core/catapult.py)
// calls once per query batch.
//
// Bound on an H100: memory.  The queries are read once (B*d*4 bytes:
// 12.6 MB at B=4096, d=768, ~3.8 us at 3.35 TB/s); the hyperplanes are
// L*d*4 bytes (24 KiB at L=8, d=768).  2*L*d flops per query is ~4
// flop/byte at L=8, below the fp32 ridge, so a tensor-core product
// would buy nothing here.
//
// Design: one pass over each query (L <= 8; one pass per 8 hyperplanes
// above).  A segment of kS lanes takes kQ = 2 queries side by side: 32
// lanes for long rows, 8 for rows of at most 32 loads, so that a warp
// holds eight of tripclick's d=24 queries instead of leaving 26 lanes
// idle.  Each lane loads its slices of the rows once (float4 where
// d % 4 == 0 and the bases are 16-byte aligned; kU loads a query in
// flight a lane, streamed past L1 with evict-first loads) and feeds
// every load into all 8 accumulators of the pass at once.  It reads the
// hyperplanes at the same offsets through L1, where the L*d floats that
// every warp of an SM reads stay resident; each hyperplane load feeds
// both queries of the segment, which halves that L1 traffic (8x the
// query bytes at L=8).  Staging the hyperplanes in shared memory serves
// them no faster and adds a copy per block and a barrier; it measured
// slower.  Then one reduce-scatter across the segment: each shuffle step
// halves the sums a lane holds, so at L=8 and 32 lanes a query costs 9
// shuffles of sums (and 5 of code bits) where one butterfly per
// hyperplane cost 40.  The bit test is acc >= 0.0f, so -0.0 sets the
// bit, as ref.lsh_hash_ref's proj >= 0 does.  The wrapper rejects
// L > 30 (bucket tables hold 2^L rows and the code is a non-negative
// int32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kU = 4;                 // row loads in flight a query a lane
constexpr int kQ = 2;                 // queries a segment
constexpr int kG = 8;                 // hyperplanes a pass
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int x) {
    return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

__device__ __forceinline__ float dot_add(float acc, float x, float y) {
    return fmaf(x, y, acc);
}

__device__ __forceinline__ float dot_add(float acc, float4 x, float4 y) {
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The code bits of the segment's query from each lane's kG partial sums
// (lane s of kS): reduce-scatter halving steps at offsets kS/2, kS/4, ...
// until a lane holds one sum, full butterfly sums over the offsets left,
// then the sign bits OR-reduced over the segment.  After the halving
// steps lane s holds hyperplane s >> (log2 kS - log2 kG).
template <int kG, int kS>
__device__ __forceinline__ unsigned segment_code(float (&v)[kG], int s) {
    static_assert(kG <= kS, "one hyperplane a lane at most");
#pragma unroll
    for (int step = 0; step < ilog2(kG); ++step) {
        const int o = kS >> (step + 1);
        const int half = kG >> (step + 1);
        const bool up = s & o;
#pragma unroll
        for (int i = 0; i < half; ++i) {
            const float send = up ? v[i] : v[i + half];
            const float keep = up ? v[i + half] : v[i];
            v[i] = keep + __shfl_xor_sync(kFull, send, o);
        }
    }
#pragma unroll
    for (int o = kS / kG / 2; o > 0; o >>= 1)
        v[0] += __shfl_xor_sync(kFull, v[0], o);
    unsigned code = (v[0] >= 0.0f ? 1u : 0u)
                    << (s >> (ilog2(kS) - ilog2(kG)));
#pragma unroll
    for (int o = kS / 2; o > 0; o >>= 1)
        code |= __shfl_xor_sync(kFull, code, o);
    return code;
}

// T = float4 (f = d / 4) or float (f = d).  A segment takes kQ queries
// side by side, so each hyperplane load feeds kQ of them, and L in groups
// of kG.  Every lane of the block runs to the shuffles, lanes past the
// last query on zeros.
// One block an SM at least: without that bound ptxas trades registers for
// resident blocks and spills the float4 build's loads in flight.
template <int kS, typename T>
__global__ void __launch_bounds__(kThreads, 1)
lsh_hash_kernel(const T* __restrict__ queries, const T* __restrict__ planes,
                int* __restrict__ out, int b, int l, int f) {
    const int s = threadIdx.x % kS;
    const long long first =
        ((long long)blockIdx.x * kThreads + threadIdx.x) / kS * kQ;
    const T* rows[kQ];
    bool live[kQ];
    unsigned code[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
        live[q] = first + q < b;
        rows[q] = queries + (live[q] ? first + q : 0) * f;
        code[q] = 0;
    }
    for (int g = 0; g < l; g += kG) {
        const int lg = min(kG, l - g);
        const T* pg = planes + (long long)g * f;
        float acc[kQ][kG];
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int h = 0; h < kG; ++h) acc[q][h] = 0.0f;
        for (int p0 = s; p0 < f; p0 += kU * kS) {
            T x[kQ][kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int p = p0 + u * kS;
#pragma unroll
                for (int q = 0; q < kQ; ++q)
                    x[q][u] = live[q] && p < f ? __ldcs(rows[q] + p)
                                               : zero<T>();
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int p = p0 + u * kS;
                if (p >= f) break;
#pragma unroll
                for (int h = 0; h < kG; ++h) {
                    if (h < lg) {
                        const T y = __ldg(pg + h * f + p);
#pragma unroll
                        for (int q = 0; q < kQ; ++q)
                            acc[q][h] = dot_add(acc[q][h], x[q][u], y);
                    }
                }
            }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q)
            code[q] |= (segment_code<kG, kS>(acc[q], s) & ((1u << lg) - 1u))
                       << g;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q)
        if (live[q] && s == 0) out[first + q] = (int)code[q];
}

template <int kS, typename T>
cudaError_t launch(const float* queries, const float* planes, int* out, int b,
                   int l, int f, cudaStream_t stream) {
    constexpr int kQueries = kThreads / kS * kQ;   // queries a block
    const unsigned blocks = (unsigned)(((long long)b + kQueries - 1)
                                       / kQueries);
    lsh_hash_kernel<kS, T><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const T*>(queries),
        reinterpret_cast<const T*>(planes), out, b, l, f);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const float* queries, const float* planes, int* out,
                     int b, int l, int f, cudaStream_t stream) {
    if (f <= kU * 8)                              // one round of 8 lanes
        return launch<8, T>(queries, planes, out, b, l, f, stream);
    return launch<32, T>(queries, planes, out, b, l, f, stream);
}

}  // namespace

// b > 0 and 0 <= l <= 30 (the wrapper's checks)
extern "C" int launch_lsh_hash(const float* queries, const float* hyperplanes,
                               int* out, int b, int l, int d, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (d % 4 == 0 && (uintptr_t)queries % 16 == 0
            && (uintptr_t)hyperplanes % 16 == 0)
        return (int)launch_t<float4>(queries, hyperplanes, out, b, l, d / 4,
                                     s);
    return (int)launch_t<float>(queries, hyperplanes, out, b, l, d, s);
}
