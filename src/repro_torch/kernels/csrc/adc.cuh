// Shared ADC (asymmetric distance) sums for every PQ distance the port
// computes on the card (pq_adc.cu and fused_hop_pq.cu).
//
// Both sums here (row_adc, row_adc_fixed) add one candidate's M
// lookup-table entries lut[m * K + code[m]] into an f32 accumulator that
// starts at 0, for m = 0, 1, ..., M-1, in that order; they differ only in
// how the codes are loaded.  Because the additions happen in the same order
// everywhere, the composed PQ hop (pq_adc + torch merge) and the fused
// PQ hop return bit-identical beams on the card, as row_sqdist
// (sqdist.cuh) makes them for L2.  The plain version (ref.pq_adc_ref)
// adds in the same m order.
//
// Codes are int32 in [0, K) by construction (the encoder's argmin); the
// kernels do not check them.  LUT entries are read straight from device
// memory through the read-only path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// An M=8 code row (32 bytes) is read once a call: the load marks it first
// to leave L2, before the LUT lines that every hop of a batch reads again.
__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
        : "=l"(policy));
    return policy;
}

__device__ __forceinline__ int4 load_code_row(const int4* p,
                                              uint64_t policy) {
    int4 v;
    asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(policy));
    return v;
}

// Codes one at a time; the LUT in device memory (fused_hop_pq and pq_adc
// at any M)
__device__ __forceinline__ float row_adc(const float* __restrict__ lut,
                                         const int* __restrict__ code,
                                         int m, int k) {
    float acc = 0.0f;
    for (int i = 0; i < m; ++i) acc += lut[i * k + __ldg(code + i)];
    return acc;
}

// fused_hop_pq and pq_adc, M = kM fixed: codes already in registers, all
// kM LUT loads independent, so they are in flight together
template <int kM>
__device__ __forceinline__ float row_adc_fixed(const float* __restrict__ lut,
                                               const int4 (&v)[kM / 4],
                                               int k) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kM / 4; ++q) {
        const float* p = lut + 4 * q * k;
        acc += __ldg(p + v[q].x);
        acc += __ldg(p + k + v[q].y);
        acc += __ldg(p + 2 * k + v[q].z);
        acc += __ldg(p + 3 * k + v[q].w);
    }
    return acc;
}
