// Shared ADC (asymmetric distance) sum for every PQ distance the port
// computes on the card (pq_adc.cu and fused_hop_pq.cu).
//
// One thread sums one candidate's M lookup-table entries
// lut[m * K + code[m]] for m = 0, 1, ..., M-1, in that order.  Because
// both kernels call this one function, every addition happens in the
// same order in both, so the composed PQ hop (pq_adc + torch merge) and
// the fused PQ hop return bit-identical beams on the card, as row_sqdist
// (sqdist.cuh) makes them for L2.  The plain version (ref.pq_adc_ref)
// adds in the same m order.
//
// Codes are int32 in [0, K) by construction (the encoder's argmin); the
// kernels do not check them.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float row_adc(const float* __restrict__ lut,
                                         const int* __restrict__ code,
                                         int m, int k) {
    float acc = 0.0f;
    for (int i = 0; i < m; ++i) acc += lut[i * k + __ldg(code + i)];
    return acc;
}
