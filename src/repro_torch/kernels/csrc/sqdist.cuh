// Shared squared-L2 reduction for every distance the port computes on
// the card (gather_distance.cu and fused_hop.cu).
//
// One warp reduces one (row, query) pair: lane t sums the strided slice
// j = t, t+32, t+64, ... of d with fused multiply-adds, and a fixed
// __shfl_xor_sync butterfly combines the 32 partial sums.  Every lane
// ends with the same float32 value.  Because both kernels call this one
// function, the order of every addition is the same in both, so the
// composed hop (gather_distance + torch merge) and the fused hop return
// bit-identical beams on the card — the promise the reference makes for
// its two hop backends.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float row_sqdist(const float* __restrict__ x,
                                            const float* __restrict__ q,
                                            int d, int lane) {
    float acc = 0.0f;
#pragma unroll 4
    for (int j = lane; j < d; j += 32) {
        const float t = __ldg(x + j) - __ldg(q + j);
        acc = fmaf(t, t, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    return acc;
}
