// Dynamic shared memory above 48 KB (l2_distance.cu).
//
// A block gets at most 48 KB of dynamic shared memory unless its kernel
// was granted more with cudaFuncSetAttribute, up to 227 KB (232,448
// bytes) on an H100.  smem_optin asks once per device and size: `granted`
// (one array per kernel) remembers the largest size granted so far.
#pragma once

#include <cuda_runtime.h>

template <typename Kernel>
inline cudaError_t smem_optin(Kernel* kernel, size_t bytes,
                              size_t (&granted)[64]) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && bytes <= granted[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && dev < 64) granted[dev] = bytes;
    return err;
}
