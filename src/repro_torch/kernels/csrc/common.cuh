// Shared by the port's kernels: the kernel kinds of the wrappers' _KIND
// (kernels/ops.py), and the CUDA runtime.
#pragma once

#include <cuda_runtime.h>

enum { KIND_LINEAR = 0, KIND_POLY = 1, KIND_RBF = 2 };

// The C entries' caches (SM counts, occupancy tables, the flags of the
// shared-memory attribute) hold a device's own values: the SM count and
// cudaFuncSetAttribute belong to the device current at the call.  So each
// is an array indexed by the current device's ordinal (rt_device).
#define RT_MAX_DEVICES 16

// The current device's ordinal into *dev: 0, or a cudaError_t (an ordinal
// of RT_MAX_DEVICES or more gives cudaErrorInvalidDevice).
static inline int rt_device(int* dev) {
    const cudaError_t err = cudaGetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    return *dev >= 0 && *dev < RT_MAX_DEVICES ? 0
                                              : (int)cudaErrorInvalidDevice;
}
