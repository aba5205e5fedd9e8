// Shared by the port's kernels: the kernel kinds of the wrappers' _KIND
// (kernels/ops.py), and the CUDA runtime.
#pragma once

#include <cuda_runtime.h>

enum { KIND_LINEAR = 0, KIND_POLY = 1, KIND_RBF = 2 };
