// Shared pieces of the port's kernel-evaluation kernels (plain f32 on the
// CUDA cores: FMA accumulation, no TF32, no tensor cores).
//
// Tiling used by all three kernels: a block of 256 threads owns a 64-row
// tile of X.  Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i
// (i < 4) and columns tx + 16 j of the current column tile, so a warp's
// stores and shared-memory column reads hit consecutive addresses.
#pragma once

#include <cuda_runtime.h>

#define RT_BM 64        // rows of X per block
#define RT_BN 64        // columns per tile (kermat, kernel_matvec)
#define RT_BK 16        // feature-chunk depth staged in shared memory
#define RT_THREADS 256

enum { KIND_LINEAR = 0, KIND_POLY = 1, KIND_RBF = 2 };

// The kernel transform of a Gram entry g = x.y, with the RBF expansion
// exp(-gamma * max(|x|^2 + |y|^2 - 2 g, 0)) from f32 row norms.
__device__ __forceinline__ float rt_transform(float g, float xn, float yn,
                                              int kind, float gamma,
                                              int degree, float coef0) {
    if (kind == KIND_LINEAR) return g;
    if (kind == KIND_POLY) {
        float base = gamma * g + coef0;
        float r = 1.0f;
        for (int e = 0; e < degree; ++e) r *= base;
        return r;
    }
    float sq = fmaxf((xn + yn) - 2.0f * g, 0.0f);
    return expf(-gamma * sq);
}

// Stage rows [r0, r0 + 64) x features [k0, k0 + 16) of a row-major (rows, d)
// matrix into s[k][r] (transposed), zero outside the matrix.
__device__ __forceinline__ void rt_load_tile(const float* __restrict__ A,
                                             int rows, int d, int r0, int k0,
                                             float (*s)[RT_BM + 4]) {
    for (int e = threadIdx.x; e < RT_BM * RT_BK; e += RT_THREADS) {
        int r = e / RT_BK, k = e % RT_BK;
        int gr = r0 + r, gk = k0 + k;
        s[k][r] = (gr < rows && gk < d) ? A[(size_t)gr * d + gk] : 0.0f;
    }
}

// Sum over the 16 threads of a half-warp that share a row (fixed xor
// pattern, so the result does not depend on scheduling).
__device__ __forceinline__ float rt_rowsum16(float v) {
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off, 16);
    return v;
}
