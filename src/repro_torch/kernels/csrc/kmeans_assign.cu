// kmeans_assign: the fused assignment step of two-step kernel k-means,
// scores = -2 K(X, Xm) @ W + s under the RBF kernel, and the row argmin.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign.py::
// kmeans_assign (pl.pallas_call at kmeans_assign.py:58), reached through
// ops.kmeans_assign.
//
// Work: per (row, sample) pair 2d flops of dot product for the RBF tile and
// 2k for its contraction with W; the bytes are (n + m) d + m k + k floats
// in and n k + n out.  At d = 54, m = 1000 and k = 4..256 that is hundreds
// of flops per byte, far past the H100's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte): the kernel is bound by f32 operations.
//
// Design: the TPU kernel holds all of Xm and W in VMEM at once; on the card
// W alone is 1 MB at m = 1000, k = 256, past a block's shared memory.  So a
// block of 256 threads owns a 64-row tile of X with its scores in registers
// (4 rows x NQ columns a thread) and walks Xm in 64-row chunks: it forms the
// RBF tile in registers from 16-deep shared-memory chunks (f32 FMAs, the
// Gram expansion of common.cuh), parks it in shared memory, stages the
// chunk's rows of W beside it and accumulates tile @ W_chunk.  The launch
// bound keeps two blocks on an SM, so one block's barriers overlap the
// other's work; at k = 256 that outweighs the few registers it spills
// (PERF.md has the times with and without it).  Xm rows past
// m are staged as zeros with zero W rows (RBF gives K(x, 0) != 0).  A block
// covers GW = 16 NQ score columns per pass; more centres take further passes
// over Xm, and the running row minimum carries across passes.  The argmin
// keeps the lowest index on equal scores, as torch.argmin does: each thread
// visits its columns in increasing order with a strict compare, and the
// half-warp reduction takes the lower index on a tie.  Padded centres carry
// zero W and s = +inf, so they never win.
#include <math.h>

#include "common.cuh"

#define KA_KS_STRIDE (RT_BM + 1)   // transposed K tile: Ks[j][r]

template <int NQ>
__global__ void __launch_bounds__(RT_THREADS, 2)
kmeans_assign_kernel(const float* __restrict__ X, const float* __restrict__ Xm,
                     const float* __restrict__ W, const float* __restrict__ s,
                     float* __restrict__ scores, long long* __restrict__ assign,
                     int n, int m, int d, int k, int kp, float gamma) {
    constexpr int GW = 16 * NQ;           // score columns a pass
    extern __shared__ float smem[];
    float* Ws = smem;                                   // (RT_BN, GW)
    float* Ks = Ws + RT_BN * GW;                        // (RT_BN, RT_BM + 1)
    __shared__ float Xs[RT_BK][RT_BM + 4];
    __shared__ float Ms[RT_BK][RT_BN + 4];
    __shared__ float xn[RT_BM], mn[RT_BN];

    const int r0 = blockIdx.x * RT_BM;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;

    float best[4];
    int bidx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        best[i] = INFINITY;
        bidx[i] = 0;
    }
    float xnrm = 0.0f;

    for (int g0 = 0; g0 < kp; g0 += GW) {
        float acc[4][NQ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < NQ; ++q) acc[i][q] = 0.0f;

        for (int c0 = 0; c0 < m; c0 += RT_BN) {
            const bool first = g0 == 0 && c0 == 0;
            float kt[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) kt[i][j] = 0.0f;
            float mnrm = 0.0f;
            for (int k0 = 0; k0 < d; k0 += RT_BK) {
                rt_load_tile(X, n, d, r0, k0, Xs);
                rt_load_tile(Xm, m, d, c0, k0, Ms);
                __syncthreads();
                if (t < RT_BM) {
                    if (first) {
#pragma unroll
                        for (int kk = 0; kk < RT_BK; ++kk)
                            xnrm = fmaf(Xs[kk][t], Xs[kk][t], xnrm);
                    }
                } else if (t < RT_BM + RT_BN) {
#pragma unroll
                    for (int kk = 0; kk < RT_BK; ++kk)
                        mnrm = fmaf(Ms[kk][t - RT_BM], Ms[kk][t - RT_BM], mnrm);
                }
#pragma unroll
                for (int kk = 0; kk < RT_BK; ++kk) {
                    float a[4], c[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
                    for (int j = 0; j < 4; ++j) c[j] = Ms[kk][tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            kt[i][j] = fmaf(a[i], c[j], kt[i][j]);
                }
                __syncthreads();
            }
            if (t < RT_BM) {
                if (first) xn[t] = xnrm;
            } else if (t < RT_BM + RT_BN) {
                mn[t - RT_BM] = mnrm;
            }
            // this chunk's rows of W (zero past m), columns [g0, g0 + GW)
            for (int e = t; e < RT_BN * GW; e += RT_THREADS) {
                const int j = e / GW, c = e % GW;
                Ws[e] = (c0 + j < m) ? W[(size_t)(c0 + j) * kp + g0 + c] : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    Ks[(tx + 16 * j) * KA_KS_STRIDE + ty + 16 * i] =
                        rt_transform(kt[i][j], xn[ty + 16 * i],
                                     mn[tx + 16 * j], KIND_RBF, gamma, 0,
                                     0.0f);
            __syncthreads();
            for (int j = 0; j < RT_BN; ++j) {
                float a[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    a[i] = Ks[j * KA_KS_STRIDE + ty + 16 * i];
#pragma unroll
                for (int q = 0; q < NQ; ++q) {
                    const float b = Ws[j * GW + tx + 16 * q];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(a[i], b, acc[i][q]);
                }
            }
            __syncthreads();   // Ws, Ks and mn are rewritten by the next chunk
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = r0 + ty + 16 * i;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int c = g0 + tx + 16 * q;
                const float v = -2.0f * acc[i][q] + s[c];
                if (r < n && c < k) scores[(size_t)r * k + c] = v;
                if (v < best[i]) {
                    best[i] = v;
                    bidx[i] = c;
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float v = best[i];
        int c = bidx[i];
        for (int off = 8; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off, 16);
            const int oc = __shfl_xor_sync(0xffffffffu, c, off, 16);
            if (ov < v || (ov == v && oc < c)) {
                v = ov;
                c = oc;
            }
        }
        const int r = r0 + ty + 16 * i;
        if (tx == 0 && r < n) assign[r] = (long long)c;
    }
}

template <int NQ>
static int launch(const float* X, const float* Xm, const float* W,
                  const float* s, float* scores, long long* assign, int n,
                  int m, int d, int k, int kp, float gamma,
                  cudaStream_t stream) {
    const size_t smem =
        ((size_t)RT_BN * 16 * NQ + (size_t)RT_BN * KA_KS_STRIDE) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kmeans_assign_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + RT_BM - 1) / RT_BM);
    kmeans_assign_kernel<NQ><<<grid, RT_THREADS, smem, stream>>>(
        X, Xm, W, s, scores, assign, n, m, d, k, kp, gamma);
    return (int)cudaGetLastError();
}

// W is (m, kp) and s (kp,), kp a multiple of 16 * group (group in 1, 2, 4,
// 8, 16 columns a thread), zero-weighted with s = +inf past the k real
// centres; scores is (n, k), assign (n,).
extern "C" int rt_kmeans_assign(const float* X, const float* Xm,
                                const float* W, const float* s, float* scores,
                                long long* assign, int n, int m, int d, int k,
                                int kp, int group, float gamma, void* stream) {
    if (n == 0) return 0;
    if (kp % (16 * group) != 0 || kp < k) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (group) {
        case 1: return launch<1>(X, Xm, W, s, scores, assign, n, m, d, k, kp, gamma, st);
        case 2: return launch<2>(X, Xm, W, s, scores, assign, n, m, d, k, kp, gamma, st);
        case 4: return launch<4>(X, Xm, W, s, scores, assign, n, m, d, k, kp, gamma, st);
        case 8: return launch<8>(X, Xm, W, s, scores, assign, n, m, d, k, kp, gamma, st);
        case 16: return launch<16>(X, Xm, W, s, scores, assign, n, m, d, k, kp, gamma, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
