// kernel_matvec: out = K(X, Z) @ v without materialising K, batched.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kermatvec.py::kernel_matvec
// (pl.pallas_call at kermatvec.py:80), reached through ops.kernel_matvec.
//
// Work: out[b] (n,) = sum_j transform(x_i . z_j) v_j over Z[b] (m, d).  Per
// (i, j) pair 2d flops of dot product plus 2 for the contraction with v;
// the bytes are only (n + m) d + m + n floats.  At d = 54 that is hundreds
// of flops per byte, far past the H100's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte): the kernel is bound by f32 operations.
//
// Design: a block owns a 64-row tile of X and walks every 64-column tile of
// Z in order.  Each K tile lives only in registers (4 x 4 per thread, FMA
// from 16-deep shared-memory chunks); the epilogue applies the transform and
// contracts it with the tile of v at once.  The sum over Z is a loop inside
// the block and the final row sum is a fixed shuffle pattern, with no
// atomics across blocks, so repeated runs give identical bits.  Padded
// columns carry v = 0 (RBF gives K(x, 0) != 0).
//
// Grid: x = row tiles, y = batch (one launch scores all clusters).
#include "common.cuh"

__global__ void __launch_bounds__(RT_THREADS)
kernel_matvec_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                     const float* __restrict__ v, float* __restrict__ out,
                     int n, int m, int d,
                     long long sxb, long long szb, long long svb,
                     int kind, float gamma, int degree, float coef0) {
    const long long b = blockIdx.y;
    X += b * sxb;
    Z += b * szb;
    v += b * svb;
    out += b * (long long)n;
    const int r0 = blockIdx.x * RT_BM;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;

    __shared__ float Xs[RT_BK][RT_BM + 4];
    __shared__ float Zs[RT_BK][RT_BM + 4];
    __shared__ float xn[RT_BM], zn[RT_BN], vs[RT_BN];

    float rowacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float xnrm = 0.0f;

    for (int c0 = 0; c0 < m; c0 += RT_BN) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        float znrm = 0.0f;
        for (int k0 = 0; k0 < d; k0 += RT_BK) {
            rt_load_tile(X, n, d, r0, k0, Xs);
            rt_load_tile(Z, m, d, c0, k0, Zs);
            __syncthreads();
            if (t < RT_BM) {
                if (c0 == 0) {
#pragma unroll
                    for (int k = 0; k < RT_BK; ++k)
                        xnrm = fmaf(Xs[k][t], Xs[k][t], xnrm);
                }
            } else if (t < RT_BM + RT_BN) {
#pragma unroll
                for (int k = 0; k < RT_BK; ++k)
                    znrm = fmaf(Zs[k][t - RT_BM], Zs[k][t - RT_BM], znrm);
            }
#pragma unroll
            for (int k = 0; k < RT_BK; ++k) {
                float a[4], c[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) c[j] = Zs[k][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
            }
            __syncthreads();
        }
        if (t < RT_BM) {
            if (c0 == 0) xn[t] = xnrm;
        } else if (t < RT_BM + RT_BN) {
            const int c = c0 + t - RT_BM;
            zn[t - RT_BM] = znrm;
            vs[t - RT_BM] = c < m ? v[c] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float kv = rt_transform(acc[i][j], xn[ty + 16 * i],
                                              zn[tx + 16 * j], kind, gamma,
                                              degree, coef0);
                rowacc[i] = fmaf(kv, vs[tx + 16 * j], rowacc[i]);
            }
        __syncthreads();   // zn / vs are rewritten by the next column tile
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float s = rt_rowsum16(rowacc[i]);
        const int r = r0 + ty + 16 * i;
        if (tx == 0 && r < n) out[r] = s;
    }
}

extern "C" int rt_kernel_matvec(const float* X, const float* Z,
                                const float* v, float* out, int batch, int n,
                                int m, int d, long long sxb, long long szb,
                                long long svb, int kind, float gamma,
                                int degree, float coef0, void* stream) {
    if (batch == 0 || n == 0) return 0;
    dim3 grid((n + RT_BM - 1) / RT_BM, batch);
    kernel_matvec_kernel<<<grid, RT_THREADS, 0, (cudaStream_t)stream>>>(
        X, Z, v, out, n, m, d, sxb, szb, svb, kind, gamma, degree, coef0);
    return (int)cudaGetLastError();
}
