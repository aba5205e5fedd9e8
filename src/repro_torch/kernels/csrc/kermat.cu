// kermat: tiled kernel matrix K(X, Y) for linear / poly / rbf, batched.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kermat.py::kermat
// (pl.pallas_call at kermat.py:75), reached through ops.kernel_matrix.
//
// Work: out[b] (n, m) f32 = transform(X[b] (n, d) . Y[b] (m, d)^T).  Per
// output element 2d flops of dot product and 4 bytes written.  On an H100
// SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s) the ridge is 20
// flop/byte; at the covtype width d = 54 an element costs 108 flops per 4
// bytes, so the kernel is bound by f32 operations, narrowly, with the output
// write close behind.  The design keeps the output write to exactly one
// store per element: each 64 x 64 tile is accumulated in registers (4 x 4
// per thread, FMA) from 16-deep feature chunks staged in shared memory, and
// the transform is the epilogue.  The row norms for the RBF expansion are
// summed in f32 from the same staged chunks.  Both operands go through the
// same arithmetic, so K(X, X) comes out exactly symmetric.
//
// Grid: x = row tiles, y = column tiles, z = batch (one launch serves all
// per-cluster Grams of a level).
#include "common.cuh"

__global__ void __launch_bounds__(RT_THREADS)
kermat_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              float* __restrict__ out, int n, int m, int d,
              long long sxb, long long syb,
              int kind, float gamma, int degree, float coef0) {
    const long long b = blockIdx.z;
    X += b * sxb;
    Y += b * syb;
    out += b * (long long)n * m;
    const int r0 = blockIdx.x * RT_BM, c0 = blockIdx.y * RT_BN;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;

    __shared__ float Xs[RT_BK][RT_BM + 4];
    __shared__ float Ys[RT_BK][RT_BM + 4];
    __shared__ float xn[RT_BM], yn[RT_BN];

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float nrm = 0.0f;   // t < 64: |x_{r0+t}|^2, 64 <= t < 128: |y_{c0+t-64}|^2

    for (int k0 = 0; k0 < d; k0 += RT_BK) {
        rt_load_tile(X, n, d, r0, k0, Xs);
        rt_load_tile(Y, m, d, c0, k0, Ys);
        __syncthreads();
        if (t < RT_BM) {
#pragma unroll
            for (int k = 0; k < RT_BK; ++k) nrm = fmaf(Xs[k][t], Xs[k][t], nrm);
        } else if (t < RT_BM + RT_BN) {
#pragma unroll
            for (int k = 0; k < RT_BK; ++k)
                nrm = fmaf(Ys[k][t - RT_BM], Ys[k][t - RT_BM], nrm);
        }
#pragma unroll
        for (int k = 0; k < RT_BK; ++k) {
            float a[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) c[j] = Ys[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
        }
        __syncthreads();
    }
    if (t < RT_BM) xn[t] = nrm;
    else if (t < RT_BM + RT_BN) yn[t - RT_BM] = nrm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx + 16 * j;
            if (c < m)
                out[(long long)r * m + c] = rt_transform(
                    acc[i][j], xn[ty + 16 * i], yn[tx + 16 * j], kind, gamma,
                    degree, coef0);
        }
    }
}

extern "C" int rt_kermat(const float* X, const float* Y, float* out,
                         int batch, int n, int m, int d,
                         long long sxb, long long syb, int kind, float gamma,
                         int degree, float coef0, void* stream) {
    if (batch == 0 || n == 0 || m == 0) return 0;
    dim3 grid((n + RT_BM - 1) / RT_BM, (m + RT_BN - 1) / RT_BN, batch);
    kermat_kernel<<<grid, RT_THREADS, 0, (cudaStream_t)stream>>>(
        X, Y, out, n, m, d, sxb, syb, kind, gamma, degree, coef0);
    return (int)cudaGetLastError();
}
