// cd_column_update: dg = y * (K(X, Xb) @ w), the rank-B gradient update of
// the level-0 block coordinate descent.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cd_update.py::
// cd_column_update (pl.pallas_call at cd_update.py:78), reached through
// ops.cd_column_update.
//
// Work: per (row, selected column) pair 2d flops of dot product plus 2 for
// the contraction with w; the bytes are n d + B d + B + 2n floats.  At
// d = 54 and B = 64 that is about 60 flops per byte, past the H100's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte): bound by f32
// operations.
//
// Design: every block holds all of Xb (B <= 256 rows, transposed and
// zero-padded to 16-deep chunks), its row norms and w in shared memory,
// and takes one 64-row tile of X.  The (64, B) kernel block is accumulated
// in registers (4 x NJ per thread, NJ = padded B / 16) and contracted with
// w in the epilogue, so the (n, B) column block never reaches device memory:
// only the (n,) result does.  Padded columns carry w = 0.
#include "common.cuh"

template <int NJ>
__global__ void __launch_bounds__(RT_THREADS)
cd_column_update_kernel(const float* __restrict__ X, const float* __restrict__ y,
                        const float* __restrict__ Xb, const float* __restrict__ w,
                        float* __restrict__ out, int n, int B, int d, int dpad,
                        int kind, float gamma, int degree, float coef0) {
    constexpr int BP = 16 * NJ;   // padded block width
    extern __shared__ float smem[];
    float* XbS = smem;                    // (dpad, BP), XbS[k * BP + j]
    float* bn = XbS + (size_t)dpad * BP;  // (BP,) |xb_j|^2
    float* ws = bn + BP;                  // (BP,) w, zero past B
    __shared__ float Xs[RT_BK][RT_BM + 4];
    __shared__ float xn[RT_BM];

    const int r0 = blockIdx.x * RT_BM;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;

    for (int e = t; e < dpad * BP; e += RT_THREADS) {
        const int k = e / BP, j = e % BP;
        XbS[e] = (j < B && k < d) ? Xb[(size_t)j * d + k] : 0.0f;
    }
    for (int j = t; j < BP; j += RT_THREADS) ws[j] = j < B ? w[j] : 0.0f;
    __syncthreads();
    for (int j = t; j < BP; j += RT_THREADS) {
        float s = 0.0f;
        for (int k = 0; k < dpad; ++k) s = fmaf(XbS[k * BP + j], XbS[k * BP + j], s);
        bn[j] = s;
    }

    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    float xnrm = 0.0f;

    for (int k0 = 0; k0 < d; k0 += RT_BK) {
        rt_load_tile(X, n, d, r0, k0, Xs);
        __syncthreads();
        if (t < RT_BM) {
#pragma unroll
            for (int k = 0; k < RT_BK; ++k) xnrm = fmaf(Xs[k][t], Xs[k][t], xnrm);
        }
#pragma unroll
        for (int k = 0; k < RT_BK; ++k) {
            const float* brow = XbS + (size_t)(k0 + k) * BP;
            float a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float c = brow[tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], c, acc[i][j]);
            }
        }
        __syncthreads();
    }
    if (t < RT_BM) xn[t] = xnrm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int c = tx + 16 * j;
            const float kv = rt_transform(acc[i][j], xn[ty + 16 * i], bn[c],
                                          kind, gamma, degree, coef0);
            s = fmaf(kv, ws[c], s);
        }
        s = rt_rowsum16(s);
        const int r = r0 + ty + 16 * i;
        if (tx == 0 && r < n) out[r] = y[r] * s;
    }
}

template <int NJ>
static int launch(const float* X, const float* y, const float* Xb,
                  const float* w, float* out, int n, int B, int d, int kind,
                  float gamma, int degree, float coef0, cudaStream_t stream) {
    const int dpad = ((d + RT_BK - 1) / RT_BK) * RT_BK;
    const size_t smem = ((size_t)dpad * 16 * NJ + 2 * 16 * NJ) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        cd_column_update_kernel<NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + RT_BM - 1) / RT_BM);
    cd_column_update_kernel<NJ><<<grid, RT_THREADS, smem, stream>>>(
        X, y, Xb, w, out, n, B, d, dpad, kind, gamma, degree, coef0);
    return (int)cudaGetLastError();
}

extern "C" int rt_cd_column_update(const float* X, const float* y,
                                   const float* Xb, const float* w, float* out,
                                   int n, int B, int d, int kind, float gamma,
                                   int degree, float coef0, void* stream) {
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (B <= 64) return launch<4>(X, y, Xb, w, out, n, B, d, kind, gamma, degree, coef0, s);
    if (B <= 128) return launch<8>(X, y, Xb, w, out, n, B, d, kind, gamma, degree, coef0, s);
    if (B <= 256) return launch<16>(X, y, Xb, w, out, n, B, d, kind, gamma, degree, coef0, s);
    return (int)cudaErrorInvalidValue;
}
