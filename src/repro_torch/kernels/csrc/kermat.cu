// kermat: tiled kernel matrix K(X, Y) for linear / poly / rbf, batched.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kermat.py::kermat
// (pl.pallas_call at kermat.py:75), reached through ops.kernel_matrix.
//
// Bound: out[b] (n, m) f32 = transform(x . y), 4 bytes written an entry
// against 3 x 2d flops of split-TF32 products.  At the main path's level-4
// cluster Grams (256 x 1816 x 1816, d = 54, K(X, X): X read once) the
// kernel writes 3.38 GB and reads 0.10 GB, 1.04 ms at 3.35 TB/s, where the
// products take 0.55 ms at 495 TFLOP/s and the exps 0.20 ms: the output
// stream bounds it.
//
// Design: the products run on the tensor cores in split-TF32
// (rbf_tile.cuh: x = hi + lo, both cvt.rna, three products, the two small
// ones in their own accumulator) with wgmma on 64 x 64 tiles, a block of
// one warpgroup.  A tile's 64 X and 64 Y rows land raw by cp.async while
// the last tile is multiplied and stored, and are split once into the
// swizzled hi and lo tiles wgmma reads (rts_split_rows: four threads a
// row, 16-byte reads and writes, the norm terms from the same pass).  The
// transform is applied in registers, and the tile is staged in shared
// memory so that it leaves as whole rows of 16-byte stores (4-byte ones
// where m is no multiple of 4).  Past d = RTS_DC the rows are split a depth
// slice at a time from device memory and the slices' products run into
// the same accumulators.
//
// rbf shifts both operands by the mean of Y's rows (ops.split_shift): K
// depends on x - y alone, and the Gram expansion then cancels between
// smaller numbers.  For K(X, X) (the caller passes sym = 1) only the tiles
// on and above the diagonal are computed; each is written with its mirror,
// and a diagonal tile writes its upper triangle to both sides, so the
// result is symmetric bit for bit (the greedy CD reads row i of Q as its
// column i) and the products are halved.
//
// Grid: persistent, KM_BLOCKS blocks an SM, each walking a contiguous run
// of the tiles of every batch item (one launch serves all per-cluster
// Grams of a level), so one tile's stores drain while the block splits and
// multiplies the next, and along a row of tiles its X rows stay split (the
// staged tile lies over the split Y rows).
#include <math.h>

#include "rbf_tile.cuh"

#define KM_THREADS 128    // one warpgroup
#define KM_T 64            // rows and columns of a tile
#define KM_LD 68           // row stride of the staged tile (floats)
#define KM_SPLIT (KM_T * 2 * 128)   // bytes of a split 64-row tile (2 slabs)
// (1 KB for the swizzle's alignment) split X rows (hi, lo), split Y rows
// (hi, lo), then the rows' and columns' norm terms, the slice's shift and
// the next tile's raw X and Y rows (d <= RTS_DC); the staged tile lies
// over the split Y rows once they are read
#define KM_SMEM (1024 + 4 * KM_SPLIT \
                 + (2 * KM_T + RTS_DC + 2 * KM_T * RTS_DC) * 4)
#define KM_BLOCKS 2        // blocks an SM (shared memory)

// Tile u of a batch item: row-major over the whole grid of tiles, or with
// sym over the tiles on and above the diagonal (row I holds tr - I).
__device__ __forceinline__ void km_tile(long long u, int tr, int tc, int sym,
                                        int& I, int& J) {
    if (!sym) {
        I = (int)(u / tc);
        J = (int)(u % tc);
        return;
    }
    const double b = 2.0 * tr + 1.0;
    I = (int)((b - sqrt(b * b - 8.0 * (double)u)) / 2.0);
    auto first = [&](long long i) { return i * tr - i * (i - 1) / 2; };
    while (I > 0 && first(I) > u) --I;
    while (I + 1 < tr && first(I + 1) <= u) ++I;
    J = I + (int)(u - first(I));
}

template <int KIND>
__global__ void __launch_bounds__(KM_THREADS, KM_BLOCKS)
kermat_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              const float* __restrict__ shift, float* __restrict__ out,
              int batch, int n, int m, int d, long long sxb, long long syb,
              int sym, int vec4, float gamma, int degree, float coef0,
              const unsigned char* __restrict__ skip) {
    // the predicated row form: a set flag returns every block at once
    if (skip != nullptr && *skip) return;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* Xhi = rts_smem_base(smem_raw);   // (KM_T, 2 slabs)
    unsigned char* Xlo = Xhi + KM_SPLIT;
    unsigned char* Yhi = Xlo + KM_SPLIT;
    unsigned char* Ylo = Yhi + KM_SPLIT;
    float* xt = (float*)(Ylo + KM_SPLIT);      // (KM_T,) row norm terms
    float* yt = xt + KM_T;                     // (KM_T,) column norm terms
    float* sh = yt + KM_T;                     // (RTS_DC,) the slice's shift
    float* rx = sh + RTS_DC;                   // (KM_T, d) raw X rows
    float* ry = rx + KM_T * RTS_DC;            // (KM_T, d) raw Y rows
    float* T = (float*)Yhi;                    // (KM_T, KM_LD) the tile

    const int kp = rts_kp(d);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float c = gamma * 1.4426950408889634f, c2 = 2.0f * c;
    const int tr = (n + KM_T - 1) / KM_T, tc = (m + KM_T - 1) / KM_T;
    const long long per = sym ? (long long)tr * (tr + 1) / 2
                              : (long long)tr * tc;
    const long long total = per * batch;
    const uint32_t xhi = rts_smem_addr(Xhi), xlo = rts_smem_addr(Xlo);
    const uint32_t yhi = rts_smem_addr(Yhi), ylo = rts_smem_addr(Ylo);
    // a block walks a contiguous run of tiles, mostly along one row of
    // tiles: while it stays there its X rows stay split
    const long long run = (total + gridDim.x - 1) / gridDim.x;
    const long long t0 = blockIdx.x * run;
    const long long t1 = t0 + run < total ? t0 + run : total;
    auto row_of = [&](long long u, int& I, int& J) {   // (item, row of tiles)
        km_tile(u % per, tr, tc, sym, I, J);
        return u / per * tr + I;
    };
    // d <= RTS_DC: a tile's rows land raw by cp.async (rts_load_flat) while
    // the last tile is multiplied and stored, and are split from there;
    // past it the rows are split a depth slice at a time from device memory
    const bool raw = kp <= RTS_DC;
    auto issue = [&](long long u, bool with_x) {
        const long long bb = u / per;
        int Iu, Ju;
        km_tile(u % per, tr, tc, sym, Iu, Ju);
        const float* xs = X + bb * sxb;
        const float* ys = Y + bb * syb;
        if (with_x)
            rts_load_flat(rx, xs, n, d, Iu * KM_T, KM_T, rts_vec(xs), tid,
                          KM_THREADS);
        rts_load_flat(ry, ys, m, d, Ju * KM_T, KM_T, rts_vec(ys), tid,
                      KM_THREADS);
        rts_cp_commit();
    };
    if (raw && t0 < t1) issue(t0, true);

    long long staged = -1;   // the row of tiles whose X rows are split
    for (long long tt = t0; tt < t1; ++tt) {
        const long long b = tt / per;
        int I, J;
        const long long row = row_of(tt, I, J);
        const float* Xb = X + b * sxb;
        const float* Yb = Y + b * syb;
        const float* sb = KIND == KIND_RBF ? shift + b * d : shift;
        float* ob = out + b * (long long)n * m;
        const int r0 = I * KM_T, c0 = J * KM_T;

        float acc[32], small[32];
        rts_stage_sh(sh, sb, d, 0, KIND);
        if (raw) {
            rts_cp_wait<0>();
            __syncthreads();   // rows and sh landed; the last T is written
            if (row != staged)
                rts_split_rows(Xhi, Xlo, xt, rx, n - r0, d, KM_T, sh, KIND, c,
                               tid, KM_THREADS);
            rts_split_rows(Yhi, Ylo, yt, ry, m - c0, d, KM_T, sh, KIND, c,
                           tid, KM_THREADS);
            rts_fence_split();
            __syncthreads();   // the split tiles are ready; raw is free
            if (tt + 1 < t1) {
                int In, Jn;
                issue(tt + 1, row_of(tt + 1, In, Jn) != row);
            }
            staged = row;
            rts_wgmma_tile(acc, small, xhi, xlo, KM_T * 128, yhi, ylo,
                           KM_T * 128, kp / 8);
        } else {
            for (int k0 = 0; k0 < kp; k0 += RTS_DC) {
                if (k0 > 0) rts_stage_sh(sh, sb, d, k0, KIND);
                __syncthreads();   // sh; the last slice (or T) is read
                rts_split_slice(Xhi, Xlo, xt, Xb + (size_t)r0 * d, sh, n - r0,
                                d, KM_T, k0, k0 == 0, tid, KM_THREADS);
                rts_split_slice(Yhi, Ylo, yt, Yb + (size_t)c0 * d, sh, m - c0,
                                d, KM_T, k0, k0 == 0, tid, KM_THREADS);
                rts_fence_split();
                __syncthreads();
                const int ks = (kp - k0 < RTS_DC ? kp - k0 : RTS_DC) / 8;
                rts_wgmma_slab(acc, small, xhi, xlo, KM_T * 128, yhi, ylo,
                               KM_T * 128, ks, k0 == 0);
                __syncthreads();   // the slice is read: sh may change
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] += small[i];
            if (tid < 2 * KM_T)   // the slices summed norms: to terms
                xt[tid] = rts_norm_term(xt[tid], KIND, c);
        }
        __syncthreads();   // the split Y rows are read: T may lie over them

        // acc register i: row 16 warp + g + 8 ((i / 2) % 2), column
        // 8 (i / 4) + 2 t + i % 2 of the tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = 16 * warp + g + 8 * ((i / 2) % 2);
            const int col = 8 * (i / 4) + 2 * t + i % 2;
            T[r * KM_LD + col] = rts_kval<KIND>(acc[i], xt[r], yt[col], c2,
                                                gamma, degree, coef0);
        }
        __syncthreads();

        // row r of the tile (a diagonal tile takes its upper triangle on
        // both sides), then with sym off the diagonal the mirror: row col
        // of the tile at (c0 + col, r0 + r) holds T[r][col]
        const bool diag = sym && I == J, mirror = sym && I != J;
        for (int pass = 0; pass < (mirror ? 2 : 1); ++pass) {
            const int gr0 = pass ? c0 : r0, gc0 = pass ? r0 : c0;
            for (int e = tid; e < KM_T * KM_T / 4; e += KM_THREADS) {
                const int r = e / (KM_T / 4), q = e % (KM_T / 4);
                const int gr = gr0 + r, gc = gc0 + 4 * q;
                if (gr >= n) continue;
                float val[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int col = 4 * q + u;
                    val[u] = pass || (diag && col < r) ? T[col * KM_LD + r]
                                                       : T[r * KM_LD + col];
                }
                float* o = ob + (long long)gr * m + gc;
                if (vec4 && gc + 3 < m) {
                    *(float4*)o = make_float4(val[0], val[1], val[2], val[3]);
                } else {
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (gc + u < m) o[u] = val[u];
                }
            }
        }
        if (!raw) staged = -1;
    }
}

static bool km_attr[RT_MAX_DEVICES];   // a device's own (common.cuh)
static int km_sms[RT_MAX_DEVICES];

static cudaError_t km_setup(int dev) {   // once a device, outside the launch
    cudaError_t err = cudaDeviceGetAttribute(
        &km_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    void (*fns[3])(const float*, const float*, const float*, float*, int, int,
                   int, int, long long, long long, int, int, float, int,
                   float, const unsigned char*) = {
        kermat_kernel<KIND_LINEAR>, kermat_kernel<KIND_POLY>,
        kermat_kernel<KIND_RBF>};
    for (auto fn : fns) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   KM_SMEM);
        if (err != cudaSuccess) return err;
    }
    km_attr[dev] = true;
    return cudaSuccess;
}

// sym: X and Y are the same tensor (n == m, sxb == syb); the result is then
// symmetric bit for bit.  shift: (batch, d) for rbf, null otherwise.  A
// persistent grid: KM_BLOCKS blocks an SM walk the tiles.  skip: null, or a
// device flag that, when set, makes the launch compute and write nothing
// (the cached solver's row form under a CUDA graph).
extern "C" int rt_kermat(const float* X, const float* Y, const float* shift,
                         float* out, int batch, int n, int m, int d,
                         long long sxb, long long syb, int sym, int kind,
                         float gamma, int degree, float coef0,
                         const unsigned char* skip, void* stream) {
    if (batch == 0 || n == 0 || m == 0) return 0;
    if (d < 1 || kind < KIND_LINEAR || kind > KIND_RBF
        || (kind == KIND_RBF && shift == nullptr) || (sym && n != m))
        return RTS_REFUSED;
    int dev;
    const int derr = rt_device(&dev);
    if (derr) return derr;
    cudaError_t err;
    if (!km_attr[dev] && (err = km_setup(dev)) != cudaSuccess) return (int)err;
    const long long tr = (n + KM_T - 1) / KM_T, tc = (m + KM_T - 1) / KM_T;
    const long long total = (sym ? tr * (tr + 1) / 2 : tr * tc) * batch;
    const long long slots = (long long)KM_BLOCKS * km_sms[dev];
    const int grid = (int)(total < slots ? total : slots);
    const int vec4 = m % 4 == 0 && ((uintptr_t)out & 15) == 0;
    cudaStream_t s = (cudaStream_t)stream;
#define KM_LAUNCH(K)                                                          \
    kermat_kernel<K><<<grid, KM_THREADS, KM_SMEM, s>>>(                       \
        X, Y, shift, out, batch, n, m, d, sxb, syb, sym, vec4, gamma, degree, \
        coef0, skip)
    if (kind == KIND_RBF) KM_LAUNCH(KIND_RBF);
    else if (kind == KIND_POLY) KM_LAUNCH(KIND_POLY);
    else KM_LAUNCH(KIND_LINEAR);
#undef KM_LAUNCH
    return (int)cudaGetLastError();
}
