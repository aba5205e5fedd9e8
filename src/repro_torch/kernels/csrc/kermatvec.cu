// kernel_matvec: out = K(X, Z) @ v without materialising K, batched.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kermatvec.py::kernel_matvec
// (pl.pallas_call at kermatvec.py:80), reached through ops.kernel_matvec.
//
// Bound: out[b] (n,) = sum_j transform(x_i . z_j) v_j over Z[b] (m, d).
// The bytes are only (n + m) d + m + n floats; the work is n m pairs of a
// depth-d product, three of them in split-TF32 (495 TFLOP/s on the tensor
// cores), and one exp each (16 a clock an SM).  At d = 54 the products
// bound it: 17.7 ms at the early-scoring shape (4 x 58,101 x 116,203).
//
// Design: a block (two warpgroups, two blocks an SM) owns a 128-row tile of
// X, split once into TF32 hi and lo parts (rbf_tile.cuh) less the shift (rbf),
// each stored K-major with the 128-byte swizzle that wgmma reads, with its
// norm terms.  It streams 64-row tiles of Z: each lands by cp.async (a
// tile's rows lie contiguous: one flat run of 16-byte copies where the
// batch item's base allows), is split once by all the block's threads into
// the same swizzled hi and lo layout, and the next tile loads while this
// one is multiplied.  Each warpgroup forms its 64 (z) x 64 (x) block of
// z.x with asynchronous wgmma (m64n64k8, f32 += tf32 x tf32, both operands
// in shared memory): small = lo_z.hi_x + hi_z.lo_x and acc = hi_z.hi_x, so
// the tensor core's truncating sums drift only in the small part.  It then
// applies the transform in registers and weights it by v; each lane keeps
// its x columns' partial sums in registers across the whole Z sweep (a
// tile's terms, then 32 tiles, then all, so the f32 error of a 100k-term
// sum stays small).  At the end a fixed xor pattern over a warp's row
// lanes and a fixed four-warp sum in shared memory give each row's sum: no
// atomics, so repeated runs give identical bits.  Padded Z rows carry
// v = 0 (RBF gives K(x, 0) != 0).
//
// Past d = 128 the two split tiles no longer fit in shared memory whole, and
// a second form (kernel_matvec_wide_kernel) streams both operands in depth
// slices of RTS_DC columns, split straight from device memory: for every Z
// tile it splits the block's X slice again beside the Z slice, and the
// products of the slices run into the same accumulators.  It takes every
// d >= 1 (the caller's plan, ops.split_tile_plan, picks the form), at about
// a third of the resident form's rate: the X tile is split once a Z tile.
//
// Grid: x = row tiles, y = batch (one launch scores all clusters).
#include "rbf_tile.cuh"

#define MV_THREADS 256
#define MV_TN 128          // rows of X a block (64 a warpgroup: the N)
#define MV_TZ 64           // rows of Z a step (the M of every product)
#define MV_SMEM_MAX 232448

static size_t mv_smem(int d) {
    const int stage = rts_stage(MV_TZ, d);
    const int raw = stage > 4 * MV_TN ? stage : 4 * MV_TN;
    return 1024 + (size_t)2 * (MV_TN + MV_TZ) * rts_slabs(d) * 128
           + (size_t)(MV_TN + MV_TZ + rts_stride(d) + raw) * sizeof(float);
}

// the streamed form: split X and Z slices (two slabs each), norms, sums,
// the slice's shift
#define MV_WIDE_SMEM (1024 + 2 * (MV_TN + MV_TZ) * 2 * 128 \
                      + (MV_TN + MV_TZ + 4 * MV_TN + RTS_DC) * 4)

// One Z tile's share of the row sums: the transform of the warp's 16 x 64
// block of z.x (acc), weighted by v, into mid (ta: the tile rows' norm
// terms, vz their v; tb the warp's x columns' norm terms).
template <int KIND>
__device__ __forceinline__ void mv_accumulate(const float (&acc)[32],
                                              const float (&ta)[2],
                                              const float (&vz)[2],
                                              const float* tb, float c2,
                                              float gamma, int degree,
                                              float coef0, float (&mid)[8][2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const float tbj = tb[8 * j + p];
            float part = 0.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = 4 * j + 2 * h + p;
                part = fmaf(rts_kval<KIND>(acc[i], ta[h], tbj, c2, gamma,
                                           degree, coef0),
                            vz[h], part);
            }
            mid[j][p] += part;
        }
}

// Every 32 Z tiles the partial sums move from mid to racc (a tile's terms,
// then 32 tiles, then all: the f32 error of a 100k-term sum stays small).
__device__ __forceinline__ void mv_flush(float (&racc)[8][2], float (&mid)[8][2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            racc[j][p] += mid[j][p];
            mid[j][p] = 0.0f;
        }
}

// Each row's sum: a fixed xor pattern over a warp's row lanes and a fixed
// four-warp sum in shared memory (red, 4 x MV_TN floats, free on entry).
__device__ __forceinline__ void mv_store(const float (&racc)[8][2],
                                         const float (&mid)[8][2], float* red,
                                         float* __restrict__ out, int x0,
                                         int n) {
    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            float s = racc[j][p] + mid[j][p];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (g == 0) red[warp * MV_TN + 64 * wg + 8 * j + 2 * t + p] = s;
        }
    __syncthreads();
    if (tid < MV_TN && x0 + tid < n)
        out[x0 + tid] = (red[tid] + red[MV_TN + tid])
                        + (red[2 * MV_TN + tid] + red[3 * MV_TN + tid]);
}

template <int KIND>
__global__ void __launch_bounds__(MV_THREADS, 2)
kernel_matvec_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                     const float* __restrict__ v,
                     const float* __restrict__ shift, float* __restrict__ out,
                     int n, int m, int d,
                     long long sxb, long long szb, long long svb,
                     float gamma, int degree, float coef0) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = rts_smem_base(smem_raw);
    const long long b = blockIdx.y;
    X += b * sxb;
    Z += b * szb;
    v += b * svb;
    if (KIND == KIND_RBF) shift += b * d;
    out += b * (long long)n;
    const int slabs = rts_slabs(d), ksteps = rts_kp(d) / 8;
    const int vec = rts_vec(Z);
    unsigned char* Xhi = base;                             // (MV_TN, slabs)
    unsigned char* Xlo = Xhi + MV_TN * 128 * slabs;
    unsigned char* Zhi = Xlo + MV_TN * 128 * slabs;        // (MV_TZ, slabs)
    unsigned char* Zlo = Zhi + MV_TZ * 128 * slabs;
    float* xterm = (float*)(Zlo + MV_TZ * 128 * slabs);    // (MV_TN,)
    float* zterm = xterm + MV_TN;                          // (MV_TZ,)
    float* sh = zterm + MV_TZ;                             // (S,) the shift
    float* raw = sh + rts_stride(d);                       // (MV_TZ, d) packed
    float* red = raw;                                      // (4, MV_TN), at the end

    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const float c = gamma * 1.4426950408889634f, c2 = 2.0f * c;
    const int x0 = blockIdx.x * MV_TN;
    const int ntz = (m + MV_TZ - 1) / MV_TZ;

    if (ntz > 0) rts_load_flat(raw, Z, m, d, 0, MV_TZ, vec, tid, MV_THREADS);
    rts_cp_commit();
    if (KIND == KIND_RBF) rts_stage_shift(sh, shift, d);
    __syncthreads();
    rts_split_rows(Xhi, Xlo, xterm, X + (size_t)x0 * d, n - x0, d, MV_TN, sh,
                   KIND, c, tid, MV_THREADS);

    const uint32_t zhi = rts_smem_addr(Zhi), zlo = rts_smem_addr(Zlo);
    const uint32_t xhi = rts_smem_addr(Xhi) + wg * 64 * 128;
    const uint32_t xlo = rts_smem_addr(Xlo) + wg * 64 * 128;
    const int zslab = MV_TZ * 128, xslab = MV_TN * 128;
    const float* tb = xterm + 64 * wg + 2 * t;
    float racc[8][2], mid[8][2], acc[32], small[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) racc[j][p] = mid[j][p] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = small[i] = 0.0f;

    for (int it = 0; it < ntz; ++it) {
        rts_cp_wait<0>();
        __syncthreads();   // tile it has landed; the products of it - 1 are done
        rts_split_rows(Zhi, Zlo, zterm, raw, m - it * MV_TZ, d, MV_TZ, sh,
                       KIND, c, tid, MV_THREADS);
        rts_fence_split();
        __syncthreads();   // the split tile is ready; raw is free
        if (it + 1 < ntz)
            rts_load_flat(raw, Z, m, d, (it + 1) * MV_TZ, MV_TZ, vec, tid,
                          MV_THREADS);
        rts_cp_commit();

        rts_wgmma_tile(acc, small, zhi, zlo, zslab, xhi, xlo, xslab, ksteps);

        float vz[2], ta[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int zl = 16 * warp + 8 * h + g;
            const int z = it * MV_TZ + zl;
            vz[h] = z < m ? __ldg(v + z) : 0.0f;
            ta[h] = zterm[zl];
        }
        mv_accumulate<KIND>(acc, ta, vz, tb, c2, gamma, degree, coef0, mid);
        if (it % 32 == 31) mv_flush(racc, mid);
    }
    rts_cp_wait<0>();
    __syncthreads();   // raw is free for the warps' sums
    mv_store(racc, mid, red, out, x0, n);
}

// The streamed form, for any d: per Z tile and depth slice, all 256 threads
// split the block's 128-row X slice and the 64-row Z slice (straight from
// device memory) into the swizzled tiles, and each warpgroup's wgmma
// products run into its accumulators across the slices.  X's norms are
// taken once over whole rows; Z's are summed slice by slice.
template <int KIND>
__global__ void __launch_bounds__(MV_THREADS, 2)
kernel_matvec_wide_kernel(const float* __restrict__ X,
                          const float* __restrict__ Z,
                          const float* __restrict__ v,
                          const float* __restrict__ shift,
                          float* __restrict__ out, int n, int m, int d,
                          long long sxb, long long szb, long long svb,
                          float gamma, int degree, float coef0) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = rts_smem_base(smem_raw);
    const long long b = blockIdx.y;
    X += b * sxb;
    Z += b * szb;
    v += b * svb;
    if (KIND == KIND_RBF) shift += b * d;
    out += b * (long long)n;
    constexpr int XS = MV_TN * 128, ZS = MV_TZ * 128;      // slab bytes
    unsigned char* Xhi = base;                             // (MV_TN, 2 slabs)
    unsigned char* Xlo = Xhi + 2 * XS;
    unsigned char* Zhi = Xlo + 2 * XS;                     // (MV_TZ, 2 slabs)
    unsigned char* Zlo = Zhi + 2 * ZS;
    float* xterm = (float*)(Zlo + 2 * ZS);                 // (MV_TN,)
    float* znrm = xterm + MV_TN;                           // (MV_TZ,)
    float* red = znrm + MV_TZ;                             // (4, MV_TN)
    float* sh = red + 4 * MV_TN;                           // (RTS_DC,)

    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const float c = gamma * 1.4426950408889634f, c2 = 2.0f * c;
    const int x0 = blockIdx.x * MV_TN;
    const int ntz = (m + MV_TZ - 1) / MV_TZ, kp = rts_kp(d);
    const float* Xt = X + (size_t)x0 * d;

    rts_row_norms(xterm, MV_TN, Xt, shift, n - x0, d, 0, KIND, tid / 32,
                  MV_THREADS / 32);
    __syncthreads();
    if (tid < MV_TN) xterm[tid] = rts_norm_term(xterm[tid], KIND, c);

    const uint32_t zhi = rts_smem_addr(Zhi), zlo = rts_smem_addr(Zlo);
    const uint32_t xhi = rts_smem_addr(Xhi) + wg * 64 * 128;
    const uint32_t xlo = rts_smem_addr(Xlo) + wg * 64 * 128;
    const float* tb = xterm + 64 * wg + 2 * t;
    float racc[8][2], mid[8][2], acc[32], small[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) racc[j][p] = mid[j][p] = 0.0f;

    for (int it = 0; it < ntz; ++it) {
        const float* Zt = Z + (size_t)it * MV_TZ * d;
        for (int k0 = 0; k0 < kp; k0 += RTS_DC) {
            __syncthreads();   // the products of the last slice are done
            rts_stage_sh(sh, shift, d, k0, KIND);
            __syncthreads();
            rts_split_slice(Xhi, Xlo, nullptr, Xt, sh, n - x0, d, MV_TN, k0,
                            false, tid, MV_THREADS);
            rts_split_slice(Zhi, Zlo, znrm, Zt, sh, m - it * MV_TZ, d, MV_TZ,
                            k0, k0 == 0, tid, MV_THREADS);
            rts_fence_split();
            __syncthreads();   // the split slices are ready
            const int ks = (kp - k0 < RTS_DC ? kp - k0 : RTS_DC) / 8;
            rts_wgmma_slab(acc, small, zhi, zlo, ZS, xhi, xlo, XS, ks, k0 == 0);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += small[i];

        float vz[2], ta[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int zl = 16 * warp + 8 * h + g;
            const int z = it * MV_TZ + zl;
            vz[h] = z < m ? __ldg(v + z) : 0.0f;
            ta[h] = rts_norm_term(znrm[zl], KIND, c);
        }
        mv_accumulate<KIND>(acc, ta, vz, tb, c2, gamma, degree, coef0, mid);
        if (it % 32 == 31) mv_flush(racc, mid);
    }
    mv_store(racc, mid, red, out, x0, n);
}

static bool mv_attr[RT_MAX_DEVICES];   // a device's own (common.cuh)

static cudaError_t mv_setup(int dev) {   // once a device, outside the launch
    void (*fns[6])(const float*, const float*, const float*, const float*,
                   float*, int, int, int, long long, long long, long long,
                   float, int, float) = {
        kernel_matvec_kernel<KIND_LINEAR>, kernel_matvec_kernel<KIND_POLY>,
        kernel_matvec_kernel<KIND_RBF>, kernel_matvec_wide_kernel<KIND_LINEAR>,
        kernel_matvec_wide_kernel<KIND_POLY>, kernel_matvec_wide_kernel<KIND_RBF>};
    for (auto fn : fns) {
        cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MV_SMEM_MAX);
        if (err != cudaSuccess) return err;
    }
    mv_attr[dev] = true;
    return cudaSuccess;
}

// stages: the caller's plan (ops.split_tile_plan): 1 for the resident form,
// 0 for the streamed one.
extern "C" int rt_kernel_matvec(const float* X, const float* Z,
                                const float* v, const float* shift, float* out,
                                int batch, int n,
                                int m, int d, long long sxb, long long szb,
                                long long svb, int stages,
                                int kind, float gamma,
                                int degree, float coef0, void* stream) {
    if (batch == 0 || n == 0) return 0;
    if (d < 1 || kind < KIND_LINEAR || kind > KIND_RBF
        || (kind == KIND_RBF && shift == nullptr))
        return RTS_REFUSED;
    const bool wide = stages == 0;
    if (!wide && (stages != 1 || mv_smem(d) > MV_SMEM_MAX)) return RTS_REFUSED;
    const size_t smem = wide ? MV_WIDE_SMEM : mv_smem(d);
    int dev;
    const int derr = rt_device(&dev);
    if (derr) return derr;
    cudaError_t err;
    if (!mv_attr[dev] && (err = mv_setup(dev)) != cudaSuccess) return (int)err;
    dim3 grid((n + MV_TN - 1) / MV_TN, batch);
    cudaStream_t s = (cudaStream_t)stream;
#define MV_LAUNCH(F, K)                                                       \
    F<K><<<grid, MV_THREADS, smem, s>>>(                                      \
        X, Z, v, shift, out, n, m, d, sxb, szb, svb, gamma, degree, coef0)
    if (wide) {
        if (kind == KIND_RBF) MV_LAUNCH(kernel_matvec_wide_kernel, KIND_RBF);
        else if (kind == KIND_POLY) MV_LAUNCH(kernel_matvec_wide_kernel, KIND_POLY);
        else MV_LAUNCH(kernel_matvec_wide_kernel, KIND_LINEAR);
    } else {
        if (kind == KIND_RBF) MV_LAUNCH(kernel_matvec_kernel, KIND_RBF);
        else if (kind == KIND_POLY) MV_LAUNCH(kernel_matvec_kernel, KIND_POLY);
        else MV_LAUNCH(kernel_matvec_kernel, KIND_LINEAR);
    }
#undef MV_LAUNCH
    return (int)cudaGetLastError();
}
