// cd_column_update: dg = y * (K(X, Xb) @ w), the rank-B gradient update of
// the level-0 block coordinate descent.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cd_update.py::
// cd_column_update (pl.pallas_call at cd_update.py:78), reached through
// ops.cd_column_update.
//
// Bound: X (n, d) is read once and the (n,) output written once; Xb, w are
// a few KB.  At the level-0 shape (n = 464,810, d = 54, B = 64) the bytes
// take 0.031 ms at 3.35 TB/s, the split-TF32 products (3 x 2 d flops a
// pair) 0.020 ms at 495 TFLOP/s and the exps 0.007 ms: bound by bytes,
// once the products leave the CUDA cores.
//
// Design: a persistent grid (two blocks an SM where they fit, 8 warps
// each).  Each block stages Xb once, split into TF32 (hi, lo) pairs in
// fragment order, with its norm terms and w (zero past B), then walks
// 128-row tiles of X through a ring of cp.async stages (a tile's rows lie
// contiguous, so it is one flat run of 16-byte copies, packed), so the next
// tiles load while tile t is multiplied.  A warp owns 16 rows of a tile and splits them in
// registers as it loads them (no row is split twice), forms their 16 x 64
// block of x.xb on the tensor cores (rbf_tile.cuh), applies the transform
// in registers and contracts it with w; a quad's xor shuffles finish each
// row's sum inside the warp, so the result does not depend on scheduling.
// B > 64 takes 64 columns a pass over the staged tile.
//
// Where the split Xb and the ring do not fit in shared memory (d > 149 at
// B <= 64, d > 72 at B = 256), a second form (cd_column_update_wide_kernel)
// streams the depth in slices of RTS_DC columns: for every tile, column pass
// and slice the block stages that slice of Xb split in fragment order, and
// each warp loads its rows' slice straight from device memory and splits it
// in registers; the products of the slices run into the same accumulators.
// It takes every d >= 1 at every B <= 256 (the caller's plan,
// ops.split_tile_plan, picks the form).
#include "rbf_tile.cuh"

#define CD_THREADS 256
#define CD_WARPS 8
#define CD_TM 128          // rows of X a tile (8 warps of 16 rows)
#define CD_CW 64           // columns of Xb a pass (8 fragment blocks)
#define CD_SMEM_MAX 232448 // shared memory a block may use (227 KB)
#define CD_SMEM_SM 233472  // shared memory of an SM (228 KB)

static size_t cd_smem(int nch, int d, int stages) {
    const int bp = nch * CD_CW;
    return (size_t)bp * rts_kp(d) * sizeof(float2)
           + (size_t)(3 * bp + rts_stride(d)) * sizeof(float)
           + (size_t)stages * rts_stage(CD_TM, d) * sizeof(float);
}

template <int KIND>
__global__ void __launch_bounds__(CD_THREADS, 2)
cd_column_update_kernel(const float* __restrict__ X, const float* __restrict__ y,
                        const float* __restrict__ Xb, const float* __restrict__ w,
                        const float* __restrict__ shift, float* __restrict__ out,
                        int n, int B, int d, int nch, int stages, int vec,
                        float gamma, int degree, float coef0) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = rts_stride(d), ksteps = rts_kp(d) / 8, bp = nch * CD_CW;
    float4* Bf = (float4*)smem;                   // split Xb, fragment order
    // (norm term, norm term, w, w) of columns 2 q and 2 q + 1, w zero past B
    float4* tw = Bf + (size_t)bp * ksteps * 4;    // (bp / 2,)
    float* bterm = (float*)(tw + bp / 2);         // (bp,) norm terms
    float* sh = bterm + bp;                       // (S,) the shift
    float* ring = sh + S;                         // stages x (CD_TM, d) packed
    const int SR = rts_stage(CD_TM, d);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float c = gamma * 1.4426950408889634f, c2 = 2.0f * c;

    const int ntiles = (n + CD_TM - 1) / CD_TM;
    const int first = blockIdx.x, step = gridDim.x;
    const int mine = first < ntiles ? (ntiles - 1 - first) / step + 1 : 0;
    for (int s = 0; s < stages - 1; ++s) {
        if (s < mine)
            rts_load_flat(ring + s * SR, X, n, d, (first + s * step) * CD_TM,
                          CD_TM, vec, tid, CD_THREADS);
        rts_cp_commit();
    }
    if (KIND == KIND_RBF) rts_stage_shift(sh, shift, d);
    rts_stage_b(Bf, bterm, bp, Xb, shift, B, d, 0, KIND, c);
    __syncthreads();
    for (int q = tid; q < bp / 2; q += CD_THREADS)
        tw[q] = make_float4(bterm[2 * q], bterm[2 * q + 1],
                            2 * q < B ? w[2 * q] : 0.0f,
                            2 * q + 1 < B ? w[2 * q + 1] : 0.0f);

    for (int it = 0; it < mine; ++it) {
        if (stages == 3) rts_cp_wait<1>(); else rts_cp_wait<0>();
        __syncthreads();   // tile it has landed; tile it - 1 is consumed
        const int nx = it + stages - 1;
        if (nx < mine)
            rts_load_flat(ring + (nx % stages) * SR, X, n, d,
                          (first + nx * step) * CD_TM, CD_TM, vec, tid,
                          CD_THREADS);
        rts_cp_commit();

        // the warp's 16 rows, split in registers as they are loaded (each
        // row by one warp), against 64 columns of Xb a pass
        const float* As = ring + (it % stages) * SR + (16 * warp + g) * d + t;
        float rs[2] = {0.0f, 0.0f};
        for (int ch = 0; ch < nch; ++ch) {
            float acc[1][8][4], small[1][8][4], an[2] = {0.0f, 0.0f};
            rts_zero(acc, small);
            const float4* Bc = Bf + (size_t)ch * 8 * ksteps * 32;
#pragma unroll 1
            for (int s = 0; s < ksteps; ++s) {
                const float* a0 = As + 8 * s;
                const int k = 8 * s + t;      // rows are packed: mask past d
                const float a[4] = {
                    rts_less(k < d ? a0[0] : 0.0f, sh, k, KIND),
                    rts_less(k < d ? a0[8 * d] : 0.0f, sh, k, KIND),
                    rts_less(k + 4 < d ? a0[4] : 0.0f, sh, k + 4, KIND),
                    rts_less(k + 4 < d ? a0[8 * d + 4] : 0.0f, sh, k + 4, KIND)};
                an[0] = fmaf(a[0], a[0], fmaf(a[2], a[2], an[0]));
                an[1] = fmaf(a[1], a[1], fmaf(a[3], a[3], an[1]));
                uint32_t ahi[1][4], alo[1][4], bf[8][4];
#pragma unroll
                for (int q = 0; q < 4; ++q) rts_split(a[q], ahi[0][q], alo[0][q]);
                rts_load_b<8>(bf, Bc, s, ksteps);
                rts_mma3<1, 8>(acc, small, ahi, alo, bf);
            }
            rts_finish(acc, small);
            float ta[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                an[h] += __shfl_xor_sync(0xffffffffu, an[h], 1);
                an[h] += __shfl_xor_sync(0xffffffffu, an[h], 2);
                ta[h] = rts_norm_term(an[h], KIND, c);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float4 q = tw[(ch * CD_CW + 8 * j + 2 * t) / 2];
                const float tb0 = q.x, tb1 = q.y, w0 = q.z, w1 = q.w;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float k0 = rts_kval<KIND>(acc[0][j][2 * h], ta[h], tb0,
                                                    c2, gamma, degree, coef0);
                    const float k1 = rts_kval<KIND>(acc[0][j][2 * h + 1], ta[h],
                                                    tb1, c2, gamma, degree, coef0);
                    rs[h] = fmaf(k1, w1, fmaf(k0, w0, rs[h]));
                }
            }
        }
        const int r = (first + it * step) * CD_TM + 16 * warp + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
            rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
            if (t == 0 && r + 8 * h < n) out[r + 8 * h] = y[r + 8 * h] * rs[h];
        }
    }
    rts_cp_wait<0>();
}

// the streamed form's shared memory: an Xb slice, (term, w) pairs, norms,
// the slice's shift
static size_t cd_wide_smem(int nch) {
    const int bp = nch * CD_CW;
    return (size_t)CD_CW / 8 * 8 * 32 * sizeof(float4)
           + (size_t)bp / 2 * sizeof(float4)
           + (size_t)(bp + RTS_DC) * sizeof(float);
}

template <int KIND>
__global__ void __launch_bounds__(CD_THREADS, 2)
cd_column_update_wide_kernel(const float* __restrict__ X,
                             const float* __restrict__ y,
                             const float* __restrict__ Xb,
                             const float* __restrict__ w,
                             const float* __restrict__ shift,
                             float* __restrict__ out, int n, int B, int d,
                             int nch, float gamma, int degree, float coef0) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int bp = nch * CD_CW, kp = rts_kp(d);
    float4* Bf = (float4*)smem;                   // an Xb slice, fragment order
    float4* tw = Bf + CD_CW / 8 * 8 * 32;         // (bp / 2,), as above
    float* bnrm = (float*)(tw + bp / 2);          // (bp,) norms
    float* sh = bnrm + bp;                        // (RTS_DC,) slice shift

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float c = gamma * 1.4426950408889634f, c2 = 2.0f * c;
    rts_row_norms(bnrm, bp, Xb, shift, B, d, 0, KIND, warp, CD_WARPS);
    __syncthreads();
    for (int q = tid; q < bp / 2; q += CD_THREADS)
        tw[q] = make_float4(rts_norm_term(bnrm[2 * q], KIND, c),
                            rts_norm_term(bnrm[2 * q + 1], KIND, c),
                            2 * q < B ? w[2 * q] : 0.0f,
                            2 * q + 1 < B ? w[2 * q + 1] : 0.0f);

    const int ntiles = (n + CD_TM - 1) / CD_TM;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int r = tile * CD_TM + 16 * warp + g;   // rows r and r + 8
        float rs[2] = {0.0f, 0.0f};
        for (int ch = 0; ch < nch; ++ch) {
            float acc[1][8][4], small[1][8][4], an[2] = {0.0f, 0.0f};
            rts_zero(acc, small);
            for (int k0 = 0; k0 < kp; k0 += RTS_DC) {
                __syncthreads();   // the last slice's fragments are read
                rts_stage_sh(sh, shift, d, k0, KIND);
                __syncthreads();
                rts_stage_b64<CD_CW, CD_THREADS>(Bf, Xb, sh, B, d, ch * CD_CW,
                                                 k0, tid);
                __syncthreads();
#pragma unroll 2
                for (int s = 0; s < RTS_DC / 8; ++s) {   // zeros past d
                    float a[4];
                    rts_pair(a[0], a[2], X, sh, n, d, r, k0, 8 * s + t);
                    rts_pair(a[1], a[3], X, sh, n, d, r + 8, k0, 8 * s + t);
                    an[0] = fmaf(a[0], a[0], fmaf(a[2], a[2], an[0]));
                    an[1] = fmaf(a[1], a[1], fmaf(a[3], a[3], an[1]));
                    uint32_t ahi[1][4], alo[1][4], bf[8][4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) rts_split(a[q], ahi[0][q], alo[0][q]);
                    rts_load_b<8>(bf, Bf, s, RTS_DC / 8);
                    rts_mma3<1, 8>(acc, small, ahi, alo, bf);
                }
            }
            rts_finish(acc, small);
            float ta[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                an[h] += __shfl_xor_sync(0xffffffffu, an[h], 1);
                an[h] += __shfl_xor_sync(0xffffffffu, an[h], 2);
                ta[h] = rts_norm_term(an[h], KIND, c);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float4 q = tw[(ch * CD_CW + 8 * j + 2 * t) / 2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float k0v = rts_kval<KIND>(acc[0][j][2 * h], ta[h], q.x,
                                                     c2, gamma, degree, coef0);
                    const float k1v = rts_kval<KIND>(acc[0][j][2 * h + 1], ta[h],
                                                     q.y, c2, gamma, degree, coef0);
                    rs[h] = fmaf(k1v, q.w, fmaf(k0v, q.z, rs[h]));
                }
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
            rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
            if (t == 0 && r + 8 * h < n) out[r + 8 * h] = y[r + 8 * h] * rs[h];
        }
    }
}

// a device's own (common.cuh)
static int cd_sms[RT_MAX_DEVICES];
static bool cd_attr[RT_MAX_DEVICES];
static int cd_occ_key[RT_MAX_DEVICES][16], cd_occ_val[RT_MAX_DEVICES][16],
    cd_occ_len[RT_MAX_DEVICES];

// Blocks an SM of device dev holds at this shared-memory size (the same for
// every kind), asked once a size.
static cudaError_t cd_occupancy(int dev, size_t smem, int* occ) {
    int* key = cd_occ_key[dev];
    int* val = cd_occ_val[dev];
    int& len = cd_occ_len[dev];
    for (int i = 0; i < len; ++i)
        if (key[i] == (int)smem) { *occ = val[i]; return cudaSuccess; }
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, cd_column_update_kernel<KIND_RBF>, CD_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (len < 16) {
        key[len] = (int)smem;
        val[len++] = *occ;
    }
    return cudaSuccess;
}

static cudaError_t cd_setup(int dev) {   // once a device, outside the launch
    cudaError_t err = cudaDeviceGetAttribute(
        &cd_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    void (*fns[3])(const float*, const float*, const float*, const float*,
                   const float*, float*, int, int, int, int, int, int, float,
                   int, float) = {
        cd_column_update_kernel<KIND_LINEAR>, cd_column_update_kernel<KIND_POLY>,
        cd_column_update_kernel<KIND_RBF>};
    for (auto fn : fns) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CD_SMEM_MAX);
        if (err != cudaSuccess) return err;
    }
    cd_attr[dev] = true;
    return cudaSuccess;
}

// stages: the caller's plan (ops.split_tile_plan): 3 or 2 ring stages for
// the resident form, 0 for the streamed one.
extern "C" int rt_cd_column_update(const float* X, const float* y,
                                   const float* Xb, const float* w,
                                   const float* shift, float* out,
                                   int n, int B, int d, int stages,
                                   int kind, float gamma, int degree,
                                   float coef0, void* stream) {
    if (n == 0) return 0;
    if (B < 1 || B > 256 || d < 1 || kind < KIND_LINEAR || kind > KIND_RBF
        || (kind == KIND_RBF && shift == nullptr))
        return RTS_REFUSED;
    const int nch = (B + CD_CW - 1) / CD_CW;
    const bool wide = stages == 0;
    if (!wide && ((stages != 2 && stages != 3)
                  || cd_smem(nch, d, stages) > CD_SMEM_MAX))
        return RTS_REFUSED;
    const size_t smem = wide ? cd_wide_smem(nch) : cd_smem(nch, d, stages);
    int dev;
    const int derr = rt_device(&dev);
    if (derr) return derr;
    cudaError_t err;
    if (!cd_attr[dev] && (err = cd_setup(dev)) != cudaSuccess) return (int)err;
    int occ = 2;   // the streamed form: two blocks an SM (its launch bound)
    if (!wide && (err = cd_occupancy(dev, smem, &occ)) != cudaSuccess)
        return (int)err;
    const int sms = cd_sms[dev];
    const int ntiles = (n + CD_TM - 1) / CD_TM;
    const int grid = ntiles < occ * sms ? ntiles : occ * sms;
    const int vec = rts_vec(X);
    cudaStream_t s = (cudaStream_t)stream;
#define CD_LAUNCH(K)                                                          \
    cd_column_update_kernel<K><<<grid, CD_THREADS, smem, s>>>(                \
        X, y, Xb, w, shift, out, n, B, d, nch, stages, vec, gamma, degree,  \
        coef0)
#define CD_WIDE(K)                                                            \
    cd_column_update_wide_kernel<K><<<grid, CD_THREADS, smem, s>>>(           \
        X, y, Xb, w, shift, out, n, B, d, nch, gamma, degree, coef0)
    if (wide) {
        if (kind == KIND_RBF) CD_WIDE(KIND_RBF);
        else if (kind == KIND_POLY) CD_WIDE(KIND_POLY);
        else CD_WIDE(KIND_LINEAR);
    } else {
        if (kind == KIND_RBF) CD_LAUNCH(KIND_RBF);
        else if (kind == KIND_POLY) CD_LAUNCH(KIND_POLY);
        else CD_LAUNCH(KIND_LINEAR);
    }
#undef CD_LAUNCH
#undef CD_WIDE
    return (int)cudaGetLastError();
}
