// The bf16 operand forms of kermat, kernel_matvec and cd_column_update:
// the precision policy compute_dtype="bfloat16" of the Gram operator.
//
// Replace the compute_dtype branches of the Pallas TPU kernels
//   src/repro/kernels/kermat.py:27-33     (kermat, pl.pallas_call at :75)
//   src/repro/kernels/kermatvec.py:37-41  (kernel_matvec, :80)
//   src/repro/kernels/cd_update.py:33-37  (cd_column_update, :78)
// reached through ops.kernel_matrix / kernel_matvec / cd_column_update with
// compute_dtype="bfloat16".
//
// Arithmetic (the reference's): both operands rounded to bf16 (to nearest
// even), their products summed in f32 (the product of two bf16 values is
// exact in f32, so one bf16 tensor-core product computes what
// dot_general(preferred_element_type=f32) computes, up to the order of the
// sum), the rbf norms taken of the rounded rows in f32, and the transform
// applied in f32.  No mean shift: the policy rounds the unshifted rows, and
// shifting first would round other values and give another function.
//
// Operands: bg_pack rounds a row-major (rows, d) f32 matrix once into a
// (rows, dp) bf16 matrix, dp = d rounded up to 8 with zero columns (they
// leave dot products and norms exact; a row is a whole number of 16-byte
// copies), and the f32 norms of the rounded rows.  The Gram operator keeps
// X packed for a whole solve, so the products read half the bytes of the
// f32 rows.
//
// Depth: rows are staged in shared memory a slice of at most BG_SLICE
// columns at a time, each slice rounded up to 32 columns by the copies'
// zero fill.  Rows of up to BG_SLICE columns are one slice; a wider row
// takes further slices, summed into the same accumulators in column
// order, so every d is taken.  The wide forms are instantiations of their
// own (WIDE), so that the one-slice forms compile as straight-line code
// (a slice loop there cost them registers, spills and occupancy).
//
// Products: mma.sync.m16n8k16 (bf16 in, f32 accumulate) on tiles staged in
// shared memory by cp.async.  A lane reads 16 bytes of a row at once: the
// 32 columns of a chunk are dealt to the two k16 steps so that lane t's
// fragment pairs (k = 2t, 2t+1 and 2t+8, 2t+9 of each step) are physical
// columns 8t .. 8t + 3 of the chunk (step one) and 8t + 4 .. 8t + 7 (step
// two).  A and B take the same map, so each product pairs equal columns.
// Staged rows are bg_ld(slice width) bytes apart, 64 past a multiple of
// 128, so the 16-byte reads of a quarter warp fall on distinct banks.
//
// Forms:
//   kermat      (n, m) f32 out, 64 x 64 tiles (four warps of 16 rows); for
//               K(X, X) only the tiles on and above the diagonal, each
//               written with its mirror (a diagonal tile's upper triangle to
//               both sides), so the result is symmetric bit for bit.  A
//               device predicate (skip) makes every block return at once:
//               the cached solver's row form, which a CUDA graph replays
//               whether or not the cache served the block.
//   matvec      out = K(X, Z) v [times y]: a block keeps 256 X rows and
//               streams Z in 64-row stages (double-buffered), summing each
//               row's terms in registers; the (n, m) block never reaches
//               device memory.  Rows wider than one slice stage the X rows
//               again with each Z stage, a slice at a time.  cd_column_update is this form with Z the
//               block's B columns and y the row signs.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

#define BG_REFUSED 20000      // ops._REFUSED: nothing launched
#define BG_SLICE 256          // widest slice of a row in shared memory
#define BG_MV_ROWS 256        // X rows a matvec block (8 warps x 32)
#define BG_MV_COLS 64         // Z rows a matvec stage
#define BG_KM_T 64            // kermat tile

__host__ __device__ __forceinline__ int bg_ld(int sw) {
    const int b = sw * 2;
    return b % 128 == 0 ? b + 64 : b;   // sw a multiple of 32: b % 64 == 0
}

// Staged width of the slice of a row that starts `left` columns before
// its end: a multiple of 32, at most BG_SLICE.
__host__ __device__ __forceinline__ int bg_sw(int left) {
    const int w = (left + 31) / 32 * 32;
    return w < BG_SLICE ? w : BG_SLICE;
}

__device__ __forceinline__ uint32_t bg_smem(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16); src_bytes 0 zero-fills
__device__ __forceinline__ void bg_cp(void* dst, const void* src, int bytes,
                                      int src_bytes) {
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(bg_smem(dst)), "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(bg_smem(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void bg_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void bg_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void bg_mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 bg_lds(const unsigned char* p) {
    return *reinterpret_cast<const uint4*>(p);
}

// The transform of one Gram entry g with the rows' norms xn, zn.
template <int KIND>
__device__ __forceinline__ float bg_kval(float g, float xn, float zn, float c,
                                         float gamma, int degree,
                                         float coef0) {
    if (KIND == KIND_LINEAR) return g;
    if (KIND == KIND_POLY) {
        const float b = gamma * g + coef0;
        float r = 1.0f;
        for (int i = 0; i < degree; ++i) r *= b;
        return r;
    }
    return exp2f(-c * fmaxf(xn + zn - 2.0f * g, 0.0f));
}

// Columns [c0, c0 + w) of rows [r0, r0 + R) of a packed (rows, dp) bf16
// matrix into shared memory (row stride ld bytes); rows past `rows` and
// columns past dp are zero-filled.
__device__ __forceinline__ void bg_load_rows(unsigned char* dst,
                                             const __nv_bfloat16* src,
                                             int rows, int dp, int c0, int w,
                                             int ld, int r0, int R, int tid,
                                             int nthr) {
    const int per = w / 8;                  // 16-byte chunks a staged row
    for (int i = tid; i < R * per; i += nthr) {
        const int r = i / per, ch = i % per;
        const int gr = r0 + r, gc = c0 + ch * 8;
        const bool ok = gr < rows && gc < dp;   // dp a multiple of 8
        const __nv_bfloat16* s =
            src + (ok ? (long long)gr * dp + gc : 0LL);
        bg_cp(dst + r * ld + ch * 16, s, 16, ok ? 16 : 0);
    }
}

// One 32-column chunk of a warp's products: MT m16 tiles of A (rows a_row0
// + 16 mt) against NT n8 tiles of B (rows b_row0 + 8 nt).
template <int MT, int NT>
__device__ __forceinline__ void bg_chunk(float (&acc)[MT][NT][4],
                                         const unsigned char* A,
                                         const unsigned char* B, int ld,
                                         int ch, int g, int t) {
    uint4 a[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = bg_lds(A + (16 * mt + g) * ld + ch * 64 + t * 16);
        a[mt][1] = bg_lds(A + (16 * mt + g + 8) * ld + ch * 64 + t * 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = bg_lds(B + (8 * nt + g) * ld + ch * 64 + t * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            bg_mma(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y,
                   a[mt][1].y, b.x, b.y);
            bg_mma(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w,
                   a[mt][1].w, b.z, b.w);
        }
    }
}

// ------------------------------------------------------------------ pack --

__global__ void bg_pack_kernel(const float* __restrict__ X, long long rows,
                               int d, int dp, __nv_bfloat16* __restrict__ out,
                               float* __restrict__ norms) {
    const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const float* x = X + r * d;
    uint4* o = reinterpret_cast<uint4*>(out + r * dp);
    float nrm = 0.0f;
    for (int c0 = 0; c0 < dp; c0 += 8) {
        __align__(16) __nv_bfloat16 q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int k = c0 + e;
            q[e] = __float2bfloat16_rn(k < d ? x[k] : 0.0f);
            const float f = __bfloat162float(q[e]);
            nrm = fmaf(f, f, nrm);
        }
        o[c0 / 8] = *reinterpret_cast<const uint4*>(q);
    }
    norms[r] = nrm;
}

// ---------------------------------------------------------------- kermat --

__device__ __forceinline__ void bg_tile_of(long long u, int tr, int tc,
                                           int sym, int& I, int& J) {
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

template <int KIND, bool WIDE>
__global__ void __launch_bounds__(128)
bg_kermat_kernel(const __nv_bfloat16* __restrict__ X,
                 const float* __restrict__ xn,
                 const __nv_bfloat16* __restrict__ Y,
                 const float* __restrict__ yn, float* __restrict__ out,
                 int n, int m, int dp, int sym,
                 const unsigned char* __restrict__ skip, float gamma,
                 int degree, float coef0) {
    if (skip != nullptr && *skip) return;
    extern __shared__ __align__(16) unsigned char bg_sm[];
    const int sw = bg_sw(dp);
    const int ld = bg_ld(sw);
    unsigned char* sx = bg_sm;
    unsigned char* sy = sx + BG_KM_T * ld;
    const int b = blockIdx.y;
    X += (long long)b * n * dp;
    xn += (long long)b * n;
    Y += (long long)b * m * dp;
    yn += (long long)b * m;
    out += (long long)b * n * m;
    const int tr = (n + BG_KM_T - 1) / BG_KM_T;
    const int tc = (m + BG_KM_T - 1) / BG_KM_T;
    int I, J;
    bg_tile_of(blockIdx.x, tr, tc, sym, I, J);
    const int r0 = I * BG_KM_T, c0 = J * BG_KM_T;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;

    float acc[1][8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.0f;
    auto slice = [&](int s0, int w) {
        bg_load_rows(sx, X, n, dp, s0, w, ld, r0, BG_KM_T, tid, 128);
        bg_load_rows(sy, Y, m, dp, s0, w, ld, c0, BG_KM_T, tid, 128);
        bg_commit();
        bg_wait<0>();
        __syncthreads();
        for (int ch = 0; ch < w / 32; ++ch)
            bg_chunk<1, 8>(acc, sx + 16 * warp * ld, sy, ld, ch, g, t);
    };
    if (!WIDE) {
        slice(0, sw);
    } else {
        for (int s0 = 0; s0 < dp; s0 += BG_SLICE) {
            if (s0 > 0) __syncthreads();    // the last slice is read
            slice(s0, bg_sw(dp - s0));
        }
    }

    const float c = gamma * 1.4426950408889634f;
    const bool diag = sym && I == J;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * warp + g + 8 * h;
        if (r >= n) continue;
        const float xr = KIND == KIND_RBF ? xn[r] : 0.0f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = c0 + 8 * nt + 2 * t + e;
                if (col >= m) continue;
                if (diag && col < r) continue;
                const float zc = KIND == KIND_RBF ? yn[col] : 0.0f;
                const float v = bg_kval<KIND>(acc[0][nt][2 * h + e], xr, zc, c,
                                              gamma, degree, coef0);
                out[(long long)r * m + col] = v;
                if (sym && col != r) out[(long long)col * m + r] = v;
            }
        }
    }
}

// ---------------------------------------------------------------- matvec --

template <int KIND, bool SIGN, bool WIDE>
__global__ void __launch_bounds__(256)
bg_matvec_kernel(const __nv_bfloat16* __restrict__ X,
                 const float* __restrict__ xn,
                 const __nv_bfloat16* __restrict__ Z,
                 const float* __restrict__ zn, const float* __restrict__ v,
                 const float* __restrict__ y, float* __restrict__ out,
                 int n, int m, int dp, float gamma, int degree, float coef0) {
    extern __shared__ __align__(16) unsigned char bg_sm[];
    const int sw = bg_sw(dp);
    const int ld = bg_ld(sw);
    unsigned char* sx = bg_sm;                              // 256 X rows
    unsigned char* sz = sx + BG_MV_ROWS * ld;               // 2 Z stages
    float* szn = (float*)(sz + 2 * BG_MV_COLS * ld);        // 2 x 64 norms
    float* sv = szn + 2 * BG_MV_COLS;                       // 2 x 64 weights
    const int b = blockIdx.y;
    X += (long long)b * n * dp;
    xn += (long long)b * n;
    Z += (long long)b * m * dp;
    zn += (long long)b * m;
    v += (long long)b * m;
    out += (long long)b * n;
    const int r0 = blockIdx.x * BG_MV_ROWS;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int tiles = (m + BG_MV_COLS - 1) / BG_MV_COLS;

    float xr[2][2], part[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 32 * warp + 16 * mt + 8 * h + g;
            xr[mt][h] = (KIND == KIND_RBF && r < n) ? xn[r] : 0.0f;
            part[mt][h] = 0.0f;
        }
    const float c = gamma * 1.4426950408889634f;
    const unsigned char* A = sx + 32 * warp * ld;
    float acc[2][8][4];
    auto clear = [&]() {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    };
    // the transform of a stage's products, times its weights, into part
    auto fold = [&](const float* zs, const float* vs) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = 8 * nt + 2 * t + e;
                const float zc = zs[col], w = vs[col];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        part[mt][h] = fmaf(
                            bg_kval<KIND>(acc[mt][nt][2 * h + e], xr[mt][h],
                                          zc, c, gamma, degree, coef0),
                            w, part[mt][h]);
            }
    };

    if (!WIDE) {
        // one slice: the block's X rows stay resident, Z streams in
        // double-buffered stages
        auto issue = [&](int tile) {
            const int st = tile & 1;
            const int z0 = tile * BG_MV_COLS;
            bg_load_rows(sz + st * BG_MV_COLS * ld, Z, m, dp, 0, sw, ld, z0,
                         BG_MV_COLS, tid, 256);
            if (tid < BG_MV_COLS) {
                const int col = z0 + tid;
                const bool ok = col < m;
                bg_cp(szn + st * BG_MV_COLS + tid, zn + (ok ? col : 0), 4,
                      ok && KIND == KIND_RBF ? 4 : 0);
                bg_cp(sv + st * BG_MV_COLS + tid, v + (ok ? col : 0), 4,
                      ok ? 4 : 0);
            }
        };
        bg_load_rows(sx, X, n, dp, 0, sw, ld, r0, BG_MV_ROWS, tid, 256);
        if (tiles > 0) issue(0);
        bg_commit();
        for (int tile = 0; tile < tiles; ++tile) {
            if (tile + 1 < tiles) issue(tile + 1);
            bg_commit();
            bg_wait<1>();
            __syncthreads();
            const int st = tile & 1;
            clear();
            for (int ch = 0; ch < sw / 32; ++ch)
                bg_chunk<2, 8>(acc, A, sz + st * BG_MV_COLS * ld, ld, ch, g,
                               t);
            fold(szn + st * BG_MV_COLS, sv + st * BG_MV_COLS);
            __syncthreads();
        }
        bg_wait<0>();
    } else {
        // wider rows: each stage stages the block's X rows and the stage's
        // Z rows a slice at a time (X is read again each stage)
        for (int tile = 0; tile < tiles; ++tile) {
            const int z0 = tile * BG_MV_COLS;
            clear();
            for (int s0 = 0; s0 < dp; s0 += BG_SLICE) {
                const int w = bg_sw(dp - s0);
                __syncthreads();            // the last slice is read
                bg_load_rows(sx, X, n, dp, s0, w, ld, r0, BG_MV_ROWS, tid,
                             256);
                bg_load_rows(sz, Z, m, dp, s0, w, ld, z0, BG_MV_COLS, tid,
                             256);
                if (s0 == 0 && tid < BG_MV_COLS) {
                    const int col = z0 + tid;
                    const bool ok = col < m;
                    szn[tid] = ok && KIND == KIND_RBF ? zn[col] : 0.0f;
                    sv[tid] = ok ? v[col] : 0.0f;
                }
                bg_commit();
                bg_wait<0>();
                __syncthreads();
                for (int ch = 0; ch < w / 32; ++ch)
                    bg_chunk<2, 8>(acc, A, sz, ld, ch, g, t);
            }
            fold(szn, sv);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float s = part[mt][h];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            const int r = r0 + 32 * warp + 16 * mt + 8 * h + g;
            if (t == 0 && r < n) out[r] = SIGN ? y[r] * s : s;
        }
}

// ----------------------------------------------------------- entry points --

static int bg_kermat_smem(int dp) { return 2 * BG_KM_T * bg_ld(bg_sw(dp)); }
static int bg_mv_smem(int dp) {
    return (BG_MV_ROWS + 2 * BG_MV_COLS) * bg_ld(bg_sw(dp))
           + 4 * BG_MV_COLS * 4;
}

static bool bg_dp_ok(int dp) { return dp >= 8 && dp % 8 == 0; }

// Allow a kernel the shared memory of the widest slice it stages, once
// (the caller keeps the flag: one per kernel instantiation).
template <typename K>
static int bg_smem_attr(K kernel, int smem_max, bool& done) {
    if (done) return 0;
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    done = err == 0;
    return err;
}

extern "C" int rt_bf16_pack(const float* X, long long rows, int d, int dp,
                            void* out, float* norms, cudaStream_t stream) {
    if (d < 1 || !bg_dp_ok(dp) || dp < d) return BG_REFUSED;
    if (rows == 0) return 0;
    const int thr = 128;
    bg_pack_kernel<<<(unsigned)((rows + thr - 1) / thr), thr, 0, stream>>>(
        X, rows, d, dp, (__nv_bfloat16*)out, norms);
    return (int)cudaGetLastError();
}

template <int KIND>
static int bg_kermat_launch(const void* X, const float* xn, const void* Y,
                            const float* yn, float* out, int batch, int n,
                            int m, int dp, int sym, const unsigned char* skip,
                            float gamma, int degree, float coef0,
                            cudaStream_t stream) {
    static bool attr[2] = {false, false};
    const bool wide = dp > BG_SLICE;
    auto kernel = wide ? bg_kermat_kernel<KIND, true>
                       : bg_kermat_kernel<KIND, false>;
    const int smem = bg_kermat_smem(dp);
    int err = bg_smem_attr(kernel, bg_kermat_smem(BG_SLICE), attr[wide]);
    if (err) return err;
    const long long tr = (n + BG_KM_T - 1) / BG_KM_T;
    const long long tc = (m + BG_KM_T - 1) / BG_KM_T;
    const long long tiles = sym ? tr * (tr + 1) / 2 : tr * tc;
    if (tiles >= (1LL << 31) || batch > 65535) return BG_REFUSED;
    dim3 grid((unsigned)tiles, (unsigned)batch);
    kernel<<<grid, 128, smem, stream>>>(
        (const __nv_bfloat16*)X, xn, (const __nv_bfloat16*)Y, yn, out, n, m,
        dp, sym, skip, gamma, degree, coef0);
    return (int)cudaGetLastError();
}

extern "C" int rt_kermat_bf16(const void* X, const float* xn, const void* Y,
                              const float* yn, float* out, int batch, int n,
                              int m, int dp, int sym, const unsigned char* skip,
                              int kind, float gamma, int degree, float coef0,
                              cudaStream_t stream) {
    if (!bg_dp_ok(dp) || (sym && n != m)) return BG_REFUSED;
    if (batch == 0 || n == 0 || m == 0) return 0;
    switch (kind) {
        case KIND_LINEAR:
            return bg_kermat_launch<KIND_LINEAR>(X, xn, Y, yn, out, batch, n,
                                                 m, dp, sym, skip, gamma,
                                                 degree, coef0, stream);
        case KIND_POLY:
            return bg_kermat_launch<KIND_POLY>(X, xn, Y, yn, out, batch, n, m,
                                               dp, sym, skip, gamma, degree,
                                               coef0, stream);
        case KIND_RBF:
            return bg_kermat_launch<KIND_RBF>(X, xn, Y, yn, out, batch, n, m,
                                              dp, sym, skip, gamma, degree,
                                              coef0, stream);
    }
    return BG_REFUSED;
}

template <int KIND, bool SIGN>
static int bg_mv_launch(const void* X, const float* xn, const void* Z,
                        const float* zn, const float* v, const float* y,
                        float* out, int batch, int n, int m, int dp,
                        float gamma, int degree, float coef0,
                        cudaStream_t stream) {
    static bool attr[2] = {false, false};
    const bool wide = dp > BG_SLICE;
    auto kernel = wide ? bg_matvec_kernel<KIND, SIGN, true>
                       : bg_matvec_kernel<KIND, SIGN, false>;
    const int smem = bg_mv_smem(dp);
    int err = bg_smem_attr(kernel, bg_mv_smem(BG_SLICE), attr[wide]);
    if (err) return err;
    if (batch > 65535) return BG_REFUSED;
    dim3 grid((unsigned)((n + BG_MV_ROWS - 1) / BG_MV_ROWS), (unsigned)batch);
    kernel<<<grid, 256, smem, stream>>>(
        (const __nv_bfloat16*)X, xn, (const __nv_bfloat16*)Z, zn, v, y, out,
        n, m, dp, gamma, degree, coef0);
    return (int)cudaGetLastError();
}

template <bool SIGN>
static int bg_mv(const void* X, const float* xn, const void* Z,
                 const float* zn, const float* v, const float* y, float* out,
                 int batch, int n, int m, int dp, int kind, float gamma,
                 int degree, float coef0, cudaStream_t stream) {
    if (!bg_dp_ok(dp)) return BG_REFUSED;
    if (batch == 0 || n == 0) return 0;
    switch (kind) {
        case KIND_LINEAR:
            return bg_mv_launch<KIND_LINEAR, SIGN>(X, xn, Z, zn, v, y, out,
                                                   batch, n, m, dp, gamma,
                                                   degree, coef0, stream);
        case KIND_POLY:
            return bg_mv_launch<KIND_POLY, SIGN>(X, xn, Z, zn, v, y, out,
                                                 batch, n, m, dp, gamma,
                                                 degree, coef0, stream);
        case KIND_RBF:
            return bg_mv_launch<KIND_RBF, SIGN>(X, xn, Z, zn, v, y, out,
                                                batch, n, m, dp, gamma,
                                                degree, coef0, stream);
    }
    return BG_REFUSED;
}

extern "C" int rt_kernel_matvec_bf16(const void* X, const float* xn,
                                     const void* Z, const float* zn,
                                     const float* v, float* out, int batch,
                                     int n, int m, int dp, int kind,
                                     float gamma, int degree, float coef0,
                                     cudaStream_t stream) {
    return bg_mv<false>(X, xn, Z, zn, v, nullptr, out, batch, n, m, dp, kind,
                        gamma, degree, coef0, stream);
}

extern "C" int rt_cd_update_bf16(const void* X, const float* xn,
                                 const float* y, const void* Xb,
                                 const float* bn, const float* w, float* out,
                                 int n, int B, int dp, int kind, float gamma,
                                 int degree, float coef0,
                                 cudaStream_t stream) {
    return bg_mv<true>(X, xn, Xb, bn, w, y, out, 1, n, B, dp, kind, gamma,
                       degree, coef0, stream);
}
