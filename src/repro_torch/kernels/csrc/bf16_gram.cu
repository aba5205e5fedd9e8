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
// f32 rows.  Bound by bytes (the f32 rows in, the packed rows out): a
// block's threads take 8 columns each, in order along its rows, read
// with 16-byte loads where the row's alignment allows (8-byte or 4-byte
// ones where it does not), so a warp reads whole runs of neighbouring
// rows; then a thread a row sums the staged rounded squares in column
// order, the fma chain of a thread that walks the row alone, so the norms
// keep their bits (a fit's unconverged levels follow ulps).
//
// Depth: rows are staged in shared memory a slice of at most BG_SLICE
// columns at a time, each slice rounded up to 32 columns by the copies'
// zero fill.  Rows of up to BG_SLICE columns are one slice; a wider row
// takes further slices, summed into the same accumulators in column
// order, so every d is taken (cd_update's slices are BG_CD_SLICE columns,
// past BG_PIPE_DP; the matvec's BG_MV_WSW, past BG_MV_DP).  The wide forms
// are instantiations of their own (WIDE), so that the one-slice forms
// compile as straight-line code (a slice loop there cost them registers,
// spills and occupancy).
//
// Products: mma.sync.m16n8k16 (bf16 in, f32 accumulate) on tiles staged in
// shared memory by cp.async (the matvec's Z rows by TMA).  A lane reads 16
// bytes of a row at once: the 32 columns of a chunk are dealt to the two
// k16 steps so that lane t's fragment pairs (k = 2t, 2t+1 and 2t+8, 2t+9
// of each step) are physical columns 8t .. 8t + 3 of the chunk (step one)
// and 8t + 4 .. 8t + 7 (step two).  A and B take the same map, so each
// product pairs equal columns.  Staged rows are unpadded, with the 16-byte
// chunks of odd rows xor-swizzled (bg_swz) where the row stride is a
// multiple of 128 bytes, so the reads are conflict-free (the matvec's TMA
// boxes cannot swizzle so: they land at a padded pitch, bg_ld).  mma.sync
// suffices for the byte-bound forms (wgmma would need its own shared-memory
// layout and could not lift a byte bound); the matvec keeps it for its
// bits (wgmma's accumulation order is its own).
//
// Forms:
//   kermat      (n, m) f32 out, 64 x 64 tiles (four warps of 16 rows),
//               bound by the output bytes (the level-4 Grams write 3.38 GB
//               and read 0.10 GB; the row form writes 119 MB of 171 MB).
//               Stores straight from the mma fragments would write 4 bytes
//               a lane, half of each sector (the mirror down a column), and
//               a block a tile would stage its X rows again each tile and
//               hide no load.  So a persistent grid: each block
//               walks a contiguous run of tiles (of every batch item; for
//               K(X, X) only those on and above the diagonal), in a ring
//               of three Y stages that load while earlier tiles are
//               multiplied and stored; a row of tiles' X rows load with its
//               first tile into one of three slots (one for the row form,
//               staged once a block).  The transform runs in registers
//               and the tile is staged in
//               shared memory, each row shifted to the output's 16-byte
//               grid, so its rows leave as aligned 16-byte stores for
//               every m; the quad a row shares with the next tile of the
//               run is carried there and stored whole (two tiles writing
//               one 32-byte sector in parts slowed misaligned rows).  K(X, X)
//               stages the tile's transpose too and writes the mirror from
//               the same values, so it is symmetric bit for bit.  A device
//               predicate (skip), read once a block, makes every block
//               return at once: the cached solver's row form, which a CUDA
//               graph replays whether or not the cache served the block.
//   matvec      out = K(X, Z) v, the (n, m) block never in device memory.
//               Bound by its exps (one MUFU ex2 a pair); the transform
//               around each is 11 more instructions (exp2f's subnormal
//               fix-up included) and the products cost about as much time
//               on the tensor pipe, and the two do not overlap.  A
//               persistent kernel: two blocks of 8 warps an SM, 32 X rows
//               a warp, walk (batch item, 256-row) units; Z streams through
//               a ring of TMA-fed entries that mbarriers mark full, and the
//               last warp to release an entry refills it, so no block-wide
//               barrier is in the loop.  A row's terms are summed in
//               registers in column order and by a quad's xor shuffles,
//               written once.  Rows wider than BG_MV_DP take 96-column
//               slices through the ring (see "matvec" below).
//   cd_update   out = y * (K(X, Xb) w), bound by the bytes of X's packed
//               rows (0.0167 ms at the level-0 shape), so the loads must run
//               under the products and exps, which a block that stages its
//               rows and then waits for them cannot do.  A persistent
//               kernel: each block keeps the block rows Xb and
//               their (norm term, weight) pairs resident in shared memory
//               (64-row chunks; a B too wide for one residency takes passes
//               of as many chunks as fit, a row's partial sums kept in its
//               output entry by the same lane, in order), and each warp
//               streams its own equal share of X's rows, 16-row tiles of
//               packed rows with their norms and signs, through its own
//               ring of four cp.async stages: no block-wide barrier in the
//               loop, so each warp's loads run ahead of its products, exps
//               and sums.  A row's terms are summed in registers and by a
//               quad's xor shuffles in a fixed order, and written once.
//               Rows wider than BG_PIPE_DP columns take a form that stages
//               a block's 128-row tile and a chunk a slice at a time.
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "tma.cuh"

#define BG_REFUSED 20000      // ops._REFUSED: nothing launched
#define BG_SLICE 256          // widest slice of a row in shared memory
#define BG_MV_COLS 64         // Z rows a matvec stage
#define BG_KM_T 64            // kermat tile
#define BG_KM_LDT 72          // row stride of the staged tile (floats)
#define BG_KM_LDM 68          // row stride of its staged transpose (floats)
#define BG_KM_STAGES 3        // Y stages of the kermat ring (and X slots)
#define BG_CD_WARPS 8         // warps a cd_update block
#define BG_CD_WR 16           // X rows a warp's tile
#define BG_CD_WS 4            // stages of a warp's ring
#define BG_CD_CW 64           // block rows a chunk
#define BG_PIPE_DP 128        // widest packed row of the pipelined forms
#define BG_CD_SLICE 128       // widest slice of cd_update's slice form
#define BG_SMEM_MAX 232448    // shared memory a block may use (227 KB)

// The ring check (-DBG_RING_CHECK: kernels/build.py's bf16_gram_check
// library, a debug build beside the one the port runs).  The matvec's Z
// ring, the one ring whose entries warps share, counts each slot's fills
// in shared memory and tags each entry with its place in the walk; a warp
// checks the tag when the entry is full and again when it releases it,
// after its last read (a refill that overwrote the entry while the warp
// read it has changed the tag), and the counts at exit.  A fault is
// counted here instead of trapping: the host reads the words with
// rt_bg_ring_check.  Words: faults; the first one's (check << 56 | block
// << 24 | warp << 8 | slot); its (expected << 32 | found); the exit checks
// that ran.  Checks: 1 the entry's tag when full, 2 the slot counts, 3 the
// entries a warp read, 4 the entry's tag at its release.  (kermat's and
// cd_update's cp.async rings are each a block's or a warp's own, ordered
// by its barriers; only the repeats of kernels/ring_stress.py test them.)
#ifdef BG_RING_CHECK
#define BG_CK(...) __VA_ARGS__
__device__ unsigned long long bg_ring_state[4];

__device__ __noinline__ void bg_ring_fault(unsigned check, unsigned slot,
                                           unsigned want, unsigned got) {
    if (atomicAdd(&bg_ring_state[0], 1ull) == 0ull) {
        bg_ring_state[1] = ((unsigned long long)check << 56)
                           | ((unsigned long long)blockIdx.x << 24)
                           | ((unsigned long long)(threadIdx.x / 32) << 8)
                           | slot;
        bg_ring_state[2] = ((unsigned long long)want << 32) | got;
    }
}
__device__ __forceinline__ void bg_ring_checked() {
    atomicAdd(&bg_ring_state[3], 1ull);
}
#else
#define BG_CK(...)
#endif

// Row pitch (bytes) of a staged slice sw columns wide, 64 bytes past a
// multiple of 128 so that the 16-byte fragment reads of a quarter warp
// (rows g, g + 1) fall on distinct banks without a swizzle.
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

// cp.async of `bytes` (4 or 16); src_bytes 0 zero-fills
__device__ __forceinline__ void bg_cp(void* dst, const void* src, int bytes,
                                      int src_bytes) {
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
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

// Entries [r0, r0 + R) of an f32 vector into shared memory by 4-byte
// copies, one a thread from thread `first` on; past `rows` zero.
__device__ __forceinline__ void bg_load_vec(float* dst, const float* src,
                                            int rows, int r0, int R, int tid,
                                            int first) {
    const int i = tid - first;
    if (i >= 0 && i < R) {
        const bool ok = r0 + i < rows;
        bg_cp(dst + i, src + (ok ? r0 + i : 0), 4, ok ? 4 : 0);
    }
}

template <int MT, int NT>
__device__ __forceinline__ void bg_zero(float (&acc)[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// ------------------------------------------------------------------ pack --

__device__ __forceinline__ float4 bg_ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float2 bg_ldg2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}

// A block packs R rows.  Its threads round 8 columns at a time, in order
// along the rows (neighbouring threads on neighbouring addresses), store
// them to the output and to shared memory; then thread r sums row r's
// rounded squares in column order, the fma chain of a thread that walks
// the row alone.  Staged rows are `ldc` 16-byte chunks apart, ldc odd so
// that the 16-byte reads of a quarter warp fall on distinct banks; rows
// too wide for shared memory (staged 0) are read back from the output.
// vec: X is 16-byte aligned.
__global__ void __launch_bounds__(256)
bg_pack_kernel(const float* __restrict__ X, long long rows, int d, int dp,
               int R, int staged, int vec, __nv_bfloat16* __restrict__ out,
               float* __restrict__ norms) {
    extern __shared__ __align__(16) unsigned char bg_sm[];
    uint4* sq = reinterpret_cast<uint4*>(bg_sm);
    const int per = dp / 8, ldc = per | 1;
    const long long r0 = (long long)blockIdx.x * R;
    const int nr = (int)(rows - r0 < R ? rows - r0 : R);
    for (int i = threadIdx.x; i < nr * per; i += blockDim.x) {
        const int lr = i / per, j = i % per;
        const long long r = r0 + lr;
        const float* x = X + r * d;
        const int c0 = 8 * j;
        // the row's alignment: 0 (16 bytes), 2 (8 bytes), else 4 bytes
        const int al = vec ? (int)((r * d) & 3) : 1;
        float f[8];
        if (c0 + 8 <= d && al == 0) {
            const float4 a = bg_ldg4(x + c0), b = bg_ldg4(x + c0 + 4);
            f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
            f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
        } else if (c0 + 8 <= d && al == 2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 a = bg_ldg2(x + c0 + 2 * e);
                f[2 * e] = a.x;
                f[2 * e + 1] = a.y;
            }
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                f[e] = c0 + e < d ? __ldg(x + c0 + e) : 0.0f;
        }
        __align__(16) __nv_bfloat16 q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) q[e] = __float2bfloat16_rn(f[e]);
        const uint4 u = *reinterpret_cast<const uint4*>(q);
        *reinterpret_cast<uint4*>(out + r * dp + c0) = u;
        if (staged) sq[lr * ldc + j] = u;
    }
    __syncthreads();   // the block's rounded rows are staged (or stored)
    for (int lr = threadIdx.x; lr < nr; lr += blockDim.x) {
        float nrm = 0.0f;
        for (int j = 0; j < per; ++j) {
            const uint4 u = staged ? sq[lr * ldc + j]
                                   : *reinterpret_cast<const uint4*>(
                                         out + (r0 + lr) * dp + 8 * j);
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {   // a bf16 is an f32's top half
                const float v = __uint_as_float(
                    e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
                nrm = fmaf(v, v, nrm);
            }
        }
        norms[r0 + lr] = nrm;
    }
}

// ---------------------------------------------------- persistent forms --
//
// Their staged rows are 2 sw bytes apart, unpadded: where that is a
// multiple of 128 the 16-byte chunk c of staged row r lies at chunk
// c ^ 4 (r & 1), so the 16-byte reads of a quarter warp (rows g and g + 1
// of a fragment, chunks 4 k + t) still fall on distinct banks.

__host__ __device__ __forceinline__ int bg_pld(int sw) { return 2 * sw; }

// The xor of a lane's chunk index (its fragment rows have g's parity).
__device__ __forceinline__ int bg_swz(int ld, int g) {
    return (ld & 127) == 0 ? (g & 1) << 2 : 0;
}

// bg_load_rows into the xor layout.
__device__ __forceinline__ void bg_load_rows_s(unsigned char* dst,
                                               const __nv_bfloat16* src,
                                               int rows, int dp, int c0,
                                               int w, int ld, int r0, int R,
                                               int tid, int nthr) {
    const int per = w / 8;                  // 16-byte chunks a staged row
    const int sx = (ld & 127) == 0 ? 4 : 0;
    for (int i = tid; i < R * per; i += nthr) {
        const int r = i / per, ch = i % per;
        const int gr = r0 + r, gc = c0 + ch * 8;
        const bool ok = gr < rows && gc < dp;   // dp a multiple of 8
        const __nv_bfloat16* s =
            src + (ok ? (long long)gr * dp + gc : 0LL);
        bg_cp(dst + r * ld + (ch ^ (r & 1 ? sx : 0)) * 16, s, 16,
              ok ? 16 : 0);
    }
}

// bg_chunk on the xor layout (sx: the lane's chunk xor).
template <int MT, int NT>
__device__ __forceinline__ void bg_chunk_s(float (&acc)[MT][NT][4],
                                           const unsigned char* A,
                                           const unsigned char* B, int ld,
                                           int ch, int sx, int g, int t) {
    const int off = ((4 * ch + t) ^ sx) * 16;
    uint4 a[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = bg_lds(A + (16 * mt + g) * ld + off);
        a[mt][1] = bg_lds(A + (16 * mt + g + 8) * ld + off);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = bg_lds(B + (8 * nt + g) * ld + off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            bg_mma(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y,
                   a[mt][1].y, b.x, b.y);
            bg_mma(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w,
                   a[mt][1].w, b.z, b.w);
        }
    }
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

// A tile of a block's walk: batch item, row and column of tiles, and the
// count of rows of tiles the walk has entered (it keys the X slots).
struct BgCursor {
    long long b;
    int I, J, seq;
};

__device__ __forceinline__ BgCursor bg_cursor(long long u, long long per,
                                              int tr, int tc, int sym) {
    BgCursor q;
    q.b = u / per;
    bg_tile_of(u % per, tr, tc, sym, q.I, q.J);
    q.seq = 0;
    return q;
}

// the next tile: along the row of tiles, then the next row (with sym it
// starts on the diagonal), then the next batch item
__device__ __forceinline__ void bg_advance(BgCursor& q, int tr, int tc,
                                           int sym) {
    if (++q.J == (sym ? tr : tc)) {
        ++q.seq;
        if (++q.I == tr) {
            ++q.b;
            q.I = 0;
        }
        q.J = sym ? q.I : 0;
    }
}

// The epilogue of one kermat tile (rows r0.., columns c0.. of batch item
// b).  The transform is applied in registers and staged in T (with sym
// its transpose in Tm), each staged row shifted by s = base % 4 entries,
// base the flat index of the output row's first entry (s = 0 where the
// output is not 16-byte aligned): quad q of a staged row then holds the
// entries whose flat index lies in [base - s + 4 q, base - s + 4 q + 4),
// so the rows leave as 16-byte stores at aligned addresses whatever m is.
// A row's last quad, which it shares with the next tile's first, is not
// stored where the block's next tile is the next one along the row
// (next): its entries wait in `carry` and complete that tile's first quad
// (prev), so no 16-byte span is written in two parts, each partly; only
// at a run's or a row's ends are a quad's entries stored 4 bytes apart.
// xs, ys: the tile's row and column norms.
template <int KIND>
__device__ __forceinline__ void bg_km_store(
    const float (&acc)[1][8][4], float* T, float* Tm, float* carry,
    const float* xs, const float* ys, float* __restrict__ out, long long b,
    int n, int m, int r0, int c0, int sym, int vec, bool prev, bool next,
    float gamma, int degree, float coef0, int tid, int warp, int g, int t) {
    const float c = gamma * 1.4426950408889634f;
    const long long item = b * (long long)n * m;
    // the shift of output row R (columns from C)
    auto shift = [&](int R, int C) {
        return vec ? (int)((item + (long long)R * m + C) & 3) : 0;
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float xr = KIND == KIND_RBF ? xs[r] : 0.0f;
        const int s = shift(r0 + r, c0);
        float* row = T + r * BG_KM_LDT + s;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int col = 8 * nt + 2 * t;
            const float v0 = bg_kval<KIND>(acc[0][nt][2 * h], xr, ys[col], c,
                                           gamma, degree, coef0);
            const float v1 = bg_kval<KIND>(acc[0][nt][2 * h + 1], xr,
                                           ys[col + 1], c, gamma, degree,
                                           coef0);
            if (s & 1) {
                row[col] = v0;
                row[col + 1] = v1;
            } else {
                *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
            }
            if (sym) {
                Tm[col * BG_KM_LDM + r + shift(c0 + col, r0)] = v0;
                Tm[(col + 1) * BG_KM_LDM + r + shift(c0 + col + 1, r0)] = v1;
            }
        }
        // the last tile's carried entries ahead of the row's first
        if (prev && t < s) row[t - s] = carry[4 * r + t];
    }
    __syncthreads();
    const bool diag = sym && r0 == c0, mirror = sym && r0 != c0;
    if (diag) {   // the lower triangle from the upper one: (r, col < r),
                  // row r of Tm carrying row r's shift
        for (int e = tid; e < BG_KM_T * BG_KM_T; e += blockDim.x) {
            const int r = e / BG_KM_T, col = e % BG_KM_T;
            if (col < r) {
                const int p = col + shift(r0 + r, c0);
                T[r * BG_KM_LDT + p] = Tm[r * BG_KM_LDM + p];
            }
        }
        __syncthreads();
    }
    // pass 0: row r of T at (r0 + r, c0..); pass 1, the mirror: row col of
    // Tm at (c0 + col, r0..).  Staged positions [lo, hi) of a row hold
    // entries; its whole quads leave a half warp a row, then its two edge
    // quads a thread each (4-byte stores, or the last into carry)
    for (int pass = 0; pass < (mirror ? 2 : 1); ++pass) {
        const float* S = pass ? Tm : T;
        const int lds = pass ? BG_KM_LDM : BG_KM_LDT;
        const int R0 = pass ? c0 : r0, C0 = pass ? r0 : c0;
        const int rows = min(BG_KM_T, (pass ? m : n) - R0);
        const int cw = min(BG_KM_T, (pass ? n : m) - C0);
        const bool from_prev = prev && !pass, to_next = next && !pass;
        const int q = tid & 15;
        if (vec)
            for (int r = tid >> 4; r < rows; r += blockDim.x / 16) {
                const long long base = item + (long long)(R0 + r) * m + C0;
                const int s = (int)(base & 3);
                const int lo = from_prev ? 0 : s, hi = s + cw;
                if (4 * q >= lo && 4 * q + 4 <= hi)
                    *reinterpret_cast<float4*>(out + (base - s + 4 * q)) =
                        *reinterpret_cast<const float4*>(S + r * lds + 4 * q);
            }
        for (int e = tid; e < 2 * rows; e += blockDim.x) {
            const int r = e >> 1;
            const long long base = item + (long long)(R0 + r) * m + C0;
            const float* src = S + r * lds;
            if (!vec) {   // unaligned output: a thread a row, 4 bytes apart
                if (e & 1)
                    for (int k = 0; k < cw; ++k) out[base + k] = src[k];
                continue;
            }
            const int s = (int)(base & 3);
            const int lo = from_prev ? 0 : s, hi = s + cw;
            // the first quad, or the quad holding the last position
            const int qe = (e & 1) ? (hi - 1) / 4 : 0;
            if ((e & 1) && qe == 0) continue;   // the first quad holds it
            const int a = max(4 * qe, lo), z = min(4 * qe + 4, hi);
            if (a == 4 * qe && z == 4 * qe + 4) continue;   // whole: above
            if ((e & 1) && to_next) {           // waits for the next tile
                for (int k = a; k < z; ++k) carry[4 * r + k - 4 * qe] = src[k];
                continue;
            }
            for (int k = a; k < z; ++k) out[base - s + k] = src[k];
        }
    }
}

// Shared memory of the kermat form at slice width sw: xs X slots and ys Y
// stages of 64 staged rows with their norms, the staged tile, the carried
// entries, and with sym the tile's transpose.
__host__ __device__ __forceinline__ int bg_km_smem(int sw, int xs, int ys,
                                                   int sym) {
    return (xs + ys) * BG_KM_T * (bg_pld(sw) + 4)
           + BG_KM_T * (BG_KM_LDT + 4) * 4
           + (sym ? BG_KM_T * BG_KM_LDM * 4 : 0);
}

template <int KIND, bool WIDE>
__global__ void __launch_bounds__(128, 3)
bg_kermat_kernel(const __nv_bfloat16* __restrict__ X,
                 const float* __restrict__ xn,
                 const __nv_bfloat16* __restrict__ Y,
                 const float* __restrict__ yn, float* __restrict__ out,
                 int batch, int n, int m, int dp, int sym, int vec,
                 int xslots, const unsigned char* __restrict__ skip,
                 float gamma, int degree, float coef0) {
    if (skip != nullptr && *skip) return;   // the one read of the flag
    extern __shared__ __align__(16) unsigned char bg_sm[];
    constexpr int S = WIDE ? 1 : BG_KM_STAGES;
    const int xsl = WIDE ? 1 : xslots;
    const int sw = WIDE ? BG_SLICE : bg_sw(dp);
    const int ld = bg_pld(sw), tile_b = BG_KM_T * ld;
    unsigned char* sx = bg_sm;                     // X slots
    unsigned char* sy = sx + xsl * tile_b;         // Y stages
    float* sxn = (float*)(sy + S * tile_b);        // their norms
    float* syn = sxn + xsl * BG_KM_T;
    float* T = syn + S * BG_KM_T;                  // (64, LDT) the tile
    float* carry = T + BG_KM_T * BG_KM_LDT;        // (64, 4) carried entries
    float* Tm = carry + BG_KM_T * 4;               // (64, LDM) its transpose
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4, swz = bg_swz(ld, g);
    const int tr = (n + BG_KM_T - 1) / BG_KM_T;
    const int tc = (m + BG_KM_T - 1) / BG_KM_T;
    const long long per = sym ? (long long)tr * (tr + 1) / 2
                              : (long long)tr * tc;
    const long long total = per * batch;
    const long long run = (total + gridDim.x - 1) / gridDim.x;
    const long long t0 = blockIdx.x * run;
    const long long count = t0 + run < total ? run : total - t0;
    if (count <= 0) return;

    auto load_x = [&](int slot, const BgCursor& q, int s0, int w) {
        bg_load_rows_s(sx + slot * tile_b, X + q.b * (long long)n * dp, n,
                       dp, s0, w, ld, q.I * BG_KM_T, BG_KM_T, tid, 128);
        if (KIND == KIND_RBF && s0 == 0)
            bg_load_vec(sxn + slot * BG_KM_T, xn + q.b * n, n, q.I * BG_KM_T,
                        BG_KM_T, tid, 0);
    };
    auto load_y = [&](int st, const BgCursor& q, int s0, int w) {
        bg_load_rows_s(sy + st * tile_b, Y + q.b * (long long)m * dp, m, dp,
                       s0, w, ld, q.J * BG_KM_T, BG_KM_T, tid, 128);
        if (KIND == KIND_RBF && s0 == 0)
            bg_load_vec(syn + st * BG_KM_T, yn + q.b * m, m, q.J * BG_KM_T,
                        BG_KM_T, tid, 64);
    };

    BgCursor cc = bg_cursor(t0, per, tr, tc, sym);   // the tile computed
    float acc[1][8][4];
    if constexpr (!WIDE) {
        // a ring of S Y stages: tile k + S - 1 loads while tile k is
        // multiplied and stored; a row of tiles' X rows load with its first
        // tile, into slot seq % xsl (the S tiles in flight span at most S
        // rows of tiles, so no slot in use is overwritten)
        BgCursor ic = cc;                                // the tile issued
        int loaded = -1, ist = 0, cst = 0;
        auto issue = [&]() {
            if (ic.seq != loaded) {
                load_x(ic.seq % xsl, ic, 0, sw);
                loaded = ic.seq;
            }
            load_y(ist, ic, 0, sw);
            ist = ist + 1 == S ? 0 : ist + 1;
            bg_advance(ic, tr, tc, sym);
        };
        for (int s = 0; s < S - 1; ++s) {
            if (s < count) issue();
            bg_commit();
        }
        for (long long k = 0; k < count; ++k) {
            bg_wait<S - 2>();
            __syncthreads();   // tile k landed; tile k - 1 is read and stored
            if (k + S - 1 < count) issue();
            bg_commit();
            const int xs = cc.seq % xsl;
            bg_zero(acc);
            for (int ch = 0; ch < sw / 32; ++ch)
                bg_chunk_s<1, 8>(acc, sx + xs * tile_b + 16 * warp * ld,
                                 sy + cst * tile_b, ld, ch, swz, g, t);
            // the tiles before and after along the row are this block's
            // (non-symmetric walks only: a mirror is written down a column)
            const bool prev = !sym && k > 0 && cc.J > 0;
            const bool next = !sym && k + 1 < count && cc.J + 1 < tc;
            bg_km_store<KIND>(acc, T, Tm, carry, sxn + xs * BG_KM_T,
                              syn + cst * BG_KM_T, out, cc.b, n, m,
                              cc.I * BG_KM_T, cc.J * BG_KM_T, sym, vec, prev,
                              next, gamma, degree, coef0, tid, warp, g, t);
            cst = cst + 1 == S ? 0 : cst + 1;
            bg_advance(cc, tr, tc, sym);
        }
        bg_wait<0>();
    } else {
        // wider rows: each tile stages its X and Y rows a slice at a time
        for (long long k = 0; k < count; ++k) {
            bg_zero(acc);
            for (int s0 = 0; s0 < dp; s0 += BG_SLICE) {
                const int w = bg_sw(dp - s0);
                __syncthreads();   // the last slice is read; T is stored
                load_x(0, cc, s0, w);
                load_y(0, cc, s0, w);
                bg_commit();
                bg_wait<0>();
                __syncthreads();
                for (int ch = 0; ch < w / 32; ++ch)
                    bg_chunk_s<1, 8>(acc, sx + 16 * warp * ld, sy, ld, ch,
                                     swz, g, t);
            }
            bg_km_store<KIND>(acc, T, Tm, carry, sxn, syn, out, cc.b, n, m,
                              cc.I * BG_KM_T, cc.J * BG_KM_T, sym, vec, false,
                              false, gamma, degree, coef0, tid, warp, g, t);
            bg_advance(cc, tr, tc, sym);
        }
    }
}

// ---------------------------------------------------------------- matvec --
//
// Bound by its exps, but the transform around each costs 11 more issue
// slots, and the products (mma.sync, depth 64 at dp 56) about as much
// time again on the tensor pipe; measured (PERF.md, runs X1-X16), the two
// do not overlap on a scheduler, whether a block's warps meet at barriers,
// drift apart in a ring, split the two roles, or run their products half
// an entry ahead, so what is left to remove is everything else.  A
// persistent grid of two blocks of 8 warps an SM walks units of 256 X
// rows (one batch item's), 32 rows a warp.  Z streams through a ring of S
// entries of ZR rows, each one TMA box (rows past m and columns past dp
// zeros) landing at a pitch 64 bytes past a multiple of 128 (bg_ld:
// conflict-free fragment reads), beside its (zn, zn, v, v) column pairs,
// which the issuing warp's lanes copy with cp.async; the entry's "full"
// mbarrier takes both.  Copied by cp.async lanes instead, the rows cost
// the issuing warp some 30 ms at n x n.  There is no block-wide barrier in
// the loop: a warp waits only for the entry it reads and releases it with
// a shared-memory count; the last of the 8 warps to release an entry
// issues the entry S further along the block's walk into its slot.  A
// unit reads Z once for 256 rows (Z, 52 MB at n x n, does not stay in the
// 50 MB L2).  A warp's products are 32 Z rows at a time (a 2 x 4 tile of
// m16n8 fragments, 32 accumulators: 64 spilled at 128 registers), its X
// rows staged in the A-fragment layout (bg_load_frag), so a fragment is
// one 16-byte load in register order.  The one-slice form (dp up to
// BG_MV_DP, one box a row) stages each warp's X rows for a unit and takes
// 64-row entries, two halves each.  The wide form takes 96-column slices,
// an entry a slice of 32 Z rows, summed into the same accumulators in
// column order, then transformed; a unit's X rows are staged whole where
// they fit beside the ring, else each warp streams its rows' slice for
// each entry through its own ring of BG_MV_WS slots (cp.async groups).
#define BG_MV_WARPS 8         // warps a block (two blocks an SM, one wide)
#define BG_MV_WR 32           // X rows a warp
#define BG_MV_SMAX 12         // most entries of the ring
#define BG_MV_DP 224          // widest packed row of the one-slice form
#define BG_MV_WSW 96          // columns a slice of the wide form
#define BG_MV_WS 4            // entries of the wide form's X ring
#define BG_MV_HDR 256         // barrier bytes ahead of the staged rows
#define BG_SM_SMEM 233472     // shared memory of an SM (228 KB)

// An arrival on the barrier once this thread's earlier cp.async copies
// have landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void bg_cp_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// One more release of a ring entry, ordered after this thread's reads of
// it (and, for the last, before its refill): the count before it.
__device__ __forceinline__ unsigned bg_release_count(unsigned* cnt) {
    unsigned old;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "r"(smem_u32(cnt)) : "memory");
    return old;
}

__device__ __forceinline__ void bg_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Staged width of the wide form's slice that starts `left` columns before
// the row's end: a multiple of 32, at most BG_MV_WSW.
__host__ __device__ __forceinline__ int bg_mv_w(int left) {
    const int w = (left + 31) / 32 * 32;
    return w < BG_MV_WSW ? w : BG_MV_WSW;
}

// Z rows an entry of the ring (the one-slice form's, or a slice's).
__host__ __device__ __forceinline__ int bg_mv_zr(bool wide) {
    return wide ? 32 : BG_MV_COLS;
}
// Staged row stride (bytes) and the bytes of one ring entry: its staged
// Z rows and their (zn, zn, v, v) column pairs.
__host__ __device__ __forceinline__ int bg_mv_ld(int dp, bool wide) {
    return bg_ld(wide ? BG_MV_WSW : bg_sw(dp));
}
__host__ __device__ __forceinline__ int bg_mv_entry(int ld, bool wide) {
    return bg_mv_zr(wide) * (ld + 8);
}
// X slots of a warp: one for the one-slice form; the wide form's slices
// of a unit (staged whole) or its ring (xring).
__host__ __device__ __forceinline__ int bg_mv_xslots(int dp, bool wide,
                                                     int xring) {
    return !wide ? 1 : xring ? BG_MV_WS : (dp + BG_MV_WSW - 1) / BG_MV_WSW;
}
// Shared memory of a block with S ring entries: the barriers, the X
// slots, the ring.
__host__ __device__ __forceinline__ int bg_mv_smem(int dp, bool wide,
                                                   int xring, int S) {
    const int ld = bg_mv_ld(dp, wide);
    return BG_MV_HDR
           + bg_mv_xslots(dp, wide, xring) * BG_MV_WARPS * BG_MV_WR * ld
           + S * bg_mv_entry(ld, wide);
}

// Columns [c0, c0 + w) of a warp's 32 rows [r0, r0 + 32) of a packed
// (rows, dp) matrix into the A-fragment layout that bg_chunk_f reads: for
// chunk ch, m16 tile mt, k16 step st and lane (g, t), 16 bytes at
// ((ch * 2 + mt) * 2 + st) * 512 + lane * 16 holding, as 4-byte column
// pairs, rows 16 mt + g and 16 mt + g + 8 at chunk columns 8 t + 4 st,
// then both at 8 t + 4 st + 2: the registers {a0, a1, a2, a3} of the
// step, so a fragment is one 16-byte load, in order.  4-byte cp.async
// copies by the warp's lanes; zero past `rows` and dp.
__device__ __forceinline__ void bg_load_frag(unsigned char* dst,
                                             const __nv_bfloat16* src,
                                             int rows, int dp, int c0, int w,
                                             int r0, int lane) {
    const int pieces = w / 32 * 512;                // 4-byte pieces
    for (int i = lane; i < pieces; i += 32) {
        const int q = i & 3, l = (i >> 2) & 31, grp = i >> 7;
        const int st = grp & 1, mt = (grp >> 1) & 1, ch = grp >> 2;
        const int r = r0 + 16 * mt + (l >> 2) + 8 * (q & 1);
        const int col = c0 + 32 * ch + 8 * (l & 3) + 4 * st + 2 * (q >> 1);
        const bool ok = r < rows && col < dp;       // dp a multiple of 8
        bg_cp(dst + 4 * i, src + (ok ? (long long)r * dp + col : 0LL), 4,
              ok ? 4 : 0);
    }
}

// bg_chunk_s<2, NT> with A in bg_load_frag's layout and B at a padded
// pitch (bg_ld, no swizzle): the same products in the same order, each A
// fragment one 16-byte load into its registers.
template <int NT>
__device__ __forceinline__ void bg_chunk_f(float (&acc)[2][NT][4],
                                           const unsigned char* Af,
                                           const unsigned char* B, int ld,
                                           int ch, int g, int t, int lane) {
    uint4 a[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int st = 0; st < 2; ++st)
            a[mt][st] = bg_lds(Af + ((ch * 2 + mt) * 2 + st) * 512
                               + lane * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = bg_lds(B + (8 * nt + g) * ld + ch * 64 + t * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            bg_mma(acc[mt][nt], a[mt][0].x, a[mt][0].y, a[mt][0].z,
                   a[mt][0].w, b.x, b.y);
            bg_mma(acc[mt][nt], a[mt][1].x, a[mt][1].y, a[mt][1].z,
                   a[mt][1].w, b.z, b.w);
        }
    }
}

// 32 of the products' columns (acc, a 2 x 4 tile of m16n8 fragments)
// transformed, times their weights (bp: the (zn, zn, v, v) pairs), into
// each row's sum, the columns in order.
template <int KIND>
__device__ __forceinline__ void bg_mv_fold(const float (&acc)[2][4][4],
                                           float (&part)[2][2],
                                           const float (&xr)[2][2],
                                           const float4* bp, float c,
                                           float gamma, int degree,
                                           float coef0, int t) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const float4 p = bp[4 * nt + t];            // columns 8 nt + 2 t, + 1
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    part[mt][h] = fmaf(
                        bg_kval<KIND>(acc[mt][nt][2 * h + e], xr[mt][h],
                                      e ? p.y : p.x, c, gamma, degree, coef0),
                        e ? p.w : p.z, part[mt][h]);
    }
}

template <int KIND, bool WIDE>
__global__ void __launch_bounds__(BG_MV_WARPS * 32, WIDE ? 1 : 2)
bg_matvec_kernel(const __grid_constant__ CUtensorMap tz,
                 const __nv_bfloat16* __restrict__ X,
                 const float* __restrict__ xn, const float* __restrict__ zn,
                 const float* __restrict__ v, float* __restrict__ out,
                 int batch, int n, int m, int dp, int stages, int xring,
                 float gamma, int degree, float coef0) {
    extern __shared__ __align__(128) unsigned char bg_mv_sm[];
    constexpr int W = BG_MV_WARPS, R = W * BG_MV_WR;  // X rows a unit
    constexpr int ZR = WIDE ? 32 : BG_MV_COLS;        // bg_mv_zr
    const int S = stages;
    const int sw = WIDE ? BG_MV_WSW : bg_sw(dp);
    const int ld = bg_ld(sw), entry = ZR * (ld + 8);
    const int nsl = WIDE ? (dp + BG_MV_WSW - 1) / BG_MV_WSW : 1;
    const bool xstream = WIDE && xring;
    uint64_t* full = reinterpret_cast<uint64_t*>(bg_mv_sm);
    unsigned* freed = reinterpret_cast<unsigned*>(full + BG_MV_SMAX);
    // in the header's spare bytes: each slot's fills and its entry's place
    // in the walk; the entries this warp has read
    BG_CK(static_assert(BG_MV_SMAX * 20 <= BG_MV_HDR, "header");
          unsigned* fills = freed + BG_MV_SMAX;
          unsigned* tags = fills + BG_MV_SMAX;
          unsigned seen = 0;)
    unsigned char* sx = bg_mv_sm + BG_MV_HDR;
    unsigned char* ring =
        sx + (!WIDE ? 1 : xstream ? BG_MV_WS : nsl) * W * BG_MV_WR * ld;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rt = (n + R - 1) / R;                 // units a batch item
    const int units = batch * rt;
    const int tiles = (m + ZR - 1) / ZR;            // entries a slice
    const int U = (int)blockIdx.x < units
        ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const float c = gamma * 1.4426950408889634f;
    // a warp's X slot x (slice x, or the X ring's slot x)
    auto xslot = [&](int x) { return sx + (x * W + warp) * BG_MV_WR * ld; };

    // Ring entry (i, j, s) of the block's walk (its unit i, Z rows [ZR j,
    // ZR j + ZR), slice s) into slot `slot`, by the calling warp; the
    // column pairs ride with the last slice.  full[slot] completes on 33
    // arrivals (lane 0's expect_tx, then each lane's cp.async) and the
    // box's bytes.
    auto issue = [&](int i, int j, int s, int slot) {
        const int u = blockIdx.x + i * gridDim.x;
        const long long b = u / rt;
        unsigned char* dst = ring + slot * entry;
        const int z0 = j * ZR, s0 = s * sw;
        BG_CK(if (lane == 0) {
                  atomicAdd(&fills[slot], 1u);
                  tags[slot] = (unsigned)((i * tiles + j) * nsl + s);
              })
        // the rows: one TMA box of ld / 2 columns (past dp and m zeros),
        // so the rows land at the padded pitch ld
        if (lane == 0) {
            mbar_expect_tx(&full[slot], ZR * ld);
            tma_load_3d(dst, &tz, &full[slot], s0, z0, (int)b);
        }
        if (s == nsl - 1) {
            float* pr = reinterpret_cast<float*>(dst + ZR * ld);
#pragma unroll
            for (int e = lane; e < 2 * ZR; e += 32) {
                const int col = e % ZR, isv = e / ZR;
                const int gc = z0 + col;
                const bool ok = gc < m && (isv || KIND == KIND_RBF);
                bg_cp(pr + 4 * (col / 2) + 2 * isv + (col & 1),
                      (isv ? v : zn) + b * m + (gc < m ? gc : 0), 4,
                      ok ? 4 : 0);
            }
        }
        bg_cp_arrive(&full[slot]);
    };
    // slice s of this warp's X rows of unit i into X slot x
    auto stage_x = [&](int i, int s, int x) {
        const int u = blockIdx.x + i * gridDim.x;
        const long long b = u / rt;
        const int s0 = s * sw;
        bg_load_frag(xslot(x), X + b * n * dp, n, dp, s0,
                     WIDE ? bg_mv_w(dp - s0) : sw,
                     (u % rt) * R + warp * BG_MV_WR, lane);
    };
    // the cursor of the entry S further along the walk than this warp's
    int ii = 0, ij = 0, is = 0;
    auto advance = [&]() {
        if (++is == nsl) {
            is = 0;
            if (++ij == tiles) {
                ij = 0;
                ++ii;
            }
        }
    };
    // the entry this warp reads: its slot and the parity of its use
    int slot = 0;
    uint32_t phase = 0;
    auto next = [&]() {
        if (++slot == S) {
            slot = 0;
            phase ^= 1u;
        }
    };
    // the entry in `slot` is the walk's entry `seen` (its tag, read anew)
    BG_CK(auto tag_check = [&](unsigned check) {
              const unsigned got =
                  reinterpret_cast<volatile unsigned*>(tags)[slot];
              if (lane == 0 && got != seen)
                  bg_ring_fault(check, slot, seen, got);
          };)
    // Done with the entry in `slot`: the last warp to release it issues
    // the cursor's entry into it (and, streaming X, each warp its slice).
    auto release = [&]() {
        __syncwarp();
        // still the entry the warp read: a refill begun while a warp
        // reads the entry has written its tag by now
        BG_CK(tag_check(4);)
        unsigned last = 0;
        if (lane == 0)
            last = (bg_release_count(&freed[slot]) & (W - 1)) == W - 1;
        last = __shfl_sync(0xffffffffu, last, 0);
        __syncwarp();   // every lane's refill after lane 0's acquire
        if (ii < U) {
            if (last) issue(ii, ij, is, slot);
            if (xstream) stage_x(ii, is, slot);
        }
        if (xstream) bg_commit();
        advance();
        next();
        BG_CK(++seen;)
    };

    if (tid == 0) {
        for (int k = 0; k < S; ++k) {
            mbar_init(&full[k], 33);
            freed[k] = 0;
            BG_CK(fills[k] = 0; tags[k] = ~0u;)
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();   // the only block-wide barrier: the barriers are set
    if (tiles > 0)
        for (int k = 0; k < S; ++k) {
            if (ii < U) {
                if (warp == 0) issue(ii, ij, is, k);
                if (xstream) stage_x(ii, is, k);
            }
            if (xstream) bg_commit();
            advance();
        }

    for (int i = 0; i < U; ++i) {
        const int u = blockIdx.x + i * gridDim.x;
        const long long b = u / rt;
        const int r0 = (u % rt) * R + warp * BG_MV_WR;
        const bool live = r0 < n;                   // the warp has rows
        float xr[2][2], part[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 16 * mt + 8 * h + g;
                xr[mt][h] = (KIND == KIND_RBF && r < n) ? xn[b * n + r] : 0.0f;
                part[mt][h] = 0.0f;
            }
        if (!xstream && live) {   // the warp's rows, staged for the unit
            __syncwarp();         // the last unit's rows are read
            for (int s = 0; s < nsl; ++s) stage_x(i, s, s);
            bg_wait_all();
            __syncwarp();
        }
        // the products of 32 of the entry's Z rows (from row z) into acc;
        // their transform, times the weights, into part
        auto products = [&](float (&acc)[2][4][4], const unsigned char* A,
                            int w, int z) {
            const unsigned char* B = ring + slot * entry + z * ld;
            for (int ch = 0; ch < w / 32; ++ch)
                bg_chunk_f<4>(acc, A, B, ld, ch, g, t, lane);
        };
        auto fold = [&](const float (&acc)[2][4][4], int sl, int z) {
            bg_mv_fold<KIND>(acc, part, xr,
                             reinterpret_cast<const float4*>(
                                 ring + sl * entry + ZR * ld) + z / 2,
                             c, gamma, degree, coef0, t);
        };
        if constexpr (!WIDE) {
            const unsigned char* A = xslot(0);
            for (int j = 0; j < tiles; ++j) {
                mbar_wait(&full[slot], phase);
                BG_CK(tag_check(1);)
                if (live)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        float acc[2][4][4];
                        bg_zero(acc);
                        products(acc, A, sw, 32 * hf);
                        fold(acc, slot, 32 * hf);
                    }
                release();
            }
        } else {
            for (int j = 0; j < tiles; ++j) {
                float acc[2][4][4];
                if (live) bg_zero(acc);
                for (int s = 0; s < nsl; ++s) {
                    if (xstream) {   // this warp's slice of X has landed
                        bg_wait<BG_MV_WS - 1>();
                        __syncwarp();
                    }
                    mbar_wait(&full[slot], phase);
                    BG_CK(tag_check(1);)
                    if (live) {
                        products(acc, xslot(xstream ? slot : s),
                                 bg_mv_w(dp - s * sw), 0);
                        if (s == nsl - 1) fold(acc, slot, 0);
                    }
                    release();
                }
            }
        }
        if (live) {
            // the unit's rows again: recomputed here rather than kept in
            // registers through the entry loop (they spilled at 128)
            int iv;
            asm volatile("mov.b32 %0, %1;\n" : "=r"(iv) : "r"(i));
            const int uu = blockIdx.x + iv * gridDim.x;
            float* o = out + (long long)(uu / rt) * n;
            const int rr = (uu % rt) * R + warp * BG_MV_WR + g;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float sum = part[mt][h];
                    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
                    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
                    const int r = rr + 16 * mt + 8 * h;
                    if (t == 0 && r < n) o[r] = sum;
                }
        }
    }
    bg_wait_all();
    BG_CK({
        const unsigned total = tiles > 0 ? (unsigned)(U * tiles * nsl) : 0u;
        if (lane == 0 && seen != total) bg_ring_fault(3, 0, total, seen);
        __syncthreads();
        if (tid == 0) {
            for (int k = 0; k < S; ++k) {
                const unsigned e =
                    total > (unsigned)k ? (total - 1 - k) / S + 1 : 0u;
                if (fills[k] != e) bg_ring_fault(2, k, e, fills[k]);
                if (freed[k] != W * e) bg_ring_fault(2, k, W * e, freed[k]);
            }
            bg_ring_checked();
        }
    })
}

// ------------------------------------------------------------- cd_update --

// Staged width of a slice of cd_update's slice form (at most BG_CD_SLICE).
__host__ __device__ __forceinline__ int bg_cd_sw(int left) {
    const int w = (left + 31) / 32 * 32;
    return w < BG_CD_SLICE ? w : BG_CD_SLICE;
}

// Shared memory of the pipelined cd_update form: `res` resident chunks of
// block rows (staged rows, norms, weights) and each warp's ring of
// BG_CD_WS tiles of BG_CD_WR X rows (staged rows, norms, signs).
__host__ __device__ __forceinline__ int bg_cd_smem(int sw, int res) {
    return (res * BG_CD_CW + BG_CD_WARPS * BG_CD_WS * BG_CD_WR)
           * (bg_pld(sw) + 8);
}
// the slice form: a slice of a block's X tile and of one chunk, as above
__host__ __device__ __forceinline__ int bg_cd_wide_smem() {
    return (BG_CD_CW + BG_CD_WARPS * BG_CD_WR) * (bg_pld(BG_CD_SLICE) + 8);
}

// A warp's 16 rows against one 64-row chunk of block rows: the transform
// of the products (acc) times the chunk's weights, into rs.  xr: the rows'
// norms; bp: (zn, zn, w, w) of the chunk's column pairs.
template <int KIND>
__device__ __forceinline__ void bg_cd_fold(const float (&acc)[1][8][4],
                                           float (&rs)[2],
                                           const float (&xr)[2],
                                           const float4* bp, float c,
                                           float gamma, int degree,
                                           float coef0, int t) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const float4 p = bp[4 * nt + t];   // columns 8 nt + 2 t, + 1
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                rs[h] = fmaf(bg_kval<KIND>(acc[0][nt][2 * h + e], xr[h],
                                           e ? p.y : p.x, c, gamma, degree,
                                           coef0),
                             e ? p.w : p.z, rs[h]);
    }
}

template <int KIND, bool WIDE>
__global__ void __launch_bounds__(BG_CD_WARPS * 32, 2)
bg_cd_kernel(const __nv_bfloat16* __restrict__ X,
             const float* __restrict__ xn, const float* __restrict__ y,
             const __nv_bfloat16* __restrict__ Xb,
             const float* __restrict__ bn, const float* __restrict__ w,
             float* __restrict__ out, int n, int B, int dp, int res,
             float gamma, int degree, float coef0) {
    extern __shared__ __align__(16) unsigned char bg_sm[];
    constexpr int NT = BG_CD_WARPS * 32, TR = BG_CD_WR;
    const int sw = WIDE ? BG_CD_SLICE : bg_sw(dp);
    const int ld = bg_pld(sw);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4, swz = bg_swz(ld, g);
    const float c = gamma * 1.4426950408889634f;
    const int nch = (B + BG_CD_CW - 1) / BG_CD_CW;
    // the block rows (res chunks, one in the slice form), then (zn, zn, w,
    // w) of their column pairs: their norms and weights
    unsigned char* sb = bg_sm;
    const int rows_b = (WIDE ? 1 : res) * BG_CD_CW;
    float4* sbp = (float4*)(sb + rows_b * ld);
    unsigned char* ring = (unsigned char*)(sbp + rows_b / 2);

    // chunks [ch0, ch0 + cnt) of the block rows, slice [s0, s0 + w_), with
    // their column terms (zero past B; visible after the caller's barrier)
    auto load_b = [&](int ch0, int cnt, int s0, int w_) {
        bg_load_rows_s(sb, Xb, B, dp, s0, w_, ld, ch0 * BG_CD_CW,
                       cnt * BG_CD_CW, tid, NT);
        if (s0 == 0)
            for (int i = tid; i < cnt * BG_CD_CW / 2; i += NT) {
                const int col = ch0 * BG_CD_CW + 2 * i;
                float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (col + e < B) {
                        v[e] = KIND == KIND_RBF ? bn[col + e] : 0.0f;
                        v[2 + e] = w[col + e];
                    }
                sbp[i] = make_float4(v[0], v[1], v[2], v[3]);
            }
    };
    // a row's sum, written once: out = y * sum (with passes, the partial
    // sums of the earlier passes wait in out, written and read by the same
    // lane)
    auto finish = [&](float (&rs)[2], int r, const float* ys, int lim,
                      int pass, int npass) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float s = rs[h];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            const int rr = r + g + 8 * h;
            if (t == 0 && rr < lim) {
                if (pass > 0) s = out[rr] + s;
                out[rr] = pass + 1 == npass ? ys[g + 8 * h] * s : s;
            }
        }
    };

    float acc[1][8][4];
    if constexpr (!WIDE) {
        // each warp streams its own share of the rows, tiles of TR rows
        // through its own ring of BG_CD_WS cp.async stages (tile it +
        // WS - 1 loading while tile it is multiplied and summed), with no
        // block-wide barrier; the block rows stay resident (a pass of up
        // to res chunks at a time, all warps taking the same count of
        // tiles so that they meet at a pass's end)
        constexpr int WS = BG_CD_WS;
        const int warps = gridDim.x * BG_CD_WARPS;
        const int share = (n + warps - 1) / warps;
        const int wr0 = min(n, (blockIdx.x * BG_CD_WARPS + warp) * share);
        const int wr1 = min(n, wr0 + share);
        const int mine = (share + TR - 1) / TR;
        const int stage_b = TR * ld;
        unsigned char* wring = ring + warp * WS * (stage_b + 8 * TR);
        float* wxn = (float*)(wring + WS * stage_b);   // WS x TR norms
        float* wy = wxn + WS * TR;                      // WS x TR signs
        const int npass = (nch + res - 1) / res;
        const int total = npass * mine;
        auto load_x = [&](int st, int k) {
            const int r0 = wr0 + k * TR;
            bg_load_rows_s(wring + st * stage_b, X, wr1, dp, 0, sw, ld, r0,
                           TR, lane, 32);
            if (KIND == KIND_RBF)
                bg_load_vec(wxn + st * TR, xn, wr1, r0, TR, lane, 0);
            bg_load_vec(wy + st * TR, y, wr1, r0, TR, lane, TR);
        };
        load_b(0, min(res, nch), 0, sw);
        bg_commit();
        bg_wait<0>();
        __syncthreads();
        for (int s = 0; s < WS - 1; ++s) {
            if (s < total) load_x(s, s % mine);
            bg_commit();
        }
        for (int it = 0; it < total; ++it) {
            const int pass = it / mine, k = it % mine;
            if (it > 0 && k == 0) {   // the next chunks of the block rows
                __syncthreads();      // every warp is done with the last
                load_b(pass * res, min(res, nch - pass * res), 0, sw);
                bg_commit();
                bg_wait<0>();
                __syncthreads();
            } else {
                bg_wait<WS - 2>();
            }
            __syncwarp();   // tile it has landed; tile it - 1 is read
            const int nx_it = it + WS - 1;
            if (nx_it < total) load_x(nx_it % WS, nx_it % mine);
            bg_commit();

            const int st = it % WS;
            float xr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int h = 0; h < 2; ++h)
                xr[h] = KIND == KIND_RBF ? wxn[st * TR + g + 8 * h] : 0.0f;
            const int cnt = min(res, nch - pass * res);
            for (int cl = 0; cl < cnt; ++cl) {
                bg_zero(acc);
                for (int ch = 0; ch < sw / 32; ++ch)
                    bg_chunk_s<1, 8>(acc, wring + st * stage_b,
                                     sb + cl * BG_CD_CW * ld, ld, ch, swz, g,
                                     t);
                bg_cd_fold<KIND>(acc, rs, xr, sbp + cl * BG_CD_CW / 2, c,
                                 gamma, degree, coef0, t);
            }
            finish(rs, wr0 + k * TR, wy + st * TR, wr1, pass, npass);
        }
        bg_wait<0>();
    } else {
        // wider rows: the block takes tiles of WARPS x TR rows; for each
        // tile and chunk, the X tile and the chunk are staged a slice at a
        // time
        constexpr int TM = BG_CD_WARPS * TR;
        float* rxn = (float*)(ring + TM * ld);
        float* ry = rxn + TM;
        const int ntiles = (n + TM - 1) / TM;
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
            const int r0 = tile * TM;
            float xr[2], rs[2] = {0.0f, 0.0f};
            for (int ch = 0; ch < nch; ++ch) {
                bg_zero(acc);
                for (int s0 = 0; s0 < dp; s0 += BG_CD_SLICE) {
                    const int w_ = bg_cd_sw(dp - s0);
                    __syncthreads();   // the last slice is read
                    load_b(ch, 1, s0, w_);
                    bg_load_rows_s(ring, X, n, dp, s0, w_, ld, r0, TM, tid,
                                   NT);
                    if (s0 == 0) {
                        if (KIND == KIND_RBF)
                            bg_load_vec(rxn, xn, n, r0, TM, tid, 0);
                        bg_load_vec(ry, y, n, r0, TM, tid, TM);
                    }
                    bg_commit();
                    bg_wait<0>();
                    __syncthreads();
                    for (int q = 0; q < w_ / 32; ++q)
                        bg_chunk_s<1, 8>(acc, ring + TR * warp * ld, sb, ld,
                                         q, swz, g, t);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    xr[h] = KIND == KIND_RBF ? rxn[TR * warp + g + 8 * h]
                                             : 0.0f;
                bg_cd_fold<KIND>(acc, rs, xr, sbp, c, gamma, degree, coef0,
                                 t);
            }
            finish(rs, r0 + TR * warp, ry + TR * warp, n, 0, 1);
        }
    }
}

// ----------------------------------------------------------- entry points --

static bool bg_dp_ok(int dp) { return dp >= 8 && dp % 8 == 0; }

#ifdef BG_RING_CHECK
// The matvec's ring entries forced down to this many (>= 2; 0: as sized;
// the X-streamed form keeps its BG_MV_WS), and the last matvec launch's
// grid, ring entries, X ring flag and blocks an SM.
static int bg_ring_stages = 0;
static long long bg_ring_geom[4];

// After a device sync: the check's words into out[0..3], the last matvec
// launch's geometry into out[4..7]; reset clears the words; stages forces
// the matvec ring's entries from the next launch on.
extern "C" int rt_bg_ring_check(unsigned long long* out, int reset,
                                int stages) {
    bg_ring_stages = stages;
    int err = (int)cudaDeviceSynchronize();
    if (!err)
        err = (int)cudaMemcpyFromSymbol(out, bg_ring_state,
                                        sizeof(bg_ring_state));
    for (int k = 0; k < 4; ++k) out[4 + k] = (unsigned long long)bg_ring_geom[k];
    if (!err && reset) {
        const unsigned long long zero[4] = {0, 0, 0, 0};
        err = (int)cudaMemcpyToSymbol(bg_ring_state, zero, sizeof(zero));
    }
    return err;
}
#endif

// Each device's own (common.cuh): its SM count, and below the occupancy
// table; the callers' attribute flags are arrays over devices too.
static int bg_sms[RT_MAX_DEVICES];

// Once a kernel instantiation and device (the caller keeps the flags, one a
// device): allow it the shared memory of the widest slice it stages.  The
// current device's ordinal into *dev.
template <typename K>
static int bg_smem_attr(K kernel, int smem_max, bool* done, int* dev) {
    int err = rt_device(dev);
    if (err || done[*dev]) return err;
    if (bg_sms[*dev] == 0) {
        err = (int)cudaDeviceGetAttribute(
            &bg_sms[*dev], cudaDevAttrMultiProcessorCount, *dev);
        if (err) return err;
    }
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    done[*dev] = err == 0;
    return err;
}

// Blocks an SM of device dev holds of `kernel` at `smem` bytes (256 or 128
// threads), asked once a (kernel, size): a persistent grid is this many
// blocks an SM.
static const void* bg_occ_fn[RT_MAX_DEVICES][32];
static int bg_occ_smem[RT_MAX_DEVICES][32], bg_occ_val[RT_MAX_DEVICES][32],
    bg_occ_len[RT_MAX_DEVICES];
template <typename K>
static int bg_occupancy(int dev, K kernel, int threads, int smem, int* occ) {
    const void* fn = (const void*)kernel;
    const void** fns = bg_occ_fn[dev];
    int* smems = bg_occ_smem[dev];
    int* vals = bg_occ_val[dev];
    int& len = bg_occ_len[dev];
    for (int i = 0; i < len; ++i)
        if (fns[i] == fn && smems[i] == smem) {
            *occ = vals[i];
            return 0;
        }
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kernel, threads, smem);
    if (err) return err;
    if (*occ < 1) *occ = 1;
    if (len < 32) {
        fns[len] = fn;
        smems[len] = smem;
        vals[len++] = *occ;
    }
    return 0;
}

extern "C" int rt_bf16_pack(const float* X, long long rows, int d, int dp,
                            void* out, float* norms, cudaStream_t stream) {
    if (d < 1 || !bg_dp_ok(dp) || dp < d) return BG_REFUSED;
    if (rows == 0) return 0;
    // rows a block: 256, or as many as 48 KB of staged rows hold; one,
    // read back from the output, where a staged row would not fit
    const long long row_b = ((long long)(dp / 8) | 1) * 16;
    const int staged = row_b <= 48 * 1024;
    const int R = staged ? (int)(48 * 1024 / row_b < 256 ? 48 * 1024 / row_b
                                                          : 256)
                         : 1;
    const int smem = staged ? (int)(R * row_b) : 0;
    const long long blocks = (rows + R - 1) / R;
    if (blocks >= (1LL << 31)) return BG_REFUSED;
    const int vec = ((uintptr_t)X & 15) == 0;
    bg_pack_kernel<<<(unsigned)blocks, 256, smem, stream>>>(
        X, rows, d, dp, R, staged, vec, (__nv_bfloat16*)out, norms);
    return (int)cudaGetLastError();
}

template <int KIND>
static int bg_kermat_launch(const void* X, const float* xn, const void* Y,
                            const float* yn, float* out, int batch, int n,
                            int m, int dp, int sym, const unsigned char* skip,
                            float gamma, int degree, float coef0,
                            cudaStream_t stream) {
    static bool attr[2][RT_MAX_DEVICES];
    const long long tr = (n + BG_KM_T - 1) / BG_KM_T;
    const long long tc = (m + BG_KM_T - 1) / BG_KM_T;
    // one X slot where the launch has one row of tiles (the row form)
    const int xslots = batch == 1 && tr == 1 ? 1 : BG_KM_STAGES;
    const bool wide = dp > BG_SLICE
        || bg_km_smem(bg_sw(dp), xslots, BG_KM_STAGES, sym) > BG_SMEM_MAX;
    auto kernel = wide ? bg_kermat_kernel<KIND, true>
                       : bg_kermat_kernel<KIND, false>;
    const int smem = wide ? bg_km_smem(BG_SLICE, 1, 1, sym)
                          : bg_km_smem(bg_sw(dp), xslots, BG_KM_STAGES, sym);
    int dev;
    int err = bg_smem_attr(kernel, BG_SMEM_MAX, attr[wide], &dev);
    if (err) return err;
    int occ;
    if ((err = bg_occupancy(dev, kernel, 128, smem, &occ))) return err;
    const long long tiles = (sym ? tr * (tr + 1) / 2 : tr * tc) * batch;
    const long long slots = (long long)occ * bg_sms[dev];
    const int grid = (int)(tiles < slots ? tiles : slots);
    const int vec = ((uintptr_t)out & 15) == 0;
    kernel<<<grid, 128, smem, stream>>>(
        (const __nv_bfloat16*)X, xn, (const __nv_bfloat16*)Y, yn, out, batch,
        n, m, dp, sym, vec, xslots, skip, gamma, degree, coef0);
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

template <int KIND>
static int bg_mv_launch(const void* X, const float* xn, const void* Z,
                        const float* zn, const float* v, float* out,
                        int batch, int n, int m, int dp, float gamma,
                        int degree, float coef0, cudaStream_t stream) {
    static bool attr[2][RT_MAX_DEVICES];
    const bool wide = dp > BG_MV_DP;
    auto kernel = wide ? bg_matvec_kernel<KIND, true>
                       : bg_matvec_kernel<KIND, false>;
    int dev;
    int err = bg_smem_attr(kernel, BG_SMEM_MAX, attr[wide], &dev);
    if (err) return err;
    // as many ring entries as fit beside the X slots (at most BG_MV_SMAX);
    // the wide form stages a unit's X rows whole where that leaves room
    // for BG_MV_WS entries, else streams them (xring, BG_MV_WS entries)
    const int ld = bg_mv_ld(dp, wide), e = bg_mv_entry(ld, wide);
    auto fit = [&](int xring, int room) {
        const int s = (room - bg_mv_smem(dp, wide, xring, 0)) / e;
        return s < BG_MV_SMAX ? s : BG_MV_SMAX;
    };
    const int two = BG_SM_SMEM / 2 - 1024;   // two blocks an SM
    int S = fit(0, two), xring = 0;
    if (S < (wide ? BG_MV_WS : 2))            // one block an SM
        S = fit(0, BG_SMEM_MAX);
    if (wide && S < BG_MV_WS) {               // X streamed under the ring
        xring = 1;
        S = BG_MV_WS;
    }
    BG_CK(if (bg_ring_stages >= 2 && !xring && S > bg_ring_stages)
              S = bg_ring_stages;)
    if (S < 2 || bg_mv_smem(dp, wide, xring, S) > BG_SMEM_MAX)
        return BG_REFUSED;
    // Z's rows through TMA: a (dp, m, batch) bf16 map, a box of ld / 2
    // columns (the row and its padding to the pitch, past dp zeros) x one
    // entry's rows; rows past m read as zeros
    CUtensorMap tz;
    memset(&tz, 0, sizeof(tz));
    if (m > 0) {
        EncodeTiled fn = encode_tiled();
        if (fn == nullptr) return (int)cudaErrorNotSupported;
        const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)m,
                                    (cuuint64_t)batch};
        const cuuint64_t strides[2] = {(cuuint64_t)dp * 2,
                                       (cuuint64_t)m * dp * 2};
        const cuuint32_t box[3] = {(cuuint32_t)(ld / 2),
                                   (cuuint32_t)bg_mv_zr(wide), 1};
        const cuuint32_t unit[3] = {1, 1, 1};
        const CUresult r = fn(&tz, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                              const_cast<void*>(Z), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return BG_REFUSED;
    }
    const int smem = bg_mv_smem(dp, wide, xring, S);
    const int threads = BG_MV_WARPS * 32;
    int occ;
    if ((err = bg_occupancy(dev, kernel, threads, smem, &occ))) return err;
    const int R = BG_MV_WARPS * BG_MV_WR;
    const long long units = (long long)batch * ((n + R - 1) / R);
    if (units > 2147483647LL) return BG_REFUSED;
    const long long slots = (long long)occ * bg_sms[dev];
    const int grid = (int)(units < slots ? units : slots);
    BG_CK(bg_ring_geom[0] = grid; bg_ring_geom[1] = S;
          bg_ring_geom[2] = xring; bg_ring_geom[3] = occ;)
    kernel<<<grid, threads, smem, stream>>>(
        tz, (const __nv_bfloat16*)X, xn, zn, v, out, batch, n, m, dp, S,
        xring, gamma, degree, coef0);
    return (int)cudaGetLastError();
}

extern "C" int rt_kernel_matvec_bf16(const void* X, const float* xn,
                                     const void* Z, const float* zn,
                                     const float* v, float* out, int batch,
                                     int n, int m, int dp, int kind,
                                     float gamma, int degree, float coef0,
                                     cudaStream_t stream) {
    if (!bg_dp_ok(dp)) return BG_REFUSED;
    if (batch == 0 || n == 0) return 0;
    switch (kind) {
        case KIND_LINEAR:
            return bg_mv_launch<KIND_LINEAR>(X, xn, Z, zn, v, out, batch, n,
                                             m, dp, gamma, degree, coef0,
                                             stream);
        case KIND_POLY:
            return bg_mv_launch<KIND_POLY>(X, xn, Z, zn, v, out, batch, n, m,
                                           dp, gamma, degree, coef0, stream);
        case KIND_RBF:
            return bg_mv_launch<KIND_RBF>(X, xn, Z, zn, v, out, batch, n, m,
                                          dp, gamma, degree, coef0, stream);
    }
    return BG_REFUSED;
}

template <int KIND>
static int bg_cd_launch(const void* X, const float* xn, const float* y,
                        const void* Xb, const float* bn, const float* w,
                        float* out, int n, int B, int dp, float gamma,
                        int degree, float coef0, cudaStream_t stream) {
    static bool attr[2][RT_MAX_DEVICES];
    const bool wide = dp > BG_PIPE_DP;
    auto kernel = wide ? bg_cd_kernel<KIND, true> : bg_cd_kernel<KIND, false>;
    int dev;
    int err = bg_smem_attr(kernel, BG_SMEM_MAX, attr[wide], &dev);
    if (err) return err;
    // as many resident chunks as fit beside the warps' rings
    const int nch = (B + BG_CD_CW - 1) / BG_CD_CW;
    int res = 1, smem = bg_cd_wide_smem();
    if (!wide) {
        const int sw = bg_sw(dp);
        while (res < nch && bg_cd_smem(sw, res + 1) <= BG_SMEM_MAX) ++res;
        smem = bg_cd_smem(sw, res);
        if (smem > BG_SMEM_MAX) return BG_REFUSED;
    }
    int occ;
    const int threads = BG_CD_WARPS * 32;
    if ((err = bg_occupancy(dev, kernel, threads, smem, &occ))) return err;
    const int rows_a_block = BG_CD_WARPS * BG_CD_WR;
    const int tiles = (n + rows_a_block - 1) / rows_a_block;
    const int sms = bg_sms[dev];
    const int grid = tiles < occ * sms ? tiles : occ * sms;
    kernel<<<grid, threads, smem, stream>>>(
        (const __nv_bfloat16*)X, xn, y, (const __nv_bfloat16*)Xb, bn, w, out,
        n, B, dp, res, gamma, degree, coef0);
    return (int)cudaGetLastError();
}

extern "C" int rt_cd_update_bf16(const void* X, const float* xn,
                                 const float* y, const void* Xb,
                                 const float* bn, const float* w, float* out,
                                 int n, int B, int dp, int kind, float gamma,
                                 int degree, float coef0,
                                 cudaStream_t stream) {
    if (!bg_dp_ok(dp) || B < 0) return BG_REFUSED;
    if (n == 0) return 0;
    if (B == 0)   // no columns: no update
        return (int)cudaMemsetAsync(out, 0, (size_t)n * sizeof(float), stream);
    switch (kind) {
        case KIND_LINEAR:
            return bg_cd_launch<KIND_LINEAR>(X, xn, y, Xb, bn, w, out, n, B,
                                             dp, gamma, degree, coef0, stream);
        case KIND_POLY:
            return bg_cd_launch<KIND_POLY>(X, xn, y, Xb, bn, w, out, n, B, dp,
                                           gamma, degree, coef0, stream);
        case KIND_RBF:
            return bg_cd_launch<KIND_RBF>(X, xn, y, Xb, bn, w, out, n, B, dp,
                                          gamma, degree, coef0, stream);
    }
    return BG_REFUSED;
}
