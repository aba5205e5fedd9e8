// The split-TF32 tile routines shared by cd_update.cu and kermatvec.cu.
//
// Both kernels contract an RBF (or linear, poly) Gram tile with a weight
// vector, at a product depth d of a few dozen.  The Gram entries x.z are
// formed on the tensor cores in split-TF32: every operand is split once,
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded with
// cvt.rna (the tensor core only truncates raw f32, which would leave lo
// wrong), and
//
//     x.z ~ lo_x.hi_z + hi_x.lo_z + hi_x.hi_z
//
// with f32 accumulation: about as accurate as plain f32 FMAs, where 1xTF32
// misses the reference's 2e-4 by 20-60x (kernels/ref.py holds the plain
// emulation of this arithmetic).  The tensor core truncates each sum it
// forms, so the two small products go to their own accumulator (their sums
// are 2^-11 smaller, so is their truncation), added once at the end; hi.hi
// is chained over the k8 steps alone.  The kernel transform is applied to
// the accumulator fragment in registers (rts_kval).
//
// For rbf both operands are shifted by one vector (the wrapper passes the
// mean of the kept operand's rows; linear and poly read no shift and get a
// null pointer): K(x, z) depends on x - z alone, and the Gram expansion
// |x|^2 + |z|^2 - 2 x.z then cancels between smaller numbers.  On
// covtype's rows (norms 11-26) that cuts the f32 error of each K entry
// about tenfold.
//
// Operands: rows land raw by cp.async (a tile's rows lie contiguous, so a
// tile is one flat run of 16-byte copies where the base allows, packed).
// The f32 norms of the shifted, unsplit rows come from the pass that
// splits them.  Two ways to the tensor cores:
//   wgmma (kernel_matvec): the block's threads split a tile once
//     (rts_split_rows) into hi and lo tiles, K-major with the 128-byte
//     swizzle that wgmma reads (32 tf32 columns a 128-byte slab, the
//     16-byte chunk c of row r at c ^ (r % 8), slabs on 1 KB boundaries),
//     and a warpgroup issues its products asynchronously (rts_wgmma_tile);
//   mma.sync.m16n8k8 (cd_column_update): the kept operand is split once
//     into fragment order (rts_stage_b, one 16-byte load a lane), and each
//     warp splits its own streamed rows in registers as it loads them
//     (rts_mma3).  At cd_column_update's bytes-bound shape this measured
//     faster than both wgmma forms (PERF.md).
//
// Accumulator fragments: register i of a warpgroup's thread t holds row
// 16 (t / 32) + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t' + i % 2, and
// acc[i][j][e] of a warp's (16 MT) x (8 NT) mma.sync tile holds row
// 16 i + g + 8 (e / 2), column 8 j + 2 t' + e % 2, with g = (t % 32) / 4
// and t' = t % 4.
#pragma once

#include <stdint.h>

#include "common.cuh"

// The entry points' answer to an input they do not take (a shape past the
// shared memory, a kind out of range): nothing is launched, and the
// wrapper raises ValueError.
#define RTS_REFUSED 20000

// ---------------------------------------------------------------- helpers --

__device__ __forceinline__ uint32_t rts_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo, both TF32 (rounded to nearest, ties away from zero)
__device__ __forceinline__ void rts_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = rts_tf32(x);
    lo = rts_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void rts_mma(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float rts_ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// cp.async of 4, 8 or 16 bytes; src_bytes < bytes zero-fills the rest
__device__ __forceinline__ void rts_cp_async(void* dst, const void* src,
                                             int bytes, int src_bytes) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    else if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void rts_cp_commit() {
    asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void rts_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x less entry k of the shift, for rbf; linear and poly are not shifted.
__device__ __forceinline__ float rts_less(float x, const float* sh, int k,
                                          int kind) {
    return kind == KIND_RBF ? x - sh[k] : x;
}

// The per-row (or per-column) term of the transform: -c |x|^2 for rbf
// (c = gamma log2 e), unused otherwise.
__device__ __forceinline__ float rts_norm_term(float nrm, int kind, float c) {
    return kind == KIND_RBF ? -c * nrm : 0.0f;
}

// Floats a cp.async moves from a source with this base: 4, 2 or 1 (the
// tiles the kernels copy start at multiples of 4 floats from the base).
__host__ __device__ __forceinline__ int rts_vec(const void* base) {
    const uintptr_t p = (uintptr_t)base;
    return p % 16 == 0 ? 4 : (p % 8 == 0 ? 2 : 1);
}

__host__ __device__ __forceinline__ int rts_kp(int d) { return (d + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int rts_stride(int d) { return rts_kp(d) + 4; }
// 128-byte slabs of 32 tf32 columns a split row takes
__host__ __device__ __forceinline__ int rts_slabs(int d) {
    return (rts_kp(d) + 31) / 32;
}
// floats of a raw stage of R packed rows, rounded up to 16 bytes
__host__ __device__ __forceinline__ int rts_stage(int R, int d) {
    return (R * d + 3) / 4 * 4;
}

// Issue the cp.async of rows [r0, r0 + R) (r0 a multiple of 4) of a
// row-major (rows, d) matrix into dst, packed (row stride d): one flat run
// of vec-float chunks, as the rows lie contiguous in memory; what lies past
// the matrix is zero-filled.  dst holds rts_stage(R, d) floats.
// Threads tid of nthr share the copies.
__device__ __forceinline__ void rts_load_flat(float* dst,
                                              const float* __restrict__ src,
                                              int rows, int d, int r0, int R,
                                              int vec, int tid, int nthr) {
    const long long first = (long long)r0 * d, total = (long long)rows * d;
    const int chunks = (R * d + vec - 1) / vec;
    for (int c = tid; c < chunks; c += nthr) {
        const long long off = first + (long long)c * vec;
        const long long left = total - off;
        const int bytes = left >= vec ? 4 * vec : (left > 0 ? 4 * (int)left : 0);
        rts_cp_async(dst + c * vec, src + (left > 0 ? off : 0), 4 * vec, bytes);
    }
}

// Stage the shift (d floats) into sh[0, kp), zero past d (rbf only).
__device__ __forceinline__ void rts_stage_shift(float* sh,
                                                const float* __restrict__ shift,
                                                int d) {
    for (int k = threadIdx.x; k < rts_kp(d); k += blockDim.x)
        sh[k] = k < d ? shift[k] : 0.0f;
}

// Split rows [0, R) (R a multiple of 8) of src (row stride d; rows
// >= rows and columns >= d read as 0), less the staged shift sh (rbf), into the
// swizzled hi and lo tiles (R rows a slab), and each row's norm term
// rts_norm_term(|x - shift|^2) into term.  Threads tid of nthr (whole
// warps) share the rows: four consecutive threads take a row, each a share
// of its 16-byte chunks, and sum their norms with a fixed xor pattern.
// Columns past the last k8 step are never read and not written.
__device__ __forceinline__ void rts_split_rows(unsigned char* hi,
                                               unsigned char* lo, float* term,
                                               const float* src, int rows,
                                               int d, int R, const float* sh,
                                               int kind, float c, int tid,
                                               int nthr) {
    const int q = tid % 4, chunks = rts_kp(d) / 4, slab = R * 128;
    for (int r = tid / 4; r < R; r += nthr / 4) {
        const float* row = src + (size_t)r * d;
        const bool in = r < rows;
        float nrm = 0.0f;
        for (int ch = q; ch < chunks; ch += 4) {
            uint32_t h[4], l[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = 4 * ch + e;
                const float a = rts_less(in && k < d ? row[k] : 0.0f, sh, k,
                                         kind);
                nrm = fmaf(a, a, nrm);
                rts_split(a, h[e], l[e]);
            }
            const int off = (ch / 8) * slab + r * 128 + (((ch % 8) ^ (r % 8)) << 4);
            *(uint4*)(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
            *(uint4*)(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
        }
        nrm += __shfl_xor_sync(0xffffffffu, nrm, 1);
        nrm += __shfl_xor_sync(0xffffffffu, nrm, 2);
        if (q == 0) term[r] = rts_norm_term(nrm, kind, c);
    }
}

// The threads' split tiles are read by wgmma through the async proxy.
__device__ __forceinline__ void rts_fence_split() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t rts_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// A 1 KB-aligned base inside the dynamic shared memory (the swizzle's
// period); the kernels ask for 1 KB more than they lay out.  An offset from
// raw, so the compiler still knows the pointers derived from it are shared
// (32-bit addresses: kernel_matvec spilled without that).
__device__ __forceinline__ unsigned char* rts_smem_base(unsigned char* raw) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(raw);
    return raw + ((1024u - (a & 1023u)) & 1023u);
}

// Stage rows [r0, r0 + R) (R a multiple of 8) of a row-major (rows, d)
// matrix, less the shift (rbf), as the B operand of the products, split and in
// fragment order: Bf[(nb ksteps + s) 32 + lane] = (hi(x[k]), hi(x[k + 4]),
// lo(x[k]), lo(x[k + 4])) of row 8 nb + g, k = 8 s + t, zero past the
// matrix and past d, so a lane loads its fragment pair with one 16-byte
// read, free of bank conflicts.  term[r] gets rts_norm_term(|x - shift|^2)
// (the f32 norm, summed by a warp in a fixed order).  Plain loads; a block
// does this once.
__device__ __forceinline__ void rts_stage_b(float4* Bf, float* term, int R,
                                            const float* __restrict__ src,
                                            const float* __restrict__ shift,
                                            int rows, int d, int r0,
                                            int kind, float c) {
    const int ksteps = rts_kp(d) / 8, items = R * ksteps * 4;
    // four items a thread at a time, so their loads are in flight together
    for (int e0 = threadIdx.x; e0 < items; e0 += 4 * blockDim.x) {
        float x[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int e = e0 + q * blockDim.x;
            const int lane = e % 32, s = (e / 32) % ksteps, nb = e / (32 * ksteps);
            const int gr = r0 + 8 * nb + lane / 4, k = 8 * s + lane % 4;
            const float* row = src + (size_t)gr * d;
            const bool in = e < items && gr < rows;
            x[q][0] = in && k < d ? rts_less(row[k], shift, k, kind) : 0.0f;
            x[q][1] = in && k + 4 < d ? rts_less(row[k + 4], shift, k + 4, kind)
                                      : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int e = e0 + q * blockDim.x;
            uint32_t h0, l0, h1, l1;
            rts_split(x[q][0], h0, l0);
            rts_split(x[q][1], h1, l1);
            if (e < items)
                Bf[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                    __uint_as_float(l0), __uint_as_float(l1));
        }
    }
    // a warp a row: lanes take strided columns, a fixed xor pattern sums them
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += blockDim.x / 32) {
        const int gr = r0 + r;
        float s = 0.0f;
        if (gr < rows)
            for (int k = lane; k < d; k += 32) {
                const float x = rts_less(src[(size_t)gr * d + k], shift, k,
                                         kind);
                s = fmaf(x, x, s);
            }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) term[r] = rts_norm_term(s, kind, c);
    }
}

// --------------------------------------------- mma.sync (cd_column_update) --

// The B fragments of one kstep: NT 8-row blocks of Bf (rts_stage_b), from
// the warp's first block, each (hi pair, lo pair).
template <int NT>
__device__ __forceinline__ void rts_load_b(uint32_t (&bf)[NT][4],
                                           const float4* Bf, int s, int ksteps) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const float4 b = Bf[(j * ksteps + s) * 32 + lane];
        bf[j][0] = __float_as_uint(b.x);
        bf[j][1] = __float_as_uint(b.y);
        bf[j][2] = __float_as_uint(b.z);
        bf[j][3] = __float_as_uint(b.w);
    }
}

// One kstep of the split-TF32 products on a warp's (16 MT) x (8 NT) tile:
// small += lo_a.hi_b + hi_a.lo_b, acc += hi_a.hi_b.
//
// The tensor core truncates each sum it forms, so a long chain of products
// into one accumulator drifts: the two small products go to their own
// accumulator (their sums are 2^-11 smaller, so is their truncation), added
// once at the end (rts_finish); hi.hi is chained over the ksteps alone.
// Each pass runs over every (i, j) tile before the next, so no product
// waits on the one just issued.
template <int MT, int NT>
__device__ __forceinline__ void rts_mma3(float (&acc)[MT][NT][4],
                                         float (&small)[MT][NT][4],
                                         const uint32_t (&ahi)[MT][4],
                                         const uint32_t (&alo)[MT][4],
                                         const uint32_t (&bf)[NT][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
            rts_mma(small[i][j], alo[i], bf[j][0], bf[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
            rts_mma(acc[i][j], ahi[i], bf[j][0], bf[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
            rts_mma(small[i][j], ahi[i], bf[j][2], bf[j][3]);
}

template <int MT, int NT>
__device__ __forceinline__ void rts_zero(float (&acc)[MT][NT][4],
                                         float (&small)[MT][NT][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = small[i][j][e] = 0.0f;
}

template <int MT, int NT>
__device__ __forceinline__ void rts_finish(float (&acc)[MT][NT][4],
                                           const float (&small)[MT][NT][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += small[i][j][e];
}

// ---------------------------------------------------- wgmma (kernel_matvec) --

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: start
// address, LBO (unused), SBO = 1 KB between groups of eight rows (>> 4); a
// k8 step inside a slab advances the start by 32 bytes.
__device__ __forceinline__ uint64_t rts_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define RTS_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RTS_F16(d, i) RTS_F4(d, i), RTS_F4(d, i + 4), RTS_F4(d, i + 8), RTS_F4(d, i + 12)

// D (64 x 64, f32) = A . B (+ D if scale_d): A (64 rows) and B (64 rows)
// tf32 in shared memory, both K-major, one k8 step.
__device__ __forceinline__ void rts_wgmma(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : RTS_F16(d, 0), RTS_F16(d, 16)
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A . B with A (64 x 8 tf32) in registers, in the A
// fragment of mma.sync.m16n8k8 (a warp's 16 rows: (g, t), (g + 8, t), (g, t
// + 4), (g + 8, t + 4)), and B (N rows, K-major) in shared memory; D's
// register i of a lane holds row g + 8 ((i / 2) % 2) of the warp's 16,
// column 8 (i / 4) + 2 t + i % 2.  N = 64 (kmeans_assign's K W).
template <int N> struct RtsWgA;
template <> struct RtsWgA<64> {
    static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : RTS_F16(d, 0), RTS_F16(d, 16)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
    }
};

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void rts_reg_fence(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A warpgroup's 64 x N block of (x - shift).(z - shift) in split-TF32, in
// acc on return (small is scratch).  a_hi, a_lo: the shared addresses of
// its A rows (slabs a_slab bytes apart); b_hi, b_lo those of its B rows
// (slabs b_slab bytes apart).  Issues 3 wgmma a k8 step and waits.
// The products of one depth slab run into acc and small, which start from
// zero when first (else they carry the earlier slabs' sums).
template <int R>
__device__ __forceinline__ void rts_wgmma_slab(float (&acc)[R], float (&small)[R],
                                               uint32_t a_hi, uint32_t a_lo,
                                               int a_slab, uint32_t b_hi,
                                               uint32_t b_lo, int b_slab,
                                               int ksteps, bool first) {
    rts_reg_fence(acc);
    rts_reg_fence(small);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int kk = 0; kk < ksteps; ++kk) {
        const uint32_t ka = (kk / 4) * a_slab + (kk % 4) * 32;
        const uint32_t kb = (kk / 4) * b_slab + (kk % 4) * 32;
        const int keep = kk > 0 || !first;
        rts_wgmma(small, rts_desc(a_lo + ka), rts_desc(b_hi + kb), keep);
        rts_wgmma(acc, rts_desc(a_hi + ka), rts_desc(b_hi + kb), keep);
        rts_wgmma(small, rts_desc(a_hi + ka), rts_desc(b_lo + kb), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    rts_reg_fence(acc);
    rts_reg_fence(small);
}

template <int R>
__device__ __forceinline__ void rts_wgmma_tile(float (&acc)[R], float (&small)[R],
                                               uint32_t a_hi, uint32_t a_lo,
                                               int a_slab, uint32_t b_hi,
                                               uint32_t b_lo, int b_slab,
                                               int ksteps) {
    rts_wgmma_slab(acc, small, a_hi, a_lo, a_slab, b_hi, b_lo, b_slab, ksteps,
                   true);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += small[i];
}

// The kernel value from the Gram entry g and the two norm terms:
// rbf exp2(min(2 c g - c|x|^2 - c|z|^2, 0)) = exp(-gamma max(|x - z|^2, 0)).
template <int KIND>
__device__ __forceinline__ float rts_kval(float g, float ta, float tb, float c2,
                                          float gamma, int degree, float coef0) {
    if (KIND == KIND_RBF) return rts_ex2(fminf(fmaf(c2, g, ta + tb), 0.0f));
    if (KIND == KIND_LINEAR) return g;
    const float base = fmaf(gamma, g, coef0);
    float r = 1.0f;
#pragma unroll 1
    for (int e = 0; e < degree; ++e) r *= base;
    return r;
}

// ------------------------------------------------- streamed depth slices --
//
// Past the width that fits in shared memory whole, an operand is split one
// depth slice of RTS_DC columns at a time, straight from device memory, and
// the products of the slices run into the same accumulators: x.z is summed
// over the slices in order, k ascending, as over whole rows.  The norms
// still cover whole rows (rts_row_norms, or partial sums per slice added up
// in a fixed order).  These routines take every d >= 1.

#define RTS_DC 64   // columns of a depth slice (8 k8 steps, two 128-byte slabs)

// x[k] less the shift (rbf) of row r of a row-major (rows, d) matrix; 0 past
// the matrix and past d.
__device__ __forceinline__ float rts_at(const float* __restrict__ src,
                                        const float* __restrict__ shift,
                                        int rows, int d, int r, int k,
                                        int kind) {
    if (r >= rows || k >= d) return 0.0f;
    const float x = __ldg(src + (size_t)r * d + k);
    return kind == KIND_RBF ? x - __ldg(shift + k) : x;
}

// The shift of the slice [k0, k0 + RTS_DC) into shared memory (0 past d,
// and for linear and poly); the slice staging routines below read it.
__device__ __forceinline__ void rts_stage_sh(float* sh,
                                             const float* __restrict__ shift,
                                             int d, int k0, int kind) {
    for (int j = threadIdx.x; j < RTS_DC; j += blockDim.x)
        sh[j] = kind == KIND_RBF && k0 + j < d ? shift[k0 + j] : 0.0f;
}

// nrm[r] = |x - shift|^2 (f32, unsplit) of rows [r0, r0 + R) of a row-major
// (rows, d) matrix, 0 past it: a warp a row, lanes over strided columns,
// summed by a fixed xor pattern.  Warp w of nwarps.
__device__ __forceinline__ void rts_row_norms(float* nrm, int R,
                                              const float* __restrict__ src,
                                              const float* __restrict__ shift,
                                              int rows, int d, int r0, int kind,
                                              int warp, int nwarps) {
    const int lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += nwarps) {
        float s = 0.0f;
        if (r0 + r < rows)
            for (int k = lane; k < d; k += 32) {
                const float x = rts_at(src, shift, rows, d, r0 + r, k, kind);
                s = fmaf(x, x, s);
            }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) nrm[r] = s;
    }
}

// x[r][k0 + j] and x[r][k0 + j + 4] less sh[j], sh[j + 4] (0 past the
// matrix and past d) through one row pointer; src lies in device memory
// or (rows landed by rts_load_flat) in shared memory.
__device__ __forceinline__ void rts_pair(float& a, float& b,
                                         const float* __restrict__ src,
                                         const float* sh, int rows, int d,
                                         int r, int k0, int j) {
    const bool in = r < rows;
    const float* p = src + (size_t)(in ? r : 0) * d + k0 + j;
    a = in && k0 + j < d ? p[0] - sh[j] : 0.0f;
    b = in && k0 + j + 4 < d ? p[4] - sh[j + 4] : 0.0f;
}

// rts_stage_a64 also sums each row's |x - shift|^2 (f32, of the unsplit
// values): a quad's four lanes hold the row's eight columns of a k8 step,
// summed by a fixed xor pattern, and lane t = 0 adds them, k8 step by k8
// step, into the warp's partial pn[warp R + row], which only it writes
// (zeroed by it at the first slice).  A row's norm is then
// rts_norm_of(pn, ...): the warps' partials summed in order.
__device__ __forceinline__ float rts_quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float rts_norm_of(const float* pn, int R, int nwarps,
                                             int r) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += pn[w * R + r];
    return s;
}

// The A operand (m16n8k8, row-major) of rows [r0, r0 + R) (R a multiple of
// 16) and columns [k0, k0 + RTS_DC), less the slice's shift sh
// (rts_stage_sh), split and in fragment order: Ahi[(mb 8 + s) 32 + lane] =
// hi of (x[g][k], x[g + 8][k], x[g][k + 4], x[g + 8][k + 4]) of rows 16 mb +
// ..., k = k0 + 8 s + t, and Alo the same of lo; a lane reads its fragment
// with one 16-byte load of each, free of bank conflicts.  NTHR threads
// share the work, four items a thread in flight at once (16 loads); the
// rows' norms go to pn (NTHR / 32 x R floats, see above; none if null).
template <int R, int NTHR>
__device__ __forceinline__ void rts_stage_a64(float4* Ahi, float4* Alo,
                                              float* pn,
                                              const float* __restrict__ src,
                                              const float* sh, int rows, int d,
                                              int r0, int k0, bool first,
                                              int tid) {
    constexpr int PER = (R / 16) * 8 * 32 / NTHR, BATCH = PER < 4 ? PER : 4;
    const int lane = tid % 32;
    float* mine = pn == nullptr ? nullptr : pn + (tid / 32) * R + lane / 4;
    if (mine != nullptr && first && lane % 4 == 0)
        for (int r = 0; r < R; r += 8) mine[r] = 0.0f;
#pragma unroll 1
    for (int q0 = 0; q0 < PER; q0 += BATCH) {
        float x[BATCH][4];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
            const int e = tid + (q0 + q) * NTHR;
            const int r = r0 + 16 * (e / 256) + lane / 4;
            const int j = 8 * ((e / 32) % 8) + lane % 4;
            rts_pair(x[q][0], x[q][2], src, sh, rows, d, r, k0, j);
            rts_pair(x[q][1], x[q][3], src, sh, rows, d, r + 8, k0, j);
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
            const int e = tid + (q0 + q) * NTHR;
            if (mine != nullptr) {
                const float a = rts_quad_sum(
                    fmaf(x[q][2], x[q][2], x[q][0] * x[q][0]));
                const float b = rts_quad_sum(
                    fmaf(x[q][3], x[q][3], x[q][1] * x[q][1]));
                if (lane % 4 == 0) {
                    mine[16 * (e / 256)] += a;
                    mine[16 * (e / 256) + 8] += b;
                }
            }
            uint32_t h[4], l[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) rts_split(x[q][i], h[i], l[i]);
            Ahi[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                 __uint_as_float(h[2]), __uint_as_float(h[3]));
            Alo[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                 __uint_as_float(l[2]), __uint_as_float(l[3]));
        }
    }
}

// The B operand of rows [r0, r0 + R) (R a multiple of 8) and columns [k0,
// k0 + RTS_DC), less sh, split in rts_stage_b's fragment order
// (Bf[(nb 8 + s) 32 + lane], s < 8), eight items a thread in flight.
template <int R, int NTHR>
__device__ __forceinline__ void rts_stage_b64(float4* Bf,
                                              const float* __restrict__ src,
                                              const float* sh, int rows, int d,
                                              int r0, int k0, int tid) {
    constexpr int PER = (R / 8) * 8 * 32 / NTHR, BATCH = PER < 8 ? PER : 8;
    const int lane = tid % 32;
#pragma unroll 1
    for (int q0 = 0; q0 < PER; q0 += BATCH) {
        float x[BATCH][2];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
            const int e = tid + (q0 + q) * NTHR;
            rts_pair(x[q][0], x[q][1], src, sh, rows, d,
                     r0 + 8 * (e / 256) + lane / 4, k0,
                     8 * ((e / 32) % 8) + lane % 4);
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
            uint32_t h0, l0, h1, l1;
            rts_split(x[q][0], h0, l0);
            rts_split(x[q][1], h1, l1);
            Bf[tid + (q0 + q) * NTHR] = make_float4(
                __uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                __uint_as_float(l1));
        }
    }
}

// The A fragments (hi, lo) of a warp's m16 block mb for k8 step s of a
// slice staged by rts_stage_a64.
__device__ __forceinline__ void rts_load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float4* Ahi, const float4* Alo,
                                           int mb, int s) {
    const int i = (mb * 8 + s) * 32 + threadIdx.x % 32;
    const float4 h = Ahi[i], l = Alo[i];
    hi[0] = __float_as_uint(h.x); hi[1] = __float_as_uint(h.y);
    hi[2] = __float_as_uint(h.z); hi[3] = __float_as_uint(h.w);
    lo[0] = __float_as_uint(l.x); lo[1] = __float_as_uint(l.y);
    lo[2] = __float_as_uint(l.z); lo[3] = __float_as_uint(l.w);
}

// Split rows [0, R) (R a multiple of 8) of src (a row-major (rows, d)
// matrix in device memory), columns [k0, k0 + RTS_DC), less the slice's
// shift sh, into the swizzled hi and lo tiles of rts_split_rows (two slabs
// of R rows).  With nrm, each row's partial |x - shift|^2 over the slice is
// stored (first) or added to nrm[r], four threads a row summing with a
// fixed xor pattern.  Threads tid of nthr (whole warps).
__device__ __forceinline__ void rts_split_slice(unsigned char* hi,
                                                unsigned char* lo, float* nrm,
                                                const float* __restrict__ src,
                                                const float* sh, int rows,
                                                int d, int R, int k0,
                                                bool first, int tid, int nthr) {
    const int q = tid % 4, slab = R * 128;
    for (int r = tid / 4; r < R; r += nthr / 4) {
        const bool in = r < rows;
        const float* row = src + (size_t)(in ? r : 0) * d + k0;
        float s = 0.0f;
#pragma unroll 2
        for (int j = 0; j < 4; ++j) {
            const int ch = q + 4 * j;
            uint32_t h[4], l[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * ch + e;
                const float x = in && k0 + c < d ? __ldg(row + c) - sh[c] : 0.0f;
                s = fmaf(x, x, s);
                rts_split(x, h[e], l[e]);
            }
            const int off = (ch / 8) * slab + r * 128 + (((ch % 8) ^ (r % 8)) << 4);
            *(uint4*)(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
            *(uint4*)(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
        }
        if (nrm != nullptr) {
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (q == 0) nrm[r] = first ? s : nrm[r] + s;
        }
    }
}
