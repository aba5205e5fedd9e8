// flash_attention: the forward pass of softmax attention with an online
// softmax, so the (Sq, Sk) score matrix never reaches device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pl.pallas_call at flash_attention.py:83), reached through
// ops.flash_attention from the model's chunked_attention (every layer's
// prefill attention).
//
// What it computes, per query row and head: running max m (from -1e30),
// running sum l and an f32 accumulator over the key tiles; scores q.k * scale
// in f32 (scale = 1/sqrt(hd)); under the causal mask a key with
// q_offset + row < key scores -1e30 (the reference's constant, not -inf);
// p = exp(s - m_new), corr = exp(m_prev - m_new); the output is
// acc / max(l, 1e-30), cast to the input type.  Keys at or past Sk are
// outside the tensor and are skipped (p = 0), whatever the mask.  Under the
// causal mask a block's key loop stops at its last query position; every
// row sees key 0 in its first tile, so its max is finite from then on and
// a tile masked for the whole row adds exactly 0.  Blocks are issued from
// the last query tile down, so the longest ones start first.  GQA/MQA:
// query head h reads kv head h / (Hq / Hkv) through the strides; K and V
// are never repeated.
//
// Work: causal attention does 2 B Hq Sq Sk hd flops (two products over half
// the score matrix); the bytes are Q, K, V and O read or written once.  At
// the model's prefill shapes (S = 2048, hd 64..256) that is hundreds of
// flops a byte: the kernel is bound by operations, at the bf16 tensor-core
// rate for bf16 inputs.
//
// Two kernels, one for each input type:
//
// bfloat16 (the model's type): Hopper's tensor cores fed by TMA, in the
// shape of FlashAttention-3.  Work items are 64 x NWG query rows of one
// (batch, head), longest first; the kernel is persistent, one block an SM
// walking items blockIdx.x, + gridDim.x, ...  A block is NWG consumer
// warpgroups (64 query rows each; 3 at hd 64, 2 above) and a producer
// warpgroup, whose registers setmaxnreg moves to the consumers (24 a
// thread, and 160 or 240 for the consumers).  One producer thread loads
// each item's Q tile and its K and V tiles with TMA (4-D maps, 128-byte
// swizzle, 64-wide column slabs) into a ring of two stages, with full and
// empty barriers for K and for V, so K and V are released apart; it runs
// ahead across items, loading the next item's Q once every consumer warp
// has formed the current item's last scores.  A consumer warpgroup forms
// S = Q K^T with wgmma (both operands in shared memory, K-major), runs the
// online softmax on the accumulator fragment in registers (row max and sum
// over the four lanes that share a row, exp2 with the scale folded in; the
// masks only in tiles that cross the diagonal or Sk), rounds P to bf16 in
// registers -- the accumulator fragment of S is the A fragment of the next
// product, so no shuffle -- and accumulates O += P V with wgmma, A from
// registers and V from shared memory read MN-major.  l sums the f32 p.
// Two overlaps keep the tensor cores fed: inside a warpgroup, tile t's
// softmax runs while tile t - 1's P V is in flight; between warpgroups,
// named barriers make them take turns, round robin, to issue their
// products (ping-pong), so one's softmax runs under the others' products.  The output is normalised
// and stored with 4-byte stores; rows >= Sq are never written.  Keys >= Sk
// are zero-filled by TMA and masked to p = 0.  Tensor maps are 4-D over
// (hd, H, S, B) on the caller's strides (that order keeps a contiguous
// tensor's strides increasing), built on the host with
// cuTensorMapEncodeTiled taken through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.  TMA needs a 16-byte aligned base and strides
// that are multiples of 16 bytes: the wrapper checks both
// (ops.flash_tma_strides).  Tiles (query rows and keys an item and tile,
// shared memory, consumer accumulator registers a thread; no spills):
//   hd  64: 192 x 128, 2 stages:  88 KB; S 64 + O  32 + P 32 (of 160)
//   hd 128: 128 x 128, 2 stages: 160 KB; S 64 + O  64 + P 32 (of 240)
//   hd 256: 128 x  64, 2 stages: 192 KB; S 32 + O 128 + P 16 (of 240)
// A lost mbarrier arrival traps after a second instead of hanging.
//
// float32: the CUDA-core kernel (TF32 could not meet the f32 tolerance of
// 2e-5): one block of 256 threads owns 64 query rows of one (batch, head)
// and walks the key tiles in a loop.  Q is staged once, transposed, in
// shared memory; each key tile stages K (transposed) and V.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4): it
// forms scores for keys tx + 16 j, the 16 threads of a half-warp that
// share a row reduce its max and sum with xor shuffles, p goes through
// shared memory, and the thread accumulates output columns tx + 16 c.
// Tiles: BK = 64 keys at hd = 64 and 128 (66 KB and 115 KB of shared
// memory), BK = 32 at hd = 256 (141 KB).
#include <cuda_bf16.h>
#include <math.h>

#include "tma.cuh"

#define FA_MASKED (-1e30f)  // the reference's causal fill and initial max

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

#define FA_BQ 64            // query rows a block
#define FA_THREADS 256

__device__ __forceinline__ float fa_max16(float v) {
    for (int off = 8; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
    return v;
}

__device__ __forceinline__ float fa_sum16(float v) {
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off, 16);
    return v;
}

template <int HD, int BK>
struct FaSmem {
    static constexpr int Q = HD * (FA_BQ + 1);   // Qs[d][row]
    static constexpr int K = HD * (BK + 1);      // Ks[d][key]
    static constexpr int V = BK * HD;            // Vs[key][d]
    static constexpr int P = BK * (FA_BQ + 1);   // Ps[key][row]
    static constexpr size_t bytes = (size_t)(Q + K + V + P) * sizeof(float);
};

template <int HD, int BK>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int Sq, int Sk, int Hq, int G, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, int causal,
                           int q_offset, float scale) {
    constexpr int NJ = BK / 16;     // score columns a thread
    constexpr int NC = HD / 16;     // output columns a thread
    using S = FaSmem<HD, BK>;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + S::Q;
    float* Vs = Ks + S::K;
    float* Ps = Vs + S::V;

    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    const int r0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
    const int bh = blockIdx.y;
    const int b = bh / Hq, h = bh % Hq, hk = h / G;
    const float* qb = q + b * q_sb + h * q_sh;
    const float* kb = k + b * k_sb + hk * k_sh;
    const float* vb = v + b * v_sb + hk * v_sh;

    for (int e = t; e < FA_BQ * HD; e += FA_THREADS) {
        const int r = e / HD, d = e % HD;
        Qs[d * (FA_BQ + 1) + r] = (r0 + r < Sq) ? qb[(r0 + r) * q_ss + d] : 0.0f;
    }

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_MASKED;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
    }

    // keys past the block's last query position are masked for every row
    const int last_q = q_offset + min(r0 + FA_BQ, Sq) - 1;
    const int k_end = causal ? min(Sk, last_q + 1) : Sk;

    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();   // Qs staged; Ks, Vs and Ps free for this tile
        for (int e = t; e < BK * HD; e += FA_THREADS) {
            const int j = e / HD, d = e % HD;
            const bool in = k0 + j < Sk;
            Ks[d * (BK + 1) + j] = in ? kb[(k0 + j) * k_ss + d] : 0.0f;
            Vs[j * HD + d] = in ? vb[(k0 + j) * v_ss + d] : 0.0f;
        }
        __syncthreads();

        float s[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float a[4], c[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Qs[d * (FA_BQ + 1) + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < NJ; ++j) c[j] = Ks[d * (BK + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_offset + r0 + ty + 16 * i;
            float mx = FA_MASKED;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int kpos = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (causal && qpos < kpos) x = FA_MASKED;
                if (kpos >= Sk) x = -INFINITY;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
            const float m_new = fmaxf(m[i], fa_max16(mx));
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float p = expf(s[i][j] - m_new);
                rs += p;
                Ps[(tx + 16 * j) * (FA_BQ + 1) + ty + 16 * i] = p;
            }
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + fa_sum16(rs);
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ps[j * (FA_BQ + 1) + ty + 16 * i];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float w = Vs[j * HD + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], w, acc[i][c]);
            }
        }
    }

    // o is (B, Sq, Hq, HD), contiguous
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= Sq) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
        float* orow = o + (((long long)b * Sq + r) * Hq + h) * HD;
#pragma unroll
        for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    }
}

template <int HD, int BK>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int Hq, int Hkv,
                      const long long* st, int causal, int q_offset,
                      float scale, cudaStream_t stream) {
    if (B * Hq > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = FaSmem<HD, BK>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<HD, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * Hq);
    flash_attention_f32_kernel<HD, BK><<<grid, FA_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk,
        Hq, Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], causal, q_offset, scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

#define FA_PRODUCER_REGS 24    // setmaxnreg of the producer warpgroup
#define FA_TMAP_ERROR 10000    // + CUresult: a tensor map was refused

// HD columns, BK keys a tile, NWG consumer warpgroups (64 query rows each)
template <int HD_, int BK_, int NWG_>
struct FaCfg {
    static constexpr int HD = HD_, BK = BK_, NWG = NWG_;
    static constexpr int BQ = 64 * NWG;               // query rows an item
    static constexpr int STAGES = 2;                  // of the K/V ring
    static constexpr int THREADS = 128 * (NWG + 1);   // + the producer
    // setmaxnreg of each consumer warpgroup: what the producer's registers
    // leave of the 64K (168 or 128 a thread at launch, by launch bounds)
    static constexpr int CONS_REGS = NWG == 2 ? 240 : 160;
    static_assert(NWG == 2 || NWG == 3, "consumer warpgroups");
    static constexpr int SLAB_Q = BQ * 128;            // bytes of one 64-wide
    static constexpr int SLAB_KV = BK * 128;           //   column slab
    static constexpr int Q_BYTES = SLAB_Q * (HD / 64);
    static constexpr int KV_BYTES = SLAB_KV * (HD / 64);   // one K or V tile
    static constexpr int BAR_BYTES = 8 * (2 + 4 * STAGES);
    // + 1 KB to align the base to the 128-byte swizzle's 1 KB period
    static constexpr size_t SMEM =
        1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
    static_assert(HD % 64 == 0 && BK % 16 == 0 && BK <= 256, "tile");
    static_assert(SMEM <= 232448, "shared memory");
};

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4).  K-major: rows of 128 bytes, eight
// rows (1 KB) a swizzle atom, SBO = 1 KB between atoms, LBO unused; a k16
// step inside the 64-wide slab advances the start by 32 bytes.  MN-major:
// LBO = the byte stride between 64-wide MN slabs, SBO = 1 KB between
// groups of eight K rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float fa_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

#define FA_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_F16(d, i) FA_F4(d, i), FA_F4(d, i + 4), FA_F4(d, i + 8), FA_F4(d, i + 12)
#define FA_F32(d, i) FA_F16(d, i), FA_F16(d, i + 16)
#define FA_D32(d) FA_F32(d, 0)
#define FA_D64(d) FA_F32(d, 0), FA_F32(d, 32)
#define FA_D128(d) FA_F32(d, 0), FA_F32(d, 32), FA_F32(d, 64), FA_F32(d, 96)

// The wgmma instructions of the kernel, one overload per accumulator width.
// Accumulator fragment of thread t of the warpgroup, register i: row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (t % 4) + i % 2.

// D (64 x 64, f32) = A . B (+ D if scale_d): A and B bf16 in shared
// memory, both K-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_D32(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = A . B (+ D if scale_d): A and B bf16 in shared
// memory, both K-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FA_D64(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A . B: A bf16 in registers (the accumulator
// fragment layout, two values a register), B bf16 in shared memory,
// MN-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A . B: A bf16 in registers (the accumulator
// fragment layout, two values a register), B bf16 in shared memory,
// MN-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FA_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A . B: A bf16 in registers (the accumulator
// fragment layout, two values a register), B bf16 in shared memory,
// MN-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : FA_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Work item j (of nq * B * Hq): query tile nq - 1 - j / (B Hq) of (batch,
// head) j % (B Hq), so items come longest first; a block takes items
// blockIdx.x, + gridDim.x, ...
struct FaItem {
    int b, h, r0, n_tiles;
};

template <class C>
__device__ __forceinline__ FaItem fa_item(int j, int nq, int B, int Hq,
                                          int Sq, int Sk, int causal,
                                          int q_offset) {
    FaItem it;
    const int bh = j % (B * Hq);
    it.b = bh / Hq;
    it.h = bh % Hq;
    it.r0 = (nq - 1 - j / (B * Hq)) * C::BQ;
    // keys past the item's last query position are masked for every row
    const int last_q = q_offset + min(it.r0 + C::BQ, Sq) - 1;
    const int k_end = causal ? min(Sk, last_q + 1) : Sk;
    it.n_tiles = (k_end + C::BK - 1) / C::BK;
    return it;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, int B, int Sq,
                            int Sk, int Hq, int G, int causal, int q_offset,
                            float scale_log2) {
    constexpr int HD = C::HD, BK = C::BK, STAGES = C::STAGES, NWG = C::NWG;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* sQ = base;                         // [HD/64][BQ][128 B]
    uint8_t* sK = sQ + C::Q_BYTES;              // [STAGES][HD/64][BK][128 B]
    uint8_t* sV = sK + STAGES * C::KV_BYTES;    // the same
    uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * C::KV_BYTES);
    uint64_t* q_empty = q_full + 1;
    uint64_t* k_full = q_empty + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* k_empty = v_full + STAGES;
    uint64_t* v_empty = k_empty + STAGES;

    const int nq = (Sq + C::BQ - 1) / C::BQ;
    const int n_items = nq * B * Hq;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        mbar_init(q_empty, 4 * NWG);           // every consumer warp
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&k_empty[s], 4 * NWG);
            mbar_init(&v_empty[s], 4 * NWG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == NWG) {
        // producer: one thread issues every TMA load, running ahead across
        // items: the next item's Q as soon as the consumers have formed the
        // last scores of this one, its K and V tiles as ring stages free up
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(FA_PRODUCER_REGS));
        if (threadIdx.x % 128 == 0) {
            int it = 0;     // K/V tiles loaded so far: the ring position
            int n = 0;      // items so far
            for (int j = blockIdx.x; j < n_items; j += gridDim.x, ++n) {
                const FaItem w = fa_item<C>(j, nq, B, Hq, Sq, Sk, causal,
                                            q_offset);
                const int hk = w.h / G;
                if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
                mbar_expect_tx(q_full, C::Q_BYTES);
                for (int c = 0; c < HD / 64; ++c)
                    tma_load_4d(sQ + c * C::SLAB_Q, &tq, q_full, 64 * c, w.h,
                             w.r0, w.b);
                for (int t = 0; t < w.n_tiles; ++t, ++it) {
                    const int s = it % STAGES;
                    const uint32_t par = ((it / STAGES) - 1) & 1;
                    uint8_t* kd = sK + s * C::KV_BYTES;
                    uint8_t* vd = sV + s * C::KV_BYTES;
                    if (it >= STAGES) mbar_wait(&k_empty[s], par);
                    mbar_expect_tx(&k_full[s], C::KV_BYTES);
                    for (int c = 0; c < HD / 64; ++c)
                        tma_load_4d(kd + c * C::SLAB_KV, &tk, &k_full[s], 64 * c,
                                 hk, t * BK, w.b);
                    if (it >= STAGES) mbar_wait(&v_empty[s], par);
                    mbar_expect_tx(&v_full[s], C::KV_BYTES);
                    for (int c = 0; c < HD / 64; ++c)
                        tma_load_4d(vd + c * C::SLAB_KV, &tv, &v_full[s], 64 * c,
                                 hk, t * BK, w.b);
                }
            }
        }
    } else {
        // consumer warpgroup wg: item rows 64 wg .. 64 wg + 63
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(C::CONS_REGS));
        const int tid = threadIdx.x % 128, lane = tid % 32;
        // this thread's rows (item-local): row_lo and row_lo + 8
        const int row_lo = 64 * wg + 16 * (tid / 32) + lane / 4;
        const int col = 2 * (lane % 4);         // + 8 (i / 4) + i % 2
        const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;

        float sc[BK / 2], oc[HD / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
        float m[2], l[2], corr[2];
        uint32_t pa[BK / 16][4];
        FaItem w;
        int it0 = 0;        // ring position of the item's first tile

        // S = Q K^T of tile t into sc (issued, not waited for)
        auto issue_s = [&](int t) {
            const int it = it0 + t;
            const uint32_t k_addr = smem_u32(sK + (it % STAGES) * C::KV_BYTES);
            mbar_wait(&k_full[it % STAGES], (it / STAGES) & 1);
            __syncwarp();
            reg_fence(sc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                wgmma_ss(sc,
                         sw128_desc(q_addr + (kk / 4) * C::SLAB_Q + off, 16, 1024),
                         sw128_desc(k_addr + (kk / 4) * C::SLAB_KV + off, 16, 1024),
                         kk > 0);
            }
            wg_commit();
        };
        // O += P V of tile t (issued, not waited for)
        auto issue_pv = [&](int t) {
            const int it = it0 + t;
            const uint32_t v_addr = smem_u32(sV + (it % STAGES) * C::KV_BYTES);
            mbar_wait(&v_full[it % STAGES], (it / STAGES) & 1);
            __syncwarp();
            reg_fence(oc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs(oc, pa[kk],
                         sw128_desc(v_addr + kk * 2048, C::SLAB_KV, 1024));
            wg_commit();
        };
        // tile t's scores are formed: release its K stage and, after the
        // item's last tile, its Q
        auto scores_done = [&](int t) {
            if (lane == 0) {
                mbar_arrive(&k_empty[(it0 + t) % STAGES]);
                if (t == w.n_tiles - 1) mbar_arrive(q_empty);
            }
        };
        // masks and online softmax of tile t's scores: p into sc, l
        // updated, O's correction into corr
        auto softmax = [&](int t) {
            reg_fence(sc);
            const int k0 = t * BK;
            if (k0 + BK > Sk ||
                (causal && k0 + BK - 1 > q_offset + w.r0 + 64 * wg)) {
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) {
                    const int key = k0 + 8 * (i / 4) + col + i % 2;
                    const int qpos = q_offset + w.r0 + row_lo + 8 * ((i / 2) % 2);
                    if (key >= Sk) sc[i] = -INFINITY;
                    else if (causal && key > qpos) sc[i] = FA_MASKED;
                }
            }
            // the log2 domain: m is max(s) * scale_log2
            float mx[2] = {-INFINITY, -INFINITY}, ls[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
                mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m[r], mx[r] * scale_log2);
                corr[r] = fa_exp2(m[r] - m_new);
                m[r] = m_new;
            }
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int r = (i / 2) % 2;
                const float p = fa_exp2(fmaf(sc[i], scale_log2, -m[r]));
                ls[r] += p;
                sc[i] = p;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
        };
        // P in bf16: the S fragment of keys 16 kk .. 16 kk + 15 is the A
        // fragment of the k16 step kk
        auto pack_p = [&]() {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j],
                                          sc[8 * kk + 2 * j + 1]);
        };
        // Ping-pong: the consumer warpgroups take turns, round robin, to
        // issue their products (named barrier 1 + wg), so one's softmax
        // runs while the others' products keep the tensor cores busy.
        // Each issue point waits for its turn and then hands it to the next
        // warpgroup; the last one opens the first turn and skips its last
        // hand-over, so every barrier sees as many arrivals as waits.
        auto turn_wait = [&]() {
            asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
        };
        auto turn_pass = [&](bool last) {
            if (!(last && wg == NWG - 1))
                asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (wg + 1) % NWG)
                             : "memory");
        };
        if (wg == NWG - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

        int n = 0;
        for (int j = blockIdx.x; j < n_items; j += gridDim.x, ++n) {
            w = fa_item<C>(j, nq, B, Hq, Sq, Sk, causal, q_offset);
            const bool last_item = j + gridDim.x >= n_items;
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) oc[i] = 0.0f;
            m[0] = m[1] = FA_MASKED;
            l[0] = l[1] = 0.0f;

            // Software pipeline: the softmax of tile t runs while the
            // tensor cores do tile t - 1's P V.
            mbar_wait(q_full, n & 1);
            turn_wait();
            issue_s(0);
            turn_pass(false);
            wg_wait_all();
            scores_done(0);
            softmax(0);
            pack_p();
            for (int t = 1; t < w.n_tiles; ++t) {
                turn_wait();
                issue_s(t);
                issue_pv(t - 1);
                turn_pass(false);
                asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
                scores_done(t);
                softmax(t);
                wg_wait_all();
                reg_fence(oc);
                if (lane == 0) mbar_arrive(&v_empty[(it0 + t - 1) % STAGES]);
#pragma unroll
                for (int i = 0; i < HD / 2; ++i) oc[i] *= corr[(i / 2) % 2];
                pack_p();
            }
            turn_wait();
            issue_pv(w.n_tiles - 1);
            turn_pass(last_item);
            wg_wait_all();
            reg_fence(oc);
            if (lane == 0)
                mbar_arrive(&v_empty[(it0 + w.n_tiles - 1) % STAGES]);
            it0 += w.n_tiles;

            // l was summed over this thread's columns: add the quad's
            float inv[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
                inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
            }
            // o is (B, Sq, Hq, HD), contiguous
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = w.r0 + row_lo + 8 * r;
                if (row >= Sq) continue;
                __nv_bfloat16* orow =
                    o + (((long long)w.b * Sq + row) * Hq + w.h) * HD;
#pragma unroll
                for (int n8 = 0; n8 < HD / 8; ++n8)
                    *reinterpret_cast<uint32_t*>(orow + 8 * n8 + col) =
                        pack_bf16(oc[4 * n8 + 2 * r] * inv[r],
                                  oc[4 * n8 + 2 * r + 1] * inv[r]);
            }
        }
    }
}

// A 4-D bf16 map over (hd, H, S, B) with element strides (sh, ss, sb), a
// box of 64 columns x `rows` sequence positions of one head, 128-byte
// swizzle; positions past S read as zeros.
static int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int H,
                    int B, long long ss, long long sh, long long sb,
                    int rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return FA_TMAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : FA_TMAP_ERROR + (int)r;
}

template <class C>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int Hq, int Hkv,
                       const long long* st, int causal, int q_offset,
                       float scale, cudaStream_t stream) {
    const long long n_items = (long long)((Sq + C::BQ - 1) / C::BQ) * B * Hq;
    if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t cerr = cudaGetDevice(&dev);
    if (cerr == cudaSuccess)
        cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (cerr != cudaSuccess) return (int)cerr;
    CUtensorMap tq, tk, tv;
    int err = make_map(&tq, q, C::HD, Sq, Hq, B, st[1], st[2], st[0], C::BQ);
    if (!err) err = make_map(&tk, k, C::HD, Sk, Hkv, B, st[4], st[5], st[3], C::BK);
    if (!err) err = make_map(&tv, v, C::HD, Sk, Hkv, B, st[7], st[8], st[6], C::BK);
    if (err) return err;
    auto kernel = flash_attention_bf16_kernel<C>;
    cerr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (cerr != cudaSuccess) return (int)cerr;
    // setmaxnreg.inc waits for the registers the producer gives up: the
    // kernel must start with enough for both counts, or the consumers would
    // wait forever
    cudaFuncAttributes attr;
    cerr = cudaFuncGetAttributes(&attr, kernel);
    if (cerr != cudaSuccess) return (int)cerr;
    if (attr.numRegs * C::THREADS <
        128 * FA_PRODUCER_REGS + 128 * C::NWG * C::CONS_REGS)
        return (int)cudaErrorInvalidConfiguration;
    // persistent: one block an SM walks the items
    const int grid = (int)(n_items < sms ? n_items : sms);
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        tq, tk, tv, (__nv_bfloat16*)o, B, Sq, Sk, Hq, Hq / Hkv, causal,
        q_offset, scale * 1.4426950408889634f);
    return (int)cudaGetLastError();
}

// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), each with a unit stride on
// the last axis and the given element strides (batch, sequence, head) on
// the others; o is (B, Sq, Hq, hd), contiguous.  is_bf16 picks bfloat16
// over float32 for all four (for bfloat16 the base addresses must be
// 16-byte aligned and the strides multiples of 8 elements).  hd is 64, 128
// or 256; Hq % Hkv == 0.  Returns a cudaError_t, or FA_TMAP_ERROR + a
// CUresult when a tensor map is refused.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Sq, int Sk, int Hq,
                                  int Hkv, int hd, long long q_sb,
                                  long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss,
                                  long long k_sh, long long v_sb,
                                  long long v_ss, long long v_sh, int causal,
                                  int q_offset, float scale, int is_bf16,
                                  void* stream) {
    if (B == 0 || Sq == 0 || Hq == 0) return 0;
    if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
        return (int)cudaErrorInvalidValue;
    const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
#define FA_ARGS q, k, v, o, B, Sq, Sk, Hq, Hkv, st, causal, q_offset, scale, s
    if (is_bf16) {
        switch (hd) {
            case 64: return launch_bf16<FaCfg<64, 128, 3>>(FA_ARGS);
            case 128: return launch_bf16<FaCfg<128, 128, 2>>(FA_ARGS);
            case 256: return launch_bf16<FaCfg<256, 64, 2>>(FA_ARGS);
        }
    } else {
        switch (hd) {
            case 64: return launch_f32<64, 64>(FA_ARGS);
            case 128: return launch_f32<128, 64>(FA_ARGS);
            case 256: return launch_f32<256, 32>(FA_ARGS);
        }
    }
#undef FA_ARGS
    return (int)cudaErrorInvalidValue;
}
