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
// outside the tensor and are skipped (p = 0), whatever the mask.
//
// Work: causal attention does 2 B Hq Sq Sk hd flops (two products over half
// the score matrix); the bytes are Q, K, V and O read or written once.  At
// the model's prefill shapes (S = 2048, hd 64..256) that is hundreds of
// flops a byte: the kernel is bound by operations.  This version does every
// step in f32 on the CUDA cores (FMAs, no tensor cores), so its bound on
// this card is the f32 rate, while the bf16 tensor-core rate is the card's
// bound for the work.
//
// Design: the TPU kernel walks a sequential grid over key tiles with its
// statistics in VMEM scratch; here one block of 256 threads owns 64 query
// rows of one (batch, head) and walks the key tiles in a loop.  Q is staged
// once, transposed, in shared memory (f32); each key tile stages K
// (transposed) and V (f32).  Thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows ty + 16 i (i < 4): it forms scores for keys tx + 16 j, the 16
// threads of a half-warp that share a row reduce its max and sum with xor
// shuffles (identical in every lane), p goes through shared memory, and the
// thread accumulates output columns tx + 16 c.  Tiles: BK = 64 keys at
// hd = 64 and 128 (66 KB and 115 KB of shared memory), BK = 32 at hd = 256
// (141 KB).  Under the causal mask the key loop stops at the block's last
// query position, so tiles that are masked for every row are never visited
// (in the reference they add exactly 0 to every row: each row has key 0
// unmasked in its first tile).  Blocks are issued from the last query tile
// down, so the longest ones start first.  GQA/MQA: query head h reads kv
// head h / (Hq / Hkv) through the strides; K and V are never repeated.
#include <cuda_bf16.h>
#include <math.h>

#define FA_BQ 64            // query rows a block
#define FA_THREADS 256
#define FA_MASKED (-1e30f)  // the reference's causal fill and initial max

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

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

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int Hq, int G, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, int causal, int q_offset, float scale) {
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
    const T* qb = q + b * q_sb + h * q_sh;
    const T* kb = k + b * k_sb + hk * k_sh;
    const T* vb = v + b * v_sb + hk * v_sh;

    for (int e = t; e < FA_BQ * HD; e += FA_THREADS) {
        const int r = e / HD, d = e % HD;
        Qs[d * (FA_BQ + 1) + r] =
            (r0 + r < Sq) ? fa_load(qb + (r0 + r) * q_ss + d) : 0.0f;
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
            Ks[d * (BK + 1) + j] = in ? fa_load(kb + (k0 + j) * k_ss + d) : 0.0f;
            Vs[j * HD + d] = in ? fa_load(vb + (k0 + j) * v_ss + d) : 0.0f;
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
        T* orow = o + (((long long)b * Sq + r) * Hq + h) * HD;
#pragma unroll
        for (int c = 0; c < NC; ++c) fa_store(orow + tx + 16 * c, acc[i][c] * inv);
    }
}

template <typename T, int HD, int BK>
static int launch(const void* q, const void* k, const void* v, void* o, int B,
                  int Sq, int Sk, int Hq, int Hkv, const long long* st,
                  int causal, int q_offset, float scale, cudaStream_t stream) {
    const size_t smem = FaSmem<HD, BK>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * Hq);
    flash_attention_kernel<T, HD, BK><<<grid, FA_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, Hq, Hq / Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
        q_offset, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                    const long long* st, int causal, int q_offset, float scale,
                    cudaStream_t stream) {
    switch (hd) {
        case 64: return launch<T, 64, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, st, causal, q_offset, scale, stream);
        case 128: return launch<T, 128, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, st, causal, q_offset, scale, stream);
        case 256: return launch<T, 256, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, st, causal, q_offset, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), each with a unit stride on
// the last axis and the given element strides (batch, sequence, head) on
// the others; o is (B, Sq, Hq, hd), contiguous.  is_bf16 picks bfloat16
// over float32 for all four.  hd is 64, 128 or 256; Hq % Hkv == 0.
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
    if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0 || B * Hq > 65535)
        return (int)cudaErrorInvalidValue;
    const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, st,
                                       causal, q_offset, scale, s);
    return dispatch<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, st, causal,
                           q_offset, scale, s);
}
