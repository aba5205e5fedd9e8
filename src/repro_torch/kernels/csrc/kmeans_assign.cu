// kmeans_assign: the fused assignment step of two-step kernel k-means,
// scores = -2 K(X, Xm) @ W + s under the RBF kernel, and the row argmin.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign.py::
// kmeans_assign (pl.pallas_call at kmeans_assign.py:58), reached through
// ops.kmeans_assign.
//
// Bound: per (row, sample) pair the kernel runs two products, S = x . xm of
// depth d and K(x, xm) W of depth k, each in split-TF32 (three TF32
// products on the tensor cores, rbf_tile.cuh), and one exp; the bytes are
// (n + m) d + m k + k floats in and n k + n out.  At the level shape
// (464,810 x 1000, d = 54, k = 256) the products take 1.75 ms at 495
// TFLOP/s, the bytes 0.17 ms and the exps 0.11 ms: bound by the products.
//
// Design: a fused back-to-back product, as in attention.  Xm and W are the
// same for every row, so a first, small kernel (kmeans_assign_prep) splits
// them once a call, in chunks of KA_MC samples, into a scratch buffer the
// wrapper allocates: Xm less the shift (the mean of its rows) as the B
// fragments of mma.sync.m16n8k8, with its row norms, and W as the B tiles
// of wgmma (K-major, 128-byte swizzle).  A block of eight warps
// then owns 128 rows of X, split once into A fragments, and walks the
// chunks: each lands by flat 16-byte cp.async copies into a double buffer
// while the last one is multiplied, one barrier a chunk.  Each warp forms
// its 16 x KA_MC block of S on the tensor cores (mma.sync), applies the RBF
// transform to the accumulator in registers, and feeds it straight back as
// the A operand, from registers, of the second product, which each
// warpgroup runs with wgmma on its 64 rows (B, W's chunk, read once a
// warpgroup from shared memory; for k <= 32 each warp with mma.sync, where
// wgmma's fixed costs weigh more): lane (g, t) holds S columns 2t and 2t + 1
// of each n8 block, which the A fragment takes as k indices t and t + 4, so
// W's samples are laid out in that order (the contraction is over the
// samples, so any order applied to both sides is exact).  K never goes
// through shared memory.  The scores of a warp's 16 rows by 8 KT columns
// stay in registers across all of Xm (the small products of K W in their
// own accumulator through a chunk, then folded in with a rounded add); more
// centres take further passes over Xm.  The split is needed on both
// products: 1xTF32 on K W misses the reference's 1e-4 at k = 256 on covtype
// rows (tests/test_torch_split_tf32.py).
//
// Xm rows past m are split as zeros with zero W rows (RBF gives K(x, 0) !=
// 0).  The argmin keeps the lowest index on equal scores, as torch.argmin
// does: each thread visits its columns in increasing order with a strict
// compare, and the quad reduction takes the lower index on a tie.  Padded
// centres (past k, to the pass width) carry zero W and s = +inf, so they
// never win.  Any d: past
// RTS_DC columns the chunks come a depth slice at a time, the X rows are
// staged a slice a step, and the products of the slices run into the same
// accumulators.
#include <math.h>

#include "rbf_tile.cuh"

#define KA_THREADS 256
#define KA_WARPS 8
#define KA_ROWS 128             // X rows a block (8 warps of 16)
#define KA_MC 32                // Xm samples a chunk (4 n8 blocks of S)
#define KA_AF (KA_ROWS / 16 * 8 * 32)   // float4 of the X slice's hi (or lo)
#define KA_BF (KA_MC / 8 * 8 * 32)      // float4 of an Xm chunk's slice

template <int KT>
struct KaCfg {
    // K W: wgmma (KT >= 8, W's chunk read once a warpgroup) or, for the
    // narrow forms, where wgmma's fixed costs weigh more, mma.sync
    static constexpr bool WG = KT >= 8;
    static constexpr int NQ = KT < 4 ? KT : 4;       // mma.sync: n8 blocks a group
    static constexpr int GW = 8 * KT;                // score columns a pass
    static constexpr int NHALF = 64;                 // the N of a wgmma
    static constexpr int NH = GW / NHALF;            // wgmma column blocks
    static constexpr int WF = KA_MC / 8 * KT * 32;   // float4 of a W chunk
    // (1 KB for the swizzle's alignment) X slice (hi, lo), then two buffers
    // of (W chunk, Xm slice, Xm norms), the warps' partial norms of X's rows
    // and the slice's shift
    static constexpr int SMEM = 1024 + (2 * KA_AF + 2 * (KA_BF + WF)) * 16
                                + (2 * KA_MC + KA_WARPS * KA_ROWS + RTS_DC) * 4;
};

// The scratch (KaScratch below): Bs[c][dd], the split slice dd of Xm's
// chunk c (KA_BF float4 in rts_stage_b's fragment order); Ws[c][p], chunk
// c of W's pass-p columns (KT 128 float4), the samples of each k8 step in
// the A fragment's order (position p < 4 holds sample 2p, p >= 4 sample
// 2 (p - 4) + 1): for wgmma (KT >= 8) its B tiles, hi then lo, each 8 KT
// rows (one a score column) of the chunk's 32 samples, K-major with the
// 128-byte swizzle (the 16-byte chunk c of row n at c ^ (n % 8)); for
// mma.sync its B fragments, Ws[(j KT + q) 32 + lane] = (hi, hi, lo, lo) of
// rows 8 j + 2t and 8 j + 2t + 1, column 8 q + g; then mnrm[c KA_MC + r],
// the norms of Xm's rows, shifted.
//
// kmeans_assign_prep: thread e of the grid writes float4 e of Bs, then of
// Ws, then (a warp a row) the norms.
__global__ void kmeans_assign_prep(const float* __restrict__ Xm,
                                   const float* __restrict__ W,
                                   const float* __restrict__ shift,
                                   float4* __restrict__ Bs,
                                   float4* __restrict__ Ws,
                                   float* __restrict__ mnrm, int m, int d,
                                   int k, int kp, int KT, int nd, int nch) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int passes = kp / (8 * KT), per = KA_MC / 8 * KT * 32;
    const long long nb = (long long)nch * nd * KA_BF;
    const long long nw = (long long)nch * passes * per;
    const int lane = (int)(e % 32);
    if (e < nb + nw) {
        if (e < nb) {
            float x0, x1;
            const int i = (int)(e % KA_BF), c = (int)(e / KA_BF / nd);
            const int k0 = (int)(e / KA_BF % nd) * RTS_DC;
            const int r = c * KA_MC + 8 * (i / 256) + lane / 4;
            const int k = k0 + 8 * ((i / 32) % 8) + lane % 4;
            x0 = rts_at(Xm, shift, m, d, r, k, KIND_RBF);
            x1 = rts_at(Xm, shift, m, d, r, k + 4, KIND_RBF);
            uint32_t h0, l0, h1, l1;
            rts_split(x0, h0, l0);
            rts_split(x1, h1, l1);
            Bs[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                __uint_as_float(l0), __uint_as_float(l1));
            return;
        }
        const long long f = e - nb;
        const int i = (int)(f % per), c = (int)(f / per / passes);
        const int p = (int)(f / per % passes), gw = 8 * KT;
        if (KT < 8) {   // mma.sync's B fragments, rows permuted as above
            const int col = gw * p + 8 * ((i / 32) % KT) + lane / 4;
            const int row = c * KA_MC + 8 * (i / (32 * KT)) + 2 * (lane % 4);
            uint32_t h0, l0, h1, l1;
            rts_split(row < m && col < k ? __ldg(W + (size_t)row * k + col) : 0.0f,
                      h0, l0);
            rts_split(row + 1 < m && col < k
                          ? __ldg(W + (size_t)(row + 1) * k + col) : 0.0f,
                      h1, l1);
            Ws[f] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                __uint_as_float(l0), __uint_as_float(l1));
            return;
        }
        // wgmma: a 16-byte chunk of the hi (part 0) or lo (part 1) B tile
        const int part = i / (gw * 8), n = i / 8 % gw;
        const int q0 = 4 * ((i % 8) ^ (n % 8));   // the chunk's first k
        const int col = gw * p + n;
        uint32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int q = q0 + u, pk = q % 8;
            const int row = c * KA_MC + 8 * (q / 8)
                            + (pk < 4 ? 2 * pk : 2 * (pk - 4) + 1);
            uint32_t h, l;
            rts_split(row < m && col < k ? __ldg(W + (size_t)row * k + col) : 0.0f,
                      h, l);
            v[u] = part ? l : h;
        }
        Ws[f] = make_float4(__uint_as_float(v[0]), __uint_as_float(v[1]),
                            __uint_as_float(v[2]), __uint_as_float(v[3]));
        return;
    }
    const long long r = (e - nb - nw) / 32;   // a warp a row (nb, nw: x 32)
    if (r >= (long long)nch * KA_MC) return;
    float s = 0.0f;
    for (int k = lane; k < d; k += 32) {
        const float x = rts_at(Xm, shift, m, d, (int)r, k, KIND_RBF);
        s = fmaf(x, x, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) mnrm[r] = s;
}

// The cp.async of step (chunk c, slice dd) of pass p: flat 16-byte copies
// of the prepared fragments into Bm, and at the chunk's first slice of its
// W columns and norms into Wf and mn.
template <int KT>
__device__ __forceinline__ void ka_issue(float4* Bm, float4* Wf, float* mn,
                                         const float4* __restrict__ Bs,
                                         const float4* __restrict__ Ws,
                                         const float* __restrict__ mnrm,
                                         int c, int dd, int p, int nd,
                                         int passes, int tid) {
    constexpr int WF = KaCfg<KT>::WF;
    const float4* bsrc = Bs + ((size_t)c * nd + dd) * KA_BF;
    for (int e = tid; e < KA_BF; e += KA_THREADS)
        rts_cp_async(Bm + e, bsrc + e, 16, 16);
    if (dd == 0) {
        const float4* wsrc = Ws + ((size_t)c * passes + p) * WF;
        for (int e = tid; e < WF; e += KA_THREADS)
            rts_cp_async(Wf + e, wsrc + e, 16, 16);
        if (tid < KA_MC / 4)
            rts_cp_async(mn + 4 * tid, mnrm + c * KA_MC + 4 * tid, 16, 16);
    }
    rts_cp_commit();
}

template <int KT>
__global__ void __launch_bounds__(KA_THREADS, KT <= 2 ? 2 : 1)
kmeans_assign_kernel(const float* __restrict__ X, const float* __restrict__ s,
                     const float* __restrict__ shift,
                     const float4* __restrict__ Bs, const float4* __restrict__ Ws,
                     const float* __restrict__ mnrm,
                     float* __restrict__ scores, long long* __restrict__ assign,
                     int n, int m, int d, int k, int kp, float gamma) {
    using Cfg = KaCfg<KT>;
    constexpr int GW = Cfg::GW, NHALF = Cfg::NHALF, NH = Cfg::NH, WF = Cfg::WF;
    constexpr int NQ = Cfg::NQ;
    extern __shared__ unsigned char smem_raw[];
    float4* Ahi = (float4*)rts_smem_base(smem_raw);   // X slice, A fragments
    float4* Alo = Ahi + KA_AF;
    float4* Wf = Alo + KA_AF;                // 2 x W chunk (B tiles, 1 KB aligned)
    float4* Bm = Wf + 2 * WF;                // 2 x Xm slice, B fragments
    float* mnb = (float*)(Bm + 2 * KA_BF);   // 2 x (KA_MC,) Xm norms
    float* xp = mnb + 2 * KA_MC;             // (KA_WARPS, KA_ROWS) X norms
    float* sh = xp + KA_WARPS * KA_ROWS;     // (RTS_DC,) the slice's shift

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float c = gamma * 1.4426950408889634f, c2 = 2.0f * c;
    const int r0 = blockIdx.x * KA_ROWS, kp8 = rts_kp(d);
    const int nd = (kp8 + RTS_DC - 1) / RTS_DC;     // depth slices
    const int nch = (m + KA_MC - 1) / KA_MC, passes = kp / (8 * KT);
    const int steps = nch * nd;

    rts_stage_sh(sh, shift, d, 0, KIND_RBF);
    __syncthreads();
    // X's rows are split once (nd == 1) or a slice a step; their norms are
    // summed as the first chunk's slices are staged, into xp
    if (nd == 1)
        rts_stage_a64<KA_ROWS, KA_THREADS>(Ahi, Alo, xp, X, sh, n, d, r0, 0,
                                           true, tid);
    float xt[2] = {0.0f, 0.0f};   // the lane's rows' norm terms, from xp

    float best[2] = {INFINITY, INFINITY};
    int bidx[2] = {0, 0};
    for (int p = 0; p < passes; ++p) {
        const int g0 = 8 * KT * p;
        // a warp's 16 rows x GW scores: acc[4 j + e] is C fragment register
        // e of n8 block j (wgmma's register order; mma.sync's per block)
        float acc[4 * KT];
#pragma unroll
        for (int i = 0; i < 4 * KT; ++i) acc[i] = 0.0f;
        float sacc[1][4][4], ssmall[1][4][4];
        __syncthreads();   // the last pass's buffers are read
        if (steps > 0)
            ka_issue<KT>(Bm, Wf, mnb, Bs, Ws, mnrm, 0, 0, p, nd, passes, tid);
        for (int st = 0; st < steps; ++st) {
            // step st's slice in buffer st % 2; chunk ci's W and norms in
            // buffer ci % 2 (copied at its first slice)
            const int ci = st / nd, dd = st % nd, k0 = dd * RTS_DC;
            const int b = st % 2, wb = ci % 2;
            rts_cp_wait<0>();
            __syncthreads();   // the step has landed; the last one is read
            if (st + 1 < steps) {
                const int cn = (st + 1) / nd;
                ka_issue<KT>(Bm + (1 - b) * KA_BF, Wf + (cn % 2) * WF,
                             mnb + (cn % 2) * KA_MC, Bs, Ws, mnrm, cn,
                             (st + 1) % nd, p, nd, passes, tid);
            }
            if (nd > 1) {
                rts_stage_sh(sh, shift, d, k0, KIND_RBF);
                __syncthreads();
                rts_stage_a64<KA_ROWS, KA_THREADS>(
                    Ahi, Alo, p == 0 && ci == 0 ? xp : nullptr, X, sh, n, d,
                    r0, k0, dd == 0, tid);
                __syncthreads();
            }

            if (dd == 0) rts_zero(sacc, ssmall);
            const int ks = (kp8 - k0 < RTS_DC ? kp8 - k0 : RTS_DC) / 8;
            const float4* Bc = Bm + b * KA_BF;
#pragma unroll 1
            for (int ss = 0; ss < ks; ++ss) {
                uint32_t ahi[1][4], alo[1][4], bf[4][4];
                rts_load_a(ahi[0], alo[0], Ahi, Alo, warp, ss);
                rts_load_b<4>(bf, Bc, ss, 8);
                rts_mma3<1, 4>(sacc, ssmall, ahi, alo, bf);
            }
            if (dd != nd - 1) continue;
            if (p == 0 && ci == 0)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    xt[h] = rts_norm_term(
                        rts_norm_of(xp, KA_ROWS, KA_WARPS, 16 * warp + g + 8 * h),
                        KIND_RBF, c);
            rts_finish(sacc, ssmall);
            const float* mn = mnb + wb * KA_MC;
            const float4* Wc = Wf + wb * WF;
            // K = exp(-gamma |x - xm|^2) of the chunk in registers, fed back
            // as the A operand: n8 block j of S is k8 step j of K W
            uint32_t khi[KA_MC / 8][1][4], klo[KA_MC / 8][1][4];
#pragma unroll
            for (int j = 0; j < KA_MC / 8; ++j) {
                float kv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    kv[e] = rts_kval<KIND_RBF>(
                        sacc[0][j][e], xt[e / 2],
                        rts_norm_term(mn[8 * j + 2 * t + e % 2], KIND_RBF, c),
                        c2, gamma, 0, 0.0f);
                const float a[4] = {kv[0], kv[2], kv[1], kv[3]};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    rts_split(a[e], khi[j][0][e], klo[j][0][e]);
            }
            // K W; its small products are folded into acc once a chunk (a
            // rounded add: the tensor core's truncating sums stay short)
            if constexpr (Cfg::WG) {
                // on the warpgroup's 64 rows with wgmma (A, K, from
                // registers; B, W, from shared memory), NHALF columns a time
                const uint32_t whi = rts_smem_addr(Wc), wlo = whi + GW * 128;
#pragma unroll
                for (int h = 0; h < NH; ++h) {
                    float (&ah)[NHALF / 2] =
                        *reinterpret_cast<float (*)[NHALF / 2]>(acc + h * NHALF / 2);
                    float sm[NHALF / 2];
#pragma unroll
                    for (int i = 0; i < NHALF / 2; ++i) sm[i] = 0.0f;
                    rts_reg_fence(ah);
                    rts_reg_fence(sm);
                    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
                    for (int j = 0; j < KA_MC / 8; ++j) {
                        const uint32_t off = h * 64 * 128 + 32 * j;
                        RtsWgA<NHALF>::mma(sm, klo[j][0], rts_desc(whi + off), 1);
                        RtsWgA<NHALF>::mma(ah, khi[j][0], rts_desc(whi + off), 1);
                        RtsWgA<NHALF>::mma(sm, khi[j][0], rts_desc(wlo + off), 1);
                    }
                    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
                    rts_reg_fence(ah);
                    rts_reg_fence(sm);
#pragma unroll
                    for (int i = 0; i < NHALF / 2; ++i) ah[i] += sm[i];
                }
            } else {
                // a warp's own 16 rows with mma.sync, NQ n8 blocks a group
#pragma unroll
                for (int gq = 0; gq < KT / NQ; ++gq) {
                    float (&ag)[1][NQ][4] = *reinterpret_cast<float (*)[1][NQ][4]>(
                        acc + 4 * NQ * gq);
                    float sm[1][NQ][4];
#pragma unroll
                    for (int q = 0; q < NQ; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e) sm[0][q][e] = 0.0f;
#pragma unroll
                    for (int j = 0; j < KA_MC / 8; ++j) {
                        uint32_t bf[NQ][4];
                        rts_load_b<NQ>(bf, Wc + (j * KT + gq * NQ) * 32, 0, 1);
                        rts_mma3<1, NQ>(ag, sm, khi[j], klo[j], bf);
                    }
                    rts_finish(ag, sm);
                }
            }
        }

        // scores = -2 K W + s of rows g, g + 8 at columns 2t, 2t + 1 of each
        // n8 block, in increasing order for the argmin
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
            const int r = r0 + 16 * warp + g + 8 * rh;
#pragma unroll
            for (int jn = 0; jn < KT; ++jn) {
                const int col = g0 + 8 * jn + 2 * t;
                float v[2];
#pragma unroll
                for (int pp = 0; pp < 2; ++pp) {
                    v[pp] = col + pp < k ? -2.0f * acc[4 * jn + 2 * rh + pp]
                                               + __ldg(s + col + pp)
                                         : INFINITY;
                    if (v[pp] < best[rh]) {
                        best[rh] = v[pp];
                        bidx[rh] = col + pp;
                    }
                }
                if (r >= n) continue;
                float* o = scores + (size_t)r * k + col;
                if (k % 2 == 0 && col + 1 < k)
                    *(float2*)o = make_float2(v[0], v[1]);
                else
#pragma unroll
                    for (int pp = 0; pp < 2; ++pp)
                        if (col + pp < k) o[pp] = v[pp];
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float v = best[h];
        int ci = bidx[h];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int oc = __shfl_xor_sync(0xffffffffu, ci, off);
            if (ov < v || (ov == v && oc < ci)) {
                v = ov;
                ci = oc;
            }
        }
        const int r = r0 + 16 * warp + g + 8 * h;
        if (t == 0 && r < n) assign[r] = (long long)ci;
    }
}

static bool ka_attr[RT_MAX_DEVICES][5];   // a device's own (common.cuh)

// The scratch's layout, in float4 (Bs, Ws) and floats (the norms): the one
// place it is defined; the caller sizes its buffer with
// rt_kmeans_assign_scratch.
struct KaScratch {
    long long bs, ws, norms;
    KaScratch(int m, int d, int kp, int group) {
        const long long nch = (m + KA_MC - 1) / KA_MC;
        const long long nd = (rts_kp(d) + RTS_DC - 1) / RTS_DC;
        bs = nch * nd * KA_BF;
        ws = nch * (kp / (8 * group)) * (KA_MC / 8 * group * 32);
        norms = nch * KA_MC;
    }
    // at least one float4, so an empty Xm still gets a buffer
    long long floats() const {
        const long long f = 4 * (bs + ws) + norms;
        return f > 4 ? f : 4;
    }
};

template <int KT>
static int launch(int slot, const float* X, const float* Xm, const float* W,
                  const float* s, const float* shift, float* scratch,
                  float* scores, long long* assign, int n, int m, int d, int k,
                  int kp, float gamma, cudaStream_t stream) {
    int dev;
    const int derr = rt_device(&dev);
    if (derr) return derr;
    if (!ka_attr[dev][slot]) {
        cudaError_t err = cudaFuncSetAttribute(
            kmeans_assign_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            KaCfg<KT>::SMEM);
        if (err != cudaSuccess) return (int)err;
        ka_attr[dev][slot] = true;
    }
    const int nd = (rts_kp(d) + RTS_DC - 1) / RTS_DC;
    const int nch = (m + KA_MC - 1) / KA_MC;
    const KaScratch sc(m, d, kp, KT);
    float4* Bs = (float4*)scratch;
    float4* Ws = Bs + sc.bs;
    float* mnrm = (float*)(Ws + sc.ws);
    const long long items = sc.bs + sc.ws + 32LL * sc.norms;
    if (nch > 0) {
        kmeans_assign_prep<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
            Xm, W, shift, Bs, Ws, mnrm, m, d, k, kp, KT, nd, nch);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((n + KA_ROWS - 1) / KA_ROWS);
    kmeans_assign_kernel<KT><<<grid, KA_THREADS, KaCfg<KT>::SMEM, stream>>>(
        X, s, shift, Bs, Ws, mnrm, scores, assign, n, m, d, k, kp, gamma);
    return (int)cudaGetLastError();
}

// W is (m, k) and s (k,); the kernel pads the centres to kp, a multiple of
// 8 * group (group in 1, 2, 4, 8, 16 n8 blocks of score columns a pass),
// with zero W columns and s = +inf; shift (d,) is the mean of Xm's rows;
// scratch holds scratch_floats floats, 16-byte aligned, at least what
// rt_kmeans_assign_scratch gives; scores is (n, k), assign (n,).
static bool ka_group(int group) {
    return group == 1 || group == 2 || group == 4 || group == 8 || group == 16;
}

extern "C" int rt_kmeans_assign_scratch(int m, int d, int kp, int group,
                                        long long* floats) {
    if (m < 0 || d < 1 || !ka_group(group) || kp % (8 * group) != 0)
        return RTS_REFUSED;
    *floats = KaScratch(m, d, kp, group).floats();
    return 0;
}

extern "C" int rt_kmeans_assign(const float* X, const float* Xm,
                                const float* W, const float* s,
                                const float* shift, float* scratch,
                                long long scratch_floats, float* scores,
                                long long* assign, int n, int m, int d, int k,
                                int kp, int group, float gamma, void* stream) {
    if (n == 0) return 0;
    if (d < 1 || shift == nullptr || scratch == nullptr || !ka_group(group)
        || kp % (8 * group) != 0 || kp < k || ((uintptr_t)scratch & 15)
        || scratch_floats < KaScratch(m, d, kp, group).floats())
        return RTS_REFUSED;
    cudaStream_t st = (cudaStream_t)stream;
    switch (group) {
        case 1: return launch<1>(0, X, Xm, W, s, shift, scratch, scores, assign, n, m, d, k, kp, gamma, st);
        case 2: return launch<2>(1, X, Xm, W, s, shift, scratch, scores, assign, n, m, d, k, kp, gamma, st);
        case 4: return launch<4>(2, X, Xm, W, s, shift, scratch, scores, assign, n, m, d, k, kp, gamma, st);
        case 8: return launch<8>(3, X, Xm, W, s, shift, scratch, scores, assign, n, m, d, k, kp, gamma, st);
        case 16: return launch<16>(4, X, Xm, W, s, shift, scratch, scores, assign, n, m, d, k, kp, gamma, st);
        default: return RTS_REFUSED;
    }
}
