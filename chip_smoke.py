#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DC-SVM on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one GPU and the CUDA
toolkit.  It builds the hand-written kernels from src/repro_torch/kernels/
csrc/ with nvcc (into build/repro_torch_kernels/; bf16_gram.cu also as
its ring check build) and runs twelve phases (phases 11 and 12 run after
phase 4, phase 10 after phase 6, phases 8 and 9 before phase 7, 9(a)
before 8(b)):

1. environment: card, power limit, versions, kernel build time and each
   kernel's registers and spills (ptxas -v); TF32 off;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (kernel_matvec also at the n x n shape of the level-0
   gradient and the objective, the plain version over a row slice), and
   kernel_matvec and cd_column_update (B = 64 and 256) at webspam_like's
   d = 254 in their streamed forms: errors, kernel / plain / bound times;
   every SVM kernel runs split-TF32 on the tensor cores, so its bound is
   taken under that arithmetic (three TF32 products of the product depth a
   pair: d, or d + k for kmeans_assign), with the f32 CUDA-core bound
   beside it; kernel and plain version are both held to float64 (kermat
   2e-5 of 1 + |exact|, kmeans_assign 1e-4 absolute, the others 2e-4 of
   1 + |exact|), and kermat's K(X, X) must equal its transpose bit for
   bit; cd_column_update also at the other tasks' shapes: B = 2 (the
   rank-2 pair step), B = 512 (chunked) and the dedup route (epsilon-SVR's
   65,536 base rows at d = 10, y = 1); then the bf16 operand forms
   (compute_dtype="bfloat16", csrc/bf16_gram.cu): kermat at the level-4
   Grams (bit symmetric) and the early-scoring bucket, its predicated row
   form at (64, n) served and not, kernel_matvec at the bucket and n x n,
   cd_column_update at B = 64 and the dedup route, and the pack; each held
   to its plain version and to float64 on the same bf16-rounded operands
   (kermat at 2e-5 of 1 + |value|, the matvec forms at 2e-5 of 1 +
   sum_j |K_ij w_j|, where the f32 form on the unrounded operands and a
   form without its last Z stage must fail), with its bound (bf16 products
   at 989 TFLOP/s, one exp a pair, the bytes of d columns a row) and the
   bf16 torch.matmul of the products alone; the slice forms at d = 300,
   and kernel_matvec's slice form with X streamed under its ring at
   (16,384, 600)^2 (the plain version over its last 1,024 rows);
3. a fit through the kernels against a fit through the plain versions on
   the card, levels = 2, full_gram_threshold = 4096 (so level 0 takes the
   Gram-free engines), n = 8192, for C-SVC on covtype_like (d = 54, gamma
   1) and webspam_like (d = 254, gamma 0.5, C 8, tol 1e-5: the streamed
   forms), weighted C-SVC on gaussian_mixture_imbalanced, epsilon-SVR on
   friedman1 (dedup view; 1,024 rows, a cut from 8,192, with
   full_gram_threshold 1,024 for its dual of 2,048), one-class SVM at
   eq_block_size 1 and 64 and
   nu-SVC with bias at eq_block_size 128 (a 512-column rank-2B update;
   these two blocked fits on 4,096 rows, level 0 Gram-free above 2,048),
   and C-SVC on covtype_like with col_cache_cap 2048 and with
   compute_dtype="bfloat16" (the host_spill pair went for time: 9(b)
   holds the spill path against the in-memory fit, 10(b) its graphed
   panel step): same objective to 1e-4 relative, rho to 1e-4 of 1 + |rho|,
   the same predictions, the kernels of each level 0 launched by the
   kernel fit, a cached fit's hits + misses = iterations x 64; the first
   kernel fit again with DCSVMConfig(trace=4096): the same alphas bit for
   bit and the same launches, level 0's ring fetched into its stats, a
   sample an iteration;
4. the main path: binary C-SVC on covtype_like at the paper's covtype
   split (464,810 training points, 116,202 queries, d = 54), k = 4,
   levels = 4, m = 1000, C = 8, gamma = 1, the default 30,000 coordinate
   descent iterations a (sub)problem at most (level 0 replays its
   iteration as a CUDA graph), then exact and early (eq. 11) prediction,
   with the launch count of every kernel over that run (one
   cd_column_update a level-0 iteration); the
   early path through the kernels is held against its plain versions in
   float32 and float64 on the same queries; then kernel_matvec timed at
   decision_exact's shape (the test queries against the support vectors),
   the products alone (torch.matmul) beside it;
11. the distributed DC-SVM (core/distributed.py, launch/mesh.py) on
   phase 4's data: (a) the CE-PBM conquer at the split, one rank over
   NCCL, B = 64, warm-started from phase 4's refine alpha: up to 1,000
   rounds through the kernels, traced, whose objective never rises
   (the ring's, within 1e-5 of its size for f32 sums) and ends below the
   start, pg_max at the returned alpha, one kernel_matvec and one
   cd_column_update a round; ms a round eager (wall, 128 rounds) and the
   device's busy share (the profiler, 8 rounds); the first 64 rounds
   against the plain versions and the cached path (2,048 rows, 3.8 GB:
   hits + misses = rounds x 64), the same rounds, the objective to 1e-4
   relative; 200 rounds under compute_dtype="bfloat16" with the cache
   against its plain run (1e-4); (b) divide_step on 32 of phase 4's 256
   level-4 clusters at 5,000 iterations a cluster: bit for bit
   solve_box_qp on the same kermat Grams, and the first cluster bit for
   bit again alone (a gram_budget one byte short); (c) and (d) run
   beside (a)'s checks and (b), once (a) has timed its round: (c) two
   ranks on
   the card over gloo (torch.multiprocessing) on 4,096 covtype_like
   rows (gamma 1, C 8): the conquer from zero (tol 1e-3, 5,000 rounds at
   most) in both modes and fit_distributed at levels 2, k 4, each
   objective within 1e-3 of the port's dense solve_with_shrinking on the
   card (run meanwhile), the rounds at P = 2 printed; (d) train_svm
   --distributed under torch.distributed.run, two ranks over gloo,
   covtype_like n = 4,000;
12. the paper's comparison solvers (repro_torch.baselines) on phase 4's
   data, each printing its seconds, test accuracy (above the larger
   class's share), SV count and launches by kernel: (a) train_exact on
   the whole split, its Gram-free branch (the graphed level-0 engine, one
   cd_column_update an iteration), traced, the objective never rising,
   64 iterations from phase 4's refine alpha against the plain versions
   (objective, 1e-4 relative; where the objective still falls fast the
   paths part at near-ties of the top-B scores), decisions on every query, the first 4,096 held to the plain
   versions (2e-5 of 1 + sum_j |K_ij w_j|); (b) train_cascade at levels 3
   on 65,536 rows, survivors by level, the first leaf's Gram (kermat's
   2e-5) and solve (objective, 1e-4) against the plain versions; (c)
   LLSVM (128 landmarks; K_bb and K(X, landmarks) held at kermat's 2e-5)
   and RFF (512 features; no kernel launched) on the same rows; (d) LTPU
   (128 units) on the whole split, Phi held at 2e-5; (e) checkpoints:
   phase 4's callback also saves every level's alpha through
   ckpt.CheckpointManager, each step restored bit for bit against a copy,
   and train_svm --n 20000 --levels 3 --ckpt-dir runs beside (a)-(d): it
   exits 0, its manifest keeps the last 3 of its 4 steps, each alpha
   finite, in [0, C], one entry a training row;
5. serving phase 4's early model (level-1 alpha, level-1 partition): a
   round-trip export (every SV, BCM) served exact and early (all queries)
   and bcm (the first 16,384) through serve_batch in 4,096-row buckets,
   exact and early held to
   decision_exact and decision_early; the default export (4,096 SVs a
   cluster, BCM) served bcm and early; the request loop of each strategy
   (50 batches of 256, then a ragged bucketed stream); the serve CLI at
   its defaults; with the launch count of every kernel
   over the serving path; then kermat timed at the bucketed (k, cap, d) x
   (k, max_sv, d) shape of bucketed_cluster_scores on the default export,
   the products alone (torch.bmm) beside it;
   (b) the async engine (launch/engine.py) over the versioned registry
   (launch/registry.py): version 1 the default export, version 2 the
   round trip; warmup of buckets 8-256 for early and exact; a burst of 24
   mixed-size requests (both versions, both strategies) queued before the
   batch loop runs, each held bit for bit to a direct serve_batch of its
   merged bucket and, served alone, within 2e-5 of 1 + sum_j K |w_j| with
   the same predictions off a 1e-3 margin (how many also match alone bit
   for bit is printed); a Poisson run at the serve CLI's defaults
   (max_batch 256, 500 offered requests a second, sizes {1, 4, 16, 64} at
   p {0.35, 0.3, 0.25, 0.1}), 2,000 early requests with a hot swap to
   version 2 at the midpoint: every request delivered and served by the
   version it resolved (held to it as above, and off the other), version 1
   dropped after its drain, admitted p50/p95/p99, achieved requests and
   queries a second, mean batch fill and each kernel's launches; an
   overload (4 waves of 1,000 requests at once against max_queue_rows 512
   and 5 ms deadlines): shed and expired both above 0, every future
   resolved, the queue empty; no kernel library loaded after any warmup;
   the serve CLI with --serve-async at its defaults;
6. the solver loops' cost per step at the main path's shapes: wall time
   without the profiler, device time from torch.profiler, and their ratio,
   the device's busy share; the level-0 iteration graphed and eager;
10. the observability layer and the bf16 rings: (a) the bounded ring
   stress check (kernels/ring_stress.py: every bf16 form at its ring's
   edges, each launch bit for bit the first, then the matvec's Z ring
   under the ring check build: entry tags when full and at release, slot
   counts, also forced to 2 entries); (b) level 0's block CD, its cached
   bf16 branch, the pairwise and the blocked (B = 64) equality steps and
   the spill panel step on 4,096 covtype_like rows, traced, graphed
   against eager bit for bit (ring included), and untraced graphed with
   the same results and launches; (c) the cost of tracing a graphed
   level-0 iteration at phase 6's shape: device ms an iteration and
   device operations a replay from torch.profiler, untraced and traced;
8. (a) one-class SVM (nu 0.1, gamma 1, k 4, levels 4, eq_block_size 1) on
   the covtype_like training rows: level 0 runs the pairwise matvec engine
   (cd_column_update at B = 2 a pair step, kernel_matvec a refresh);
   seconds per level, launches per kernel, the nu-property, an early
   model's per-cluster rho_c and oneclass_early_gap_bound, the ocsvm
   export served exact and early against decision_exact and
   decision_early; (b) epsilon-SVR on friedman1 (65,536 x 10, eps 0.1, C
   4, gamma 1, 5,000 iterations a (sub)problem, a cut from 30,000):
   level 0 graphed over the dedup view; test MSE below the
   mean predictor's, the svr export served exact;
9. (a) phase 4's main path under compute_dtype="bfloat16" with a 4,096-row
   column cache (bf16, 3.8 GB), at phase 4's depth (30,000 iterations a
   (sub)problem), level 0 graphed with the cache inside the graph: exact
   and early accuracy within 0.01 of phase 4's, the f32
   objective of the bf16 alpha, the cache counters (hits + misses =
   iterations x 64), seconds a level, launches a kernel, and kernel_matvec's
   bf16 form at decision_exact's shape; (b) the spill tier:
   fit(host_spill=True) on 16,384 covtype_like rows (a cut of the split,
   whose f32 level-0 Gram of 864 GB no host holds) with gram_budget 256
   MiB (a quarter of the 1 GiB Gram a device slot, the host tier pinned):
   rounds, panels, counters, H2D GB/s, the share of the copies' time
   hidden behind the sub-solves, seconds and objective against the
   in-memory fit (1e-3 relative);
7. dense-LM serving (qwen1.5-0.5b at full width, bf16, random weights
   from seed 0): (a) the flash library's bf16 kernels hold wgmma (HGMMA)
   and TMA (UTMALDG) instructions in their SASS; the flash_attention
   kernel against its plain version (flash_attention_ref) on the card,
   causal, at each dense config's attention shape (B = 8, S = 2048) and,
   for qwen1.5's, at a ragged length and with a query offset, each in
   bfloat16 (within 2^-7 |o| + 2^-8 softmax(s).|v| + 1e-4 of the f32
   plain output o, elementwise: the kernel rounds p to bf16 before P.V;
   at qwen1.5's shape the mask one position off and no mask, both
   through the kernel, must exceed that bound) and float32 (within
   2e-5), with its bound and scaled_dot_product_attention's time as a
   yardstick (the kernels line's flash_attention row comes from here);
   (b) the main path: prefill of 8 x 2048 tokens through the kernel, then
   31 greedy decode steps, with the launch count of every kernel over each
   phase;
   the same prefill through the plain attention held to the kernel path
   on the last-position logits and every layer's prompt K/V, and two
   wrong attentions (no causal mask; the mask one position off) that the
   same comparison must refuse; a profile of the prefill; (c) the port's
   serve CLI at its defaults (batch 4, prompt 32, gen 16).

Any failed check raises, and the script exits non-zero without printing a
result.  The last line is {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
DEV = "cuda"
N_TRAIN, N_TEST = 464_810, 116_202      # the paper's covtype split
# CD iterations a (sub)problem on phase 4's main path and on 9(a), which
# is compared with it: the default.  (At 15,000 the bf16 fit's early model,
# from under-converged level-1 solves, read 0.9684 against the f32 fit's
# 0.9786 on an H100, past the 0.01 that 9(a) holds them to.)
MAIN_ITERS = 30_000
GRAM_BUDGET = 16 * 2 ** 30              # bytes for a level's cluster Grams
FIT_N, FIT_N_TEST = 8192, 2048          # phase 3
FIT_FULL_GRAM = 4096                    # phase 3: level 0 Gram-free above it
# phase 3's blocked equality fits (one-class at eq_block_size 64, nu-SVC
# with bias at 128) on FIT_N_EQ rows, level 0 Gram-free above
# FIT_FULL_GRAM_EQ: cut from 8,192 rows (50.6 s and 76.6 s a pair on an
# NVIDIA H100 80GB HBM3 at 700 W, most of it their sub-QPs' sequential
# pair steps; the smoke read 1,176.0 s with phase 12); 10(b) holds the
# blocked step graphed against eager
FIT_N_EQ, FIT_FULL_GRAM_EQ = 4096, 2048
ACC_FLOOR = 0.75                        # least exact and early test accuracy
EARLY_CHECK_N = 2048                    # queries in the early kernel-vs-plain check
EARLY_TOL = 2e-5                        # of 1 + sum_j K(x, x_j) |beta_j|
PEAK_F32_FLOPS = 67e12                  # H100 SXM, f32 without tensor cores
PEAK_BF16_FLOPS = 989e12                # H100 SXM, dense bf16 tensor cores
PEAK_TF32_FLOPS = 495e12                # H100 SXM, dense TF32 tensor cores
PEAK_EX2 = 16 * 132 * 1.98e9            # MUFU exp2 a second (16 a clock an SM)
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
NXN_ROWS = 1024                         # rows of the n x n plain check
F64_ROWS = 512                          # rows of the float64 checks
N_WEB = 464_810                         # webspam_like rows of phase 2's d = 254 rows
WEB_NXN = 32_768                        # of them, kernel_matvec's X = Z at d = 254
WEB_GAMMA, WEB_C = 0.5, 8.0             # benchmarks/common.py's webspam_like
# phase 3's webspam fit: at gamma 0.5 K is near the identity and level 0
# starts within the default tol (1e-3), running no iteration; at 1e-5 (as
# tests/test_torch_fit.py runs) it takes the block CD
WEB_TOL = 1e-5
KERMAT_TOL = 2e-5                       # of 1 + |exact| (test_kernels_pallas.py)
# the bf16 matvec forms (kernel_matvec, cd_column_update): of 1 + sum_j
# |K_ij w_j|, the measure and limit of the f32 early decisions (EARLY_TOL).
# On an H100 they read 2.2e-7 to 9.0e-7 (cd_column_update at B = 64, whose
# sum has 64 terms, 6.2e-6); the f32 form on the unrounded operands and a
# form without its last Z stage must fail it (controls, bf16_case)
MV_BF16_TOL = EARLY_TOL
# Z rows a ring entry of the bf16 matvec form (the one-slice form's; the
# wide form's are 32, so there the control drops two)
MV_STAGE = 64
# phase 2's slice forms of the bf16 kernels (rows wider than one staged
# slice): WIDE_D uniform columns, kermat and kernel_matvec on WIDE_N rows,
# cd_column_update on all N_TRAIN at B = 64; gamma puts K near 1/e at the
# rows' mean squared distance (WIDE_D / 6)
WIDE_D, WIDE_N = 300, 32_768
WIDE_GAMMA = 6.0 / WIDE_D
# phase 8: one-class SVM on the covtype_like training rows (OC_N of them)
# and epsilon-SVR on friedman1 at its published d = 10, at
# benchmarks/bench_svr.py's eps 0.1, C 4, gamma 1.  OC_N is cut from the
# 464,810 rows: there the level-1 solves leave 201,810 points with alpha > 0
# (the warm start's projection onto each cluster's sum shifts every
# coordinate), and the refine pass's dense Gram over them needs 152 GiB; at
# 131,072 rows it fits even if every point stays a support vector
OC_N, OC_NU = 131_072, 0.1
OC_NU_SLACK = 0.01                      # outlier fraction <= nu + this
OC_GAP_QUERIES = 256                    # queries of the gap-bound check
OC_SIGMA_N = 1e-6                       # sigma_n given to the gap bound
SVR_N, SVR_N_TEST, SVR_D = 65_536, 16_384, 10
SVR_EPS, SVR_C = 0.1, 4.0
SVR_PRED_TOL = 1e-2                     # phase 3: kernel vs plain SVR predictions
# phase 8(b)'s SVR fit at 5,000 CD iterations a (sub)problem, cut from the
# default 30,000 to keep the smoke inside its time limit with phase 9 (its
# level 0 ran to the cap, about 2 ms an iteration), and from 10,000 when
# phase 5(b) came (the whole smoke read 1,147.5 s on a slow host).  Phase 3's SVR fit keeps
# 30,000 (at 10,000 its kernel and plain fits stopped 2e-4 apart in
# objective) and is cut in scale instead, to FIT_N_SVR rows with level 0
# Gram-free above FIT_FULL_GRAM_SVR, so it runs the kernels (at 8,192 rows
# its level 0 took 28,841-30,000 iterations, 155 s for the pair; at
# 4,096, 17,621-18,578 and 104.5 s, with the whole smoke at 1,181 s of its
# 1,200; at 3,072, 13,005-13,392 and 80.2 s, the smoke at 1,176.0 s with
# phase 12, on an NVIDIA H100 80GB HBM3 at 700 W; 8(b) holds SVR at full
# width)
SVR_ITERS = 5_000
FIT_N_SVR, FIT_FULL_GRAM_SVR = 1024, 1024
PRED_MARGIN = 1e-3                      # phase 3: labels compared off |f| < this
SVM_KERNELS = ("kermat", "kernel_matvec", "cd_column_update", "kmeans_assign")
SOURCES = {"kermat": ("src/repro_torch/kernels/csrc/kermat.cu",
                      "src/repro/kernels/kermat.py:75"),
           "kernel_matvec": ("src/repro_torch/kernels/csrc/kermatvec.cu",
                             "src/repro/kernels/kermatvec.py:80"),
           "cd_column_update": ("src/repro_torch/kernels/csrc/cd_update.cu",
                                "src/repro/kernels/cd_update.py:78"),
           "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                             "src/repro/kernels/kmeans_assign.py:58"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:83")}
# the bf16 operand forms (csrc/bf16_gram.cu), rows of their own in the
# kernels line beside the f32 forms they share a TPU kernel with
BF16_SOURCES = {
    "kermat_bf16": ("src/repro/kernels/kermat.py:27-33 (the compute_dtype "
                    "branch of kermat, pl.pallas_call at :75)"),
    "kernel_matvec_bf16": ("src/repro/kernels/kermatvec.py:37-41 (the "
                           "compute_dtype branch of kernel_matvec, :80)"),
    "cd_column_update_bf16": ("src/repro/kernels/cd_update.py:33-37 (the "
                              "compute_dtype branch of cd_column_update, "
                              ":78)"),
    "bf16_pack": ("the operand casts of the three compute_dtype branches "
                  "(kermat.py:27-33, kermatvec.py:37-41, cd_update.py:33-37)"),
}
BF16_CACHE = 4096                       # phase 9(a): column-cache rows (bf16)
# phase 9(b): the spill tier on SPILL_N covtype_like rows (a cut of the
# 464,810-row split, whose f32 level-0 Gram of 864 GB no host holds): the
# Gram is 1 GiB, the device budget a quarter of it (65,536 rows until the
# whole smoke ran 1,181-1,260 s of its 1,200 on some hosts, then 32,768
# until it ran 1,217.9 s on a slow host with phase 10; the phase took
# 87-105 s of it)
SPILL_N, SPILL_N_TEST = 16_384, 8_192
SPILL_BUDGET = SPILL_N * SPILL_N   # bytes: a quarter of the f32 Gram
PHASE3_CACHE = 2048                     # phase 3's cached fit
FIT_TRACE = 4096                        # phase 3: level 0's ring a class
# phase 2: kernel_matvec_bf16's slice form with X streamed under its ring
# (packed rows past 384 columns), uniform rows, gamma 6 / XS_D
XS_D, XS_N = 600, 16_384
# phase 10: the ring stress check's launches a form (and under the check
# build), the traced engines' rows, the iterations of the tracing cost (12
# replays a turn, 24 before phase 5(b) came)
RING_LAUNCHES, RING_CHECK_LAUNCHES = 300, 50
TRACE_N = 4096
TRACE_COST_ITERS = 12
MAIN: dict = {}                         # phase 4's numbers, for phase 9(a)
# phase 11, the distributed DC-SVM: (a) the conquer at the split, one rank
# over NCCL, B = 64, warm-started from phase 4's refine alpha, up to
# DIST_ROUNDS rounds (traced, its objective never rising), the first
# DIST_HOLD against the plain versions, the cached path (DIST_CACHE rows of
# 464,810 f32, 3.8 GB), bf16 with the cache over DIST_BF16_ROUNDS, ms a
# round over DIST_TIMED rounds (the profiler over DIST_PROF);
# (b) divide_step on DIST_CLUSTERS of phase 4's level-4 clusters at
# DIST_DIVIDE_ITERS iterations a cluster, the sequential sweep on the first
# DIST_SEQ_CLUSTERS (cuts: 32 of 256 clusters, 5,000 of 30,000 iterations,
# 1 of them one at a time: 2.1 s a cluster eager); (c) two ranks on the one card over gloo on
# DIST_P2_N covtype_like rows (a cut of the split: 16,384 rows took 101 s,
# D5, 13 ms a parallel round), gamma 1, C 8, the
# conquer from zero at tol 1e-3 and fit_distributed at levels 2, k 4, each
# objective within 1e-3 of the dense solve; (d) the train CLI under
# torch.distributed.run, two ranks over gloo, n = DIST_CLI_N
DIST_ROUNDS, DIST_HOLD, DIST_B = 1000, 64, 64
DIST_CACHE, DIST_BF16_ROUNDS, DIST_TIMED = 2048, 200, 128
DIST_PROF = 8                            # 11(a)'s profiled rounds
DIST_CLUSTERS, DIST_DIVIDE_ITERS = 32, 5000
DIST_SEQ_CLUSTERS = 1                    # of them, solved one at a time
DIST_P2_N, DIST_P2_ROUNDS, DIST_P2_TOL = 4096, 5000, 1e-3
DIST_CLI_N = 4000
DIST_GRAD_CHUNKS = 2048                  # the plain initial gradient's rows
DIST_RISE = 1e-5                         # of |objective|: f32 ring noise
# 11(a)'s runs against the kernels' over the same rounds, relative
# objective.  The paths can part at f32 near-ties of the top-B scores
# among 464,810: from phase 4's refine alpha plain, cached and bf16 read
# 4.2e-6, 7.9e-8 and 3.8e-5 (D9); from a 2,000-iteration fit's, the plain
# path parted at round 0 (its initial gradient's sums) and the cached one
# at round 19 (kermat's rows, no mean shift): 9.0e-5, 2.7e-4, 6.4e-4
DIST_PATH_TOL = 1e-4
# phase 12, the comparison solvers on phase 4's split: (a) train_exact on
# all 464,810 rows (its Gram-free branch) capped at CMP_EXACT_ITERS
# iterations (cut from its default 300,000; about 2 ms an iteration),
# CMP_HOLD from phase 4's refine alpha against the plain versions, decisions on every query, the
# first CMP_DEC_CHECK held to the plain versions; (b) train_cascade at
# CMP_CASCADE_LEVELS levels on the first CMP_N rows (8 leaves of 8,192, a
# 268 MB Gram each), each solve capped at CMP_CASCADE_ITERS (cut from
# 100,000: the eager greedy CD takes 0.2-0.35 ms a step); (c) LLSVM
# (CMP_LANDMARKS landmarks) and RFF (CMP_FEATURES features) on the same
# CMP_N rows (their dual Q is n x n: 17 GB here, 864 GB at the split),
# the block CD capped at CMP_BLOCK_ITERS outer iterations (cut from
# 200,000: about 1,300 eager launches each); (d) LTPU (CMP_UNITS units)
# on the whole split; (e) train_svm --ckpt-dir at n = CMP_CLI_N, levels
# CMP_CLI_LEVELS, in the background
CMP_EXACT_ITERS, CMP_HOLD, CMP_DEC_CHECK = 2000, 64, 4096
CMP_N, CMP_CASCADE_LEVELS, CMP_CASCADE_ITERS = 65_536, 3, 5000
CMP_LANDMARKS, CMP_FEATURES, CMP_UNITS = 128, 512, 128
CMP_BLOCK_ITERS = 300
CMP_CLI_N, CMP_CLI_LEVELS = 20_000, 3
ASSIGN_TOL = 1e-4                       # kmeans_assign scores (absolute)
ASSIGN_TIE = 2e-4                       # gap below which an argmin may differ
SERVE_BUCKET = 4096                     # query rows a serving call
SERVE_LOOP = (50, 256)                  # the serve CLI's request loop
SERVE_STRATEGIES = ("exact", "early", "bcm")
# the serve CLI runs at its defaults (early) once; it ran once a strategy
# (three processes, 53 s) before phase 5(b) and its --serve-async run came
BCM_CHECK_N = 4 * SERVE_BUCKET          # queries of the every-SV bcm check
# phase 5(b): the async engine at the serve CLI's defaults (max_batch 256,
# 500 offered requests a second, sizes {1, 4, 16, 64} at p {0.35, 0.3,
# 0.25, 0.1}), a burst of mixed sizes, then an overload of ENGINE_WAVES
# waves of requests all at once against a 512-row queue and 5 ms deadlines
ENGINE_NAME = "covtype"
ENGINE_BATCH = 256
ENGINE_QPS = 500.0
ENGINE_REQUESTS = 2000
ENGINE_SIZES = ((1, 4, 16, 64), (0.35, 0.3, 0.25, 0.1))
ENGINE_BURST = (1, 4, 16, 64, 3, 7, 100, 33, 250, 12, 64, 1, 16, 4, 200, 9,
                64, 64, 64, 64, 2, 130, 5, 40)
ENGINE_WAVES = (4, 1000, 0.02)           # waves, requests a wave, seconds apart
OVERLOAD_QUEUE, OVERLOAD_TIMEOUT = 512, 5e-3
LM_ARCH = "qwen1.5-0.5b"                # phase 7's model, full width
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32   # 31 decode steps after prefill
# (arch, Hq, Hkv, hd) of the dense configs' attention
LM_ATTN = (("qwen1.5-0.5b", 16, 16, 64), ("qwen3-8b", 32, 8, 128),
           ("yi-6b", 32, 4, 128), ("gemma-2b", 8, 1, 256))
FLASH_F32_TOL = 2e-5    # absolute, float32 (tests/test_flash_attention.py)
# bfloat16, elementwise against the f32 plain output o: the kernel rounds p
# and its output to bf16 (u = 2^-8), so |err| <= 2^-7 |o| + 2^-8
# softmax(s).|v| + 1e-4 (kernels.ref.flash_bf16_share)
FLASH_BF16_TOL_TEXT = "|err| <= 2^-7 |plain| + 2^-8 softmax(s).|v| + 1e-4"
# op-level wrong attentions that bound must refuse, at qwen1.5's shape: the
# causal mask one position off (each query sees one key more) and none
FLASH_CONTROLS = (("mask off by one", dict(q_offset=1)),
                  ("non-causal", dict(causal=False)))
LM_LOGIT_TOL = 5e-2     # kernel vs plain prefill logits, of max |plain logit|
LM_KV_TOL = 5e-2        # kernel vs plain prompt K/V, of max |plain K/V|
# wrong attentions the comparison must refuse: no causal mask, and each
# query missing its own key (the mask one position off)
LM_CONTROLS = (("non-causal", {"causal": False}),
               ("mask off by one", {"q_offset": -1}))


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured into one CUDA
    graph and replayed: the launches run back to back with no host time
    between them, as inside the level-0 graph (``cuda_ms`` of a short
    kernel measures the wrapper's host time instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def split_bound(pairs: float, depth: int, nbytes: float):
    """The least time of a split-TF32 kernel (csrc/rbf_tile.cuh) at 700 W:
    three TF32 products of the product depth a pair on the tensor cores (d;
    d + k for kmeans_assign's two products), one MUFU exp2 a pair, the
    bytes once.  (ms, "bytes" or "operations", what bounds it)."""
    times = {"split-TF32 products": 3 * 2 * depth * pairs / PEAK_TF32_FLOPS,
             "MUFU exps": pairs / PEAK_EX2, "bytes": nbytes / PEAK_BYTES}
    detail = max(times, key=times.get)
    return (times[detail] * 1e3, "bytes" if detail == "bytes"
            else "operations", detail)


def rbf_f64(A, B, gamma):
    """K(A, B) in float64 (the Gram expansion, unshifted): the yardstick of
    the float64 checks."""
    A, B = A.double(), B.double()
    sq = (A * A).sum(-1)[..., :, None] + (B * B).sum(-1)[..., None, :] \
        - 2 * A @ B.mT
    return (-gamma * sq.clamp(min=0.0)).exp()


def phase_kernels(torch, Xtr, Xq_test, cfg_main, k_leaves, Xw, Xf):
    """Phase 2: each kernel against its plain version at main-path shapes,
    the split kernels' streamed forms on webspam rows (Xw, d = 254), and
    cd_column_update at the shapes the other tasks give it: B = 2 (the
    rank-2 pair step of phase 8's one-class level 0), B = 512 (chunked, two
    launches) and the dedup route at epsilon-SVR's base rows (Xf, friedman1,
    d = 10: all-ones y, B = 64)."""
    from repro_torch.core import Kernel
    from repro_torch.core.predict import early_capacity
    from repro_torch.kernels import ops, ref

    kern = cfg_main.kernel
    rkw = dict(kind=kern.kind, gamma=kern.gamma, degree=kern.degree,
               coef0=kern.coef0)
    d = Xtr.shape[1]
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    # level-l_max cluster Grams: k^l_max clusters of ceil(n / k^l_max)
    n = Xtr.shape[0]

    def rows_of(count, width):      # real training rows, wrapped at n
        idx = torch.arange(count * width, device=DEV) % n
        return Xtr[idx].reshape(count, width, d).contiguous()

    nc = -(-n // k_leaves)
    b = min(k_leaves, cfg_main.gram_budget // (nc * nc * 4))
    Xc = rows_of(b, nc)
    # early scoring (eq. 11 on the level-1 partition): the test queries
    # bucketed per cluster, scored against the cluster's members
    k1 = cfg_main.k
    nc1 = -(-n // k1)
    cap = early_capacity(N_TEST, k1)
    Q = rows_of(k1, cap).flip(0).contiguous()
    M = rows_of(k1, nc1)
    v = torch.randn(k1, nc1, device=DEV, generator=gen)
    # the plain versions materialise K: run them over row blocks of Q
    # (rows are independent) of about 1 GiB each
    blk = max(1, 2 ** 28 // (k1 * nc1))

    def plain_matvec():
        return torch.cat([ref.kernel_matvec_ref(Q[:, r:r + blk], M, v, **rkw)
                          for r in range(0, cap, blk)], dim=1)

    def matmul_matvec():
        for r in range(0, cap, blk):
            torch.bmm(Q[:, r:r + blk], M.transpose(1, 2))
    # the level-0 gradient and the objective: K(X, X) @ v over all n points;
    # the plain version over the first NXN_ROWS rows
    vn = torch.randn(n, device=DEV, generator=gen)
    # level-0 rank-64 update over all n points
    B = 64
    ys = torch.where(torch.rand(Xtr.shape[0], device=DEV,
                                generator=gen) < 0.5, -1.0, 1.0)
    w = torch.randn(B, device=DEV, generator=gen)
    Xb = Xtr[:B].contiguous()
    f_pair = 2 * d + 5            # dot product + RBF epilogue per K entry
    g = kern.gamma
    # webspam rows (d = 254): kernel_matvec with X = Z, cd_column_update
    # over all N_WEB rows at B = 64 and 256 (Xb among them, as in a fit)
    wk = Kernel("rbf", gamma=WEB_GAMMA)
    wkw = dict(kind="rbf", gamma=WEB_GAMMA)
    dw = Xw.shape[1]
    Xwn = Xw[:WEB_NXN]
    vw = torch.randn(WEB_NXN, device=DEV, generator=gen)
    yw = torch.where(torch.rand(N_WEB, device=DEV, generator=gen) < 0.5,
                     -1.0, 1.0)
    ww = torch.randn(256, device=DEV, generator=gen)
    fw_pair = 2 * dw + 5
    pairs_sym = b * nc * (nc + 1) // 2     # kermat computes K(X, X)'s upper half

    def cd_web(Bw):
        Xbw = Xw[:Bw].contiguous()
        return dict(
            run=lambda: ops.cd_column_update(Xw, yw, Xbw, ww[:Bw], wk),
            plain=lambda: ref.cd_column_update_ref(Xw, yw, Xbw, ww[:Bw], **wkw),
            matmul=lambda: Xw @ Xbw.T,
            flops=N_WEB * Bw * (fw_pair + 2),
            bytes=4 * (N_WEB * (dw + 2) + Bw * (dw + 1)),
            pairs=N_WEB * Bw, depth=dw,
            f64=lambda got, want: (got, want, yw.double() * (
                rbf_f64(Xw, Xbw, WEB_GAMMA) @ ww[:Bw].double())),
            tol=2e-4, reps=10, shape=f"webspam ({N_WEB}, {dw}) x ({Bw}, {dw}), "
                                     f"plan {ops.split_tile_plan(dw, Bw)}")

    def cd_case(Xa, ya, Xs, ws, gamma_, reps, shape):
        kern_ = Kernel("rbf", gamma=gamma_)
        na, da = Xa.shape
        Bs = Xs.shape[0]
        return dict(
            run=lambda: ops.cd_column_update(Xa, ya, Xs, ws, kern_),
            plain=lambda: ref.cd_column_update_ref(Xa, ya, Xs, ws, kind="rbf",
                                                   gamma=gamma_),
            matmul=lambda: Xa @ Xs.T,
            flops=na * Bs * (2 * da + 7),
            bytes=4 * (na * (da + 2) + Bs * (da + 1)),
            pairs=na * Bs, depth=da,
            f64=lambda got, want: (got, want, ya.double() * (
                rbf_f64(Xa, Xs, gamma_) @ ws.double())),
            tol=2e-4, reps=reps,
            shape=f"{shape} ({na}, {da}) x ({Bs}, {da}), "
                  f"{len(ops.cd_chunks(Bs))} launch(es) of "
                  f"{[b - a for a, b in ops.cd_chunks(Bs)]} columns")

    ones_f = torch.ones(Xf.shape[0], device=DEV)
    cases = {
        "kermat": dict(
            run=lambda: ops.kernel_matrix(Xc, Xc, kern),
            plain=lambda: ref.kermat_ref(Xc, Xc, **rkw),
            matmul=lambda: torch.bmm(Xc, Xc.transpose(1, 2)),
            flops=b * nc * nc * f_pair,
            bytes=4 * (b * nc * d + b * nc * nc),   # Xc read once
            pairs=pairs_sym, depth=d,
            f64=lambda got, want: (got[:2, :F64_ROWS], want[:2, :F64_ROWS],
                                   torch.stack([rbf_f64(Xc[i, :F64_ROWS],
                                                        Xc[i], g)
                                                for i in range(2)])),
            symmetric=True,
            tol=KERMAT_TOL, reps=5,
            shape=f"({b}, {nc}, {d}) x ({b}, {nc}, {d}), K(X, X)"),
        "kernel_matvec": dict(
            run=lambda: ops.kernel_matvec(Q, M, v, kern),
            plain=plain_matvec, matmul=matmul_matvec,
            flops=k1 * cap * nc1 * (f_pair + 2),
            bytes=4 * (k1 * (cap + nc1) * d + k1 * (nc1 + cap)),
            pairs=k1 * cap * nc1, depth=d,
            f64=lambda got, want: (got[:, :F64_ROWS], want[:, :F64_ROWS],
                                   torch.stack([rbf_f64(Q[i, :F64_ROWS], M[i],
                                                        g) @ v[i].double()
                                                for i in range(k1)])),
            tol=2e-4, reps=5,
            shape=f"({k1}, {cap}, {d}) x ({k1}, {nc1}, {d})"),
        "kernel_matvec_nxn": dict(
            run=lambda: ops.kernel_matvec(Xtr, Xtr, vn, kern),
            plain=lambda: ref.kernel_matvec_ref(Xtr[:NXN_ROWS], Xtr, vn,
                                                **rkw),
            matmul=lambda: Xtr[:NXN_ROWS] @ Xtr.T,
            flops=n * n * (f_pair + 2), bytes=4 * (n * d + 2 * n),
            pairs=n * n, depth=d, rows=NXN_ROWS,
            f64=lambda got, want: (got[:F64_ROWS], want[:F64_ROWS],
                                   rbf_f64(Xtr[:F64_ROWS], Xtr, g)
                                   @ vn.double()),
            tol=2e-4, reps=2, shape=f"({n}, {d}) x ({n}, {d}), plain over "
                                    f"the first {NXN_ROWS} rows"),
        "cd_column_update": dict(
            run=lambda: ops.cd_column_update(Xtr, ys, Xb, w, kern),
            plain=lambda: ref.cd_column_update_ref(Xtr, ys, Xb, w, **rkw),
            matmul=lambda: Xtr @ Xb.T,
            flops=Xtr.shape[0] * B * (f_pair + 2),
            bytes=4 * (Xtr.shape[0] * (d + 2) + B * (d + 1)),
            pairs=Xtr.shape[0] * B, depth=d,
            f64=lambda got, want: (got, want, ys.double() * (
                rbf_f64(Xtr, Xb, g) @ w.double())),
            tol=2e-4, reps=20, shape=f"({Xtr.shape[0]}, {d}) x ({B}, {d})"),
        "kernel_matvec_d254": dict(
            run=lambda: ops.kernel_matvec(Xwn, Xwn, vw, wk),
            plain=lambda: ref.kernel_matvec_ref(Xwn[:NXN_ROWS], Xwn, vw, **wkw),
            matmul=lambda: Xwn[:NXN_ROWS] @ Xwn.T,
            flops=WEB_NXN * WEB_NXN * (fw_pair + 2),
            bytes=4 * (WEB_NXN * dw + 2 * WEB_NXN),
            pairs=WEB_NXN * WEB_NXN, depth=dw, rows=NXN_ROWS,
            f64=lambda got, want: (got[:F64_ROWS], want[:F64_ROWS],
                                   rbf_f64(Xwn[:F64_ROWS], Xwn, WEB_GAMMA)
                                   @ vw.double()),
            tol=2e-4, reps=3,
            shape=f"webspam ({WEB_NXN}, {dw}) x ({WEB_NXN}, {dw}), plain over "
                  f"the first {NXN_ROWS} rows, plan {ops.split_tile_plan(dw)}"),
        "cd_column_update_d254_b64": cd_web(64),
        "cd_column_update_d254_b256": cd_web(256),
        "cd_column_update_b2": cd_case(
            Xtr, ys, Xtr[:2].contiguous(), w[:2].contiguous(), g, 50,
            "rank-2 pair step"),
        "cd_column_update_b512": cd_case(
            Xtr, ys, Xtr[:512].contiguous(),
            torch.randn(512, device=DEV, generator=gen), g, 10,
            "rank-2B, 512 columns"),
        "cd_column_update_dedup": cd_case(
            Xf, ones_f, Xf[:64].contiguous(), w, 1.0, 50,
            "dedup route, epsilon-SVR base rows, y = 1,"),
    }
    rows = {}
    for name, c in cases.items():
        got = c["run"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        r = c.get("rows")
        diff = ((got[:r] if r else got) - want).abs()
        err = float(diff.max())
        # the reference's parity form: |got - want| <= tol + tol * |want|
        rel = float((diff / (1.0 + want.abs())).max())
        # the split-TF32 kernels shift their operands (kermat's plain
        # version does not): kernel and plain version are both held to
        # float64 (unshifted), same form and tolerance, and either failing
        # fails the run
        mine, plain_part, exact = c["f64"](got, want)
        f64 = {who: float(((val.double() - exact).abs()
                           / (1.0 + exact.abs())).max())
               for who, val in (("kernel", mine), ("plain", plain_part))}
        extra = (f" err_vs_f64={f64['kernel']:.3e} plain_err_vs_f64="
                 f"{f64['plain']:.3e} (on {tuple(mine.shape)})")
        sym = None
        if c.get("symmetric"):
            sym = bool(torch.equal(got, got.transpose(-1, -2)))
            extra += f" bitwise_symmetric={sym}"
        del got, want, diff, mine, plain_part, exact
        torch.cuda.empty_cache()
        ms = cuda_ms(torch, c["run"], c["reps"])
        plain_ms = cuda_ms(torch, c["plain"], max(2, c["reps"] // 2))
        mm_ms = cuda_ms(torch, c["matmul"], c["reps"])
        bound_f32, _ = bound(c["flops"], c["bytes"])
        sb, sby, detail = split_bound(c["pairs"], c["depth"], c["bytes"])
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=sb, bound_by=sby, bound_detail=detail,
                   bound_f32_ms=bound_f32, matmul_ms=mm_ms,
                   max_err_over_1_plus_abs_plain=rel,
                   err_vs_f64=f64["kernel"], plain_err_vs_f64=f64["plain"])
        if sym is not None:
            row["bitwise_symmetric"] = sym
        log(f"kernel {name} {c['shape']}: max_abs_err={err:.3e} "
            f"max_err_over_1_plus_abs_plain={rel:.3e} (tolerance "
            f"{c['tol']:.0e}){extra} kernel_ms={ms:.4f} plain_ms="
            f"{plain_ms:.4f} bound_ms={sb:.4f} ({detail}) bound_f32_ms="
            f"{bound_f32:.4f} share_of_bound={sb / ms:.4f} "
            f"library_ms(torch.matmul, Gram product only)={mm_ms:.4f}")
        if not rel <= c["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rel} > {c['tol']}")
        for who, e in f64.items():
            if not e <= c["tol"]:
                raise AssertionError(f"{name}: the {who} disagrees with "
                                     f"float64: {e} > {c['tol']}")
        if sym is False:
            raise AssertionError(f"{name}: K(X, X) is not symmetric bit for "
                                 "bit")
        rows[name] = row
        torch.cuda.empty_cache()
    # kmeans_assign at the level-l_max assignment (all n points against the
    # m-point sample, k^l_max centres) and at the eq.-11 routing of the test
    # queries (k centres); centres from kernel k-means on the sample
    shapes = {"level": (Xtr, k_leaves), "routing": (Xq_test, k1)}
    for which, (Xa, k) in shapes.items():
        rows["kmeans_assign" if which == "level" else "kmeans_assign_routing"] \
            = assign_case(torch, Xa, Xtr, k, kern, cfg_main.m)
    return rows


def assign_case(torch, Xa, Xtr, k, kern, m):
    """``kmeans_assign`` against its plain version on one shape: scores to
    ASSIGN_TOL, assignments equal except where the plain version's two best
    scores lie within ASSIGN_TIE; kernel and plain scores both held to
    float64 on the first F64_ROWS rows."""
    from repro_torch.core.kkmeans import kernel_kmeans
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(SEED)
    sample = torch.randperm(Xtr.shape[0], generator=gen)[:m].to(DEV)
    Xm = Xtr[sample].contiguous()
    Kmm = ref.kermat_ref(Xm, Xm, gamma=kern.gamma)
    _, W, s = kernel_kmeans(Kmm, k, torch.randperm(m, generator=gen))
    W = W.contiguous()
    s = torch.where(W.sum(0) <= 0, torch.inf, s).contiguous()
    n, d = Xa.shape

    def run():
        return ops.kmeans_assign(Xa, Xm, W, s, kern.gamma)

    def plain():
        return ref.kmeans_assign_ref(Xa, Xm, W, s, gamma=kern.gamma)

    got_a, got_s = run()
    want_a, want_s = plain()
    torch.cuda.synchronize()
    finite = torch.isfinite(want_s)
    if not torch.equal(finite, torch.isfinite(got_s)):
        raise AssertionError("kmeans_assign: the kernel's infinite scores "
                             "differ from the plain version's")
    err = float((got_s - want_s)[finite].abs().max())
    top2 = torch.topk(want_s, min(2, k), dim=1, largest=False).values
    clear = ((top2[:, 1] - top2[:, 0]) >= ASSIGN_TIE if k > 1
             else torch.ones(n, dtype=torch.bool, device=DEV))
    differ = int((got_a != want_a)[clear].sum())
    ties = int((~clear).sum())
    exact = (-2.0 * rbf_f64(Xa[:F64_ROWS], Xm, kern.gamma) @ W.double()
             + s.double())
    fin = torch.isfinite(exact)
    f64 = {who: float((val[:F64_ROWS].double() - exact)[fin].abs().max())
           for who, val in (("kernel", got_s), ("plain", want_s))}
    del got_a, got_s, want_a, want_s, top2, clear, exact, fin, finite
    ms = cuda_ms(torch, run, 5)
    plain_ms = cuda_ms(torch, plain, 2)
    mm_ms = cuda_ms(torch, lambda: (Xa @ Xm.T) @ W, 5)
    flops = 2 * n * m * (d + k)
    nbytes = 4 * ((n + m) * d + m * k + k + n * k) + 8 * n
    bound_f32, _ = bound(flops, nbytes)
    # both products in split-TF32: depth d + k a (row, sample) pair
    sb, sby, detail = split_bound(n * m, d + k, nbytes)
    log(f"kernel kmeans_assign ({n}, {d}) x ({m}, {d}), k={k}: "
        f"max_abs_err={err:.3e} (tolerance {ASSIGN_TOL:.0e}) err_vs_f64="
        f"{f64['kernel']:.3e} plain_err_vs_f64={f64['plain']:.3e} (first "
        f"{F64_ROWS} rows) assignments_differing={differ} near_ties={ties} "
        f"(gap < {ASSIGN_TIE:.0e}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={sb:.4f} ({detail}) bound_f32_ms={bound_f32:.4f} "
        f"share_of_bound={sb / ms:.4f} "
        f"library_ms(torch.matmul, the two products only)={mm_ms:.4f}")
    if not err <= ASSIGN_TOL:
        raise AssertionError(f"kmeans_assign scores disagree: {err}")
    for who, e in f64.items():
        if not e <= ASSIGN_TOL:
            raise AssertionError(f"kmeans_assign: the {who} disagrees with "
                                 f"float64: {e} > {ASSIGN_TOL}")
    if differ:
        raise AssertionError(f"kmeans_assign: {differ} assignments differ "
                             "outside near-ties")
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=sb,
                bound_by=sby, bound_detail=detail, bound_f32_ms=bound_f32,
                matmul_ms=mm_ms, err_vs_f64=f64["kernel"],
                plain_err_vs_f64=f64["plain"])


def phase_fit_parity(torch, datasets):
    """Phase 3: kernel fit vs plain fit on the card, for each of
    ``datasets``: (name, kernel, C, tol, X, y, Xte, yte, task, extra config).
    Same objective to 1e-4 relative, rho (the equality tasks) to 1e-4 of
    1 + |rho|, the same predictions (labels off a PRED_MARGIN band around
    0; SVR values to SVR_PRED_TOL), and the kernel fit launching the
    kernels its level 0 runs (``_level0_kernels``); a cached fit's counters
    add up (hits + misses = iterations x B).  Returns the kernel fits'
    launches by name."""
    import dataclasses

    from repro_torch.core import (DCSVMConfig, fit, objective_value,
                                  predict_exact)
    from repro_torch.core.predict import decision_exact
    from repro_torch.kernels import ops

    fit_launches = {}
    for name, kern, C, tol, X, y, Xte, yte, task, extra in datasets:
        cfg = DCSVMConfig(kernel=kern, C=C, k=4, levels=2, m=1000, tol=tol,
                          seed=SEED, **{"full_gram_threshold": FIT_FULL_GRAM,
                                        **extra})
        out = {}
        for use in (True, False):
            c = dataclasses.replace(cfg, use_kernels=use)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            model = fit(c, X, None if task is not None and task.label_free
                        else y, device=DEV, task=task)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            td = model.task.build(model.X, model.y[None], C)
            obj = float(objective_value(c, td.Xd, td.S[0], model.alpha,
                                        p=td.P[0]))
            dec = decision_exact(model, Xte)
            pred = predict_exact(model, Xte)
            st0 = model.level_stats[-1]
            out[use] = (obj, model.rho, dec, pred, launches)
            cached = c.col_cache_cap > 0 and not c.host_spill
            if cached and (st0["cache_hits"] + st0["cache_misses"]
                           != st0["iters"] * max(c.block, 64)):
                raise AssertionError(f"{name}: cache counters do not add "
                                     f"up: {st0}")
            if model.task.is_regression:
                quality = f"test_mse={float(((pred - yte) ** 2).mean()):.5f}"
            elif model.task.label_free:
                quality = f"outlier_frac={float((pred < 0).float().mean()):.4f}"
            else:
                quality = f"test_acc={float((pred == yte).float().mean()):.4f}"
            log(f"fit {name} n={X.shape[0]} d={X.shape[1]} use_kernels={use}: "
                f"objective={obj:.6f} rho={model.rho} {quality} "
                f"fit_s={t_fit:.2f} level0_iters={st0['iters']} "
                f"level0_pg_max={st0['pg_max']:.3e} n_sv={st0['n_sv']} "
                f"levels_s={[round(s_['train_time'], 2) for s_ in model.level_stats]} "
                + _cache_line(st0) + " kernels " + json.dumps(launches))
            if use and name == datasets[0][0]:
                traced_fit(torch, c, X, y, model, launches)
        (ok, rk, dk, pk, lk), (op, rp, dp, pp, _) = out[True], out[False]
        if not abs(ok - op) <= 1e-4 * abs(op):
            raise AssertionError(f"{name}: objectives differ: {ok} vs {op}")
        if rp is not None and not abs(rk - rp) <= 1e-4 * (1 + abs(rp)):
            raise AssertionError(f"{name}: rho differs: {rk} vs {rp}")
        if task is not None and task.is_regression:
            differ = float((pk - pp).abs().max())
            line = f"max |prediction difference| {differ:.3e}"
            bad = not differ <= SVR_PRED_TOL
        else:
            clear = (dp.abs() > PRED_MARGIN) & (dk.abs() > PRED_MARGIN)
            differ = int((pk != pp)[clear].sum())
            line = (f"labels differing {differ} of {int(clear.sum())} off the "
                    f"|f| < {PRED_MARGIN:.0e} band ({int((~clear).sum())} in "
                    f"it)")
            bad = differ > 0
            if task is None or not task.label_free:
                acc = [float((q == yte).float().mean()) for q in (pk, pp)]
                line += f"; accuracy {acc[0]:.4f} vs {acc[1]:.4f}"
                bad = bad or acc[0] != acc[1]
        log(f"fit {name}: kernel vs plain objective rel "
            f"{abs(ok - op) / abs(op):.3e}" + (
                f", rho {abs(rk - rp) / (1 + abs(rp)):.3e} of 1 + |rho|"
                if rp is not None else "") + f"; {line}")
        if bad:
            raise AssertionError(f"{name}: predictions differ: {line}")
        missing = [k for k in _level0_kernels(cfg) if lk[k] == 0]
        if missing:
            raise AssertionError(f"{name}: the kernel fit did not launch "
                                 f"{missing}")
        fit_launches[name] = lk
    return fit_launches


def traced_fit(torch, cfg, X, y, untraced, launched):
    """The kernel fit ``untraced`` of ``cfg`` again with DCSVMConfig(trace=
    FIT_TRACE): the same alphas bit for bit and the same launches, and
    level 0's ring fetched into its stats, a sample an iteration."""
    import dataclasses

    from repro_torch.core import fit
    from repro_torch.kernels import ops

    c = dataclasses.replace(cfg, trace=FIT_TRACE)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    model = fit(c, X, y, device=DEV)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st0 = model.level_stats[-1]
    ring = st0.get("trace")
    same = torch.equal(model.alpha, untraced.alpha)
    log(f"fit traced (trace={FIT_TRACE}) n={X.shape[0]}: fit_s={t_fit:.2f} "
        f"alphas equal to the untraced fit's: {same}; launches equal: "
        f"{launches == launched}; level 0 trace "
        + json.dumps(st0.get("trace_summary")) + f" over {st0['iters']} "
        "iterations")
    if not (same and launches == launched):
        raise AssertionError(f"the traced fit differs from the untraced one: "
                             f"alphas equal {same}, launches {launches} vs "
                             f"{launched}")
    if not (isinstance(ring, list) and len(ring) == 1
            and ring[0]["samples"] > 0
            and ring[0]["samples"] + ring[0]["dropped"] == st0["iters"]):
        raise AssertionError(f"level 0's trace {st0.get('trace_summary')} "
                             f"against {st0['iters']} iterations")


def _level0_kernels(cfg):
    """The kernels a Gram-free level 0 of ``cfg`` launches: the gradient's
    kernel_matvec, and the rank-B update's cd_column_update, or the row
    form of kermat (the column cache, the spill panels); their bf16 forms
    and the pack under the policy."""
    names = ["kernel_matvec",
             "kermat" if cfg.col_cache_cap > 0 or cfg.host_spill
             else "cd_column_update"]
    if cfg.compute_dtype == "bfloat16":
        names = [f"{k}_bf16" for k in names] + ["bf16_pack"]
    return names


def early_errors(early, Xq):
    """The early path through the kernels against its plain versions in
    float32 and in float64, on the same queries and the same routing.

    A decision sums a cluster's 58k-116k terms K(x, x_j) beta_j, which
    cancel to values near +-1, and f32 rounding scales with the sum of their
    magnitudes, so each difference is taken relative to
    1 + sum_j K(x, x_j) |beta_j| (in float64); the one relative to
    1 + |f(x)| is printed beside it.  Returns the first, by pair."""
    import torch

    from repro_torch.core.kkmeans import assign_points
    from repro_torch.core.predict import (_early_blocks,
                                          bucketed_cluster_scores,
                                          decision_early, early_capacity)

    kern, part = early.config.kernel, early.partition
    got = decision_early(early, Xq).double()
    plain = decision_early(early, Xq, use_kernels=False).double()
    cid, _ = assign_points(kern, part.model, Xq, use_kernels=False)
    Xm, wm = _early_blocks(early, early.weights)
    cap = early_capacity(Xq.shape[0], part.k)

    def f64(w):
        return bucketed_cluster_scores(kern, Xq.double(), cid, Xm.double(),
                                       w.double(), cap)[:, 0]

    exact, mag = f64(wm), f64(wm.abs())
    errs, line = {}, []
    for pair, a, b in (("kernels-plain", got, plain),
                       ("kernels-f64", got, exact),
                       ("plain-f64", plain, exact)):
        diff = (a - b).abs()
        errs[pair] = float((diff / (1.0 + mag)).max())
        line.append(f"{pair} {errs[pair]:.3e} (of 1 + |f|: "
                    f"{float((diff / (1.0 + exact.abs())).max()):.3e})")
    log(f"early decisions on {Xq.shape[0]} queries, max error of 1 + "
        f"sum_j K |beta_j| (tolerance {EARLY_TOL:.0e}): " + "; ".join(line))
    torch.cuda.empty_cache()
    return errs


def phase_main(torch, Xtr, ytr, Xte, yte, cfg, fit4=None):
    """Phase 4: the main path, with every launch counted; ``fit4`` (a
    dict) receives its refine alpha and partitions for phase 11."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import (accuracy, decision_early, decision_exact,
                                  fit, objective_value)
    from repro_torch.core.kkmeans import assign_points
    from repro_torch.kernels import ops
    from repro_torch.obs.spans import SpanTimer

    level1_alpha = {}
    # 12(e): every level's alpha saved as the train CLI saves it (step
    # levels - level + 1, written on the manager's thread), beside a copy
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=cfg.levels + 1)
    copies = {}

    def cb(level, alpha, st):
        if level == 1:
            level1_alpha["alpha"] = alpha.clone()
        step = cfg.levels - level + 1
        copies[step] = (level, alpha.clone())
        mgr.save(step, {"alpha": alpha,
                        "level": torch.tensor(level, dtype=torch.int32)},
                 blocking=False)
        extra = ""
        if level == 0:
            extra = f" iters={st['iters']} pg_max={st['pg_max']:.3e}"
        log(f"level {level}: clusters={st['clusters']} n_sv={st['n_sv']} "
            f"cluster_s={st['cluster_time']:.2f} solve_s="
            f"{st['train_time']:.2f}{extra}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = SpanTimer()
    ops.reset_launches()
    t0 = time.perf_counter()
    with timer.activate(), _capture_fit({} if fit4 is None else fit4):
        model = fit(cfg, Xtr, ytr, callback=cb, device=DEV)
    t_fit = time.perf_counter() - t0
    check_checkpoints(torch, mgr, copies)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    obj = float(objective_value(cfg, model.X, model.y, model.alpha))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d_exact = decision_exact(model, Xte)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t1
    # eq. 11: the level-1 local models on the level-1 partition (the
    # partition the fit ends with), as fit(early_stop_level=1) returns them
    a1 = level1_alpha["alpha"]
    early = dataclasses.replace(model, alpha=a1, beta=a1 * model.y,
                                is_early=True)
    t1 = time.perf_counter()
    d_early = decision_early(early, Xte)
    torch.cuda.synchronize()
    t_early = time.perf_counter() - t1
    # eq. 10 beside it: the same level-1 alpha over all its support vectors
    d_level1 = decision_exact(early, Xte)
    launches = dict(ops.LAUNCHES)

    nq = Xte.shape[0]
    for name, dv in (("exact", d_exact), ("early", d_early),
                     ("level1", d_level1)):
        if dv.shape != (nq,) or not bool(torch.isfinite(dv).all()):
            raise AssertionError(f"{name} decisions malformed")
    acc_exact = accuracy(yte, torch.sign(d_exact))
    acc_early = accuracy(yte, torch.sign(d_early))
    acc_level1 = accuracy(yte, torch.sign(d_level1))
    st0 = model.level_stats[-1]
    MAIN.update(objective=obj, acc_exact=acc_exact, acc_early=acc_early,
                fit_s=t_fit)
    log("spans_s " + json.dumps({k: round(v, 3)
                                 for k, v in timer.totals.items()}))
    log(f"main: n_train={Xtr.shape[0]} n_test={nq} fit_s={t_fit:.2f} "
        f"objective={obj:.6f} level0_iters={st0['iters']} "
        f"level0_pg_max={st0['pg_max']:.3e} n_sv={len(model.sv_index)} "
        f"exact_acc={acc_exact:.4f} early_acc={acc_early:.4f} "
        f"level1_eq10_acc={acc_level1:.4f} "
        f"exact_us_per_query={1e6 * t_exact / nq:.3f} "
        f"early_us_per_query={1e6 * t_early / nq:.3f} "
        f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    log("kernels " + json.dumps(launches) + f" (level-0 iterations "
        f"{st0['iters']}, cap {cfg.max_iters})")
    # the early path's routing: test queries and training members per
    # level-1 cluster
    part = model.partition
    cid, _ = assign_points(cfg.kernel, part.model, Xte, use_kernels=False)
    log("early routing: queries " + json.dumps(
        torch.bincount(cid, minlength=part.k).tolist()) + " members "
        + json.dumps(part.mask.sum(axis=1).tolist()))
    errs = early_errors(early, Xte[:EARLY_CHECK_N])
    if not math.isfinite(obj) or not math.isfinite(st0["pg_max"]):
        raise AssertionError("non-finite objective or KKT residual")
    for pair in ("kernels-plain", "kernels-f64"):
        if not errs[pair] <= EARLY_TOL:
            raise AssertionError(f"early decisions, {pair}: {errs[pair]} > "
                                 f"{EARLY_TOL}")
    if min(acc_exact, acc_early) < ACC_FLOOR:
        raise AssertionError(f"accuracy too low: {acc_exact}, {acc_early}")
    missing = [k for k in SVM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if launches["kmeans_assign"] < cfg.levels + 1:
        raise AssertionError("kmeans_assign did not route every fit level "
                             f"and the early path: {launches}")
    # one cd_column_update a level-0 iteration, replayed in the CUDA graph:
    # as many as the iterations where level 0 ran to its cap, else up to
    # SYNC_EVERY - 1 frozen ones more (the loop checks the host every
    # SYNC_EVERY)
    from repro_torch.core.solver import SYNC_EVERY

    steps, it0 = launches["cd_column_update"], st0["iters"]
    if not (steps == it0 if it0 == cfg.max_iters
            else it0 <= steps < it0 + SYNC_EVERY):
        raise AssertionError(f"cd_column_update launches {steps} against "
                             f"{it0} level-0 iterations")
    return launches, early, d_level1, d_early, exact_matvec_case(torch, model,
                                                                 Xte)


def check_checkpoints(torch, mgr, copies):
    """12(e), on phase 4's fit: every kept step restores, on the card,
    bit for bit the alpha the callback copied, with its level."""
    t0 = time.perf_counter()
    mgr.wait()
    steps = mgr.steps()
    for s in steps:
        tree = mgr.restore({"alpha": torch.zeros(0),
                            "level": torch.zeros((), dtype=torch.int32)},
                           step=s, device=DEV)
        level, alpha = copies[s]
        if not (torch.equal(tree["alpha"], alpha)
                and int(tree["level"]) == level):
            raise AssertionError(f"12(e) step {s} does not restore the "
                                 f"level-{level} alpha bit for bit")
    log(f"12(e) phase 4's checkpoints: steps {steps} (levels "
        f"{[copies[s][0] for s in steps]}) restore bit for bit "
        f"({time.perf_counter() - t0:.2f}s after the fit)")
    if steps != sorted(copies):
        raise AssertionError(f"12(e) steps {steps} of {sorted(copies)}")


def exact_matvec_case(torch, model, Xq):
    """kernel_matvec at decision_exact's shape (the queries against the
    model's support vectors) against its plain version over row blocks,
    relative to 1 + sum_j K(x, x_j) |beta_j| (the decisions cancel; see
    early_errors), with its split-TF32 bound."""
    from repro_torch.kernels import ops, ref

    kern = model.config.kernel
    rkw = dict(kind=kern.kind, gamma=kern.gamma, degree=kern.degree,
               coef0=kern.coef0)
    sv = torch.as_tensor(model.sv_index, device=DEV)
    Xs, wv = model.X[sv].contiguous(), model.weights[sv].contiguous()
    (nq, d), ns = Xq.shape, Xs.shape[0]
    blk = max(1, 2 ** 28 // ns)

    def run():
        return ops.kernel_matvec(Xq, Xs, wv, kern)

    def plain(w=wv):
        return torch.cat([ref.kernel_matvec_ref(Xq[r:r + blk], Xs, w, **rkw)
                          for r in range(0, nq, blk)])

    got, want, mag = run(), plain(), plain(wv.abs())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / (1.0 + mag)).max())
    del got, want, mag
    def matmul():
        for r in range(0, nq, blk):
            Xq[r:r + blk] @ Xs.T

    ms = cuda_ms(torch, run, 3)
    plain_ms = cuda_ms(torch, plain, 1)
    mm_ms = cuda_ms(torch, matmul, 3)
    nbytes = 4 * ((nq + ns) * d + ns + nq)
    bound_f32, _ = bound(nq * ns * (2 * d + 7), nbytes)
    sb, sby, detail = split_bound(nq * ns, d, nbytes)
    log(f"kernel kernel_matvec at decision_exact ({nq}, {d}) x ({ns}, {d}): "
        f"max_abs_err={err:.3e} max_err_over_1_plus_sum_K_abs_beta={rel:.3e} "
        f"(tolerance {EARLY_TOL:.0e}) kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} bound_ms={sb:.4f} ({detail}) bound_f32_ms="
        f"{bound_f32:.4f} share_of_bound={sb / ms:.4f} library_ms(torch."
        f"matmul, the products only, {blk}-row blocks)={mm_ms:.4f}")
    if not rel <= EARLY_TOL:
        raise AssertionError(f"kernel_matvec at decision_exact's shape "
                             f"disagrees with its plain version: {rel}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=sb,
                bound_detail=detail, bound_f32_ms=bound_f32, matmul_ms=mm_ms,
                n_sv=ns)


def kermat_serving_case(torch, sm, Xq, kern):
    """kermat at bucketed_cluster_scores' batched shape on a served model:
    (k, cap, d) query buckets of one SERVE_BUCKET-row batch against the
    (k, max_sv, d) SV blocks, held to its plain version and to float64 (first
    bucket), with its split-TF32 bound."""
    from repro_torch.core.predict import early_capacity
    from repro_torch.kernels import ops, ref

    rkw = dict(kind=kern.kind, gamma=kern.gamma, degree=kern.degree,
               coef0=kern.coef0)
    k, ns, d = sm.Xsv.shape
    cap = early_capacity(SERVE_BUCKET, k)
    idx = torch.arange(k * cap, device=DEV) % Xq.shape[0]
    qbuf = Xq[idx].reshape(k, cap, d).contiguous()
    Xsv = sm.Xsv.contiguous()

    def run():
        return ops.kernel_matrix(qbuf, Xsv, kern)

    def plain():
        return ref.kermat_ref(qbuf, Xsv, **rkw)

    got, want = run(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / (1.0 + want.abs())).max())
    exact = rbf_f64(qbuf[0, :F64_ROWS], Xsv[0], kern.gamma)
    f64 = {who: float(((val[0, :F64_ROWS].double() - exact).abs()
                       / (1.0 + exact.abs())).max())
           for who, val in (("kernel", got), ("plain", want))}
    del got, want, exact
    ms = cuda_ms(torch, run, 20, warmup=3)
    plain_ms = cuda_ms(torch, plain, 5)
    mm_ms = cuda_ms(torch, lambda: torch.bmm(qbuf, Xsv.transpose(1, 2)), 20,
                    warmup=3)
    pairs = k * cap * ns
    nbytes = 4 * (k * (cap + ns) * d + pairs)
    bound_f32, _ = bound(pairs * (2 * d + 5), nbytes)
    sb, sby, detail = split_bound(pairs, d, nbytes)
    log(f"kernel kermat at the serving bucket ({k}, {cap}, {d}) x ({k}, {ns}, "
        f"{d}): max_abs_err={err:.3e} max_err_over_1_plus_abs_plain="
        f"{rel:.3e} err_vs_f64={f64['kernel']:.3e} plain_err_vs_f64="
        f"{f64['plain']:.3e} (tolerance {KERMAT_TOL:.0e}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={sb:.4f} ({detail}) bound_f32_ms="
        f"{bound_f32:.4f} share_of_bound={sb / ms:.4f} "
        f"library_ms(torch.bmm, the products only)={mm_ms:.4f}")
    if not max(rel, *f64.values()) <= KERMAT_TOL:
        raise AssertionError(f"kermat at the serving bucket disagrees: {rel}, "
                             f"{f64}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=sb,
                bound_detail=detail, bound_f32_ms=bound_f32, matmul_ms=mm_ms,
                shape=[k, cap, ns, d])


def _sv_per_cluster(torch, early):
    """Support vectors in each cluster of the early model's partition."""
    part = early.partition
    return [int((early.weights[torch.as_tensor(
        part.idx[c][part.mask[c]], device=DEV)] != 0).sum())
        for c in range(part.k)]


def serve_all(sm, Xq, kern, strategy):
    """Serve every query in SERVE_BUCKET-row calls; (classes, scores)."""
    import torch

    from repro_torch.launch.serve_svm import serve_batch

    outs = [serve_batch(sm, Xq[i:i + SERVE_BUCKET], kern, strategy,
                        bucket=SERVE_BUCKET)
            for i in range(0, Xq.shape[0], SERVE_BUCKET)]
    return (torch.cat([p for p, _ in outs]), torch.cat([s for _, s in outs]))


def phase_serving(torch, early, Xte, yte, d_eq10, d_early):
    """Phase 5: the serving path on phase 4's early model (the level-1
    local models on the k = 4 level-1 partition, n = 464,810, d = 54), with
    every launch counted: a round-trip export (every SV, BCM) served exact,
    early and bcm; the default export (4,096 SVs a cluster, BCM) served bcm
    and early; the request loop of each strategy on the default export;
    the serve CLI at its defaults.

    Eq. 11 scores a query with its cluster's local model only, which is
    what the level-l alpha solves for; the final alpha's decisions cancel
    across clusters, so the early model is the one served here."""
    import dataclasses
    import os

    import numpy as np

    from repro_torch.core import accuracy, decision_early, decision_exact
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_svm import (_bcm_factor,
                                              export_serving_model,
                                              run_request_loop)

    kern = early.config.kernel
    sv_per_cluster = _sv_per_cluster(torch, early)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sm_rt = export_serving_model(early,
                                 max_sv_per_cluster=max(sv_per_cluster))
    torch.cuda.synchronize()
    t_rt = time.perf_counter() - t0
    served = {}
    for strategy in SERVE_STRATEGIES:
        t0 = time.perf_counter()
        served[strategy] = serve_all(
            sm_rt, Xte[:BCM_CHECK_N] if strategy == "bcm" else Xte, kern,
            strategy)
        torch.cuda.synchronize()
        served[strategy] += (time.perf_counter() - t0,)
    del sm_rt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sm = export_serving_model(early)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    _bcm_factor(kern, sm.Xsv, sm.svmask, 1e-2, True)
    torch.cuda.synchronize()
    t_bcm = time.perf_counter() - t0
    served_default = {}
    for strategy in ("bcm", "early"):
        t0 = time.perf_counter()
        served_default[strategy] = serve_all(sm, Xte, kern, strategy)
        torch.cuda.synchronize()
        served_default[strategy] += (time.perf_counter() - t0,)
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, Xte.shape[0], size=SERVE_LOOP)
    fixed = Xte[torch.as_tensor(idx, device=DEV)]
    sizes = rng.choice([b for b in (1, 4, 16, 64, 256, 1000, 3000)
                        if b <= Xte.shape[0] // 2], size=SERVE_LOOP[0])
    starts = rng.integers(0, Xte.shape[0] - int(sizes.max()), SERVE_LOOP[0])
    ragged = [Xte[a:a + int(b)] for a, b in zip(starts, sizes)]
    reports = []
    for strategy in SERVE_STRATEGIES:
        for batches, bucketed in ((fixed, False), (ragged, True)):
            reports.append(run_request_loop(sm, kern, strategy, batches,
                                            bucketed=bucketed))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log("serving kernels " + json.dumps(launches))

    # the round trip against the training-side decisions on the same
    # routing, relative to 1 + sum_j K(x, x_j) |beta_j| (see early_errors)
    absm = dataclasses.replace(early, beta=early.weights.abs())
    checks = {"exact": (d_eq10, decision_exact(absm, Xte)),
              "early": (d_early, decision_early(absm, Xte))}
    accs = {}
    for strategy, (pred, scores, secs) in served.items():
        nq = pred.shape[0]
        accs[strategy] = accuracy(yte[:nq], pred)
        line = (f"serve round trip {strategy}: {nq} queries in "
                f"{SERVE_BUCKET}-row buckets, {secs:.3f}s, accuracy "
                f"{accs[strategy]:.4f}")
        if strategy in checks:
            want, mag = checks[strategy]
            err = float(((scores[:, 1] - want).abs() / (1.0 + mag)).max())
            sym = float(((scores[:, 0] + scores[:, 1]).abs()
                         / (1.0 + mag)).max())
            line += (f", max error against decision_{strategy} of 1 + sum_j "
                     f"K |beta_j| {err:.3e} (tolerance {EARLY_TOL:.0e})")
            if not max(err, sym) <= EARLY_TOL:
                raise AssertionError(f"serve {strategy} disagrees with "
                                     f"decision_{strategy}: {err}, {sym}")
        elif scores.shape != (nq, 2) or not bool(
                torch.isfinite(scores).all()):
            raise AssertionError(f"serve {strategy} malformed")
        log(line)
    log(f"serve export: round trip (every SV: max_sv_per_cluster "
        f"{max(sv_per_cluster)}, BCM) {t_rt:.3f}s; default "
        f"(max_sv_per_cluster 4096, BCM) {t_export:.3f}s, SVs per cluster "
        f"{sv_per_cluster}, thinned clusters "
        f"{sum(c > 4096 for c in sv_per_cluster)}, BCM Gram + Cholesky of "
        f"{tuple(sm.Lchol.shape)} {t_bcm:.3f}s")
    for strategy, (pred, scores, secs) in served_default.items():
        if scores.shape != (Xte.shape[0], 2) or not bool(
                torch.isfinite(scores).all()):
            raise AssertionError(f"serve {strategy} (default export) "
                                 "malformed")
        log(f"serve default export {strategy}: {secs:.3f}s, accuracy "
            f"{accuracy(yte, pred):.4f} (thinned SV blocks; not held to "
            f"{ACC_FLOOR})")
    for rep in reports:
        log("serve loop " + json.dumps(rep))
        if rep["compiles_timed"] != 0:
            raise AssertionError(f"kernel libraries loaded inside the timed "
                                 f"loop: {rep}")
    low = {k: v for k, v in accs.items() if v < ACC_FLOOR}
    if low:
        raise AssertionError(f"serving accuracy below {ACC_FLOOR}: {low}")
    missing = [k for k in ("kermat", "kmeans_assign") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: "
                             f"{missing}")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_svm"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"serve CLI failed:\n{out.stdout}\n"
                             f"{out.stderr}")
    lines = out.stdout.strip().splitlines()
    acc = float(next(line for line in lines if line.startswith(
        "serving accuracy")).split(": ")[1])
    log(f"serve CLI ({time.perf_counter() - t0:.1f}s in all): "
        + " | ".join(lines))
    if not acc > ACC_FLOOR:
        raise AssertionError(f"serve CLI accuracy {acc} <= {ACC_FLOOR}")
    return launches, kermat_serving_case(torch, sm, Xte, kern)


def _packed(sizes, max_batch):
    """The batches the engine's _pop_ready forms from one group's queue
    when every request is queued before the loop pops: request indices in
    order, each batch up to ``max_batch`` rows (a larger request alone)."""
    groups, cur, total = [], [], 0
    for i, n in enumerate(sizes):
        if cur and total + n > max_batch:
            groups.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += n
    return groups + [cur] if cur else groups


def _abs_weights(torch, sm):
    """A serving model with |w| and no offsets: its scores are the
    magnitudes sum_j K(x, x_j) |w_j| of the decisions' terms."""
    return sm._replace(Wsv=sm.Wsv.abs(), Wall=sm.Wall.abs(),
                       rho=torch.zeros_like(sm.rho),
                       rho_c=torch.zeros_like(sm.rho_c))


def _served_close(torch, entry, strategy, rows, scores, pred, bucket=None):
    """(largest difference of served ``scores`` from ``rows`` served
    directly, relative to 1 + sum_j K |w_j|; predictions that differ off a
    PRED_MARGIN gap between the top two scores; the direct scores).  The
    direct call serves ``rows`` at ``bucket``, or in SERVE_BUCKET-row
    calls."""
    from repro_torch.launch.serve_svm import serve_batch

    Xq = torch.as_tensor(rows, device=DEV)

    def serve(sm):
        if bucket is None:
            return serve_all(sm, Xq, entry.kern, strategy)
        return serve_batch(sm, Xq, entry.kern, strategy, bucket=bucket)

    want_p, want = serve(entry.sm)
    _, mag = serve(_abs_weights(torch, entry.sm))
    got = torch.as_tensor(scores, device=DEV)
    err = float(((got - want).abs() / (1.0 + mag)).max())
    top = want.topk(2, dim=1).values
    clear = (top[:, 0] - top[:, 1]) > PRED_MARGIN
    differ = int((torch.as_tensor(pred, device=DEV) != want_p)[clear].sum())
    return err, differ, want.cpu().numpy()


def phase_engine(torch, early, Xte, smi):
    """Phase 5(b): the async serving engine (launch/engine.py) over the
    versioned registry (launch/registry.py) on phase 4's early model:
    version 1 its default export (4,096 SVs a cluster, BCM), version 2 the
    round-trip export (every SV, BCM).  Warmup of buckets 8-256 for early
    and exact; a burst of mixed sizes (both versions, both strategies)
    held bit for bit to a direct serve_batch of each merged bucket and,
    served alone, to EARLY_TOL of 1 + sum_j K |w_j| with the same
    predictions off PRED_MARGIN; a Poisson run at the serve CLI's defaults
    with a hot swap to version 2 at its midpoint, every request checked
    against the version it resolved; an overload against a 512-row queue
    with 5 ms deadlines; the serve CLI with --serve-async at its defaults.
    No kernel library may load after warmup."""
    import asyncio
    import os

    import numpy as np

    from repro_torch.core.predict import bucket_size
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (AsyncServingEngine,
                                           DeadlineExceeded, EngineConfig,
                                           EngineOverloaded)
    from repro_torch.launch.registry import ModelRegistry
    from repro_torch.launch.serve_svm import serve_batch, serving_cache_size

    pool = Xte.cpu().numpy()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    reg.register(ENGINE_NAME, early)
    reg.register(ENGINE_NAME, early,
                 max_sv_per_cluster=max(_sv_per_cluster(torch, early)))
    torch.cuda.synchronize()
    entries = {v: reg.resolve(ENGINE_NAME, v) for v in (1, 2)}
    log(f"engine registry: {ENGINE_NAME} v1 (default export, SV blocks "
        f"{tuple(entries[1].sm.Xsv.shape)}) and v2 (round trip, "
        f"{tuple(entries[2].sm.Xsv.shape)}) in "
        f"{time.perf_counter() - t0:.2f}s; manifests "
        + json.dumps([{k: m[k] for k in ("version", "task", "n_sv", "k",
                                         "max_sv_per_cluster", "strategies")}
                      for m in reg.manifests()]))
    config = EngineConfig(max_batch=ENGINE_BATCH)
    rng = np.random.default_rng(SEED)

    def warmed(cfg, strategies):
        engine = AsyncServingEngine(reg, cfg)
        t0 = time.perf_counter()
        loaded = engine.warmup(strategies=strategies)
        log(f"engine warmup {strategies} at buckets 8-{cfg.max_bucket} of "
            f"versions {reg.versions(ENGINE_NAME)}: "
            f"{time.perf_counter() - t0:.2f}s, {loaded} kernel libraries "
            f"loaded")
        return engine, serving_cache_size()

    # -- the burst: queued before the loop pops, so the merges are fixed
    combos = [(v, s) for v in (1, 2) for s in ("early", "exact")]
    reqs = [(pool[rng.integers(0, pool.shape[0], size=n)],) + combos[i % 4]
            for i, n in enumerate(ENGINE_BURST)]
    engine, libs = warmed(config, ["early", "exact"])

    async def burst():
        async with engine:
            return await asyncio.gather(*[
                engine.submit(X, ENGINE_NAME, version=v, strategy=st)
                for X, v, st in reqs])

    outs = asyncio.run(burst())
    worst, differ, same_alone = 0.0, 0, 0
    for v, st in combos:
        mine = [i for i, r in enumerate(reqs) if r[1:] == (v, st)]
        entry = entries[v]
        for group in _packed([len(reqs[i][0]) for i in mine], ENGINE_BATCH):
            idx = [mine[j] for j in group]
            rows = np.concatenate([reqs[i][0] for i in idx])
            bucket = bucket_size(len(rows), lo=config.min_bucket,
                                 hi=config.max_bucket)
            mp, ms = serve_batch(entry.sm, rows, entry.kern, st,
                                 bucket=bucket)
            mp, ms = mp.cpu().numpy(), ms.cpu().numpy()
            off = 0
            for i in idx:
                n = len(reqs[i][0])
                pred, scores = outs[i]
                if not (np.array_equal(scores, ms[off:off + n])
                        and np.array_equal(pred, mp[off:off + n])):
                    raise AssertionError(
                        f"engine burst request {i} ({n} rows, v{v} {st}) is "
                        f"not bit for bit its merged bucket's {bucket} rows")
                off += n
                err, dif, alone = _served_close(torch, entry, st, reqs[i][0],
                                                scores, pred,
                                                bucket=bucket_size(n))
                same_alone += bool(np.array_equal(scores, alone))
                worst, differ = max(worst, err), differ + dif
    bst = engine.stats()
    log(f"engine burst: {len(reqs)} requests ({sum(ENGINE_BURST)} rows; "
        f"v1/v2 x early/exact) bit for bit their merged buckets: "
        f"{len(reqs)}; bit for bit served alone: {same_alone} of "
        f"{len(reqs)}; served alone, max error of 1 + sum_j K |w_j| "
        f"{worst:.3e} (tolerance {EARLY_TOL:.0e}), predictions differing "
        f"off a {PRED_MARGIN:.0e} margin {differ}; compiles after warmup "
        f"{bst['compiles_after_warmup']}")
    if not worst <= EARLY_TOL or differ:
        raise AssertionError(f"engine burst against serving alone: {worst}, "
                             f"{differ} predictions")
    if bst["compiles_after_warmup"] or serving_cache_size() != libs:
        raise AssertionError("kernel libraries loaded after the burst's "
                             "warmup")

    # -- the Poisson run, with a hot swap to v2 at its midpoint
    sizes = rng.choice(ENGINE_SIZES[0], size=ENGINE_REQUESTS,
                       p=ENGINE_SIZES[1])
    arrivals = np.cumsum(rng.exponential(1.0 / ENGINE_QPS,
                                         size=ENGINE_REQUESTS))
    rows = [pool[rng.integers(0, pool.shape[0], size=int(n))] for n in sizes]
    mid = ENGINE_REQUESTS // 2
    engine, libs = warmed(config, ["early"])
    versions, lats, outs, swapped = {}, {}, {}, {}

    async def do_swap():
        swapped["owed"] = engine._queued_matching(ENGINE_NAME, 1)
        t0 = time.perf_counter()
        swapped["old"] = await engine.swap(ENGINE_NAME, 2)
        swapped["drain_s"] = time.perf_counter() - t0
        swapped["versions"] = reg.versions(ENGINE_NAME)

    async def one(i, tasks):
        await asyncio.sleep(float(arrivals[i]))
        # submit resolves the route before its first await: this read is
        # the version it takes
        versions[i] = reg.default_version(ENGINE_NAME)
        if i == mid - 1:            # runs once this request is queued
            tasks.append(asyncio.ensure_future(do_swap()))
        t0 = time.perf_counter()
        outs[i] = await engine.submit(rows[i], ENGINE_NAME, strategy="early")
        lats[i] = time.perf_counter() - t0

    async def poisson():
        tasks = []
        async with engine:
            ops.reset_launches()
            t0 = time.perf_counter()
            await asyncio.gather(*[one(i, tasks)
                                   for i in range(ENGINE_REQUESTS)])
            await asyncio.gather(*tasks)
            return time.perf_counter() - t0

    wall = asyncio.run(poisson())
    launches = dict(ops.LAUNCHES)
    st = engine.stats()
    by_version = {v: [i for i in range(ENGINE_REQUESTS) if versions[i] == v]
                  for v in (1, 2)}
    counted = {v: int(sum(c for k, c in engine.metrics.to_json()[
        "counters"].items() if k.startswith("serve_requests_total")
        and f'version="{v}"' in k)) for v in (1, 2)}
    errs = {}
    for v, other in ((1, 2), (2, 1)):
        ids = by_version[v]
        X = np.concatenate([rows[i] for i in ids])
        S = np.concatenate([outs[i][1] for i in ids])
        P = np.concatenate([outs[i][0] for i in ids])
        errs[v] = _served_close(torch, entries[v], "early", X, S, P)[:2]
        errs[f"{v}_against_v{other}"] = _served_close(
            torch, entries[other], "early", X, S, P)[:2]
    ms = np.sort(np.asarray(list(lats.values()))) * 1e3
    hists = engine.metrics.to_json()["histograms"]
    fill = hists["serve_batch_fill_ratio"]
    queries = int(sizes.sum())
    rec = {"offered_rps": ENGINE_QPS, "requests": ENGINE_REQUESTS,
           "queries": queries, "delivered": len(outs),
           "achieved_rps": len(outs) / wall, "achieved_qps": queries / wall,
           "wall_s": wall, "p50_ms": float(np.percentile(ms, 50)),
           "p95_ms": float(np.percentile(ms, 95)),
           "p99_ms": float(np.percentile(ms, 99)),
           "mean_ms": float(ms.mean()), "batches": fill["count"],
           "mean_batch_fill": fill["sum"] / fill["count"],
           # the engine's histograms (bucket bounds, not exact): a batch's
           # formation to its results on the host, and a request's wait
           "compute_ms": {q: 1e3 * hists["serve_compute_seconds"][q]
                          for q in ("p50", "p99")},
           "compute_ms_mean": 1e3 * hists["serve_compute_seconds"]["sum"]
           / fill["count"],
           "queue_wait_ms": {q: 1e3 * hists["serve_queue_wait_seconds"][q]
                             for q in ("p50", "p99")},
           "resolved_v1": len(by_version[1]), "resolved_v2":
               len(by_version[2]), "served_v1": counted[1],
           "served_v2": counted[2], "swap": swapped,
           "compiles_after_warmup": st["compiles_after_warmup"],
           "libraries_growth": serving_cache_size() - libs,
           "launches": {k: launches[k] for k in SVM_KERNELS}, "card": smi,
           "max_err_own_version": {v: errs[v][0] for v in (1, 2)},
           "differing_predictions": {v: errs[v][1] for v in (1, 2)},
           "max_err_other_version": {v: errs[f"{v}_against_v{o}"][0]
                                     for v, o in ((1, 2), (2, 1))}}
    log("engine poisson: " + json.dumps(rec))
    if rec["delivered"] != ENGINE_REQUESTS or st["requests"] != \
            ENGINE_REQUESTS or st["shed"] or st["deadline_exceeded"]:
        raise AssertionError(f"engine poisson run lost requests: {st}")
    # the route moves once: every request resolved v1 up to the swap (the
    # request before the midpoint, and any whose timer fired in its loop
    # turn), v2 after it, and the engine served each on that version
    v1 = by_version[1]
    if (v1 != list(range(len(v1))) or len(v1) < mid
            or counted != {v: len(by_version[v]) for v in (1, 2)}):
        raise AssertionError(f"hot swap: requests resolved {rec['resolved_v1']}"
                             f" / {rec['resolved_v2']}, served {counted}")
    if swapped["old"] != 1 or swapped["versions"] != [2] or not \
            swapped["owed"]:
        raise AssertionError(f"hot swap did not drain and drop v1 with "
                             f"requests in flight: {swapped}")
    if (max(errs[v][0] for v in (1, 2)) > EARLY_TOL
            or errs[1][1] or errs[2][1]):
        raise AssertionError(f"engine poisson results against their "
                             f"versions: {errs}")
    if min(errs[f"{v}_against_v{o}"][0] for v, o in ((1, 2), (2, 1))) \
            <= EARLY_TOL:
        raise AssertionError("v1 and v2 serve alike: the version check "
                             f"cannot tell them apart: {errs}")
    if rec["compiles_after_warmup"] or rec["libraries_growth"]:
        raise AssertionError("kernel libraries loaded after warmup")
    missing = [k for k in ("kermat", "kmeans_assign") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the engine: {missing}")

    # -- overload: waves of requests all at once past what it sustains
    waves, per_wave, gap = ENGINE_WAVES
    engine, libs = warmed(EngineConfig(max_batch=ENGINE_BATCH,
                                       max_queue_rows=OVERLOAD_QUEUE,
                                       timeout_s=OVERLOAD_TIMEOUT), ["early"])
    n_over = waves * per_wave
    osizes = rng.choice(ENGINE_SIZES[0], size=n_over, p=ENGINE_SIZES[1])
    orows = [pool[rng.integers(0, pool.shape[0], size=int(n))]
             for n in osizes]
    olats = {}

    async def timed(i):
        t0 = time.perf_counter()
        out = await engine.submit(orows[i], ENGINE_NAME, strategy="early")
        olats[i] = time.perf_counter() - t0
        return out

    async def overload():
        async with engine:
            futs = []
            t0 = time.perf_counter()
            for w in range(waves):
                futs += [asyncio.ensure_future(timed(w * per_wave + j))
                         for j in range(per_wave)]
                await asyncio.sleep(gap)
            got = await asyncio.wait_for(
                asyncio.gather(*futs, return_exceptions=True), timeout=120)
            return got, time.perf_counter() - t0

    got, owall = asyncio.run(overload())
    ost = engine.stats()
    shed = sum(isinstance(o, EngineOverloaded) for o in got)
    expired = sum(isinstance(o, DeadlineExceeded) for o in got)
    other = [o for o in got if isinstance(o, BaseException)
             and not isinstance(o, (EngineOverloaded, DeadlineExceeded))]
    oms = np.sort(np.asarray(list(olats.values()))) * 1e3
    orec = {"requests": n_over, "waves": waves, "wave_gap_s": gap,
            "queries": int(osizes.sum()), "wall_s": owall,
            "delivered": len(olats), "shed": shed, "expired": expired,
            "stats_shed": ost["shed"], "stats_expired":
                ost["deadline_exceeded"], "queue_depth": ost["queue_depth"],
            "p50_ms": float(np.percentile(oms, 50)) if len(oms) else None,
            "p99_ms": float(np.percentile(oms, 99)) if len(oms) else None,
            "compiles_after_warmup": ost["compiles_after_warmup"],
            "libraries_growth": serving_cache_size() - libs}
    log("engine overload (max_queue_rows 512, timeout 5 ms): "
        + json.dumps(orec))
    if other or len(got) != n_over or shed + expired + len(olats) != n_over:
        raise AssertionError(f"engine overload: futures unresolved or "
                             f"failed otherwise: {other[:3]}")
    if not (shed and expired and olats) or (shed, expired) != (
            ost["shed"], ost["deadline_exceeded"]) or ost["queue_depth"]:
        raise AssertionError(f"engine overload: {orec}")
    if orec["compiles_after_warmup"] or orec["libraries_growth"]:
        raise AssertionError("kernel libraries loaded after warmup")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_svm",
         "--serve-async"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"serve CLI --serve-async failed:\n"
                             f"{out.stdout}\n{out.stderr}")
    lines = out.stdout.strip().splitlines()
    log(f"serve CLI --serve-async ({time.perf_counter() - t0:.1f}s in all): "
        + " | ".join(lines))
    summary = next(ln for ln in lines if ln.startswith("async early v1: "))
    if "delivered 50 shed 0 expired 0" not in summary or not \
            summary.endswith("after warmup 0"):
        raise AssertionError(f"serve CLI --serve-async: {summary}")
    return launches


def _served_errors(sm, Xq, kern, pairs):
    """Serve Xq in SERVE_BUCKET-row calls for each (strategy, decision,
    magnitude) of ``pairs`` and return the largest difference of the
    served score from the decision, relative to 1 + the magnitude
    sum_j K(x, x_j) |beta_j| (see early_errors), by strategy."""
    errs = {}
    for strategy, want, mag in pairs:
        _, scores = serve_all(sm, Xq, kern, strategy)
        if scores.shape != (Xq.shape[0], 1):
            raise AssertionError(f"served {strategy} scores malformed: "
                                 f"{tuple(scores.shape)}")
        errs[strategy] = float(((scores[:, 0] - want).abs()
                                / (1.0 + mag)).max())
    return errs


def _level_seconds(timer):
    return {k: round(v, 2) for k, v in timer.totals.items()}


def phase_oneclass(torch, Xtr, Xte):
    """Phase 8(a): one-class SVM at full width on the covtype_like training
    rows (OC_N of them, d = 54), nu = OC_NU, gamma 1, k 4, levels 4, m 1000,
    the default tol and 30,000 iterations, eq_block_size 1: level 0 runs
    solve_eq_qp_matvec, cd_column_update at B = 2 a pair step and
    kernel_matvec a refresh.  Checks the nu-property, an early model's
    per-cluster rho_c and oneclass_early_gap_bound, and the ocsvm export
    served exact and early.  Returns the launches of the fit and its
    decisions, by kernel."""
    import dataclasses

    from repro_torch.core import DCSVMConfig, Kernel, fit
    from repro_torch.core import dcsvm as D
    from repro_torch.core.bounds import oneclass_early_gap_bound
    from repro_torch.core.kkmeans import assign_points
    from repro_torch.core.predict import decision_early, decision_exact
    from repro_torch.core.tasks import OneClassSVM
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_svm import export_serving_model
    from repro_torch.obs.spans import SpanTimer

    X = Xtr[:OC_N].contiguous()
    n = X.shape[0]
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=1.0, k=4, levels=4,
                      m=1000, gram_budget=GRAM_BUDGET, seed=SEED,
                      eq_block_size=1)
    task = OneClassSVM(nu=OC_NU)
    level1 = {}

    def cb(level, alpha, st):
        if level == 1:
            level1["alpha"] = alpha.clone()
        extra = (f" iters={st['iters']} pg_max={st['pg_max']:.3e}"
                 if level == 0 else "")
        log(f"ocsvm level {level}: clusters={st['clusters']} n_sv="
            f"{st['n_sv']} cluster_s={st['cluster_time']:.2f} solve_s="
            f"{st['train_time']:.2f}{extra}")

    torch.cuda.synchronize()
    timer = SpanTimer()
    ops.reset_launches()
    t0 = time.perf_counter()
    with timer.activate():
        model = fit(cfg, X, None, callback=cb, task=task, device=DEV)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    f_train = decision_exact(model, X)
    d_exact = decision_exact(model, Xte)
    # the early model (eq. 11) at level 1, as fit(early_stop_level=1)
    # returns it: the level-1 alpha on the level-1 partition, with the
    # per-cluster offsets of its local sub-QPs
    td = task.build(X, torch.zeros((1, n), device=DEV), cfg.C)
    a1 = level1["alpha"][None]
    early = dataclasses.replace(
        model, alpha=a1[0], beta=td.collapse(a1)[0], is_early=True,
        rho=D._recover_rho(cfg, td, task, a1),
        rho_clusters=D._recover_rho_clusters(cfg, td, task, a1,
                                             model.partition))
    d_early = decision_early(early, Xte)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    st0 = model.level_stats[-1]
    sv_frac = float((model.alpha > 0).float().mean())
    bound_frac = float((model.alpha >= 1.0).float().mean())
    # free SVs sit on f = 0 to within the KKT gap the solve stopped at, so an
    # outlier is f < -max(tol, pg_max)
    band = max(cfg.tol, model.level_stats[-1]["pg_max"])
    out_frac = float((f_train < -band).float().mean())
    log(f"ocsvm: n={n} (cut from {Xtr.shape[0]}: the refine Gram over the "
        f"level-1 support vectors) d={X.shape[1]} nu={OC_NU} fit_s={t_fit:.2f} "
        f"rho={model.rho:.6f} level0_iters={st0['iters']} level0_pg_max="
        f"{st0['pg_max']:.3e} sv_frac={sv_frac:.4f} at_bound_frac="
        f"{bound_frac:.4f} outlier_frac(f<-{band:.1e})={out_frac:.4f} "
        f"(f<0: {float((f_train < 0).float().mean()):.4f}) spans_s "
        + json.dumps(_level_seconds(timer)))
    log("ocsvm kernels " + json.dumps(launches) + f" (level-0 pair steps "
        f"{st0['iters']}, cap {cfg.max_iters})")
    for name, dv in (("exact", d_exact), ("early", d_early),
                     ("train", f_train)):
        if not bool(torch.isfinite(dv).all()):
            raise AssertionError(f"ocsvm {name} decisions not finite")
    if not (out_frac <= OC_NU + OC_NU_SLACK and sv_frac >= OC_NU - 1e-6):
        raise AssertionError(f"nu-property fails: outliers {out_frac}, SVs "
                             f"{sv_frac}, nu {OC_NU} (slack {OC_NU_SLACK})")
    missing = [k for k in SVM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the one-class path: "
                             f"{missing}")
    # the early model scores each query with its routed cluster's rho_c
    rho_c = early.rho_clusters
    cid, _ = assign_points(cfg.kernel, model.partition.model, Xte,
                           use_kernels=True)
    no_off = decision_early(dataclasses.replace(early, rho_clusters=None,
                                                rho=0.0), Xte)
    shift = float((no_off - rho_c[cid] - d_early).abs().max())
    log(f"ocsvm early model: rho_c {[round(float(r), 6) for r in rho_c]} "
        f"(global rho of the level-1 alpha {early.rho:.6f}); decision_early "
        f"less (the offset-free scores - rho_c[cluster]): max {shift:.3e}")
    if rho_c.shape != (model.partition.k,) or not shift <= 1e-4:
        raise AssertionError("the early model does not use its rho_c")
    Xq = Xte[:OC_GAP_QUERIES]
    cid_q = cid[:OC_GAP_QUERIES]
    t1 = time.perf_counter()
    gap = oneclass_early_gap_bound(
        cfg.kernel, X, model.partition.assign, early.alpha, model.rho, rho_c,
        Xq, cid_q.cpu().numpy(), OC_SIGMA_N, alpha_exact=model.alpha,
        num_chunks=-(-n * n // 2 ** 28))
    err = float((decision_early(early, Xq) - decision_exact(model, Xq))
                .abs().max())
    log(f"ocsvm gap bound ({time.perf_counter() - t1:.1f}s, sigma_n "
        f"{OC_SIGMA_N:g}): |f_early - f| max {err:.4e} <= bound_measured "
        f"{gap['bound_measured']:.4e} (drift {gap['term_drift_measured']:.4e}"
        f", cross {gap['term_cross']:.4e}, rho {gap['term_rho']:.4e}); "
        f"a-priori bound {gap['bound']:.4e}, D(pi) {gap['d_pi']:.4e}")
    if not err <= gap["bound_measured"] <= gap["bound"]:
        raise AssertionError(f"oneclass_early_gap_bound fails: {err}, {gap}")
    # the ocsvm export with every SV, served exact and early
    part = early.partition
    per = [int((early.weights[torch.as_tensor(part.idx[c][part.mask[c]],
                                               device=DEV)] != 0).sum())
           for c in range(part.k)]
    sm = export_serving_model(early, max_sv_per_cluster=max(per),
                              with_bcm=False)
    absm = dataclasses.replace(early, beta=early.weights.abs(), rho=None,
                               rho_clusters=None)
    mag = decision_exact(absm, Xte)
    errs = _served_errors(sm, Xte, cfg.kernel, (
        ("exact", decision_exact(early, Xte), mag),
        ("early", d_early, mag)))
    log(f"ocsvm export (every SV, {per} a cluster, rho_c {sm.rho_c.shape[0]}"
        f"): served exact and early, max error of 1 + sum_j K |beta_j| "
        f"{errs} (tolerance {EARLY_TOL:.0e})")
    if not max(errs.values()) <= EARLY_TOL:
        raise AssertionError(f"ocsvm serving disagrees: {errs}")
    return launches, timer.totals


def phase_svr(torch):
    """Phase 8(b): epsilon-SVR on friedman1 at d = SVR_D, SVR_N training
    rows and SVR_N_TEST queries, eps 0.1, C 4, gamma 1, k 4, levels 4: a
    dual of 2 SVR_N coordinates, so level 0 takes the graphed block CD with
    the dedup view's cd_column_update.  Checks test MSE below the
    predict-the-mean MSE and the svr export served exact.  Returns the
    launches of the fit and its decisions, by kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.core import DCSVMConfig, Kernel, fit
    from repro_torch.core.predict import decision_exact, mse
    from repro_torch.core.tasks import EpsilonSVR
    from repro_torch.data import friedman1, train_test_split
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_svm import export_serving_model
    from repro_torch.obs.spans import SpanTimer

    rng = np.random.default_rng(SEED + 2)
    X, y = friedman1(rng, SVR_N + SVR_N_TEST, d=SVR_D)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(DEV) for a in
                          train_test_split(rng, X, y, test_frac=SVR_N_TEST / (
                              SVR_N + SVR_N_TEST)))
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=SVR_C, k=4,
                      levels=4, m=1000, gram_budget=GRAM_BUDGET, seed=SEED,
                      max_iters=SVR_ITERS)

    def cb(level, alpha, st):
        extra = (f" iters={st['iters']} pg_max={st['pg_max']:.3e}"
                 if level == 0 else "")
        log(f"svr level {level}: clusters={st['clusters']} n_sv={st['n_sv']} "
            f"cluster_s={st['cluster_time']:.2f} solve_s="
            f"{st['train_time']:.2f}{extra}")

    torch.cuda.synchronize()
    timer = SpanTimer()
    ops.reset_launches()
    t0 = time.perf_counter()
    with timer.activate():
        model = fit(cfg, Xtr, ytr, callback=cb, task=EpsilonSVR(eps=SVR_EPS),
                    device=DEV)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    d_exact = decision_exact(model, Xte)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    st0 = model.level_stats[-1]
    test_mse = mse(yte, d_exact)
    mean_mse = mse(yte, torch.full_like(yte, float(ytr.mean())))
    log(f"svr: n={Xtr.shape[0]} (dual {2 * Xtr.shape[0]}) d={Xtr.shape[1]} "
        f"fit_s={t_fit:.2f} level0_iters={st0['iters']} level0_pg_max="
        f"{st0['pg_max']:.3e} n_sv={len(model.sv_index)} test_mse="
        f"{test_mse:.5f} mean_predictor_mse={mean_mse:.5f} spans_s "
        + json.dumps(_level_seconds(timer)))
    log("svr kernels " + json.dumps(launches) + f" (level-0 iterations "
        f"{st0['iters']}, cap {cfg.max_iters})")
    if not bool(torch.isfinite(d_exact).all()) or d_exact.shape != yte.shape:
        raise AssertionError("svr decisions malformed")
    if not test_mse < mean_mse:
        raise AssertionError(f"svr test MSE {test_mse} not below the "
                             f"predict-the-mean MSE {mean_mse}")
    missing = [k for k in SVM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the SVR path: "
                             f"{missing}")
    sm = export_serving_model(model, max_sv_per_cluster=Xtr.shape[0],
                              with_bcm=False)
    absm = dataclasses.replace(model, beta=model.weights.abs())
    errs = _served_errors(sm, Xte, cfg.kernel, (
        ("exact", d_exact, decision_exact(absm, Xte)),))
    log(f"svr export ({sm.Xall.shape[0]} SVs): served exact, max error of 1 "
        f"+ sum_j K |beta_j| {errs} (tolerance {EARLY_TOL:.0e})")
    if not max(errs.values()) <= EARLY_TOL:
        raise AssertionError(f"svr serving disagrees: {errs}")
    return launches, timer.totals


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_ms(torch, fn) -> dict:
    """Device ms and launches of ``fn``'s kernels, by name, from
    ``torch.profiler``: {name: (ms, count)}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (ms + e.self_device_time_total / 1e3,
                              count + e.count)
    return by_name


def counted_device_ms(torch, fn) -> dict:
    """``device_ms`` of ``fn``, checking that the profiler saw as many
    ``cd_column_update`` kernels as ``ops.LAUNCHES`` counted in the run (a
    CUDA graph's launches are counted once a replay by bookkeeping; this
    shows the replays ran them).  The run's one ``kernel_matvec`` launch
    (the initial gradient, launched eagerly and counted at its launch) is
    logged, not checked: the profiler drops the record of that long kernel
    in many runs, graphed and eager alike."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    by_name = device_ms(torch, fn)
    counts = {}
    for name in ("cd_column_update", "kernel_matvec"):
        counts[name] = (sum(count for key, (_, count) in by_name.items()
                            if f"{name}_kernel" in key),
                        ops.LAUNCHES[name] - before[name])
    seen, launched = counts["cd_column_update"]
    if seen != launched:
        raise AssertionError(f"the profiler saw {seen} cd_column_update "
                             f"kernels, ops.LAUNCHES counted {launched}")
    log("profiled run: " + ", ".join(
        f"{name} {seen} seen of {launched} launched"
        for name, (seen, launched) in counts.items()))
    return by_name


def loop_cost(torch, run, steps: int, base: int = 0, prof_steps: int = 0):
    """A solver loop's cost a step, net of its set-up: ``run(base + steps)``
    less ``run(base)``, over ``steps``, wall ms without the profiler (the
    profiler slows these launch-bound loops down); and device ms by kernel
    from the profiler over ``prof_steps`` (default ``steps``), counting only
    the kernels whose launches grow with the steps (the set-up's own, such
    as the initial gradient, vary by more than a step's time); and the
    launches of the profiled run's kernels, by name."""
    prof_steps = prof_steps or steps
    run(base + 2)
    wall = (wall_ms(torch, lambda: run(base + steps))
            - wall_ms(torch, lambda: run(base))) / steps
    with_steps = counted_device_ms(torch, lambda: run(base + prof_steps))
    setup = counted_device_ms(torch, lambda: run(base))
    return wall, {key: (ms - setup.get(key, (0.0, 0))[0]) / prof_steps
                  for key, (ms, count) in with_steps.items()
                  if count > setup.get(key, (0.0, 0))[1]}, \
        {key: count for key, (_, count) in with_steps.items()}


def phase_loops(torch, Xtr, ytr, cfg):
    """Phase 6: cost of the solver loops a step on the main path's shapes
    (greedy CD on a level-l_max cluster batch; level-0 block CD over all
    n, replayed as a CUDA graph and eager), and the device's busy share:
    device time over wall time."""
    from repro_torch.core import gramop
    from repro_torch.core import solver as S
    from repro_torch.kernels import ops

    n, d = Xtr.shape
    k = cfg.k ** cfg.levels
    nc = -(-n // k)
    idx = torch.arange(k * nc, device=DEV) % n
    Xc, yc = Xtr[idx].reshape(k, nc, d), ytr[idx].reshape(k, nc)
    Q = ops.kernel_matrix(Xc, Xc, cfg.kernel)
    Q.mul_(yc[:, :, None]).mul_(yc[:, None, :])
    steps = 100
    wall, dev, _ = loop_cost(
        torch, lambda s: S.solve_box_qp(Q, cfg.C, tol=-1.0, max_iters=s), steps)
    busy = sum(dev.values())
    log(f"loop greedy CD ({k}, {nc}) x {steps} steps: {wall:.4f} ms/step, "
        f"device {busy:.4f} ms/step, device busy {100 * busy / wall:.1f}%")
    del Q
    op = gramop.GramOperator(Xd=Xtr, s=ytr, kernel=cfg.kernel,
                             use_kernels=True)
    out = {}
    # graphed: both runs capture (base > GRAPH_WARMUP), so the difference
    # is replays; eager: 20 iterations (fewer than before, when 500
    # graphed / 100 profiled and 50 eager took 68-75 s, mostly the
    # profiler's own work)
    for graph, iters, base, prof in ((True, 200, 16, 30), (False, 20, 0, 0)):
        wall, dev, seen = loop_cost(
            torch, lambda s: S.solve_box_qp_op(op, cfg.C, tol=-1.0,
                                               max_iters=s, graph=graph),
            iters, base, prof)
        cd_seen = sum(c for key, c in seen.items() if "cd_column_update" in key)
        busy = sum(dev.values())
        cd = sum(v for key, v in dev.items() if "cd_column_update" in key)
        name = "graphed" if graph else "eager"
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        log(f"loop level-0 block CD (n={n}, B=64), {name}, x {iters} iters "
            f"(profiled over {prof or iters}): "
            f"{wall:.4f} ms/iter, device {busy:.4f} ms/iter, device busy "
            f"{100 * busy / wall:.1f}% (cd_column_update {cd:.4f} ms/iter, "
            f"{cd_seen} kernels in the profiled run of {base + (prof or iters)}"
            " iterations, as counted; "
            f"{len(dev)} kernel names seen by the profiler; top: "
            + "; ".join(f"{key[:50]} {v:.4f}" for key, v in top) + ")")
        out[name] = dict(ms=wall, device_ms=busy, busy=busy / wall, cd_ms=cd)
    return out


def flash_case(torch, B, S, Hq, Hkv, hd, dtype, q_offset=0, controls=False):
    """The flash kernel against its plain version on one causal shape, with
    its bound and the time of scaled_dot_product_attention (and the backend
    it picked) on the same inputs.  With ``controls``, two wrong attentions
    through the kernel must exceed the bf16 bound."""
    from torch.nn.attention import SDPBackend
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    Sq = S - q_offset

    def draw(*shape):
        return torch.randn(*shape, device=DEV, generator=gen).to(dtype)

    q, k, v = draw(B, Sq, Hq, hd), draw(B, S, Hkv, hd), draw(B, S, Hkv, hd)

    def run(**kw):
        return ops.flash_attention(q, k, v, **{"causal": True,
                                                "q_offset": q_offset, **kw})

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=True,
                                       q_offset=q_offset)

    control_shares = {}
    if dtype == torch.bfloat16:
        want, sv = ref.flash_bf16_bound(q, k, v, causal=True,
                                        q_offset=q_offset)
        got = run()
        err = float((got.float() - want).abs().max())
        ratio = ref.flash_bf16_share(got, want, sv)
        tol_text = FLASH_BF16_TOL_TEXT
        if controls:
            for name, wrong in FLASH_CONTROLS:
                control_shares[name] = ref.flash_bf16_share(run(**wrong), want,
                                                            sv)
        del want, sv, got
    else:
        got, want = run().float(), plain().float()
        err = float((got - want).abs().max())
        ratio = err / FLASH_F32_TOL
        tol_text = f"{FLASH_F32_TOL:.0e}"
        del got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # 20 calls after 5 warm-up ones: 5 cold calls read the bf16 kernel
    # about 25% slower than it runs inside a prefill
    ms = cuda_ms(torch, run, 20, warmup=5)
    plain_ms = cuda_ms(torch, plain, 3)
    # SDPA's causal mask is aligned to the top left; with a query offset
    # it computes another function, so it is timed on square shapes only
    lib_ms, backend = None, None
    if q_offset == 0:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def lib():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv)
        lib_ms = cuda_ms(torch, lib, 20, warmup=5)
        # the backend SDPA's dispatcher picks for these arguments
        backend = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv)).name
    # each query row attends keys 0..q_offset + i (all S when past them)
    pairs = sum(min(S, q_offset + i + 1) for i in range(Sq))
    flops = 4 * B * Hq * hd * pairs
    esize = q.element_size()
    nbytes = esize * hd * B * (2 * Sq * Hq + 2 * S * Hkv)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"kernel flash_attention B={B} S={S} q_offset={q_offset} Hq={Hq} "
        f"Hkv={Hkv} hd={hd} {dtype}: max_abs_err={err:.3e} (tolerance "
        f"{tol_text}; worst share of it {ratio:.3f}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
        f"{flops / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s) "
        f"kernel_TFLOP/s={flops / ms / 1e9:.2f} share_of_bound="
        f"{bound_ms / ms:.4f} library_ms(scaled_dot_product_attention)="
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} backend={backend}")
    if control_shares:
        log("kernel flash_attention controls (wrong attentions through the "
            "kernel, worst share of the bf16 bound; each must exceed 1): "
            + ", ".join(f"{n} {r:.1f}" for n, r in control_shares.items()))
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: max_abs_err {err}, {ratio} of "
                             f"{tol_text}")
    accepted = [n for n, r in control_shares.items() if not r > 1.0]
    if accepted:
        raise AssertionError(f"the bf16 bound accepts a wrong attention: "
                             f"{accepted}")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, tol_share=ratio, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                backend=backend, controls=control_shares)


def flash_sass():
    """The SASS of the flash library's bf16 kernels (``cuobjdump -sass``):
    how many wgmma (HGMMA) and TMA load (UTMALDG) instructions each holds.
    Fails unless every head dim's kernel has both."""
    import re

    from repro_torch.kernels import build

    found = {}
    for fn, c in build.sass_counts("flash_attention").items():
        cfg = re.search(r"FaCfgILi(\d+)ELi(\d+)ELi(\d+)E", fn)
        if "flash_attention_bf16_kernel" in fn and cfg:
            hd, bk, nwg = cfg.groups()
            found[f"hd {hd} (BK {bk}, {nwg} consumer warpgroups)"] = c
    log("flash_attention bf16 SASS (cuobjdump -sass): " + "; ".join(
        f"{name}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}"
        for name, c in sorted(found.items())))
    if len(found) != 3 or not all(c["HGMMA"] and c["UTMALDG"]
                                  for c in found.values()):
        raise AssertionError(f"the bf16 flash kernels lack tensor-core or "
                             f"TMA instructions: {found}")
    return found


def phase_lm(torch):
    """Phase 7: dense-LM serving on the card (qwen1.5-0.5b, full width,
    bf16): (a) the flash kernel at every dense config's attention shape,
    (b) prefill + greedy decode with every launch counted, held to the
    plain attention path, which refuses two wrong attentions, (c) the
    serve CLI at its defaults.  Returns the
    flash kernel's row and the launch counts of (b)."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers as LY
    from repro_torch.models.param import leaves

    bf16 = torch.bfloat16
    f32 = torch.float32
    flash_sass()
    rows = {}
    for arch, Hq, Hkv, hd in LM_ATTN:
        for dtype in (bf16, f32):
            rows[arch, dtype] = flash_case(torch, LM_BATCH, LM_PROMPT, Hq,
                                           Hkv, hd, dtype,
                                           controls=arch == LM_ARCH)
    _, Hq, Hkv, hd = LM_ATTN[0]
    # 2000 = a length that is no tile multiple; queries at 1024..2047
    for dtype in (bf16, f32):
        for S, off in ((LM_PROMPT - 48, 0), (LM_PROMPT, LM_PROMPT // 2)):
            flash_case(torch, LM_BATCH, S, Hq, Hkv, hd, dtype, q_offset=off)

    cfg = get_config(LM_ARCH)
    S_max = LM_PROMPT + LM_GEN
    params = serve.init_params(cfg, SEED, DEV)
    prompts = serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, SEED + 1, DEV)
    n_params = sum(p.numel() for p in leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tok, logits, cache = serve.prefill(cfg, params, prompts, S_max)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches_prefill = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    gen = serve.decode(cfg, params, cache, tok, LM_PROMPT, LM_GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches_decode = {k: launches[k] - launches_prefill[k] for k in launches}
    steps = LM_GEN - 1
    log(f"lm {LM_ARCH}: {n_params / 1e9:.3f}B params bf16, prefill "
        f"{LM_BATCH}x{LM_PROMPT}: {t_prefill * 1e3:.2f} ms (first call); "
        f"decode {steps} steps: {t_decode * 1e3 / steps:.3f} ms/step, "
        f"{LM_BATCH * steps / t_decode:.1f} tok/s; peak_mem_gib={peak:.2f}")
    log("lm kernels prefill " + json.dumps(launches_prefill) + " decode "
        + json.dumps(launches_decode))
    for r in range(2):
        log(f"lm generated ids row {r}: {gen[r, :16].tolist()}")
    if gen.shape != (LM_BATCH, LM_GEN) or not bool(
            ((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError(f"generated ids malformed: {gen.shape}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("non-finite prefill logits")
    if (launches_prefill["flash_attention"] != cfg.n_layers
            or launches_decode["flash_attention"] != 0):
        raise AssertionError(f"flash_attention launches: prefill "
                             f"{launches_prefill}, decode {launches_decode}; "
                             f"expected {cfg.n_layers} and 0")

    # the same prefill through the plain attention, held to the kernel path
    # on the last-position logits and on every layer's prompt K/V (layer
    # l's K/V carry layers 0..l-1's attention at every position); then
    # wrong attentions through the plain path, which the same comparison
    # must refuse
    def plain_prefill(**wrong):
        orig = LY.chunked_attention
        LY.chunked_attention = (lambda q, k, v, **kw:
                                orig(q, k, v, **{**kw, **wrong}))
        try:
            return serve.prefill(cfg, params, prompts, S_max,
                                 use_kernels=False)[1:]
        finally:
            LY.chunked_attention = orig

    plain_logits, plain_cache = plain_prefill()
    want = plain_logits[:, -1].float()
    scale = float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_TOL * scale

    def compare(name, got_logits, got_cache):
        got = got_logits[:, -1].float()
        err = float((got - want).abs().max()) / scale
        num = den = 0.0
        for slot, kv in plain_cache["stack"].items():
            for key, ref_t in kv.items():
                for layer in range(ref_t.shape[0]):
                    x = got_cache["stack"][slot][key][layer, :, :LM_PROMPT]
                    y = ref_t[layer, :, :LM_PROMPT].float()
                    num = max(num, float((x.float() - y).abs().max()))
                    den = max(den, float(y.abs().max()))
        kv_err = num / den
        differ = int((got.argmax(-1) != want.argmax(-1))[clear].sum())
        ok = err <= LM_LOGIT_TOL and kv_err <= LM_KV_TOL and not differ
        log(f"lm prefill, {name} vs plain attention: logits max_abs_err / "
            f"max|plain| = {err:.3e} (tolerance {LM_LOGIT_TOL:.0e}, "
            f"max|plain| {scale:.3f}); prompt K/V max_abs_err / max|plain| "
            f"= {kv_err:.3e} (tolerance {LM_KV_TOL:.0e}, max|plain| "
            f"{den:.3f}); first tokens differing {differ} of "
            f"{int(clear.sum())} rows with a top-2 gap above the logit "
            f"tolerance; all rows equal: "
            f"{bool((got.argmax(-1) == want.argmax(-1)).all())}; within "
            f"tolerance: {ok}")
        return ok

    agree = compare("flash kernel path", logits, cache)
    del cache
    accepted = []
    for name, wrong in LM_CONTROLS:
        wrong_logits, wrong_cache = plain_prefill(**wrong)
        if compare(f"control ({name}, plain path)", wrong_logits,
                   wrong_cache):
            accepted.append(name)
        del wrong_logits, wrong_cache
    if not agree:
        raise AssertionError("kernel and plain prefill disagree")
    if accepted:
        raise AssertionError(f"the kernel-vs-plain comparison accepts a "
                             f"wrong attention: {accepted}")
    del plain_logits, plain_cache
    torch.cuda.empty_cache()

    # steady prefill times, kernel and plain attention in turns, and a
    # profile of one kernel prefill
    def prefill_with(use):
        return lambda: serve.prefill(cfg, params, prompts, S_max,
                                     use_kernels=use)
    times = {True: [], False: []}
    for use in (False, True, True, False):
        times[use].append(wall_ms(torch, prefill_with(use)))
    dev = {key: ms for key, (ms, _) in
           device_ms(torch, prefill_with(True)).items()}
    busy = sum(dev.values())
    flash = sum(v for key, v in dev.items() if "flash_attention" in key)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    log(f"lm prefill steady: kernel {min(times[True]):.2f} ms, plain "
        f"attention {min(times[False]):.2f} ms (min of 2 each); profiled "
        f"device time {busy:.2f} ms, flash_attention {flash:.2f} ms "
        f"({100 * flash / busy:.1f}%); top: "
        + "; ".join(f"{key[:60]} {v:.2f}" for key, v in top))
    del params, prompts, logits
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"LM serve CLI failed:\n{out.stdout}\n"
                             f"{out.stderr}")
    lines = out.stdout.strip().splitlines()
    log(f"lm serve CLI defaults ({time.perf_counter() - t0:.1f}s in all): "
        + " | ".join(line.strip() for line in lines))
    if not (lines[0].startswith("prefill:") and lines[1].startswith("decode:")
            and len(lines) == 5):
        raise AssertionError(f"LM serve CLI output malformed: {lines}")
    row = dict(rows[LM_ARCH, bf16])
    keys = ("max_abs_err", "tol_share", "ms", "plain_ms", "bound_ms",
            "library_ms")
    row["by_arch"] = {f"{arch} {str(dtype)[6:]}": {k: r[k] for k in keys}
                      for (arch, dtype), r in rows.items()}
    return row, launches_prefill, launches_decode


# --- the precision policy and the memory tiers (phases 2, 3 and 9) --------

def bf16_bound(pairs: float, depth: int, nbytes: float):
    """The least time of a bf16 operand form (csrc/bf16_gram.cu) at 700 W:
    one bf16 product of the product depth a pair on the tensor cores, one
    MUFU exp2 a pair, the bytes once.  (ms, "bytes" or "operations", what
    bounds it)."""
    times = {"bf16 products": 2 * depth * pairs / PEAK_BF16_FLOPS,
             "MUFU exps": pairs / PEAK_EX2, "bytes": nbytes / PEAK_BYTES}
    detail = max(times, key=times.get)
    return (times[detail] * 1e3, "bytes" if detail == "bytes"
            else "operations", detail)


def bf16_case(torch, name, c):
    """One bf16 form against its plain version (``kernels.ref``) on the
    same inputs and against float64 on the same bf16-rounded operands
    (exact in float64), both at ``c["tol"]`` of 1 + |value|, or, for the
    forms that sum K w over a row (``c["mag"]``: the plain version with
    |w|, and the float64 one as a fourth entry of ``c["f64"]``), of 1 +
    sum_j |K_ij w_j|: such a sum cancels, and its f32 rounding scales with
    the magnitude of its terms, not of the result (the unshifted bf16
    expansion rounds |x|^2 + |z|^2 - 2 x.z at covtype's norms, where the
    f32 forms' mean shift has removed most of them).  The figure of 1 +
    |value| is logged beside it.  ``c["controls"]`` names wrong forms
    (their values at the float64 check's rows) that the float64 check must
    refuse, so that the limit is shown to tell them from the kernel.  Times
    of the kernel, the plain version, and the bf16 ``torch.matmul`` of the
    products alone (the library yardstick)."""
    got = c["run"]()
    want = c["plain"]()
    torch.cuda.synchronize()
    r = c.get("rows")
    diff = ((got[r] if r is not None else got) - want).abs()
    err = float(diff.max())
    rel_abs = float((diff / (1.0 + want.abs())).max())
    rel = (float((diff / (1.0 + c["mag"]().abs())).max()) if "mag" in c
           else rel_abs)
    mine, plain_part, exact, *mag64 = c["f64"](got, want)
    scale = 1.0 + (mag64[0] if mag64 else exact.abs())
    f64 = {who: float(((val.double() - exact).abs() / scale).max())
           for who, val in (("kernel", mine), ("plain", plain_part))}
    f64_abs = float(((mine.double() - exact).abs()
                     / (1.0 + exact.abs())).max())
    controls = {who: float(((val.double() - exact).abs() / scale).max())
                for who, val in c.get("controls", dict)().items()}
    sym = None
    if c.get("symmetric"):
        sym = bool(torch.equal(got, got.transpose(-1, -2)))
    del got, want, diff, mine, plain_part, exact
    torch.cuda.empty_cache()
    eager_ms = cuda_ms(torch, c["run"], c["reps"])
    # a short kernel's eager calls time the wrapper's host work: its time
    # is that of graph replays, as the level-0 graph launches it
    ms = (graph_ms(torch, c["run"], c["graph_reps"]) if c.get("graph_reps")
          else eager_ms)
    plain_ms = cuda_ms(torch, c["plain"], max(2, c["reps"] // 2))
    mm_ms = cuda_ms(torch, c["matmul"], c["reps"])
    sb, sby, detail = bf16_bound(c["pairs"], c["depth"], c["bytes"])
    of = "1 + sum |K w|" if "mag" in c else "1 + |value|"
    row = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms,
               timed="graph replays" if c.get("graph_reps") else "eager",
               plain_ms=plain_ms, bound_ms=sb, bound_by=sby,
               bound_detail=detail, share_of_bound=sb / ms, matmul_ms=mm_ms,
               max_err_over_1_plus_abs_plain=rel_abs, err_vs_f64=f64["kernel"],
               plain_err_vs_f64=f64["plain"], err_vs_f64_of_1_plus_abs=f64_abs,
               tolerance=f"{c['tol']:.0e} of {of}", shape=c["shape"])
    if sym is not None:
        row["bitwise_symmetric"] = sym
    if controls:
        row["controls_vs_f64"] = controls
    log(f"kernel {name} {c['shape']}: max_abs_err={err:.3e} "
        f"err_vs_plain={rel:.3e} err_vs_f64_on_rounded={f64['kernel']:.3e} "
        f"plain_err_vs_f64_on_rounded={f64['plain']:.3e} (tolerance "
        f"{c['tol']:.0e} of {of}; of 1 + |value|: vs plain {rel_abs:.3e}, "
        f"vs f64 {f64_abs:.3e})"
        + (f" bitwise_symmetric={sym}" if sym is not None else "")
        + "".join(f" control[{who}]_vs_f64={e:.3e}"
                  for who, e in controls.items())
        + f" kernel_ms={ms:.4f} ({row['timed']}; eager calls "
        f"{eager_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={sb:.4f} "
        f"({detail}) share_of_bound={sb / ms:.4f} library_ms(bf16 "
        f"torch.matmul, products only)={mm_ms:.4f}")
    if not rel <= c["tol"]:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rel} > {c['tol']}")
    for who, e in f64.items():
        if not e <= c["tol"]:
            raise AssertionError(f"{name}: the {who} disagrees with float64 "
                                 f"on the rounded operands: {e} > {c['tol']}")
    for who, e in controls.items():
        if not e > c["tol"]:
            raise AssertionError(f"{name}: the control ({who}) passes the "
                                 f"float64 check: {e} <= {c['tol']}")
    if sym is False:
        raise AssertionError(f"{name}: K(X, X) is not symmetric bit for bit")
    torch.cuda.empty_cache()
    return row


def drop_last_stage(w):
    """The weights with the last (partial) MV_STAGE-row stage of Z zeroed:
    what a matvec form that skipped its last stage computes."""
    m = w.shape[-1]
    out = w.clone()
    out[..., m - (m % MV_STAGE or MV_STAGE):] = 0
    return out


def served_row_case(torch, row_form, plain, not_served):
    """The predicated row form as the cached level 0 runs it: captured into
    a CUDA graph once, with its device flag set before each replay.  Not
    served, a replay must agree with the plain version (KERMAT_TOL of 1 +
    |value|); served, it must leave a NaN-filled output untouched.  Times
    (graph replays, no host time between launches): served, and not served
    beside ``not_served``'s eager time; and the served eager call (the
    wrapper's host time).  Its bound is the one byte of the flag."""
    flag = torch.tensor(False, device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        row_form(flag)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = row_form(flag)
    want = plain()
    errs, untouched = [], None
    for is_served in (False, True, False):
        out.fill_(float("nan"))
        flag.fill_(is_served)
        graph.replay()
        torch.cuda.synchronize()
        if is_served:
            untouched = bool(torch.isnan(out).all())
        else:
            errs.append(float(((out - want).abs() / (1 + want.abs())).max()))
    del want

    def replays(is_served, reps=200):
        flag.fill_(is_served)
        graph.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    ms = replays(True)
    computed_ms = replays(False)
    flag.fill_(True)
    eager_ms = cuda_ms(torch, lambda: row_form(flag), 50)
    del graph, out
    sb = 1e3 / PEAK_BYTES
    row = dict(max_abs_err=None, err_not_served=max(errs),
               served_leaves_output=untouched, ms=ms, eager_ms=eager_ms,
               not_served_graph_ms=computed_ms,
               not_served_eager_ms=not_served["eager_ms"], bound_ms=sb,
               bound_by="bytes", share_of_bound=sb / ms,
               shape="predicated row form, served (flag set): "
                     + not_served["shape"])
    log(f"kernel kermat_bf16 predicated row form in a CUDA graph: served "
        f"kernel_ms={ms:.4f} (a graph replay a launch; the eager call "
        f"{eager_ms:.4f}, the wrapper's host time), not served "
        f"{computed_ms:.4f} (eager {not_served['eager_ms']:.4f}); not served vs "
        f"plain {max(errs):.3e} (tolerance {KERMAT_TOL:.0e} of 1 + |value|); "
        f"served left the NaN-filled output untouched: {untouched}; bound "
        f"{sb:.2e} ms (the flag's byte)")
    if not max(errs) <= KERMAT_TOL:
        raise AssertionError(f"the graphed row form disagrees with its plain "
                             f"version: {max(errs)}")
    if not untouched:
        raise AssertionError("the served row form wrote its output")
    if not ms < 0.5 * computed_ms:
        raise AssertionError(f"the served row form did not skip its work: "
                             f"{ms} ms against {computed_ms} not served")
    return row


def phase_bf16_kernels(torch, Xtr, cfg_main, k_leaves, Xf):
    """Phase 2, the bf16 operand forms (compute_dtype="bfloat16") at the
    main path's shapes: kermat on the level-4 cluster Grams (K(X, X), bit
    symmetric) and at the early-scoring bucket, its predicated row form at
    (64, n) once served (the launch returns at once) and once not,
    kernel_matvec at the bucket and n x n, cd_column_update at B = 64 and
    the dedup route, and the pack of the training rows; the slice forms of
    kermat, kernel_matvec and cd_column_update at d = WIDE_D; each against
    its plain version and float64 on the rounded operands.  Bounds count
    the bytes of the function (d bf16 columns and an f32 norm a packed
    row), not those of the padding to 8 columns."""
    from repro_torch.core import Kernel
    from repro_torch.core.predict import early_capacity
    from repro_torch.kernels import ops, ref

    BF = "bfloat16"
    kern = cfg_main.kernel
    rkw = dict(kind=kern.kind, gamma=kern.gamma, degree=kern.degree,
               coef0=kern.coef0)
    g = kern.gamma
    n, d = Xtr.shape
    dp = ops.bf16_width(d)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)

    def q(A):                       # the bf16-rounded rows in f32
        return A.to(torch.bfloat16).float()

    def rows_of(count, width):
        idx = torch.arange(count * width, device=DEV) % n
        return Xtr[idx].reshape(count, width, d).contiguous()

    nc = -(-n // k_leaves)
    b = min(k_leaves, cfg_main.gram_budget // (nc * nc * 4))
    Xc = rows_of(b, nc)
    Xcq = Xc.to(torch.bfloat16)
    k1 = cfg_main.k
    nc1 = -(-n // k1)
    cap = early_capacity(N_TEST, k1)
    Q = rows_of(k1, cap).flip(0).contiguous()
    M = rows_of(k1, nc1)
    Qq, Mq = Q.to(torch.bfloat16), M.to(torch.bfloat16)
    # kermat at the bucket of one SERVE_BUCKET-row batch (the (k, cap, n_c)
    # kernel matrix of the whole test set would take 100 GiB)
    cap_s = early_capacity(SERVE_BUCKET, k1)
    Qs, Qsq = Q[:, :cap_s].contiguous(), Qq[:, :cap_s].contiguous()
    v = torch.randn(k1, nc1, device=DEV, generator=gen)
    blk = max(1, 2 ** 28 // (k1 * nc1))
    P = ops.pack_bf16(Xtr)          # the operator's packed rows, once a fit
    Xq16 = Xtr.to(torch.bfloat16)
    vn = torch.randn(n, device=DEV, generator=gen)
    B = 64
    ys = torch.where(torch.rand(n, device=DEV, generator=gen) < 0.5, -1.0,
                     1.0)
    w = torch.randn(B, device=DEV, generator=gen)
    sel = torch.arange(B, device=DEV)
    Psel = P.index(sel)
    pbytes = lambda rows, d=d: rows * (2 * d + 4)            # noqa: E731
    Pf = ops.pack_bf16(Xf)
    ones_f = torch.ones(Xf.shape[0], device=DEV)
    Pf_sel = Pf.index(sel)
    served = torch.tensor(True, device=DEV)
    computed = torch.tensor(False, device=DEV)
    last = slice(n - NXN_ROWS, n)   # the n x n checks' rows: the last block
    last64 = slice(n - F64_ROWS, n)
    F32, DROP = "f32 form, unrounded operands", "last Z stage dropped"
    # the slice forms' rows, packed once (the kernels alone are timed)
    kern_w = Kernel("rbf", gamma=WIDE_GAMMA)
    rkw_w = dict(kind="rbf", gamma=WIDE_GAMMA)
    Xs = torch.rand(n, WIDE_D, device=DEV, generator=gen)
    Xsn = Xs[:WIDE_N]
    Ps, Psn = ops.pack_bf16(Xs), ops.pack_bf16(Xsn)
    Ps_sel = Ps.index(sel)
    Xs16 = Xs.to(torch.bfloat16)
    vs = torch.randn(WIDE_N, device=DEV, generator=gen)
    top = slice(0, F64_ROWS)
    # the X-streamed slice form: its plain version over the last rows
    kern_x = Kernel("rbf", gamma=6.0 / XS_D)
    rkw_x = dict(kind="rbf", gamma=6.0 / XS_D)
    Xx = torch.rand(XS_N, XS_D, device=DEV, generator=gen)
    Px, Xx16 = ops.pack_bf16(Xx), Xx.to(torch.bfloat16)
    vx = torch.randn(XS_N, device=DEV, generator=gen)
    lastx = slice(XS_N - NXN_ROWS, XS_N)
    lastx64 = slice(XS_N - F64_ROWS, XS_N)

    cases = {
        "kermat_bf16": dict(
            run=lambda: ops.kernel_matrix(Xc, Xc, kern, compute_dtype=BF),
            plain=lambda: ref.kermat_bf16_ref(Xc, Xc, **rkw),
            matmul=lambda: torch.bmm(Xcq, Xcq.transpose(1, 2)),
            pairs=b * nc * (nc + 1) // 2, depth=d,
            bytes=4 * b * nc * d + 4 * b * nc * nc,
            f64=lambda got, want: (got[:2, :F64_ROWS], want[:2, :F64_ROWS],
                                   torch.stack([rbf_f64(q(Xc[i, :F64_ROWS]),
                                                        q(Xc[i]), g)
                                                for i in range(2)])),
            symmetric=True, tol=KERMAT_TOL, reps=5, graph_reps=3,
            shape=f"level-4 Grams ({b}, {nc}, {d}) x ({b}, {nc}, {d}), "
                  "K(X, X), f32 rows packed in the call"),
        "kermat_bf16_bucket": dict(
            run=lambda: ops.kernel_matrix(Qs, M, kern, compute_dtype=BF),
            plain=lambda: ref.kermat_bf16_ref(Qs, M, **rkw),
            matmul=lambda: torch.bmm(Qsq, Mq.transpose(1, 2)),
            pairs=k1 * cap_s * nc1, depth=d,
            bytes=4 * k1 * (cap_s + nc1) * d + 4 * k1 * cap_s * nc1,
            f64=lambda got, want: (got[:, :F64_ROWS], want[:, :F64_ROWS],
                                   torch.stack([rbf_f64(q(Qs[i, :F64_ROWS]),
                                                        q(M[i]), g)
                                                for i in range(k1)])),
            tol=KERMAT_TOL, reps=3, graph_reps=3,
            shape=f"early-scoring bucket of a {SERVE_BUCKET}-query batch "
                  f"({k1}, {cap_s}, {d}) x ({k1}, {nc1}, {d})"),
        "kermat_bf16_rows": dict(
            run=lambda: ops.kernel_matrix(Psel, P, kern, compute_dtype=BF,
                                          skip=computed),
            plain=lambda: ref.kermat_bf16_ref(Xtr[:B], Xtr, **rkw),
            matmul=lambda: Xq16[:B] @ Xq16.T,
            pairs=B * n, depth=d, bytes=pbytes(B + n) + 4 * B * n,
            f64=lambda got, want: (got, want, rbf_f64(q(Xtr[:B]), q(Xtr), g)),
            tol=KERMAT_TOL, reps=20, graph_reps=20,
            shape=f"predicated row form, not served ({B}, {dp} packed) x "
                  f"({n}, {dp} packed)"),
        "kernel_matvec_bf16": dict(
            run=lambda: ops.kernel_matvec(Q, M, v, kern, compute_dtype=BF),
            plain=lambda: torch.cat([ref.kernel_matvec_bf16_ref(
                Q[:, r:r + blk], M, v, **rkw) for r in range(0, cap, blk)],
                dim=1),
            matmul=lambda: [torch.bmm(Qq[:, r:r + blk], Mq.transpose(1, 2))
                            for r in range(0, cap, blk)],
            pairs=k1 * cap * nc1, depth=d,
            bytes=4 * (k1 * (cap + nc1) * d + k1 * (nc1 + cap)),
            mag=lambda: torch.cat([ref.kernel_matvec_bf16_ref(
                Q[:, r:r + blk], M, v.abs(), **rkw)
                for r in range(0, cap, blk)], dim=1),
            f64=lambda got, want: (got[:, :F64_ROWS], want[:, :F64_ROWS],
                                   *(torch.stack([rbf_f64(q(Q[i, :F64_ROWS]),
                                                          q(M[i]), g)
                                                  @ w_[i].double()
                                                  for i in range(k1)])
                                     for w_ in (v, v.abs()))),
            controls=lambda: {
                F32: ops.kernel_matvec(Q[:, :F64_ROWS].contiguous(), M, v,
                                       kern),
                DROP: torch.stack([rbf_f64(q(Q[i, :F64_ROWS]), q(M[i]), g)
                                   @ drop_last_stage(v[i]).double()
                                   for i in range(k1)])},
            tol=MV_BF16_TOL, reps=5,
            shape=f"early-scoring bucket ({k1}, {cap}, {d}) x ({k1}, {nc1}, "
                  f"{d})"),
        "kernel_matvec_bf16_nxn": dict(
            run=lambda: ops.kernel_matvec(P, P, vn, kern, compute_dtype=BF),
            plain=lambda: ref.kernel_matvec_bf16_ref(Xtr[last], Xtr, vn,
                                                     **rkw),
            matmul=lambda: Xq16[last] @ Xq16.T,
            pairs=n * n, depth=d, bytes=pbytes(n) + 8 * n, rows=last,
            mag=lambda: ref.kernel_matvec_bf16_ref(Xtr[last], Xtr, vn.abs(),
                                                   **rkw),
            f64=lambda got, want: (got[last64], want[-F64_ROWS:],
                                   *(rbf_f64(q(Xtr[last64]), q(Xtr), g)
                                     @ w_.double() for w_ in (vn, vn.abs()))),
            controls=lambda: {
                F32: ops.kernel_matvec(Xtr[last64], Xtr, vn, kern),
                DROP: rbf_f64(q(Xtr[last64]), q(Xtr), g)
                @ drop_last_stage(vn).double()},
            tol=MV_BF16_TOL, reps=2,
            shape=f"({n}, {dp} packed) x ({n}, {dp} packed), plain over the "
                  f"last {NXN_ROWS} rows (the last X block and Z stage, "
                  f"both partial)"),
        "cd_column_update_bf16": dict(
            run=lambda: ops.cd_column_update(P, ys, Psel, w, kern,
                                             compute_dtype=BF),
            plain=lambda: ref.cd_column_update_bf16_ref(Xtr, ys, Xtr[:B], w,
                                                        **rkw),
            matmul=lambda: Xq16 @ Xq16[:B].T,
            pairs=n * B, depth=d, bytes=pbytes(n + B) + 4 * (2 * n + B),
            mag=lambda: ref.cd_column_update_bf16_ref(Xtr, ys.abs(), Xtr[:B],
                                                      w.abs(), **rkw),
            f64=lambda got, want: (got, want, *(
                ys.double() * (rbf_f64(q(Xtr), q(Xtr[:B]), g) @ w.double()),
                rbf_f64(q(Xtr), q(Xtr[:B]), g) @ w.double().abs())),
            controls=lambda: {F32: ops.cd_column_update(Xtr, ys, Xtr[:B], w,
                                                        kern)},
            tol=MV_BF16_TOL, reps=20, graph_reps=20,
            shape=f"({n}, {dp} packed) x ({B}, {dp} packed)"),
        "cd_column_update_bf16_dedup": dict(
            run=lambda: ops.cd_column_update(Pf, ones_f, Pf_sel, w, kern,
                                             compute_dtype=BF),
            plain=lambda: ref.cd_column_update_bf16_ref(Xf, ones_f, Xf[:B],
                                                        w, kind="rbf",
                                                        gamma=1.0),
            matmul=lambda: Xf.to(torch.bfloat16) @ Xf[:B].to(
                torch.bfloat16).T,
            pairs=Xf.shape[0] * B, depth=Xf.shape[1],
            bytes=pbytes(Xf.shape[0] + B, Xf.shape[1])
            + 4 * (2 * Xf.shape[0] + B),
            mag=lambda: ref.cd_column_update_bf16_ref(
                Xf, ones_f, Xf[:B], w.abs(), kind="rbf", gamma=1.0),
            f64=lambda got, want: (got, want, *(
                rbf_f64(q(Xf), q(Xf[:B]), 1.0) @ w_.double()
                for w_ in (w, w.abs()))),
            controls=lambda: {F32: ops.cd_column_update(
                Xf, ones_f, Xf[:B], w, Kernel("rbf", gamma=1.0))},
            tol=MV_BF16_TOL, reps=50, graph_reps=20,
            shape=f"dedup route, epsilon-SVR base rows, y = 1, "
                  f"{tuple(Xf.shape)} x ({B}, {Xf.shape[1]})"),
        "kernel_matvec_bf16_wide": dict(
            run=lambda: ops.kernel_matvec(Psn, Psn, vs, kern_w,
                                          compute_dtype=BF),
            plain=lambda: ref.kernel_matvec_bf16_ref(Xsn, Xsn, vs, **rkw_w),
            matmul=lambda: Xs16[:WIDE_N] @ Xs16[:WIDE_N].T,
            pairs=WIDE_N * WIDE_N, depth=WIDE_D,
            bytes=pbytes(WIDE_N, WIDE_D) + 8 * WIDE_N,
            mag=lambda: ref.kernel_matvec_bf16_ref(Xsn, Xsn, vs.abs(),
                                                   **rkw_w),
            f64=lambda got, want: (got[top], want[top], *(
                rbf_f64(q(Xsn[top]), q(Xsn), WIDE_GAMMA) @ w_.double()
                for w_ in (vs, vs.abs()))),
            # (the f32 form's error on unrounded uniform rows averages out
            # over 32,768 terms: not a control here)
            controls=lambda: {DROP: rbf_f64(q(Xsn[top]), q(Xsn), WIDE_GAMMA)
                              @ drop_last_stage(vs).double()},
            tol=MV_BF16_TOL, reps=5,
            shape=f"slice form ({WIDE_N}, {WIDE_D}) x ({WIDE_N}, {WIDE_D}), "
                  "packed"),
        "kernel_matvec_bf16_xstream": dict(
            run=lambda: ops.kernel_matvec(Px, Px, vx, kern_x,
                                          compute_dtype=BF),
            plain=lambda: ref.kernel_matvec_bf16_ref(Xx[lastx], Xx, vx,
                                                     **rkw_x),
            matmul=lambda: Xx16 @ Xx16.T,
            pairs=XS_N * XS_N, depth=XS_D,
            bytes=pbytes(XS_N, XS_D) + 8 * XS_N, rows=lastx,
            mag=lambda: ref.kernel_matvec_bf16_ref(Xx[lastx], Xx, vx.abs(),
                                                   **rkw_x),
            f64=lambda got, want: (got[lastx64], want[-F64_ROWS:], *(
                rbf_f64(q(Xx[lastx64]), q(Xx), 6.0 / XS_D) @ w_.double()
                for w_ in (vx, vx.abs()))),
            controls=lambda: {DROP: rbf_f64(q(Xx[lastx64]), q(Xx),
                                            6.0 / XS_D)
                              @ drop_last_stage(vx).double()},
            tol=MV_BF16_TOL, reps=5,
            shape=f"slice form with X streamed under the ring ({XS_N}, "
                  f"{XS_D}) x ({XS_N}, {XS_D}), packed, plain over the last "
                  f"{NXN_ROWS} rows"),
        "kermat_bf16_wide": dict(
            run=lambda: ops.kernel_matrix(Psn, Psn, kern_w, compute_dtype=BF),
            plain=lambda: ref.kermat_bf16_ref(Xsn, Xsn, **rkw_w),
            matmul=lambda: Xs16[:WIDE_N] @ Xs16[:WIDE_N].T,
            pairs=WIDE_N * (WIDE_N + 1) // 2, depth=WIDE_D,
            bytes=pbytes(WIDE_N, WIDE_D) + 4 * WIDE_N * WIDE_N,
            f64=lambda got, want: (got[top], want[top], rbf_f64(
                q(Xsn[top]), q(Xsn), WIDE_GAMMA)),
            symmetric=True, tol=KERMAT_TOL, reps=5,
            shape=f"slice form ({WIDE_N}, {WIDE_D})^2, K(X, X), packed"),
        "cd_column_update_bf16_wide": dict(
            run=lambda: ops.cd_column_update(Ps, ys, Ps_sel, w, kern_w,
                                             compute_dtype=BF),
            plain=lambda: ref.cd_column_update_bf16_ref(Xs, ys, Xs[:B], w,
                                                        **rkw_w),
            matmul=lambda: Xs16 @ Xs16[:B].T,
            pairs=n * B, depth=WIDE_D,
            bytes=pbytes(n + B, WIDE_D) + 4 * (2 * n + B),
            mag=lambda: ref.cd_column_update_bf16_ref(Xs, ys.abs(), Xs[:B],
                                                      w.abs(), **rkw_w),
            f64=lambda got, want: (got, want, *(
                ys.double() * (rbf_f64(q(Xs), q(Xs[:B]), WIDE_GAMMA)
                               @ w.double()),
                rbf_f64(q(Xs), q(Xs[:B]), WIDE_GAMMA) @ w.double().abs())),
            controls=lambda: {F32: ops.cd_column_update(Xs, ys, Xs[:B], w,
                                                        kern_w)},
            tol=MV_BF16_TOL, reps=20, graph_reps=20,
            shape=f"slice form ({n}, {WIDE_D}) x ({B}, {WIDE_D}), packed"),
        "bf16_pack": dict(
            run=lambda: ops.pack_bf16(Xtr).data,
            plain=lambda: torch.nn.functional.pad(Xq16, (0, dp - d)),
            matmul=lambda: Xtr.to(torch.bfloat16),
            pairs=0, depth=0, bytes=4 * n * d + pbytes(n),
            f64=lambda got, want: (got.float(), want.float(),
                                   torch.nn.functional.pad(q(Xtr).double(),
                                                           (0, dp - d))),
            tol=0.0, reps=20, graph_reps=20,
            shape=f"({n}, {d}) f32 -> ({n}, {dp}) bf16 + f32 norms"),
    }
    rows = {name: bf16_case(torch, name, c) for name, c in cases.items()}
    # the pack's norms: f32 sums of the rounded rows' squares
    nrm_err = float(((P.norms.double() - (q(Xtr).double() ** 2).sum(-1))
                     .abs() / (1 + (q(Xtr).double() ** 2).sum(-1))).max())
    log(f"bf16_pack norms: max error of 1 + |exact| {nrm_err:.3e}")
    if not nrm_err <= 1e-6:
        raise AssertionError(f"bf16_pack norms disagree: {nrm_err}")
    rows["kermat_bf16_rows_served"] = served_row_case(
        torch, lambda skip: ops.kernel_matrix(Psel, P, kern, compute_dtype=BF,
                                              skip=skip),
        cases["kermat_bf16_rows"]["plain"], rows["kermat_bf16_rows"])
    f32_served = cuda_ms(torch, lambda: ops.kernel_matrix(
        Xtr[:B], Xtr, kern, skip=served), 50)
    f32_computed = cuda_ms(torch, lambda: ops.kernel_matrix(
        Xtr[:B], Xtr, kern, skip=computed), 20)
    log(f"f32 kermat row form (host-timed): served {f32_served:.4f} ms, not "
        f"served {f32_computed:.4f} ms")
    return rows


def _cache_line(st):
    return " ".join(f"{k}={st[k]}" for k in (
        "cache_hits", "cache_misses", "cache_hit_rate", "cache_evictions",
        "spills", "spill_hits") if k in st)


def phase_bf16_main(torch, Xtr, ytr, Xte, yte, cfg, main):
    """Phase 9(a): the main path under the precision policy with the column
    cache, compute_dtype="bfloat16" and col_cache_cap=BF16_CACHE (a bf16
    cache of BF16_CACHE x n rows), level 0 graphed with the cache inside the
    graph.  Exact and early accuracy within 0.01 of phase 4's f32 fit, the
    f32 objective of the bf16 alpha against phase 4's, the cache counters
    (hits + misses = iterations x B), seconds a level, launches a kernel;
    then kernel_matvec's bf16 form at decision_exact's shape.  Returns
    (launches, row of that case)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import (accuracy, decision_early, decision_exact,
                                  fit, objective_value)
    from repro_torch.kernels import ops, ref
    from repro_torch.obs.spans import SpanTimer

    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                col_cache_cap=BF16_CACHE)
    level1 = {}

    def cb(level, alpha, st):
        if level == 1:
            level1["alpha"] = alpha.clone()
        extra = (f" iters={st['iters']} pg_max={st['pg_max']:.3e} "
                 + _cache_line(st) if level == 0 else "")
        log(f"bf16 level {level}: clusters={st['clusters']} n_sv={st['n_sv']} "
            f"cluster_s={st['cluster_time']:.2f} solve_s="
            f"{st['train_time']:.2f}{extra}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = SpanTimer()
    ops.reset_launches()
    t0 = time.perf_counter()
    with timer.activate():
        model = fit(cfg16, Xtr, ytr, callback=cb, device=DEV)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    d_exact = decision_exact(model, Xte)
    a1 = level1["alpha"]
    early = dataclasses.replace(model, alpha=a1, beta=a1 * model.y,
                                is_early=True)
    d_early = decision_early(early, Xte)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    obj = float(objective_value(cfg, model.X, model.y, model.alpha))
    acc_exact = accuracy(yte, torch.sign(d_exact))
    acc_early = accuracy(yte, torch.sign(d_early))
    st0 = model.level_stats[-1]
    for name, dv in (("exact", d_exact), ("early", d_early)):
        if dv.shape != yte.shape or not bool(torch.isfinite(dv).all()):
            raise AssertionError(f"bf16 {name} decisions malformed")
    block = max(cfg.block, 64)
    it_ms = 1e3 * st0["train_time"] / max(1, st0["iters"])
    log("bf16 spans_s " + json.dumps(_level_seconds(timer)))
    log(f"bf16 level 0: {it_ms:.4f} ms an iteration (graphed, the cache "
        f"inside the graph; {st0['iters']} iterations in "
        f"{st0['train_time']:.2f} s)")
    log(f"bf16 main: {cfg16.max_iters} iterations a (sub)problem (phase 4: "
        f"{cfg.max_iters}) fit_s={t_fit:.2f} (f32 phase 4: {main['fit_s']:.2f}) "
        f"f32_objective_of_bf16_alpha={obj:.6f} (f32 fit {main['objective']:.6f}"
        f", rel {abs(obj - main['objective']) / abs(main['objective']):.3e}) "
        f"exact_acc={acc_exact:.4f} (f32 {main['acc_exact']:.4f}) early_acc="
        f"{acc_early:.4f} (f32 {main['acc_early']:.4f}) level0_iters="
        f"{st0['iters']} {_cache_line(st0)} cache_gb="
        f"{BF16_CACHE * Xtr.shape[0] * 2 / 1e9:.2f} peak_mem_gib={peak:.2f}")
    log("bf16 kernels " + json.dumps(launches))
    if not math.isfinite(obj):
        raise AssertionError("bf16 objective not finite")
    for what, a, b in (("exact", acc_exact, main["acc_exact"]),
                       ("early", acc_early, main["acc_early"])):
        if not abs(a - b) <= 0.01:
            raise AssertionError(f"bf16 {what} accuracy {a} not within 0.01 "
                                 f"of the f32 fit's {b}")
    if st0["cache_hits"] + st0["cache_misses"] != st0["iters"] * block:
        raise AssertionError(f"cache counters {st0} do not add up to "
                             f"iterations x {block}")
    missing = [k for k in ("bf16_pack", "kermat_bf16", "kernel_matvec_bf16",
                           "kmeans_assign") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the bf16 path: "
                             f"{missing}")
    # kernel_matvec's bf16 form at decision_exact's shape
    rkw = dict(kind=cfg.kernel.kind, gamma=cfg.kernel.gamma)
    sv = torch.as_tensor(model.sv_index, device=DEV)
    Xs, ws = model.X[sv].contiguous(), model.weights[sv].contiguous()
    Xq = Xte.contiguous()
    ns, d = Xs.shape
    nq = Xq.shape[0]
    blk = max(1, 2 ** 28 // ns)
    row = bf16_case(torch, "kernel_matvec_bf16_exact", dict(
        run=lambda: ops.kernel_matvec(Xq, Xs, ws, cfg.kernel,
                                      compute_dtype="bfloat16"),
        plain=lambda: torch.cat([ref.kernel_matvec_bf16_ref(
            Xq[r:r + blk], Xs, ws, **rkw) for r in range(0, nq, blk)]),
        matmul=lambda: [Xq[r:r + blk].to(torch.bfloat16)
                        @ Xs.to(torch.bfloat16).T for r in range(0, nq, blk)],
        pairs=nq * ns, depth=d, bytes=4 * (nq + ns) * d + 4 * (ns + nq),
        mag=lambda: torch.cat([ref.kernel_matvec_bf16_ref(
            Xq[r:r + blk], Xs, ws.abs(), **rkw) for r in range(0, nq, blk)]),
        f64=lambda got, want: (got[:F64_ROWS], want[:F64_ROWS], *(rbf_f64(
            Xq[:F64_ROWS].to(torch.bfloat16).float(),
            Xs.to(torch.bfloat16).float(), cfg.kernel.gamma) @ w_.double()
            for w_ in (ws, ws.abs()))),
        controls=lambda: {
            "f32 form, unrounded operands": ops.kernel_matvec(
                Xq[:F64_ROWS], Xs, ws, cfg.kernel),
            "last Z stage dropped": rbf_f64(
                Xq[:F64_ROWS].to(torch.bfloat16).float(),
                Xs.to(torch.bfloat16).float(), cfg.kernel.gamma)
            @ drop_last_stage(ws).double()},
        tol=MV_BF16_TOL, reps=3,
        shape=f"decision_exact ({nq}, {d}) x ({ns} SVs, {d})"))
    del model, early, d_exact, d_early
    torch.cuda.empty_cache()
    return launches, row, dict(fit_s=t_fit, levels_s=_level_seconds(timer),
                               level0=st0, level0_ms_per_iteration=it_ms)


def phase_spill(torch):
    """Phase 9(b): the spill tier.  fit(host_spill=True) on SPILL_N
    covtype_like rows with gram_budget SPILL_BUDGET: the f32 level-0 Gram is
    SPILL_N^2 x 4 bytes (1 GiB), the device pool holds a quarter of it a
    slot (as benchmarks/bench_outofcore.py sizes it) and the pinned host
    tier all of it.  Rounds, panels, counters, H2D GB/s, the share of the
    panel copies' time that overlapped a sub-solve, the fit's seconds and
    f32 objective against the in-memory fit at the same n (within 1e-3
    relative, the reference's own criterion)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import (DCSVMConfig, Kernel, accuracy,
                                  decision_exact, fit, gramop,
                                  objective_value)
    from repro_torch.data import covtype_like, train_test_split
    from repro_torch.kernels import ops
    from repro_torch.obs.spans import SpanTimer

    avail = [line for line in Path("/proc/meminfo").read_text().splitlines()
             if line.startswith(("MemTotal", "MemAvailable"))]
    log("host memory: " + "; ".join(" ".join(a.split()) for a in avail))
    rng = np.random.default_rng(SEED + 4)
    X, y = covtype_like(rng, SPILL_N + SPILL_N_TEST)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(DEV) for a in train_test_split(
        rng, X, y, test_frac=SPILL_N_TEST / (SPILL_N + SPILL_N_TEST)))
    n = Xtr.shape[0]
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=8.0, k=4, levels=4,
                      m=1000, gram_budget=SPILL_BUDGET, seed=SEED)
    timing: dict = {}
    orig = gramop.solve_box_qp_spill
    out = {}
    for spill in (True, False):
        c = dataclasses.replace(cfg, host_spill=spill)
        torch.cuda.synchronize()
        timer = SpanTimer()
        ops.reset_launches()
        gramop.solve_box_qp_spill = (
            lambda *a, **k: orig(*a, timing=timing, **k))
        try:
            t0 = time.perf_counter()
            with timer.activate():
                model = fit(c, Xtr, ytr, device=DEV)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
        finally:
            gramop.solve_box_qp_spill = orig
        launches = dict(ops.LAUNCHES)
        obj = float(objective_value(cfg, model.X, model.y, model.alpha))
        acc = accuracy(yte, torch.sign(decision_exact(model, Xte)))
        st0 = model.level_stats[-1]
        out[spill] = dict(obj=obj, acc=acc, fit_s=t_fit, st0=st0,
                          launches=launches, levels_s=_level_seconds(timer))
        log(f"spill={spill}: n={n} fit_s={t_fit:.2f} objective={obj:.6f} "
            f"test_acc={acc:.4f} level0_iters={st0['iters']} level0_pg_max="
            f"{st0['pg_max']:.3e} level0_s={st0['train_time']:.2f} "
            f"{_cache_line(st0)} spans_s " + json.dumps(out[spill]["levels_s"])
            + " kernels " + json.dumps(launches))
        del model
        torch.cuda.empty_cache()
    sp, mem = out[True], out[False]
    h2d_gbs = (timing["h2d_bytes"] / (timing["h2d_ms"] * 1e-3) / 1e9
               if timing.get("h2d_ms") else float("nan"))
    hidden = (timing["hidden_ms"] / timing["h2d_ms"]
              if timing.get("h2d_ms") else float("nan"))
    rel = abs(sp["obj"] - mem["obj"]) / abs(mem["obj"])
    log(f"spill tier: rounds={timing['rounds']} panels={timing['panels']} "
        f"rows_a_panel={timing['rows_p']} device_panels={timing['cap_panels']} "
        f"+1 prefetch slot, host tier "
        f"{n * n * 4 / 2 ** 30:.1f} GiB pinned; h2d_gb="
        f"{timing.get('h2d_bytes', 0) / 1e9:.2f} h2d_ms="
        f"{timing.get('h2d_ms', 0.0):.1f} h2d_GB_per_s={h2d_gbs:.2f} "
        f"copy_time_hidden_share={hidden:.3f}; fit_s spill "
        f"{sp['fit_s']:.2f} vs in-memory {mem['fit_s']:.2f}; objective rel "
        f"diff {rel:.3e}")
    st = sp["st0"]
    if not rel <= 1e-3:
        raise AssertionError(f"spill objective {sp['obj']} vs in-memory "
                             f"{mem['obj']}")
    if st["spills"] != timing["panels"] or timing["panels"] < 4:
        raise AssertionError(f"spill panels {st} of {timing['panels']}")
    if timing["rounds"] > 1 and st["spill_hits"] == 0:
        raise AssertionError("no panel re-loaded from the host tier")
    missing = [k for k in ("kermat", "kernel_matvec", "kmeans_assign")
               if sp["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the spill fit: "
                             f"{missing}")
    return sp["launches"], dict({"h2d_bytes": 0, "h2d_ms": 0.0,
                                 "hidden_ms": 0.0}, **timing,
                                h2d_gb_per_s=h2d_gbs, hidden_share=hidden,
                                spill=sp, memory=mem)


def _same_ring(torch, a, b) -> bool:
    """Two rings equal bit for bit (NaN where nothing was recorded)."""
    return (torch.equal(a.buf.view(torch.int32), b.buf.view(torch.int32))
            and torch.equal(a.count, b.count))


def phase_trace(torch, Xtr, ytr, cfg):
    """Phase 10: (a) ROADMAP C4's bounded ring stress check
    (``kernels/ring_stress.py`` at RING_LAUNCHES launches a form, and
    RING_CHECK_LAUNCHES under the ring check build); (b) the traced
    level-0 engines on TRACE_N rows, graphed against eager (bit for bit,
    ring included, the same launches), and untraced graphed (the traced
    results, the same launches); (c) device ms a graphed level-0
    iteration at phase 6's shape and device operations a replay,
    untraced and traced (torch.profiler over TRACE_COST_ITERS
    replays, net of the solve's set-up)."""
    from repro_torch.core import gramop
    from repro_torch.core import solver as S
    from repro_torch.kernels import ops, ring_stress
    from repro_torch.obs.trace import trace_fetch, trace_init

    t0 = time.perf_counter()
    res = ring_stress.stress(RING_LAUNCHES, RING_CHECK_LAUNCHES)
    ring = {name: dict(
        launches=r["launches"], mismatches=len(r["mismatches"]),
        **{key: {k: r[key][k] for k in ("launches", "faults", "checked",
                                        "stages", "blocks_per_sm", "xring")
                 if k in r[key]}
           for key in ("check", "forced") if key in r})
        for name, r in res.items()}
    log(f"phase 10(a) ring stress ({time.perf_counter() - t0:.2f}s): "
        + json.dumps(ring))
    bad = ring_stress.failures(res)
    if bad:
        raise AssertionError(f"ring stress check: {bad}")

    n = TRACE_N
    X, y = Xtr[:n].contiguous(), ytr[:n].contiguous()
    kern = cfg.kernel
    ones = torch.ones(n, device=DEV)

    def level0(cd, cache):
        return lambda g, t: S.solve_box_qp_op(
            gramop.GramOperator(Xd=X, s=y, kernel=kern, use_kernels=True,
                                compute_dtype=cd),
            cfg.C, tol=1e-3, max_iters=150, cache_cap=cache, graph=g,
            trace=t)

    engines = {
        "level-0 block CD": level0(None, 0),
        "cached bf16 branch": level0("bfloat16", 512),
        "pairwise equality step": lambda g, t: S.solve_eq_qp_matvec(
            X, ones, kern, 1.0, 1.0, 0.1 * n, tol=1e-3, max_iters=600,
            use_kernels=True, graph=g, trace=t),
        # 6 iterations (a graph captured and replayed): 0.3-0.45 s each
        # at these rows (Z5, Z6)
        "blocked equality step": lambda g, t: S.solve_eq_qp_matvec(
            X, ones, kern, 1.0, 1.0, 0.1 * n, tol=1e-3, max_iters=6,
            use_kernels=True, block=64, graph=g, trace=t),
        "spill panel step": lambda g, t: gramop.solve_box_qp_spill(
            gramop.GramOperator(Xd=X, s=y, kernel=kern, use_kernels=True),
            cfg.C, tol=1e-3, max_iters=400, block=64,
            device_budget_bytes=1024 * n * 4, graph=g, trace=t)}
    checked = {}
    for name, run in engines.items():
        t0 = time.perf_counter()
        out, launches = {}, {}
        for key in ((False, True), (True, True), (True, False)):
            graph, traced = key
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)
            out[key] = run(graph, trace_init(256, device=DEV)
                           if traced else None)
            torch.cuda.synchronize()
            launches[key] = {k: ops.LAUNCHES[k] - before[k] for k in before
                             if ops.LAUNCHES[k] != before[k]}
        eager, graphed, plain = (out[False, True], out[True, True],
                                 out[True, False])
        same = all(
            _same_ring(torch, a, b) if f == "trace" else
            ((a is None and b is None) or torch.equal(a, b))
            for f in S.SolveResult._fields
            for a, b in [(getattr(eager, f), getattr(graphed, f))])
        untraced = all(torch.equal(getattr(plain, f), getattr(graphed, f))
                       for f in ("alpha", "grad", "iters", "pg_max"))
        fetched = trace_fetch(graphed.trace)
        checked[name] = dict(iters=int(graphed.iters),
                             samples=fetched["samples"],
                             dropped=fetched["dropped"],
                             graphed_equals_eager=same,
                             untraced_equals_traced=untraced,
                             launches=launches[True, True],
                             seconds=time.perf_counter() - t0)
        log(f"phase 10(b) {name}, traced: " + json.dumps(checked[name]))
        if not (same and untraced and plain.trace is None):
            raise AssertionError(f"{name}: traced graphed {same}, untraced "
                                 f"{untraced}")
        if not launches[False, True] == launches[True, True] == launches[
                True, False]:
            raise AssertionError(f"{name}: launches differ: {launches}")
        if not launches[True, True] or fetched["samples"] == 0:
            raise AssertionError(f"{name}: no kernel launch or no sample")
        if name != "spill panel step" and (fetched["samples"]
                                           + fetched["dropped"]
                                           != int(graphed.iters)):
            raise AssertionError(f"{name}: {fetched['samples']} + "
                                 f"{fetched['dropped']} samples of "
                                 f"{int(graphed.iters)} iterations")
        del out
        torch.cuda.empty_cache()

    op = gramop.GramOperator(Xd=Xtr, s=ytr, kernel=kern, use_kernels=True)

    def solve(steps, traced):
        return S.solve_box_qp_op(
            op, cfg.C, tol=-1.0, max_iters=steps, graph=True,
            trace=trace_init(FIT_TRACE, device=DEV) if traced else None)

    # device time of the replays: the profiled run of base + TRACE_COST_
    # ITERS iterations less that of base (both capture: base > GRAPH_
    # WARMUP), by kernel, as phase 6 takes it; and the device operations
    # (kernels, copies) a replay.  The profiler costs about 0.14 s a
    # replay here (some 1,350 device operations each) and 7 s a turn,
    # hence few replays and one turn of each kind.
    t0 = time.perf_counter()
    per, ops_per = {}, {}
    base = 4
    for traced in (False, True):
        solve(base + 2, traced)
        full = counted_device_ms(torch, lambda: solve(
            base + TRACE_COST_ITERS, traced))
        setup = counted_device_ms(torch, lambda: solve(base, traced))
        grown = [(ms - setup.get(key, (0.0, 0))[0],
                  count - setup.get(key, (0.0, 0))[1])
                 for key, (ms, count) in full.items()
                 if count > setup.get(key, (0.0, 0))[1]]
        per[traced] = sum(ms for ms, _ in grown) / TRACE_COST_ITERS
        ops_per[traced] = sum(c for _, c in grown) / TRACE_COST_ITERS
    cost = dict(untraced_ms=per[False], traced_ms=per[True],
                untraced_ops=ops_per[False], traced_ops=ops_per[True],
                shape=f"level-0 block CD ({Xtr.shape[0]}, B=64), graphed, "
                      f"ring of {FIT_TRACE}",
                seconds=time.perf_counter() - t0)
    log(f"phase 10(c) tracing cost: device ms a graphed level-0 iteration "
        f"(torch.profiler, over {TRACE_COST_ITERS} replays) untraced "
        f"{per[False]} traced {per[True]}; device operations a replay "
        f"untraced {ops_per[False]} traced {ops_per[True]} "
        f"({cost['shape']})")
    return dict(ring=ring, engines=checked, trace_cost=cost)


def _capture_fit(store: dict):
    """Around phase 4's fit: keep what phase 11 reuses, level 0's warm
    start (the refine pass's alpha: what ``_solve_full`` starts from) and
    every level's partition, by k."""
    import contextlib

    from repro_torch.core import dcsvm

    @contextlib.contextmanager
    def capture():
        solve_full, kmeans = dcsvm._solve_full, dcsvm.two_step_kernel_kmeans

        def solve(cfg, td, alpha, use_kernels=False):
            store["refine_alpha"] = alpha[0].clone()
            return solve_full(cfg, td, alpha, use_kernels=use_kernels)

        def cluster(kernel, X, k, *a, **kw):
            part = kmeans(kernel, X, k, *a, **kw)
            store.setdefault("partitions", {})[k] = part
            return part

        dcsvm._solve_full, dcsvm.two_step_kernel_kmeans = solve, cluster
        try:
            yield store
        finally:
            dcsvm._solve_full = solve_full
            dcsvm.two_step_kernel_kmeans = kmeans

    return capture()


def _dist_conquer(torch, mesh, X, y, cfg, a0, after_timing):
    """Phase 11(a): the CE-PBM conquer at the split, one rank;
    ``after_timing()`` runs once the round is timed (it starts the
    background parts)."""
    import dataclasses

    from repro_torch.core import distributed as DI
    from repro_torch.core import objective_value
    from repro_torch.core.solver import SYNC_EVERY
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import trace_fetch

    base = DI.ConquerConfig(kernel=cfg.kernel, C=cfg.C, tol=cfg.tol,
                            max_iters=DIST_ROUNDS, block=DIST_B,
                            mode="parallel")

    def run(c, **kw):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = DI.conquer_step(mesh, "i", c, X, y, a0, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(ops.LAUNCHES)

    def obj(alpha):
        return float(objective_value(cfg, X, y, alpha))

    f0 = obj(a0)
    out = {"objective_start": f0}
    # up to DIST_ROUNDS rounds through the kernels, traced
    (alpha, rounds, pg, tr), secs, launches = run(
        dataclasses.replace(base, trace_cap=DIST_ROUNDS))
    rounds, pg = int(rounds), float(pg)
    ring = trace_fetch(tr)["objective"]
    rise = max([b - a for a, b in zip(ring, ring[1:])] + [0.0])
    f1 = obj(alpha)
    steps = launches["cd_column_update"]
    log(f"11(a) conquer, {X.shape[0]} rows, one rank over NCCL, B {DIST_B}, "
        f"traced: {rounds} rounds in {secs:.2f}s, pg_max {pg:.4e} at the "
        f"returned alpha, objective {f0:.6f} -> {f1:.6f}, largest rise of "
        f"the ring's objective {rise:.3e}; launches {launches}")
    if not (math.isfinite(pg) and math.isfinite(f1) and f1 <= f0):
        raise AssertionError(f"11(a): objective {f0} -> {f1}, pg {pg}")
    if rise > DIST_RISE * abs(ring[0]):
        raise AssertionError(f"11(a): the objective rose by {rise}")
    if launches["kernel_matvec"] != 1 or not (
            steps == rounds if rounds == DIST_ROUNDS
            else rounds <= steps < rounds + SYNC_EVERY):
        raise AssertionError(f"11(a) launches {launches}, {rounds} rounds")
    out.update(rounds=rounds, pg_max=pg, objective=f1, seconds=secs,
               ring_rise=rise, launches=launches)

    # ms a round, eager and untraced, and the device's busy share
    bare = dataclasses.replace(base, trace_cap=0)
    # a round's cost: 4 + DIST_TIMED rounds less 4 (both past the
    # sub-solve graph's capture), wall, the least of two runs each (a
    # host hiccup of a second would read 8 ms a round); device time by
    # kernel from the profiler over a run of DIST_PROF rounds, without
    # kernel_matvec (the one initial gradient a conquer; the profiler
    # drops its long record in some runs), over DIST_PROF: every round
    # runs one sub-solve (eagerly in the graph's two warm-up rounds), and
    # the rest of the set-up is a few small kernels.  A profiled session
    # costs seconds (a record of each of the sub-solve graph's 1,280
    # kernels a replay), so there is one, over few rounds
    t0 = time.perf_counter()

    def rounds(s):
        DI.conquer_step(mesh, "i", dataclasses.replace(bare, max_iters=s),
                        X, y, a0)

    rounds(4)       # the first untraced call has a one-off of about 1 s
    wall = (min(wall_ms(torch, lambda: rounds(4 + DIST_TIMED))
                for _ in range(2))
            - min(wall_ms(torch, lambda: rounds(4)) for _ in range(2))
            ) / DIST_TIMED
    dev = {k: ms / DIST_PROF for k, (ms, c) in
           device_ms(torch, lambda: rounds(DIST_PROF)).items()
           if "kernel_matvec" not in k}
    out["timing_s"] = time.perf_counter() - t0
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    log(f"11(a) a round, eager, untraced: {wall:.4f} ms wall, device "
        f"{busy:.4f} ms, busy {100 * busy / wall:.1f}% (over "
        f"{DIST_TIMED} rounds, the profiler over {DIST_PROF}; "
        f"{out['timing_s']:.1f}s); top: "
        + "; ".join(f"{k[:50]} {v:.4f}" for k, v in top))
    out.update(ms_round=wall, device_ms_round=busy, busy=busy / wall)
    after_timing()

    # the first DIST_HOLD rounds through the kernels, the plain versions
    # and the cached path, traced: where their objectives first part
    t0 = time.perf_counter()
    held, rings = {}, {}
    for name, over in (("kernels", {}), ("plain", dict(use_kernels=False)),
                       ("cached", dict(cache_cap=DIST_CACHE))):
        counters = {}
        (a, r, p, t), secs, launched = run(dataclasses.replace(
            bare, max_iters=DIST_HOLD, grad_chunks=DIST_GRAD_CHUNKS,
            trace_cap=DIST_HOLD, **over), counters=counters)
        rings[name] = trace_fetch(t)["objective"]
        held[name] = dict(rounds=int(r), objective=rings[name][-1],
                          seconds=secs,
                          launches=launched,
                          **{k: int(v) for k, v in counters.items()})

    def parted(a, b):
        return next((i for i, (u, v) in enumerate(zip(a, b))
                     if abs(u - v) > 1e-6 * abs(v)), None)

    fk = held["kernels"]["objective"]
    for name in ("plain", "cached"):
        h = held[name]
        h["rel"] = abs(h["objective"] - fk) / abs(fk)
        h["parted_at_round"] = parted(rings["kernels"], rings[name])
        log(f"11(a) {DIST_HOLD} rounds, kernels / {name}: rounds "
            f"{held['kernels']['rounds']} / {h['rounds']}, objective "
            f"{fk:.6f} / {h['objective']:.6f} (rel {h['rel']:.3e}; the "
            f"rings' objectives part at round {h['parted_at_round']}), "
            f"{held['kernels']['seconds']:.2f} / {h['seconds']:.2f}s; "
            f"launches {h['launches']}")
    c = held["cached"]
    log(f"11(a) cached ({DIST_CACHE} rows of {X.shape[0]}): hits "
        f"{c['cache_hits']} + misses {c['cache_misses']} rows")
    for name in ("plain", "cached"):
        if held[name]["rounds"] != held["kernels"]["rounds"] \
                or held[name]["rel"] > DIST_PATH_TOL:
            raise AssertionError(f"11(a) kernels vs {name}: {held}")
    if c["cache_hits"] + c["cache_misses"] != c["rounds"] * DIST_B:
        raise AssertionError(f"11(a) cache counters: {c}")
    out["held"] = held
    out["held_s"] = time.perf_counter() - t0

    # bf16 with the cache, kernels against plain
    t0 = time.perf_counter()
    bf = {}
    for use_kernels in (True, False):
        (a, r, p, t), secs, launched = run(dataclasses.replace(
            bare, max_iters=DIST_BF16_ROUNDS, cache_cap=DIST_CACHE,
            compute_dtype="bfloat16", use_kernels=use_kernels,
            grad_chunks=DIST_GRAD_CHUNKS, trace_cap=DIST_BF16_ROUNDS))
        bf[use_kernels] = (int(r), trace_fetch(t)["objective"][-1], secs,
                           launched)
    (rk, fk, sk, lk), (rp, fp, sp, _) = bf[True], bf[False]
    log(f"11(a) bf16 + cache, {DIST_BF16_ROUNDS} rounds, kernels / plain: "
        f"rounds {rk} / {rp}, objective {fk:.6f} / {fp:.6f} (rel "
        f"{abs(fk - fp) / abs(fp):.3e}), {sk:.2f} / {sp:.2f}s; kernel "
        f"launches {lk}")
    if rk != rp or abs(fk - fp) > DIST_PATH_TOL * abs(fp) \
            or not lk["kermat_bf16"] or not lk["kernel_matvec_bf16"]:
        raise AssertionError(f"11(a) bf16: {bf}")
    out["bf16"] = dict(kernels=bf[True][:3], plain=bf[False][:3])
    out["bf16_s"] = time.perf_counter() - t0
    return out


def _dist_divide(torch, mesh, X, y, cfg, part):
    """Phase 11(b): divide_step on DIST_CLUSTERS of phase 4's level-4
    clusters: bit for bit solve_box_qp on the same kermat Grams, and bit
    for bit again one cluster at a time."""
    import dataclasses

    import numpy as np

    from repro_torch.core import distributed as DI
    from repro_torch.core import solver as S
    from repro_torch.kernels import ops

    idx, mask = part.idx[:DIST_CLUSTERS], part.mask[:DIST_CLUSTERS]
    gi = torch.as_tensor(np.maximum(idx, 0), device=DEV)
    m = torch.as_tensor(mask, device=DEV)
    Xc, yc = X[gi].contiguous(), y[gi]
    pc, cc = torch.full_like(yc, -1.0), torch.full_like(yc, cfg.C)
    ac = torch.zeros_like(yc)
    k, nc = idx.shape
    dcfg = dataclasses.replace(cfg, max_iters=DIST_DIVIDE_ITERS)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = DI.divide_step(mesh, "i", dcfg, Xc, yc, pc, cc, ac, m)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    K = torch.stack([ops.kernel_matrix(Xc[j], Xc[j], cfg.kernel)
                     for j in range(k)])
    Q = (yc[:, :, None] * yc[:, None, :]) * torch.where(
        m[:, :, None] & m[:, None, :], K, 0.0)
    Q = Q + torch.diag_embed((~m).to(Q.dtype))
    ref = S.solve_box_qp(Q, cc, alpha0=torch.where(m, ac, 0.0), tol=cfg.tol,
                         max_iters=DIST_DIVIDE_ITERS, active_mask=m, p=pc)
    del K, Q
    # the sequential sweep (a budget one byte short of the batch) on the
    # first DIST_SEQ_CLUSTERS: bit for bit the batched solve's rows (each
    # cluster's Gram and solve are the same bits in a batch or alone)
    ks = DIST_SEQ_CLUSTERS
    seq = dataclasses.replace(dcfg, gram_budget=ks * nc * nc * 4 - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_seq = DI.divide_step(mesh, "i", seq, Xc[:ks], yc[:ks], pc[:ks],
                           cc[:ks], ac[:ks], m[:ks])
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    same, same_seq = torch.equal(A, ref.alpha), torch.equal(A_seq, A[:ks])
    iters = ref.iters.cpu()
    log(f"11(b) divide_step, {k} level-4 clusters of up to {nc} rows at "
        f"{DIST_DIVIDE_ITERS} iterations: {t_batch:.2f}s batched "
        f"(iterations {int(iters.min())}-{int(iters.max())}), bit for bit "
        f"solve_box_qp on the same kermat Grams: {same}; the first {ks} one "
        f"at a time: {t_seq:.2f}s, bit for bit the batch's: {same_seq}; "
        f"launches {launches}")
    if not (same and same_seq) or launches["kermat"] != k:
        raise AssertionError("11(b) divide_step differs")
    return dict(clusters=k, nc=nc, batched_s=t_batch, sequential_s=t_seq,
                sequential_clusters=ks,
                iters=(int(iters.min()), int(iters.max())))


def _dist_rank(rank, world, init, X, y, out_dir, spec):
    """Phase 11(c): one rank of a gloo world on the card (spawned): the
    conquer from zero in both modes and fit_distributed, as ``spec``
    says."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import DCSVMConfig, Kernel
    from repro_torch.core import distributed as DI
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_conquer_mesh

    mesh = make_conquer_mesh("i", device=spec["device"], backend="gloo",
                             init_method=f"file://{init}", world_size=world,
                             rank=rank)
    kern = Kernel("rbf", gamma=spec["gamma"])
    Xt = torch.from_numpy(X).to(mesh.device)
    yt = torch.from_numpy(y).to(mesh.device)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    res = {}
    for mode in ("parallel", "replicated"):
        cfg = DI.ConquerConfig(kernel=kern, C=spec["C"], tol=spec["tol"],
                               max_iters=spec["rounds"], block=spec["B"],
                               mode=mode)
        ops.reset_launches()
        t0 = time.perf_counter()
        a, r, pg = DI.conquer_step(mesh, "i", cfg, Xt, yt,
                                   torch.zeros_like(yt))
        sync()
        res[mode] = dict(alpha=a.cpu().numpy(), rounds=int(r),
                         pg_max=float(pg), seconds=time.perf_counter() - t0,
                         launches=dict(ops.LAUNCHES))
    cfg = DCSVMConfig(kernel=kern, C=spec["C"], k=4, levels=2, m=1000,
                      tol=spec["tol"], seed=spec["seed"],
                      gram_budget=spec["gram_budget"])
    ops.reset_launches()
    t0 = time.perf_counter()
    a, stats = DI.fit_distributed(cfg, mesh, "i", Xt, yt,
                                  conquer_block=spec["B"],
                                  conquer_iters=spec["rounds"])
    sync()
    res["fit"] = dict(alpha=a.cpu().numpy(), stats=stats,
                      seconds=time.perf_counter() - t0,
                      launches=dict(ops.LAUNCHES))
    if rank == 0:
        np.savez(f"{out_dir}/p2.npz", **{m: r.pop("alpha")
                                          for m, r in res.items()})
        with open(f"{out_dir}/p2.json", "w") as f:
            json.dump(res, f)
    mesh.close()


def _dist_two_ranks_start(torch, X, y, cfg, tmp):
    """Phase 11(c): spawn the two ranks (they run beside 11(b))."""
    import torch.multiprocessing as mp

    spec = dict(device="cuda:0" if DEV == "cuda" else DEV, gamma=1.0,
                C=cfg.C, tol=DIST_P2_TOL, rounds=DIST_P2_ROUNDS, B=DIST_B,
                seed=SEED, gram_budget=GRAM_BUDGET)
    ctx = mp.spawn(_dist_rank, args=(2, f"{tmp}/gloo", X.cpu().numpy(),
                                     y.cpu().numpy(), tmp, spec),
                   nprocs=2, join=False)
    return ctx, spec, time.perf_counter()


def _dist_two_ranks(torch, X, y, cfg, tmp, started):
    """Phase 11(c): two ranks on the one card over gloo, against the dense
    solve_with_shrinking on the card (run while the ranks finish)."""
    import numpy as np

    from repro_torch.core import solver as S
    from repro_torch.kernels import ops

    ctx, spec, t0 = started
    kern = type(cfg.kernel)("rbf", gamma=spec["gamma"])
    Q = ops.kernel_matrix(X, X, kern)
    Q.mul_(y[:, None]).mul_(y[None, :])
    t1 = time.perf_counter()
    dense = S.solve_with_shrinking(Q, cfg.C, tol=DIST_P2_TOL,
                                   max_iters=200_000)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t1

    def f(a):
        a = torch.as_tensor(a, device=DEV, dtype=torch.float32)
        return float(0.5 * torch.dot(a.double(), (Q @ a).double())
                     - a.double().sum())

    fd = f(dense.alpha)
    while not ctx.join(timeout=900):
        pass
    t_all = time.perf_counter() - t0
    alphas = dict(np.load(f"{tmp}/p2.npz"))
    with open(f"{tmp}/p2.json") as fh:
        res = json.load(fh)
    out = {"dense": dict(objective=fd, iters=int(dense.iters),
                         seconds=t_dense), "seconds": t_all}
    for name, r in res.items():
        fr = f(alphas[name])
        rel = abs(fr - fd) / abs(fd)
        extra = (f"rounds {r['rounds']}, pg_max {r['pg_max']:.3e}"
                 if name != "fit" else
                 f"levels {[st.get('clusters', st.get('rounds')) for st in r['stats']]}")
        log(f"11(c) two ranks on cuda:0 over gloo, {X.shape[0]} rows, "
            f"{name}: {extra}, objective {fr:.6f} against the dense "
            f"{fd:.6f} ({int(dense.iters)} iterations, {t_dense:.2f}s): "
            f"rel {rel:.3e}, {r['seconds']:.2f}s; launches {r['launches']}")
        if not rel <= 1e-3:
            raise AssertionError(f"11(c) {name}: rel {rel}")
        out[name] = dict(rel=rel, seconds=r["seconds"],
                         **{k: r[k] for k in ("rounds", "pg_max")
                            if k in r})
    log(f"11(c) rounds at P = 2: parallel {res['parallel']['rounds']}, "
        f"replicated {res['replicated']['rounds']} (figures, not checks); "
        f"{t_all:.2f}s in all")
    return out


def _dist_cli_start():
    """Phase 11(d): train_svm --distributed under torch.distributed.run,
    two ranks on the one card over gloo, started (it runs beside 11(b)
    and (c))."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train_svm",
         "--distributed", "--dist-backend", "gloo", "--dataset",
         "covtype_like", "--samples", str(DIST_CLI_N)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, time.perf_counter()


def _dist_cli(started):
    """Phase 11(d): wait for the CLI; it must exit 0 and print its level
    stats."""
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    stats = [line for line in lines if line.startswith("{'level'")]
    if proc.returncode != 0 or not any("'level': 0" in s for s in stats) \
            or not any(line.startswith("done in") for line in lines):
        raise AssertionError(f"11(d) the distributed train CLI failed:\n"
                             f"{stdout}\n{stderr[-4000:]}")
    log(f"11(d) train_svm --distributed, 2 ranks over gloo ({secs:.1f}s "
        "in all): " + " | ".join(line.strip() for line in lines))
    return dict(seconds=secs, stats=stats)


def phase_distributed(torch, Xtr, ytr, cfg, fit4):
    """Phase 11: the distributed DC-SVM (core/distributed.py) on the card,
    with phase 4's data, refine alpha and level-4 partition; the launches
    of (a)'s traced conquer are its kernels' counts."""
    import tempfile

    from repro_torch.launch.mesh import make_conquer_mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    out = {}
    mesh = make_conquer_mesh("i", device=DEV, backend="nccl",
                             init_method=f"file://{tmp}/nccl", world_size=1,
                             rank=0)
    X2, y2 = Xtr[:DIST_P2_N].contiguous(), ytr[:DIST_P2_N].contiguous()
    bg = {}

    def start_background():
        # (c) and (d) check and time nothing: they run beside (a)'s checks
        # and (b), once (a) has timed its round
        bg["cli"] = _dist_cli_start()
        bg["ranks"] = _dist_two_ranks_start(torch, X2, y2, cfg, tmp)

    try:
        t0 = time.perf_counter()
        out["a"] = _dist_conquer(torch, mesh, Xtr, ytr, cfg,
                                 fit4["refine_alpha"], start_background)
        out["a"]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["b"] = _dist_divide(torch, mesh, Xtr, ytr, cfg,
                                fit4["partitions"][cfg.k ** cfg.levels])
        out["b"]["phase_s"] = time.perf_counter() - t0
        mesh.close()
        torch.cuda.empty_cache()
        out["c"] = _dist_two_ranks(torch, X2, y2, cfg, tmp, bg["ranks"])
        out["d"] = _dist_cli(bg["cli"])
        out["bcd_s"] = time.perf_counter() - t0
    finally:
        mesh.close()
        cli = bg.get("cli")
        if cli is not None and cli[0].poll() is None:
            cli[0].kill()
            cli[0].communicate()
        for p in (bg["ranks"][0].processes if "ranks" in bg else ()):
            if p.is_alive():
                p.kill()
    return out


def _cmp_line(torch, name, secs, yte, dec, launches, n_sv=None, extra=""):
    """One comparison solver's line: seconds, test accuracy, SV count and
    launches by kernel; its accuracy must exceed the larger class's share
    of the queries."""
    acc = float((torch.sign(dec) == yte).float().mean())
    share = max(float((yte > 0).float().mean()),
                float((yte < 0).float().mean()))
    used = {k: v for k, v in launches.items() if v}
    log(f"12 {name}: seconds={secs:.2f} test_acc={acc:.4f} (larger class "
        f"{share:.4f}) n_sv={n_sv} launches {json.dumps(used)}{extra}")
    if dec.shape != yte.shape or not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"12 {name}: decisions malformed")
    if not acc > share:
        raise AssertionError(f"12 {name}: accuracy {acc} not above the "
                             f"larger class's share {share}")
    return dict(seconds=secs, acc=acc, n_sv=n_sv, launches=launches)


def _kermat_err(torch, X, Y, kern) -> float:
    """kermat's K(X, Y) against its plain version, of 1 + |plain|."""
    from repro_torch.core.kernels import gram

    k = gram(kern, X, Y, use_kernels=True)
    p = gram(kern, X, Y, use_kernels=False)
    return float(((k - p).abs() / (1.0 + p.abs())).max())


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _cmp_exact(torch, Xtr, ytr, Xte, yte, cfg, warm):
    """12(a): train_exact on the whole split, its Gram-free branch (the
    graphed level-0 engine), traced: the objective never rises, one
    cd_column_update an iteration; CMP_HOLD iterations from ``warm``
    (phase 4's refine alpha) against the plain versions; decision on every
    query, the first CMP_DEC_CHECK held to the plain versions."""
    import dataclasses

    from repro_torch.baselines import train_exact
    from repro_torch.core import objective_value
    from repro_torch.core.solver import SYNC_EVERY
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import trace_fetch, trace_init

    kern, C = cfg.kernel, cfg.C
    ops.reset_launches()
    m = train_exact(Xtr, ytr, kern, C, max_iters=CMP_EXACT_ITERS, device=DEV,
                    trace=trace_init(CMP_EXACT_ITERS, device=DEV))
    fit_launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    dec = m.decision(Xte)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    ring = trace_fetch(m.trace)["objective"]
    rise = max([0.0] + [b - a for a, b in zip(ring, ring[1:])])
    # CMP_HOLD iterations through the kernels and the plain versions from
    # phase 4's refine alpha (DC-SVM's warm start of this solver), both
    # objectives by the one kernel_matvec.  Where the objective still
    # falls fast the two paths part at f32 near-ties of the top-B scores
    # and drift apart: from zero (every |projected gradient| 1) 5.3e-2
    # after 64 iterations, from the traced run's alpha 2.8e-4 (NVIDIA H100
    # 80GB HBM3, 700 W)
    held = {use: float(objective_value(cfg, Xtr, ytr, train_exact(
        Xtr, ytr, kern, C, max_iters=CMP_HOLD, alpha0=warm, device=DEV,
        use_kernels=use, grad_chunks=DIST_GRAD_CHUNKS).alpha))
        for use in (True, False)}
    obj_rel = _rel(held[True], held[False])
    Xq = Xte[:CMP_DEC_CHECK]
    plain = dataclasses.replace(m, use_kernels=False)
    want = plain.decision(Xq).double()
    # sum_j K_ij |w_j| (rbf: K > 0, alpha >= 0)
    mag = dataclasses.replace(plain, y=torch.ones_like(m.y)).decision(Xq)
    dec_err = float(((dec[:CMP_DEC_CHECK].double() - want).abs()
                     / (1.0 + mag.double())).max())
    out = _cmp_line(
        torch, "train_exact (Gram-free, the whole split)",
        m.train_time + t_dec, yte, dec, launches,
        n_sv=int((m.alpha > 0).sum()),
        extra=f"; fit_s={m.train_time:.2f} decision_s={t_dec:.2f} "
        f"iters={m.iters} (cap {CMP_EXACT_ITERS}) pg_max={m.pg_max:.4e} "
        f"objective {ring[0]:.4f} -> {ring[-1]:.4f}, largest rise "
        f"{rise:.3e}; {CMP_HOLD} iterations from phase 4's refine alpha, "
        f"kernels vs plain "
        f"objective {held[True]:.6f} vs {held[False]:.6f} (rel "
        f"{obj_rel:.3e}); decisions on {CMP_DEC_CHECK} queries vs plain "
        f"{dec_err:.3e} of 1 + sum_j |K_ij w_j|")
    steps = fit_launches["cd_column_update"]
    if not (steps == m.iters if m.iters == CMP_EXACT_ITERS
            else m.iters <= steps < m.iters + SYNC_EVERY) \
            or fit_launches["kernel_matvec"] != 1:
        raise AssertionError(f"12(a) launches {fit_launches} against "
                             f"{m.iters} iterations")
    if rise > DIST_RISE * abs(ring[-1]):
        raise AssertionError(f"12(a): the objective rose by {rise}")
    if not obj_rel <= 1e-4:
        raise AssertionError(f"12(a) held iterations: {held}")
    if not dec_err <= EARLY_TOL:
        raise AssertionError(f"12(a) decisions: {dec_err} > {EARLY_TOL}")
    out.update(iters=m.iters, objective=ring[-1], obj_rel=obj_rel,
               dec_err=dec_err, fit_s=m.train_time, decision_s=t_dec)
    return out


def _cmp_cascade(torch, X, y, Xte, yte, cfg):
    """12(b): train_cascade on CMP_N rows, CMP_CASCADE_LEVELS levels; the
    first leaf's Gram and solve held to the plain versions (the solves by
    objective: survivor sets may part at f32 near-ties)."""
    import numpy as np

    from repro_torch.baselines import train_cascade
    from repro_torch.baselines.common import signed
    from repro_torch.core import solver as S
    from repro_torch.core.kernels import gram
    from repro_torch.kernels import ops

    kern, C = cfg.kernel, cfg.C
    ops.reset_launches()
    m = train_cascade(X, y, kern, C, levels=CMP_CASCADE_LEVELS,
                      max_iters=CMP_CASCADE_ITERS, seed=SEED, device=DEV)
    t0 = time.perf_counter()
    dec = m.decision(Xte)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    perm = np.random.default_rng(SEED).permutation(X.shape[0])
    leaf = torch.as_tensor(np.array_split(perm, 2 ** CMP_CASCADE_LEVELS)[0],
                           device=DEV)
    Xl, yl = X[leaf].contiguous(), y[leaf]
    k_err = _kermat_err(torch, Xl, Xl, kern)
    obj = {}
    for use in (True, False):
        r = S.solve_box_qp(signed(gram(kern, Xl, Xl, use_kernels=use), yl),
                           C, max_iters=CMP_CASCADE_ITERS)
        obj[use] = float(S.objective(r.alpha, r.grad))
    obj_rel = _rel(obj[True], obj[False])
    solves = 2 ** (CMP_CASCADE_LEVELS + 1)     # the tree's, and the last
    out = _cmp_line(
        torch, f"train_cascade (levels {CMP_CASCADE_LEVELS}, "
        f"{X.shape[0]} rows)", m.train_time + t_dec, yte, dec, launches,
        n_sv=len(m.sv_index),
        extra=f"; fit_s={m.train_time:.2f} survivors by level "
        f"{list(m.survivors)}; first leaf ({len(leaf)} rows) Gram vs plain "
        f"{k_err:.3e} of 1 + |K|, solve objective {obj[True]:.6f} vs "
        f"{obj[False]:.6f} (rel {obj_rel:.3e})")
    if launches["kermat"] != solves + 1 or any(
            v for k, v in launches.items() if k != "kermat"):
        raise AssertionError(f"12(b) launches {launches}: a kermat a solve "
                             f"({solves}) and the decision's")
    if not k_err <= KERMAT_TOL or not obj_rel <= 1e-4:
        raise AssertionError(f"12(b) first leaf: Gram {k_err}, objective "
                             f"{obj}")
    out.update(survivors=list(m.survivors), k_err=k_err, obj_rel=obj_rel,
               fit_s=m.train_time)
    return out


def _cmp_low_rank(torch, X, y, Xte, yte, cfg):
    """12(c): LLSVM (CMP_LANDMARKS landmarks) and RFF (CMP_FEATURES
    features) on CMP_N rows, their block CD capped at CMP_BLOCK_ITERS outer
    iterations; LLSVM's K_bb and K(X, landmarks) held to the plain versions
    at kermat's tolerance; RFF launches nothing."""
    from repro_torch.baselines import train_llsvm, train_rff
    from repro_torch.kernels import ops

    kern, C = cfg.kernel, cfg.C
    out = {}
    ops.reset_launches()
    m = train_llsvm(X, y, kern, C, num_landmarks=CMP_LANDMARKS,
                    max_iters=CMP_BLOCK_ITERS, seed=SEED, device=DEV)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dec = m.decision(Xte)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    errs = [_kermat_err(torch, m.landmarks, m.landmarks, kern),
            _kermat_err(torch, X, m.landmarks, kern)]
    out["llsvm"] = _cmp_line(
        torch, f"train_llsvm ({CMP_LANDMARKS} landmarks, {X.shape[0]} rows)",
        m.train_time + t_dec, yte, dec, launches,
        extra=f"; fit_s={m.train_time:.2f} (block CD capped at "
        f"{CMP_BLOCK_ITERS}); K_bb and K(X, landmarks) vs plain "
        f"{errs[0]:.3e}, {errs[1]:.3e} of 1 + |K|")
    if launches["kermat"] != 3 or any(v for k, v in launches.items()
                                      if k != "kermat"):
        raise AssertionError(f"12(c) LLSVM launches {launches}")
    if not max(errs) <= KERMAT_TOL:
        raise AssertionError(f"12(c) LLSVM Grams vs plain: {errs}")
    out["llsvm"].update(k_err=errs, fit_s=m.train_time)
    del m
    ops.reset_launches()
    m = train_rff(X, y, kern, C, num_features=CMP_FEATURES,
                  max_iters=CMP_BLOCK_ITERS, seed=SEED, device=DEV)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dec = m.decision(Xte)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    out["rff"] = _cmp_line(
        torch, f"train_rff ({CMP_FEATURES} features, {X.shape[0]} rows)",
        m.train_time + t_dec, yte, dec, launches,
        extra=f"; fit_s={m.train_time:.2f} (block CD capped at "
        f"{CMP_BLOCK_ITERS}); runs no hand-written kernel")
    if any(launches.values()):
        raise AssertionError(f"12(c) RFF launched kernels: {launches}")
    out["rff"]["fit_s"] = m.train_time
    return out


def _cmp_ltpu(torch, Xtr, ytr, Xte, yte, cfg):
    """12(d): LTPU (CMP_UNITS units) on the whole split, Phi held to the
    plain version at kermat's tolerance."""
    from repro_torch.baselines import train_ltpu
    from repro_torch.kernels import ops

    ops.reset_launches()
    m = train_ltpu(Xtr, ytr, cfg.kernel, num_units=CMP_UNITS, seed=SEED,
                   device=DEV)
    t0 = time.perf_counter()
    dec = m.decision(Xte)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    err = _kermat_err(torch, Xtr, m.centers, cfg.kernel)
    out = _cmp_line(
        torch, f"train_ltpu ({CMP_UNITS} units, the whole split)",
        m.train_time + t_dec, yte, dec, launches,
        extra=f"; fit_s={m.train_time:.2f}; Phi vs plain {err:.3e} of "
        "1 + |K|")
    if launches["kermat"] != 2 or any(v for k, v in launches.items()
                                      if k != "kermat"):
        raise AssertionError(f"12(d) LTPU launches {launches}")
    if not err <= KERMAT_TOL:
        raise AssertionError(f"12(d) Phi vs plain: {err}")
    out.update(k_err=err, fit_s=m.train_time)
    return out


def _ckpt_cli_start(ckpt_dir: str):
    """12(e): train_svm --ckpt-dir, started (it runs beside (a)-(d))."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train_svm", "--n",
         str(CMP_CLI_N), "--levels", str(CMP_CLI_LEVELS), "--ckpt-dir",
         ckpt_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _ckpt_cli(torch, started, ckpt_dir: str):
    """12(e): the CLI exits 0, its manifest keeps the last 3 of its
    levels + 1 steps, and each restored alpha is finite, in [0, C] (the
    CLI's default 4) and has one entry a training row."""
    from repro_torch.ckpt import CheckpointManager

    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or not any(line.startswith("done in")
                                       for line in lines):
        raise AssertionError(f"12(e) train_svm --ckpt-dir failed:\n{stdout}"
                             f"\n{stderr[-4000:]}")
    mgr = CheckpointManager(ckpt_dir)
    steps = mgr.steps()
    n_train = int(lines[-1].split("SVs ")[1].split("/")[1])
    want = list(range(CMP_CLI_LEVELS - 1, CMP_CLI_LEVELS + 2))
    found = []
    for s in steps:
        tree = mgr.restore({"alpha": torch.zeros(0),
                            "level": torch.zeros((), dtype=torch.int32)},
                           step=s, device=DEV)
        a = tree["alpha"]
        found.append((s, int(tree["level"]), tuple(a.shape),
                      float(a.min()), float(a.max())))
        if not (a.shape == (n_train,) and bool(torch.isfinite(a).all())
                and float(a.min()) >= 0.0 and float(a.max()) <= 4.0
                and int(tree["level"]) == CMP_CLI_LEVELS + 1 - s):
            raise AssertionError(f"12(e) step {s}: {found[-1]}")
    log(f"12(e) train_svm --n {CMP_CLI_N} --levels {CMP_CLI_LEVELS} "
        f"--ckpt-dir ({secs:.1f}s in all): manifest steps {steps}; "
        f"(step, level, shape, min, max) {found}; " + lines[-1].strip())
    if steps != want:
        raise AssertionError(f"12(e) manifest steps {steps}, want {want}")
    return dict(seconds=secs, steps=steps)


def phase_comparison(torch, Xtr, ytr, Xte, yte, cfg, fit4):
    """Phase 12: the paper's comparison solvers (repro_torch.baselines) on
    phase 4's split (``fit4``: phase 4's refine alpha), and train_svm
    --ckpt-dir in the background."""
    import shutil
    import tempfile

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_cli_")
    cli = _ckpt_cli_start(ckpt_dir)
    out = {}
    try:
        X, y = Xtr[:CMP_N].contiguous(), ytr[:CMP_N].contiguous()
        for key, run in (
                ("exact", lambda: _cmp_exact(torch, Xtr, ytr, Xte, yte, cfg,
                                             fit4["refine_alpha"])),
                ("cascade", lambda: _cmp_cascade(torch, X, y, Xte, yte, cfg)),
                ("low_rank", lambda: _cmp_low_rank(torch, X, y, Xte, yte,
                                                   cfg)),
                ("ltpu", lambda: _cmp_ltpu(torch, Xtr, ytr, Xte, yte, cfg))):
            t0 = time.perf_counter()
            out[key] = run()
            torch.cuda.empty_cache()
            log(f"12 {key}: {time.perf_counter() - t0:.2f}s")
        out["ckpt_cli"] = _ckpt_cli(torch, cli, ckpt_dir)
    finally:
        if cli[0].poll() is None:
            cli[0].kill()
            cli[0].communicate()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out.update(out.pop("low_rank"))
    return out


def comparison_alone():
    """Phase 12 alone (``python -c "import chip_smoke as c;
    c.comparison_alone()"``, about 5 minutes): phase 4's data and fit
    (without its predictions and checks), then phase 12 but the
    checkpoints of phase 4's fit."""
    import numpy as np
    import torch

    from repro_torch.core import DCSVMConfig, Kernel, fit
    from repro_torch.data import covtype_like, train_test_split
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    rng = np.random.default_rng(SEED)
    X, y = covtype_like(rng, N_TRAIN + N_TEST)
    data = train_test_split(rng, X, y, test_frac=N_TEST / (N_TRAIN + N_TEST))
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(DEV) for a in data)
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=8.0, k=4, levels=4,
                      m=1000, gram_budget=GRAM_BUDGET, seed=SEED,
                      max_iters=MAIN_ITERS)
    fit4 = {}
    with _capture_fit(fit4):
        fit(cfg, Xtr, ytr, device=DEV)
    t0 = time.perf_counter()
    out = phase_comparison(torch, Xtr, ytr, Xte, yte, cfg, fit4)
    log(f"phase comparison solvers (12): {time.perf_counter() - t0:.2f}s")
    log("phase 12: " + json.dumps(out, default=str))
    return out


def distributed_alone():
    """Phase 11 alone (``python -c "import chip_smoke as c;
    c.distributed_alone()"``, about 5 minutes): phase 4's data and fit
    (without its predictions and checks), then phase 11 on its refine
    alpha and level-4 partition."""
    import numpy as np
    import torch

    from repro_torch.core import DCSVMConfig, Kernel, fit
    from repro_torch.data import covtype_like, train_test_split
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    rng = np.random.default_rng(SEED)
    X, y = covtype_like(rng, N_TRAIN + N_TEST)
    Xtr, ytr, _, _ = train_test_split(rng, X, y,
                                      test_frac=N_TEST / (N_TRAIN + N_TEST))
    Xtr, ytr = (torch.from_numpy(a).to(DEV) for a in (Xtr, ytr))
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=8.0, k=4, levels=4,
                      m=1000, gram_budget=GRAM_BUDGET, seed=SEED,
                      max_iters=MAIN_ITERS)
    fit4 = {}
    with _capture_fit(fit4):
        fit(cfg, Xtr, ytr, device=DEV)
    t0 = time.perf_counter()
    out = phase_distributed(torch, Xtr, ytr, cfg, fit4)
    log(f"phase distributed (11): {time.perf_counter() - t0:.2f}s")
    log("phase 11: " + json.dumps(out, default=str))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core import (DCSVMConfig, EpsilonSVR, Kernel, NuSVC,
                                  OneClassSVM, WeightedCSVC)
    from repro_torch.data import (covtype_like, friedman1,
                                  gaussian_mixture_imbalanced,
                                  train_test_split, webspam_like)
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    # ptxas -v: registers, spills; the ring check build for phase 10(a)
    libs = build.build_all(verbose=True, variants=True)
    log(f"kernel build: {time.perf_counter() - t0:.2f}s "
        f"({', '.join(p.name for p in libs.values())})")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    X, y = covtype_like(rng, N_TRAIN + N_TEST)
    Xtr, ytr, Xte, yte = train_test_split(rng, X, y,
                                          test_frac=N_TEST / (N_TRAIN + N_TEST))
    if (Xtr.shape[0], Xte.shape[0]) != (N_TRAIN, N_TEST):
        raise AssertionError(f"split {Xtr.shape[0]}/{Xte.shape[0]}")
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(DEV)
                          for a in (Xtr, ytr, Xte, yte))
    log(f"data: covtype_like {Xtr.shape[0]} train / {Xte.shape[0]} test, "
        f"d={Xtr.shape[1]}, {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    Xw, yw = (torch.from_numpy(a).to(DEV) for a in
              webspam_like(np.random.default_rng(SEED + 1), N_WEB))
    log(f"data: webspam_like {Xw.shape[0]} rows, d={Xw.shape[1]}, "
        f"{float((Xw == 0).float().mean()):.3f} of entries zero, "
        f"{time.perf_counter() - t0:.2f}s")

    # friedman1 at its published d = 10 (phase 8(b)'s draw): phase 2's
    # dedup-route rows and phase 3's SVR fit
    Xf, yf = (torch.from_numpy(a).to(DEV) for a in friedman1(
        np.random.default_rng(SEED + 2), SVR_N + SVR_N_TEST, d=SVR_D))
    Xi, yi = (torch.from_numpy(a).to(DEV) for a in gaussian_mixture_imbalanced(
        np.random.default_rng(SEED + 3), FIT_N + FIT_N_TEST, d=10))

    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=8.0, k=4, levels=4,
                      m=1000, gram_budget=GRAM_BUDGET, seed=SEED,
                      max_iters=MAIN_ITERS)
    t0 = time.perf_counter()
    rows = phase_kernels(torch, Xtr, Xte, cfg, cfg.k ** cfg.levels, Xw,
                         Xf[:SVR_N].contiguous())
    rows.update(phase_bf16_kernels(torch, Xtr, cfg, cfg.k ** cfg.levels,
                                   Xf[:SVR_N].contiguous()))
    log(f"phase kernels: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    fw, fw_te = slice(0, FIT_N), slice(FIT_N, FIT_N + FIT_N_TEST)
    cov = (Xtr[:FIT_N], ytr[:FIT_N], Xte[:FIT_N_TEST], yte[:FIT_N_TEST])
    cov_eq = (Xtr[:FIT_N_EQ], ytr[:FIT_N_EQ], Xte[:FIT_N_TEST],
              yte[:FIT_N_TEST])
    fit3 = phase_fit_parity(torch, [
        ("covtype_like", cfg.kernel, cfg.C, cfg.tol, *cov, None, {}),
        ("covtype_like, col_cache_cap 2048", cfg.kernel, cfg.C, cfg.tol,
         *cov, None, {"col_cache_cap": PHASE3_CACHE}),
        ("covtype_like, compute_dtype bfloat16", cfg.kernel, cfg.C, cfg.tol,
         *cov, None, {"compute_dtype": "bfloat16"}),
        ("webspam_like", Kernel("rbf", gamma=WEB_GAMMA), WEB_C, WEB_TOL,
         Xw[fw], yw[fw], Xw[fw_te], yw[fw_te], None, {}),
        ("weighted-svc gaussian_mixture_imbalanced", Kernel("rbf", gamma=8.0),
         4.0, cfg.tol, Xi[fw], yi[fw], Xi[fw_te], yi[fw_te],
         WeightedCSVC(w_pos=10.0), {}),
        ("svr friedman1 (dedup view)", cfg.kernel, SVR_C, cfg.tol,
         Xf[:FIT_N_SVR], yf[:FIT_N_SVR], Xf[fw_te], yf[fw_te],
         EpsilonSVR(eps=SVR_EPS), {"full_gram_threshold": FIT_FULL_GRAM_SVR}),
        ("one-class covtype_like, eq_block_size 1", cfg.kernel, 1.0, cfg.tol,
         *cov, OneClassSVM(nu=OC_NU), {"eq_block_size": 1}),
        ("one-class covtype_like, eq_block_size 64", cfg.kernel, 1.0, cfg.tol,
         *cov_eq, OneClassSVM(nu=OC_NU),
         {"eq_block_size": 64, "full_gram_threshold": FIT_FULL_GRAM_EQ}),
        ("nu-svc with bias covtype_like, eq_block_size 128", cfg.kernel, 1.0,
         cfg.tol, *cov_eq, NuSVC(nu=OC_NU, with_bias=True),
         {"eq_block_size": 128, "full_gram_threshold": FIT_FULL_GRAM_EQ})])
    del Xw, yw, Xf, yf, Xi, yi
    log(f"phase fit parity: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    fit4 = {}
    launches, early, d_eq10, d_early, rows["kernel_matvec_exact"] = \
        phase_main(torch, Xtr, ytr, Xte, yte, cfg, fit4)
    log(f"phase main path: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    dist = phase_distributed(torch, Xtr, ytr, cfg, fit4)
    torch.cuda.empty_cache()
    log(f"phase distributed (11): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    comparison = phase_comparison(torch, Xtr, ytr, Xte, yte, cfg, fit4)
    del fit4
    log(f"phase comparison solvers (12): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    serving, rows["kermat_serving"] = phase_serving(torch, early, Xte, yte,
                                                    d_eq10, d_early)
    log(f"phase serving: {time.perf_counter() - t0:.2f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine_launches = phase_engine(torch, early, Xte, smi)
    del early, d_eq10, d_early
    torch.cuda.empty_cache()
    log(f"phase engine (5b): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    level0 = phase_loops(torch, Xtr, ytr, cfg)
    log(f"phase loops: {time.perf_counter() - t0:.2f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    observed = phase_trace(torch, Xtr, ytr, cfg)
    log(f"phase observability and rings (10): "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    oc_launches, _ = phase_oneclass(torch, Xtr, Xte)
    log(f"phase one-class (8a): {time.perf_counter() - t0:.2f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bf_launches, rows["kernel_matvec_bf16_exact"], bf_main = phase_bf16_main(
        torch, Xtr, ytr, Xte, yte, cfg, MAIN)
    log(f"phase bf16 main path with the column cache (9a): "
        f"{time.perf_counter() - t0:.2f}s")
    del Xtr, ytr, Xte, yte
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    svr_launches, _ = phase_svr(torch)
    log(f"phase svr (8b): {time.perf_counter() - t0:.2f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spill_launches, spill = phase_spill(torch)
    log(f"phase spill tier (9b): {time.perf_counter() - t0:.2f}s")
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows["flash_attention"], lm_prefill, lm_decode = phase_lm(torch)
    launches["flash_attention"] = lm_prefill["flash_attention"]
    log(f"phase lm serving: {time.perf_counter() - t0:.2f}s")

    kernels = []
    extra = {"kermat": {"serving": "kermat_serving"},
             "kernel_matvec": {"nxn": "kernel_matvec_nxn",
                               "exact": "kernel_matvec_exact",
                               "d254": "kernel_matvec_d254"},
             "cd_column_update": {"d254_b64": "cd_column_update_d254_b64",
                                  "d254_b256": "cd_column_update_d254_b256",
                                  "b2": "cd_column_update_b2",
                                  "b512": "cd_column_update_b512",
                                  "dedup": "cd_column_update_dedup"},
             "kmeans_assign": {"routing": "kmeans_assign_routing"}}
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "launches_serving": serving[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        if name in SVM_KERNELS:
            row.update(launches_engine=engine_launches[name],
                       launches_phase8a=oc_launches[name],
                       launches_phase8b=svr_launches[name],
                       matmul_only_ms=r["matmul_ms"],
                       bound_detail=r["bound_detail"],
                       bound_f32_ms=r["bound_f32_ms"],
                       err_vs_f64=r["err_vs_f64"])
            if "max_err_over_1_plus_abs_plain" in r:
                row["max_err_over_1_plus_abs_plain"] = r[
                    "max_err_over_1_plus_abs_plain"]
            if "bitwise_symmetric" in r:
                row["bitwise_symmetric"] = r["bitwise_symmetric"]
            for prefix, key in extra.get(name, {}).items():
                row.update({f"{prefix}_{k}": v for k, v in rows[key].items()})
        else:
            row.update(launches_decode=lm_decode[name],
                       library=f"scaled_dot_product_attention ({r['backend']})",
                       bf16_bound_share=r["tol_share"],
                       bf16_bound_controls=r["controls"], by_arch=r["by_arch"])
        if name == "kernel_matvec":
            row["nxn_plain_rows"] = NXN_ROWS
        if name == "cd_column_update":
            row.update({f"level0_{key}": {m: level0[key][m] for m in
                                          ("ms", "device_ms", "busy",
                                           "cd_ms")}
                        for key in ("graphed", "eager")})
        if name in SVM_KERNELS:
            row.update(launches_phase9a=bf_launches[name],
                       launches_phase9b=spill_launches[name],
                       launches_phase11a=dist["a"]["launches"][name],
                       launches_phase12={
                           k: comparison[k]["launches"][name]
                           for k in ("exact", "cascade", "llsvm", "rff",
                                     "ltpu")})
        kernels.append(row)
    # the bf16 operand forms: launches from phase 9(a)'s bf16 main path;
    # cd_column_update's bf16 form is not on it (the column cache serves
    # level 0 with kermat's row form), so its count comes from phase 3's
    # bf16 fit, whose level 0 runs it
    bf_fit = fit3["covtype_like, compute_dtype bfloat16"]
    bf_extra = {"kermat_bf16": {"bucket": "kermat_bf16_bucket",
                                "rows": "kermat_bf16_rows",
                                "rows_served": "kermat_bf16_rows_served",
                                "wide": "kermat_bf16_wide"},
                "kernel_matvec_bf16": {"nxn": "kernel_matvec_bf16_nxn",
                                       "exact": "kernel_matvec_bf16_exact",
                                       "wide": "kernel_matvec_bf16_wide",
                                       "xstream":
                                           "kernel_matvec_bf16_xstream"},
                "cd_column_update_bf16": {
                    "dedup": "cd_column_update_bf16_dedup",
                    "wide": "cd_column_update_bf16_wide"}}
    for name, replaces in BF16_SOURCES.items():
        r = rows[name]
        on_9a = name != "cd_column_update_bf16"
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/bf16_gram.cu",
               "replaces": replaces,
               "launches": bf_launches[name] if on_9a else bf_fit[name],
               "launches_from": ("phase 9(a) bf16 main path" if on_9a else
                                 "phase 3 compute_dtype=bfloat16 kernel fit"),
               "launches_phase3_bf16_fit": bf_fit[name],
               "launches_phase9a": bf_launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "bound_detail": r["bound_detail"],
               "library_ms": None,
               "matmul_only_ms": r["matmul_ms"],
               "matmul_only": "torch.matmul in bf16, the products only",
               "err_vs_f64_on_rounded": r["err_vs_f64"],
               "max_err_over_1_plus_abs_plain":
                   r["max_err_over_1_plus_abs_plain"], "shape": r["shape"]}
        if "bitwise_symmetric" in r:
            row["bitwise_symmetric"] = r["bitwise_symmetric"]
        for prefix, key in bf_extra.get(name, {}).items():
            row.update({f"{prefix}_{k}": v for k, v in rows[key].items()})
        kernels.append(row)
    log("phase 9: " + json.dumps({
        "bf16_main": {"fit_s": bf_main["fit_s"],
                      "levels_s": bf_main["levels_s"],
                      "level0": bf_main["level0"],
                      "level0_ms_per_iteration":
                          bf_main["level0_ms_per_iteration"]},
        "spill": {k: spill[k] for k in ("rounds", "panels", "rows_p",
                                        "cap_panels", "h2d_bytes", "h2d_ms",
                                        "hidden_ms", "h2d_gb_per_s",
                                        "hidden_share")},
        "spill_fit_s": spill["spill"]["fit_s"],
        "memory_fit_s": spill["memory"]["fit_s"]}, default=str))
    log("phase 10: " + json.dumps(observed, default=str))
    log("phase 11: " + json.dumps(dist, default=str))
    log("phase 12: " + json.dumps(comparison, default=str))
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
