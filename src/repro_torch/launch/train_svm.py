"""DC-SVM end-to-end training command line, every task.

    PYTHONPATH=src python -m repro_torch.launch.train_svm --task svc \\
        --dataset covtype_like --n 20000 --levels 3 [--early 2] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train_svm --task svr \\
        --dataset friedman1 --eps 0.1
    PYTHONPATH=src python -m repro_torch.launch.train_svm \\
        --task weighted-svc --dataset imbalanced --class-weight 20
    PYTHONPATH=src python -m repro_torch.launch.train_svm --task one-class \\
        --dataset outliers --nu 0.1
    PYTHONPATH=src python -m repro_torch.launch.train_svm --task nu-svc \\
        --nu 0.3 [--nu-bias] [--eq-block 64]
    PYTHONPATH=src python -m repro_torch.launch.train_svm --n 20000 \\
        --compute-dtype bfloat16 --host-spill --gram-budget 268435456
    PYTHONPATH=src python -m repro_torch.launch.train_svm --trace fit.json \\
        --trace-cap 4096 --stats-json stats.json
    PYTHONPATH=src python -m repro_torch.launch.train_svm --n 20000 \\
        --levels 3 --dataset covtype_like --ckpt-dir /tmp/dcsvm_ckpt
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train_svm --distributed \\
        --samples 4000 [--dist-backend gloo] [--dist-mode replicated] \\
        [--dist-cache 2048]

Tasks: ``svc`` (hinge C-SVC), ``weighted-svc`` (box ``c_i = C * w_{y_i}``,
``--class-weight POS[,NEG]``), ``svr`` (epsilon-insensitive regression,
``--eps``), ``nu-svc`` (``--nu`` bounds the support mass; ``--nu-bias``
restores the bias, two constraints solved per label group) and
``one-class`` (label-free; ``--nu`` bounds the outlier fraction).
``--eq-block B`` runs the equality tasks on the rank-2B blocked engine (1:
the rank-2 pairwise one).  ``--compute-dtype bfloat16`` rounds the Gram
product operands to bf16 (f32 accumulation); ``--host-spill`` solves level
0 out of core (kernel-row panels in pinned host RAM, a device pool within
``--gram-budget`` bytes).  Prints one line per level (with level 0's
cache and spill counters when there are any) and the reference CLI's
summary line: accuracy (and per-class recall for weighted-svc), MSE and
MAE for svr, outlier recall, precision and F1 for one-class.  ``--trace
PATH`` writes the fit's span tree as Chrome trace-event JSON (Perfetto,
chrome://tracing) and prints its table; ``--trace-cap N`` records the
last N iterations of the level-0 solve into a device ring
(``DCSVMConfig.trace``); ``--stats-json PATH`` writes every level's stats,
the convergence trace among them.

``--ckpt-dir DIR`` saves each level's alpha and level number as it ends
(``ckpt.CheckpointManager``: step ``levels - level + 1``, written on a
background thread, the last 3 steps kept), as the reference's code does.
Nothing is restored: a restart trains from the start.  (The reference's
docstring speaks of saving the assignments and resuming at the next
level; its code saves alpha and level only and restores nothing.)  The
distributed path saves nothing, as in the reference.

``--distributed`` runs ``core.distributed.fit_distributed_model`` (svc,
weighted-svc and svr): every level's clusters and the conquer's rows
sharded over the ranks, the conquer by parallel block minimisation
(``--dist-mode replicated``: one global block a round; ``--dist-cache N``:
a row cache of N slots a rank).  Under ``python -m torch.distributed.run``
each rank takes its own GPU (``--dist-backend nccl``, the default on
CUDA) or shares the card (``gloo``, the default on the CPU); without it
the world is one process.  Only rank 0 prints and writes files.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import (DCSVMConfig, EpsilonSVR, Kernel, NuSVC,
                              OneClassSVM, WeightedCSVC, accuracy, f1, fit,
                              mae, mse, precision, predict_early,
                              predict_exact, recall)
from repro_torch.core.distributed import fit_distributed_model
from repro_torch.data import (checkerboard, covtype_like, friedman1,
                              gaussian_mixture, gaussian_mixture_imbalanced,
                              gaussian_with_outliers, sinc1d,
                              stratified_split, train_test_split,
                              webspam_like)
from repro_torch.launch.mesh import make_conquer_mesh
from repro_torch.obs.spans import SpanTracer

DATASETS = {
    "covtype_like": covtype_like,
    "webspam_like": webspam_like,
    "checkerboard": lambda rng, n: checkerboard(rng, n, cells=4),
    "gaussian": lambda rng, n: gaussian_mixture(rng, n, d=16,
                                                modes_per_class=8),
    "imbalanced": lambda rng, n: gaussian_mixture_imbalanced(rng, n, d=10),
    "outliers": gaussian_with_outliers,
    "sinc1d": sinc1d,
    "friedman1": friedman1,
}
REGRESSION_DATASETS = {"sinc1d", "friedman1"}
# level 0's memory-tier counters, printed when the fit reports them
COUNTERS = ("iters", "cache_hits", "cache_misses", "cache_hit_rate",
            "cache_evictions", "spills", "spill_hits")
ONECLASS_DATASETS = {"outliers"}


def _json_default(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v
                          ).tolist()
    raise TypeError(f"not JSON-serializable: {type(v)!r}")


def parse_class_weight(spec: str):
    """"POS" or "POS,NEG" -> (w_pos, w_neg)."""
    parts = [float(v) for v in spec.split(",") if v]
    if len(parts) == 1:
        return parts[0], 1.0
    if len(parts) == 2:
        return parts[0], parts[1]
    raise ValueError(f"--class-weight expects POS[,NEG], got {spec!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="svc",
                    choices=["svc", "weighted-svc", "svr", "nu-svc",
                             "one-class"])
    ap.add_argument("--dataset", default="gaussian", choices=sorted(DATASETS))
    ap.add_argument("--n", "--samples", dest="n", type=int, default=8000,
                    help="points generated (--samples under "
                         "torch.distributed.run, whose parser takes --n "
                         "for an abbreviation of its own options)")
    ap.add_argument("--C", type=float, default=4.0)
    ap.add_argument("--gamma", type=float, default=8.0)
    ap.add_argument("--kernel", default="rbf", choices=["rbf", "poly", "linear"])
    ap.add_argument("--class-weight", default="10",
                    help="weighted-svc cost multipliers POS[,NEG] on top of C")
    ap.add_argument("--eps", type=float, default=0.1,
                    help="epsilon-SVR insensitivity tube half-width")
    ap.add_argument("--nu", type=float, default=0.1,
                    help="nu-svc / one-class support-mass bound in (0, 1]")
    ap.add_argument("--nu-bias", action="store_true",
                    help="nu-svc only: restore the bias term (two-constraint "
                         "dual, solved per label group)")
    ap.add_argument("--eq-block", type=int, default=1,
                    help="equality-family rank-2B block size B (pairs per "
                         "outer iteration); 1 = rank-2 pairwise engine")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--block", type=int, default=0)
    ap.add_argument("--early", type=int, default=0,
                    help="stop at this level and use early prediction")
    ap.add_argument("--distributed", action="store_true",
                    help="shard the divide/conquer over the ranks of a "
                         "torch.distributed world (svc, weighted-svc and "
                         "svr; a world of one without torch.distributed."
                         "run)")
    ap.add_argument("--dist-mode", default="parallel",
                    choices=["parallel", "replicated"],
                    help="conquer scheme: 'parallel' = P simultaneous local "
                         "block solves per communication round (CE-PBM), "
                         "'replicated' = one global block per round")
    ap.add_argument("--dist-cache", type=int, default=0,
                    help="per-rank kernel-row LRU capacity for the "
                         "parallel conquer (0 = recompute rows on the fly)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend (default: nccl on "
                         "cuda, gloo on cpu; gloo lets several ranks share "
                         "one card)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="Gram product-operand precision (accumulation stays "
                         "f32); float32 keeps the default paths")
    ap.add_argument("--host-spill", action="store_true",
                    help="level-0 out-of-core solve: kernel-row panels live "
                         "in host RAM, a device pool holds the working set "
                         "within --gram-budget bytes")
    ap.add_argument("--gram-budget", type=int, default=0,
                    help="byte budget for Gram storage tiers: a level's "
                         "batch of cluster Grams, the column cache, the "
                         "spill panels (0 = default)")
    ap.add_argument("--ckpt-dir", default="",
                    help="save every level's alpha and level here "
                         "(non-distributed fits)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the fit's span "
                         "tree (divide/conquer phases) to this path and "
                         "print the aggregated span table; load in Perfetto "
                         "or chrome://tracing")
    ap.add_argument("--trace-cap", type=int, default=0,
                    help="device-resident convergence-trace ring capacity "
                         "for the level-0 solve (keeps the LAST N "
                         "per-iteration samples; 0 = tracing off, the "
                         "untraced solver loops)")
    ap.add_argument("--stats-json", default="",
                    help="dump per-level training stats (times, SV counts, "
                         "cache counters, convergence traces) as JSON")
    args = ap.parse_args(argv)

    is_reg = args.dataset in REGRESSION_DATASETS
    if (args.task == "svr") != is_reg:
        ap.error(f"--task {args.task} needs a "
                 f"{'regression' if args.task == 'svr' else 'classification'} "
                 f"dataset; --dataset {args.dataset} is not one "
                 f"(regression: {sorted(REGRESSION_DATASETS)})")
    if args.task == "one-class" and args.dataset not in ONECLASS_DATASETS:
        ap.error(f"--task one-class needs a dataset with inlier/outlier "
                 f"ground truth for evaluation: {sorted(ONECLASS_DATASETS)}; "
                 f"got --dataset {args.dataset}")
    if args.nu_bias and args.task != "nu-svc":
        ap.error("--nu-bias applies to --task nu-svc only")
    if args.distributed and args.task in ("nu-svc", "one-class"):
        raise SystemExit(
            "--distributed covers the box-constrained duals (svc, "
            "weighted-svc, svr); the equality-constrained tasks "
            f"({args.task}) need the pairwise engine -- drop --distributed")
    task = None
    if args.task == "weighted-svc":
        w_pos, w_neg = parse_class_weight(args.class_weight)
        task = WeightedCSVC(w_pos=w_pos, w_neg=w_neg)
    elif args.task == "svr":
        task = EpsilonSVR(eps=args.eps)
    elif args.task == "nu-svc":
        task = NuSVC(nu=args.nu, with_bias=args.nu_bias)
    elif args.task == "one-class":
        task = OneClassSVM(nu=args.nu)

    rng = np.random.default_rng(args.seed)
    X, y = DATASETS[args.dataset](rng, args.n)
    split = stratified_split if args.dataset == "imbalanced" else train_test_split
    Xtr, ytr, Xte, yte = split(rng, X, y)
    extra = {"gram_budget": args.gram_budget} if args.gram_budget > 0 else {}
    if args.compute_dtype != "float32":     # float32 = the default paths
        extra["compute_dtype"] = args.compute_dtype
    if args.trace_cap > 0:
        extra["trace"] = args.trace_cap
    cfg = DCSVMConfig(kernel=Kernel(args.kernel, gamma=args.gamma), C=args.C,
                      k=args.k, levels=args.levels, m=args.m, tol=args.tol,
                      block=args.block, eq_block_size=args.eq_block,
                      early_stop_level=args.early, seed=args.seed,
                      host_spill=args.host_spill, **extra)

    mesh = None
    if args.distributed:
        mesh = make_conquer_mesh("i", device=args.device,
                                 backend=args.dist_backend)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir and mesh is None \
        else None

    def cb(level, alpha, st):
        counters = "".join(f" {k}={st[k]}" for k in COUNTERS if k in st)
        print(f"level {level}: clusters={st.get('clusters', 1)} "
              f"n_sv={st['n_sv']} cluster_t={st.get('cluster_time', 0):.1f}s "
              f"train_t={st['train_time']:.1f}s{counters}", flush=True)
        if mgr is not None:
            mgr.save(cfg.levels - level + 1,
                     {"alpha": alpha,
                      "level": torch.tensor(level, dtype=torch.int32)},
                     blocking=False)

    lead = mesh is None or mesh.rank == 0      # prints and writes files
    tracer = None
    span_ctx = contextlib.nullcontext()
    if args.trace:
        tracer = SpanTracer()
        span_ctx = tracer.activate()
    t0 = time.perf_counter()
    with span_ctx:
        if mesh is None:
            model = fit(cfg, Xtr, None if args.task == "one-class" else ytr,
                        callback=cb, task=task, device=args.device)
        else:
            model = fit_distributed_model(
                cfg, mesh, "i", Xtr, ytr, task=task,
                conquer_block=max(args.block, 64), mode=args.dist_mode,
                cache_cap=args.dist_cache)
    t_train = time.perf_counter() - t0
    if mesh is not None:
        mesh.close()
        if lead:
            group = mesh.backend or "no process group"
            print(f"distributed: {mesh.size} ranks ({group}), device "
                  f"{mesh.device}", flush=True)
            for st in model.level_stats:
                print({k: v for k, v in st.items() if k != "trace"},
                      flush=True)
    if not lead:
        return
    if tracer is not None:
        tracer.write_chrome_trace(args.trace)
        print(f"chrome trace -> {args.trace}", flush=True)
        print(tracer.summary(), flush=True)
    if args.stats_json:
        payload = {"task": args.task, "dataset": args.dataset,
                   "n": int(Xtr.shape[0]), "train_time": t_train,
                   "levels": model.level_stats}
        with open(args.stats_json, "w") as f:
            json.dump(payload, f, indent=1, default=_json_default)
        print(f"stats -> {args.stats_json}", flush=True)
    if model.is_early:
        pred = predict_early(model, Xte).cpu()
        mode = f"early prediction (level {args.early})"
    else:
        pred = predict_exact(model, Xte).cpu()
        mode = "exact"
    if args.task == "svr":
        metrics = f"test mse {mse(yte, pred):.5f} mae {mae(yte, pred):.5f}"
    elif args.task == "one-class":
        metrics = (f"outlier recall {recall(yte, pred, -1.0):.4f} "
                   f"precision {precision(yte, pred, -1.0):.4f} "
                   f"f1 {f1(yte, pred, -1.0):.4f} | pred outlier rate "
                   f"{float(np.mean(pred.numpy() < 0)):.4f} (nu={args.nu}) "
                   f"rho={model.rho:.4f}")
    else:
        metrics = f"test acc {accuracy(yte, pred):.4f}"
        if args.task == "weighted-svc":
            metrics += (f" | recall +1 {recall(yte, pred, 1.0):.4f}"
                        f" -1 {recall(yte, pred, -1.0):.4f}")
    print(f"done in {t_train:.1f}s | {mode} | {metrics} | "
          f"SVs {len(model.sv_index)}/{Xtr.shape[0]}", flush=True)
    if mgr is not None:
        mgr.wait()


if __name__ == "__main__":
    main()
