"""SVM serving for DC-SVM models of every task (port of
``repro.launch.serve_svm``).

Turns a trained ``DCSVMModel`` (C-SVC, weighted C-SVC, nu-SVC, epsilon-SVR,
one-class SVM) or a one-vs-all ``MulticlassModel`` into a compacted,
device-resident ``ServingModel`` and serves batched requests through one
of three strategies:

* ``exact`` -- K(Xq, SV-union) @ W, argmax over classes (paper eq. 10).
* ``early`` -- paper eq. 11: route each query to its nearest kernel-kmeans
  cluster (the fused ``kmeans_assign`` kernel) and score it against ONLY
  that cluster's packed SV block (``predict.bucketed_cluster_scores``).
* ``bcm``   -- precision-weighted combination of the k local models; the
  per-cluster regularized SV Grams are Cholesky-factored at export time.

Export drops every non-SV, packs the per-cluster SV blocks into a dense
(k, max_sv, d) layout with masks (zero weights on padding slots, masked
kernel columns where padding would leak), and puts the whole model on the
device once; the request loop never touches host memory.

Regression models are exported with one beta column and no classes (the
prediction is the score), models with an offset (one-class SVM, nu-SVC
with its bias) with one beta column, one class and ``rho`` (and the
per-cluster ``rho_c`` of an early model): the prediction is +1 where
score - rho >= 0.

    PYTHONPATH=src python -m repro_torch.launch.serve_svm --n 4000 \\
        --classes 3 --strategy early --batch 256 --batches 50 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve_svm --task svr|ocsvm

``--serve-async`` serves a Poisson trace of mixed-size requests through the
continuous-batching engine (``launch/engine.py``) over the versioned
registry (``launch/registry.py``), on the device ``--device`` names:

    PYTHONPATH=src python -m repro_torch.launch.serve_svm --serve-async \
        [--qps 500] [--batches 50] [--max-queue 0] [--timeout-s 0] \
        [--registry manifests.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dcsvm import DCSVMConfig
from repro_torch.core.kernels import Kernel, gram, resolve_use_kernels
from repro_torch.core.kkmeans import KKMeansModel, assign_points
from repro_torch.core.multiclass import MulticlassModel, fit_ova
from repro_torch.core.predict import (_early_program, bucket_size,
                                      early_capacity)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry


class ServingModel(NamedTuple):
    """Device-resident compacted model.

    Binary classifiers are exported with two weight columns (-w, +w) and
    classes (-1, +1), so the argmax request loop is the same for every
    classifier; regression with one column and empty ``classes``; a model
    with an offset with one column, ``classes`` (1,) and ``rho`` (``rho_c``
    (k,) for an early model, empty otherwise).  ``task`` reads the kind off
    the shape of ``classes``."""

    # routing (implicit kernel-kmeans centers)
    Xm: torch.Tensor       # (m, d)
    Wm: torch.Tensor       # (m, k)
    sm: torch.Tensor       # (k,)
    # early strategy: per-cluster packed SV blocks
    Xsv: torch.Tensor      # (k, max_sv, d)
    Wsv: torch.Tensor      # (k, max_sv, n_classes)  zero on padding
    svmask: torch.Tensor   # (k, max_sv)             True on real SVs
    # exact strategy: SV union
    Xall: torch.Tensor     # (ns, d)
    Wall: torch.Tensor     # (ns, n_classes)
    # bcm strategy: Cholesky factor of the regularized masked SV Gram per
    # cluster (identity padding), factored once at export
    Lchol: torch.Tensor    # (k, max_sv, max_sv) lower-triangular
    classes: torch.Tensor  # (n_classes,): empty for svr, (1,) for ocsvm
    rho: torch.Tensor      # () decision offset (0 without one)
    rho_c: torch.Tensor    # (k,) per-cluster offsets of an early model, or (0,)

    @property
    def k(self) -> int:
        return self.Xsv.shape[0]

    @property
    def n_classes(self) -> int:
        return self.classes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.Xall.device

    @property
    def task(self) -> str:
        """"svr" (no classes), "ocsvm" (one) or "svc"."""
        if self.classes.shape[0] == 0:
            return "svr"
        return "ocsvm" if self.classes.shape[0] == 1 else "svc"


def _export_weights(model
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """(W (n, columns), classes, active (n,), rho) of a model."""
    if isinstance(model, MulticlassModel):
        W = (model.alpha * model.Y).T.cpu().numpy()
        return (W, np.asarray(model.classes),
                (model.alpha > 0).any(dim=0).cpu().numpy(), 0.0)
    task = getattr(model, "task", None)
    w = model.weights.cpu().numpy()
    if getattr(task, "has_rho_offset", False):
        return (w[:, None], np.array([1.0], np.float32), w != 0,
                float(model.rho or 0.0))
    if getattr(task, "is_regression", False):
        return w[:, None], np.zeros((0,), np.float32), w != 0, 0.0
    return (np.stack([-w, w], axis=1), np.array([-1.0, 1.0], np.float32),
            w != 0, 0.0)


def export_serving_model(model, noise: float = 1e-2,
                         max_sv_per_cluster: int = 4096,
                         with_bcm: bool = True) -> ServingModel:
    """Compact a trained classifier for serving on its own device: drop
    non-SVs, pack per-cluster SV blocks, prefactor the BCM Grams.

    Clusters holding more than ``max_sv_per_cluster`` SVs are strided down
    to bound the packed block size, which makes ``early``/``bcm`` serving
    an approximation of the training-side decision (a warning says so);
    raise the cap for an exact round trip.  ``with_bcm=False`` skips the
    k (max_sv, max_sv) BCM Grams, the export's largest memory cost."""
    part = model.partition
    if part is None:
        raise ValueError("serving export requires a partitioned model")
    kern = model.config.kernel
    dev = model.X.device
    W, classes, active, rho = _export_weights(model)
    X = model.X.cpu().numpy()
    n_cls = W.shape[1]
    d = X.shape[1]

    sv_lists = []
    n_thinned = 0
    for c in range(part.k):
        members = part.idx[c][part.mask[c]]
        sv = members[active[members]]
        if len(sv) > max_sv_per_cluster:
            sv = sv[:: len(sv) // max_sv_per_cluster + 1]
            n_thinned += 1
        sv_lists.append(sv)
    if n_thinned:
        warnings.warn(
            f"{n_thinned} cluster(s) exceeded max_sv_per_cluster="
            f"{max_sv_per_cluster}; their SV blocks were subsampled, so "
            "early/bcm serving approximates the training-side decision",
            stacklevel=2)
    msv = max(1, max(len(s) for s in sv_lists))
    Xsv = np.zeros((part.k, msv, d), X.dtype)
    Wsv = np.zeros((part.k, msv, n_cls), np.float32)
    svmask = np.zeros((part.k, msv), bool)
    for c, sv in enumerate(sv_lists):
        Xsv[c, : len(sv)] = X[sv]
        Wsv[c, : len(sv)] = W[sv]
        svmask[c, : len(sv)] = True

    union = np.nonzero(active)[0]
    if len(union) == 0:
        union = np.array([0])

    def t(a):
        return torch.as_tensor(a, device=dev)

    Xsv_t, mask_t = t(Xsv), t(svmask)
    if with_bcm:
        Lchol = _bcm_factor(kern, Xsv_t, mask_t, noise,
                            resolve_use_kernels(model.config.use_kernels,
                                                dev))
    else:
        Lchol = torch.zeros((part.k, 0, 0), dtype=torch.float32, device=dev)
    rm = part.model
    return ServingModel(
        Xm=rm.Xm.to(dev), Wm=rm.W.to(dev), sm=rm.s.to(dev),
        Xsv=Xsv_t, Wsv=t(Wsv), svmask=mask_t, Xall=t(X[union]),
        Wall=t(W[union].astype(np.float32)), Lchol=Lchol,
        classes=t(np.asarray(classes)),
        rho=torch.tensor(rho, dtype=torch.float32, device=dev),
        rho_c=_rho_c(model, dev))


def _rho_c(model, dev: torch.device) -> torch.Tensor:
    rho_c = getattr(model, "rho_clusters", None)
    if rho_c is None:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    return torch.as_tensor(rho_c, device=dev).to(torch.float32)


def _bcm_factor(kern: Kernel, Xsv: torch.Tensor, svmask: torch.Tensor,
                noise: float, use_kernels: bool) -> torch.Tensor:
    """Cholesky factors of the masked per-cluster SV Grams plus noise on
    the real block and identity on padding (padding rows of Xsv are zeros;
    for RBF K(x, 0) != 0, so the mask, not the zero rows, keeps padding out
    of the solve).  The Gram is masked in place: at a full-size export it
    is the largest tensor.  Raises naming the cluster whose factor
    fails."""
    K = gram(kern, Xsv, Xsv, use_kernels=use_kernels)
    K.masked_fill_(~(svmask[:, :, None] & svmask[:, None, :]), 0.0)
    K.diagonal(dim1=1, dim2=2).add_(torch.where(svmask, noise, 1.0))
    L, info = torch.linalg.cholesky_ex(K)
    bad = torch.nonzero(info).flatten().tolist()
    if bad:
        raise RuntimeError(
            f"BCM Gram of cluster {bad[0]} is not positive definite "
            f"(cholesky info {int(info[bad[0]])}); raise the noise term")
    return L


# ---------------------------------------------------------------------------
# request programs (scores (nq, n_classes); the argmax happens on device)
# ---------------------------------------------------------------------------

def _cluster_offsets(sm: ServingModel) -> torch.Tensor:
    """(k,) decision offsets, one per cluster: the per-cluster rho_c of an
    early export, else the global rho broadcast (0 without an offset, so
    applying them is a uniform no-op)."""
    if sm.rho_c.shape[0]:
        return sm.rho_c
    return sm.rho.expand(sm.k)


def serve_scores_exact(sm: ServingModel, Xq: torch.Tensor, kern: Kernel,
                       use_kernels: bool = False) -> torch.Tensor:
    return gram(kern, Xq, sm.Xall, use_kernels=use_kernels) @ sm.Wall - sm.rho


def serve_scores_early(sm: ServingModel, Xq: torch.Tensor, kern: Kernel,
                       cap: int, use_kernels: bool = False) -> torch.Tensor:
    """Route + bucketed SV-block scoring: the training side's early program
    (``predict._early_program``) fed the packed serving blocks."""
    route = KKMeansModel(Xm=sm.Xm, W=sm.Wm, s=sm.sm)
    return _early_program(kern, Xq, route, sm.Xsv, sm.Wsv, cap,
                          use_kernels=use_kernels,
                          offsets=_cluster_offsets(sm)[:, None])


def serve_scores_bcm(sm: ServingModel, Xq: torch.Tensor, kern: Kernel,
                     noise: float = 1e-2,
                     use_kernels: bool = False) -> torch.Tensor:
    """All clusters at once: (k, nq, max_sv) masked cross-kernels, two
    triangular solves against the export's factors, precision-weighted
    average of the local decisions."""
    k, nq = sm.k, Xq.shape[0]
    diag = kern.diag(Xq)
    Xb = Xq[None].expand(k, nq, Xq.shape[1]).contiguous()
    Kqs = gram(kern, Xb, sm.Xsv, use_kernels=use_kernels)
    Kqs = Kqs * sm.svmask[:, None, :]
    f = Kqs @ sm.Wsv - _cluster_offsets(sm)[:, None, None]    # (k, nq, C)
    sol = torch.cholesky_solve(Kqs.mT, sm.Lchol)               # (k, s, nq)
    var = torch.clamp(diag[None] - torch.einsum("kqs,ksq->kq", Kqs, sol),
                      min=noise)
    prec = torch.where(sm.svmask.any(dim=1)[:, None], 1.0 / var, 0.0)
    return ((f * prec[..., None]).sum(0)
            / (prec.sum(0) + 1e-12)[:, None])


def serve_batch(sm: ServingModel, Xq, kern: Kernel, strategy: str,
                use_kernels: Optional[bool] = None,
                bucket: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched request: returns (predictions, scores).  Predictions
    are classes (argmax) for classifiers, the score for ``svr`` and
    ``score - rho >= 0 -> +1`` for ``ocsvm`` (every scorer has applied the
    offset already).

    ``bucket``, when given, pads the batch with zero query rows to exactly
    ``bucket`` rows before scoring and slices the results back to the real
    rows, so the early strategy's buffer capacity depends only on the
    bucket.  Per-row scores do not depend on the padding rows."""
    Xq = torch.as_tensor(Xq, device=sm.device).to(sm.Xall.dtype)
    nq = Xq.shape[0]
    if bucket is not None:
        pad = int(bucket) - nq
        if pad < 0:
            raise ValueError(f"bucket={bucket} smaller than the batch ({nq})")
        if pad:
            Xq = torch.cat([Xq, Xq.new_zeros((pad, Xq.shape[1]))])
    use = resolve_use_kernels(use_kernels, sm.device)
    if strategy == "exact":
        scores = serve_scores_exact(sm, Xq, kern, use_kernels=use)
    elif strategy == "early":
        cap = early_capacity(Xq.shape[0], sm.k)
        scores = serve_scores_early(sm, Xq, kern, cap, use_kernels=use)
    elif strategy == "bcm":
        if sm.Lchol.shape[1] == 0:
            raise ValueError("model was exported with with_bcm=False; "
                             "re-export to serve the bcm strategy")
        scores = serve_scores_bcm(sm, Xq, kern, use_kernels=use)
    else:
        raise ValueError(f"unknown strategy: {strategy}")
    scores = scores[:nq]
    if sm.task == "svr":
        return scores[:, 0], scores
    if sm.task == "ocsvm":
        raw = scores[:, 0]
        return torch.where(raw >= 0, 1.0, -1.0).to(raw.dtype), scores
    return sm.classes[torch.argmax(scores, dim=1)], scores


def serving_cache_size() -> int:
    """Kernel libraries loaded so far: any growth between two reads means a
    serving call built or loaded a kernel inside the measured region."""
    from repro_torch.kernels import build

    return len(build._loaded)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_request_loop(sm: ServingModel, kern: Kernel, strategy: str, batches,
                     use_kernels: Optional[bool] = None, warmup: int = 2,
                     metrics: Optional[MetricsRegistry] = None,
                     bucketed: bool = False) -> dict:
    """Drive the request program over a query stream, synchronising after
    each response (a real serving loop), and report latency/throughput.

    ``batches`` is a stacked (num_batches, batch, d) tensor or a sequence
    of (nq_i, d) arrays with ragged sizes; ``bucketed=True`` pads each
    batch to its power-of-two bucket (``predict.bucket_size``).  Warmup
    runs every distinct (shape, bucket) once or more before timing, and
    ``compiles_timed`` (kernel libraries loaded during the timed loop,
    ``serving_cache_size``) must read 0.  With ``metrics``, each latency
    feeds a per-strategy histogram and the loop keeps request/query
    counters; ``early`` also records the per-cluster route counts and the
    extra bucketed rounds, outside the timed loop."""
    dev = sm.device
    if isinstance(batches, (list, tuple)):
        blist = [torch.as_tensor(b, device=dev) for b in batches]
    else:
        batches = torch.as_tensor(batches, device=dev)
        blist = [batches[i] for i in range(batches.shape[0])]
    sizes = [int(b.shape[0]) for b in blist]
    buckets = [bucket_size(n) if bucketed else None for n in sizes]
    uniform = len(set(sizes)) == 1

    distinct = {}
    for b, bk in zip(blist, buckets):
        distinct.setdefault((tuple(b.shape), bk), (b, bk))
    for _ in range(max(1, warmup)):
        for b, bk in distinct.values():
            serve_batch(sm, b, kern, strategy, use_kernels, bucket=bk)
    _sync(dev)

    hist = (metrics.histogram("serve_latency_seconds", strategy=strategy)
            if metrics is not None else None)
    lat = []
    cache0 = serving_cache_size()
    t_all = time.perf_counter()
    for b, bk in zip(blist, buckets):
        t0 = time.perf_counter()
        serve_batch(sm, b, kern, strategy, use_kernels, bucket=bk)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
        if hist is not None:
            hist.observe(lat[-1])
    wall = time.perf_counter() - t_all
    compiles_timed = serving_cache_size() - cache0
    if metrics is not None:
        metrics.counter("serve_requests_total", strategy=strategy).inc(
            len(blist))
        metrics.counter("serve_queries_total", strategy=strategy).inc(
            sum(sizes))
        if compiles_timed:
            metrics.counter("serve_compiles_total", strategy=strategy).inc(
                compiles_timed)
        if strategy == "early":
            _record_route_metrics(sm, kern, blist, buckets, metrics,
                                  resolve_use_kernels(use_kernels, dev))
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    return {
        "strategy": strategy,
        "batch": sizes[0] if uniform else 0,   # 0 = ragged stream
        "batches": len(blist),
        "queries": int(sum(sizes)),
        "compiles_timed": int(compiles_timed),
        "qps": sum(sizes) / max(wall, 1e-9),
        "lat_ms_mean": float(lat_ms.mean()),
        "lat_ms_p50": float(np.percentile(lat_ms, 50)),
        "lat_ms_p95": float(np.percentile(lat_ms, 95)),
        "lat_ms_p99": float(np.percentile(lat_ms, 99)),
    }


def _record_route_metrics(sm: ServingModel, kern: Kernel, blist, buckets,
                          metrics: MetricsRegistry, use_kernels: bool) -> None:
    """Early-strategy routing telemetry: per-cluster query counts and the
    number of EXTRA bucketed scoring rounds caused by per-batch cluster
    loads above ``early_capacity``."""
    route_model = KKMeansModel(Xm=sm.Xm, W=sm.Wm, s=sm.sm)
    assign, _ = assign_points(kern, route_model, torch.cat(blist),
                              use_kernels=use_kernels)
    assign = assign.cpu().numpy()
    total = np.bincount(assign, minlength=sm.k)
    for c in range(sm.k):
        if total[c]:
            metrics.counter("serve_route_total", cluster=str(c)).inc(
                int(total[c]))
    overflow = 0
    off = 0
    for b, bk in zip(blist, buckets):
        row = assign[off: off + b.shape[0]]
        off += b.shape[0]
        if row.size == 0:
            continue
        cap = early_capacity(bk if bk is not None else b.shape[0], sm.k)
        overflow += max(
            0, -(-int(np.bincount(row, minlength=sm.k).max()) // cap) - 1)
    metrics.counter("serve_early_overflow_rounds_total").inc(overflow)


def _serve_async(args, model, Xpool: np.ndarray) -> None:
    """--serve-async: register the model, warm every bucket signature, and
    drive a Poisson trace of mixed-size requests through the continuous-
    batching engine (imports are local: registry and engine import this
    module)."""
    import asyncio

    from repro_torch.launch.engine import (AsyncServingEngine,
                                           DeadlineExceeded, EngineConfig,
                                           EngineOverloaded)
    from repro_torch.launch.registry import ModelRegistry

    registry = ModelRegistry()
    man = registry.register("default", model,
                            with_bcm=(args.strategy == "bcm"))
    if args.registry:
        registry.save(args.registry)
        print(f"registry manifests -> {args.registry}", flush=True)
    engine = AsyncServingEngine(registry, EngineConfig(
        max_batch=args.batch,
        max_queue_rows=args.max_queue if args.max_queue > 0 else None,
        timeout_s=args.timeout_s if args.timeout_s > 0 else None))
    warm = engine.warmup(strategies=[args.strategy])
    rng = np.random.default_rng(args.seed)
    n_req = args.batches
    sizes = rng.choice([1, 4, 16, 64], size=n_req, p=[0.35, 0.3, 0.25, 0.1])
    arrivals = np.cumsum(rng.exponential(1.0 / args.qps, size=n_req))
    lats: list = []
    outcomes = {"shed": 0, "expired": 0}

    async def one(delay: float, size: int) -> None:
        await asyncio.sleep(delay)
        Xq = Xpool[rng.integers(0, Xpool.shape[0], size=size)]
        t0 = time.perf_counter()
        try:
            await engine.submit(Xq, "default", strategy=args.strategy)
        except EngineOverloaded:
            outcomes["shed"] += 1           # the in-process 429
            return
        except DeadlineExceeded:
            outcomes["expired"] += 1
            return
        lats.append(time.perf_counter() - t0)

    async def drive() -> None:
        async with engine:
            await asyncio.gather(*[
                one(float(arrivals[i]), int(sizes[i])) for i in range(n_req)])

    asyncio.run(drive())
    stats = engine.stats()
    # tails over admitted-and-delivered requests only: shed and expired
    # requests fail fast by design and stay out of the latency report
    ms = (np.asarray(lats) * 1e3 if lats else np.asarray([float("nan")]))
    print(f"async {args.strategy} v{man.version}: {n_req} requests "
          f"({int(sizes.sum())} queries) at {args.qps:.0f} offered rps | "
          f"delivered {len(lats)} shed {outcomes['shed']} "
          f"expired {outcomes['expired']} | "
          f"admitted lat ms p50 {np.percentile(ms, 50):.2f} "
          f"p95 {np.percentile(ms, 95):.2f} p99 {np.percentile(ms, 99):.2f} "
          f"| warmup compiles {warm}, after warmup "
          f"{stats['compiles_after_warmup']}", flush=True)
    if args.metrics_out:
        prom = engine.metrics.dump(args.metrics_out)
        print(f"metrics -> {args.metrics_out} and {prom}", flush=True)


def main(argv=None) -> None:
    from repro_torch.core.dcsvm import fit
    from repro_torch.core.predict import accuracy_multiclass, f1, mse, recall
    from repro_torch.core.tasks import EpsilonSVR, OneClassSVM
    from repro_torch.data import (friedman1, gaussian_mixture_multiclass,
                                  gaussian_with_outliers, train_test_split)

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="svc", choices=["svc", "svr", "ocsvm"])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--strategy", default="early",
                    choices=["exact", "early", "bcm"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--gamma", type=float, default=8.0)
    ap.add_argument("--C", type=float, default=4.0)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--nu", type=float, default=0.1,
                    help="one-class support/outlier mass bound")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--metrics-out", default="",
                    help="dump serving metrics (latency histograms, "
                         "request/route counters) as JSON at this path plus "
                         "Prometheus text exposition next to it (.prom)")
    ap.add_argument("--serve-async", action="store_true",
                    help="serve through the asyncio continuous-batching "
                         "engine (launch/engine.py): Poisson arrivals with "
                         "mixed request sizes against the versioned "
                         "registry, instead of the fixed-batch sync loop")
    ap.add_argument("--qps", type=float, default=500.0,
                    help="offered Poisson request rate for --serve-async")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="--serve-async admission bound on queued query "
                         "rows; submits past it shed with EngineOverloaded "
                         "(0 = unbounded)")
    ap.add_argument("--timeout-s", type=float, default=0.0,
                    help="--serve-async default per-request deadline; "
                         "requests expiring in queue resolve with "
                         "DeadlineExceeded before batch formation "
                         "(0 = none)")
    ap.add_argument("--registry", default="",
                    help="write the model registry's manifests JSON here "
                         "(--serve-async)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kern = Kernel("rbf", gamma=args.gamma)
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    if args.task == "svr":
        X, y = friedman1(rng, args.n)
    elif args.task == "ocsvm":
        X, y = gaussian_with_outliers(rng, args.n)
    else:
        X, y = gaussian_mixture_multiclass(rng, args.n, n_classes=args.classes)
    Xtr, ytr, Xte, yte = train_test_split(rng, X, y)
    cfg = DCSVMConfig(kernel=kern, C=args.C, k=args.k, levels=args.levels,
                      m=min(1000, Xtr.shape[0]), tol=1e-3, seed=args.seed)
    if args.task == "svr":
        model = fit(cfg, Xtr, ytr, task=EpsilonSVR(eps=args.eps), device=dev)
        print(f"fit svr: {time.perf_counter() - t0:.1f}s  "
              f"n_sv={len(model.sv_index)}/{Xtr.shape[0]}", flush=True)
    elif args.task == "ocsvm":
        model = fit(cfg, Xtr, task=OneClassSVM(nu=args.nu), device=dev)
        print(f"fit ocsvm: {time.perf_counter() - t0:.1f}s  "
              f"n_sv={len(model.sv_index)}/{Xtr.shape[0]}  "
              f"rho={model.rho:.4f}", flush=True)
    else:
        model = fit_ova(cfg, Xtr, ytr, device=dev)
        print(f"fit_ova: {time.perf_counter() - t0:.1f}s  "
              f"n_sv={len(model.sv_union)}/{Xtr.shape[0]}", flush=True)

    sm = export_serving_model(model)
    pred, _ = serve_batch(sm, Xte, kern, args.strategy)
    pred = pred.cpu()
    if sm.task == "svr":
        print(f"serving mse ({args.strategy}): {mse(yte, pred):.5f}",
              flush=True)
    elif sm.task == "ocsvm":
        print(f"serving outlier recall ({args.strategy}): "
              f"{recall(yte, pred, -1.0):.4f}  f1: {f1(yte, pred, -1.0):.4f}",
              flush=True)
    else:
        acc = accuracy_multiclass(yte, pred)
        print(f"serving accuracy ({args.strategy}): {acc:.4f}", flush=True)

    if args.serve_async:
        _serve_async(args, model, Xte)
        return

    idx = rng.integers(0, Xte.shape[0], size=(args.batches, args.batch))
    batches = torch.as_tensor(Xte[idx], device=dev)
    registry = MetricsRegistry() if args.metrics_out else None
    if registry is not None:
        registry.counter("serve_strategy_selected_total",
                         strategy=args.strategy).inc()
    rep = run_request_loop(sm, kern, args.strategy, batches, metrics=registry)
    print(f"{rep['strategy']}: {rep['qps']:.0f} q/s | "
          f"lat ms mean {rep['lat_ms_mean']:.2f} "
          f"p50 {rep['lat_ms_p50']:.2f} p95 {rep['lat_ms_p95']:.2f} "
          f"p99 {rep['lat_ms_p99']:.2f} | compiles_timed "
          f"{rep['compiles_timed']}", flush=True)
    if registry is not None:
        prom = registry.dump(args.metrics_out)
        print(f"metrics -> {args.metrics_out} and {prom}", flush=True)


if __name__ == "__main__":
    main()
