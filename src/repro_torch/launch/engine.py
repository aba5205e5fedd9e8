"""Asyncio serving engine: continuous batching over the versioned registry
(port of ``repro.launch.engine``).

An asyncio front end wraps a request -> future map over a batch manager
that pops ready requests into pad-bucketed batches.

* ``submit`` resolves the request's (model, version) against the
  registry's route table once, at enqueue (so a hot swap repoints later
  requests while queued ones keep their resolved version), attaches an
  ``asyncio.Future`` and parks the request, as host (numpy) rows, on its
  (name, version, strategy) group queue.
* The batch-manager task pops the group with the oldest waiting request,
  drains up to ``max_batch`` query rows from it (continuous batching: one
  slow group never blocks another; late arrivals ride the next pop),
  copies the rows into one host buffer already padded to a power-of-two
  bucket (``predict.bucket_size``) and serves it through ``serve_batch``
  with one host-to-device copy.  The early strategy's capacity derives
  from the bucket, so ragged request sizes collapse onto O(log max_batch)
  shapes, all of which ``warmup`` runs first.
* Results scatter back per request id: each future resolves with exactly
  its own (pred, scores) rows, as numpy arrays.

Overload robustness (admit -> queue -> shed):

* **Admission control**: ``EngineConfig.max_queue_rows`` bounds the total
  queued query rows; a ``submit`` that would push past the bound fails
  fast with ``EngineOverloaded`` (the in-process 429) and increments
  ``serve_shed_total``.  Nothing is enqueued.
* **Per-request deadlines**: ``submit(..., timeout_s=)`` (or
  ``EngineConfig.timeout_s``) arms a deadline timer; a request whose
  deadline expires while queued resolves with ``DeadlineExceeded`` and is
  reaped in ``_pop_ready`` before batch formation, so dead rows never take
  device time (``serve_deadline_exceeded_total``).  A request admitted
  into a batch has its timer cancelled: the deadline bounds queue wait,
  not device compute.  ``timeout_s <= 0`` is pre-expired: it resolves at
  once without enqueueing.
* **Supervision**: batch-formation errors (a popped group whose registry
  entry is gone: a swap/drain protocol violation) kill the loop, and the
  death is observed: queued futures fail, drainers wake, and
  ``submit``/``drain``/``stop`` re-raise the loop's exception.  A serve
  error goes to the callers of its batch only.

``warmup`` serves every (version, strategy, bucket) signature outside the
request path and marks the baseline of ``serving_cache_size`` (the kernel
libraries loaded so far); ``serve_compiles_total`` counts the libraries
loaded after it, and should stay 0.

Hot swap: ``swap`` atomically repoints the registry route, then drains the
old version's queue and drops it: in-flight requests complete on the
version they resolved; queued requests whose deadline expires during the
drain are reaped, not served.

Port-specific design:

* **One device thread, owned by the engine.**  CUDA's current device is
  set per thread, and the kernel wrappers launch on the current device
  (with the current stream of their tensors' device), so device work runs
  on a single-worker ``ThreadPoolExecutor`` created with the engine and
  shut down by ``stop`` (or ``close``), and every ``serve_batch`` there
  runs inside ``torch.cuda.device(model device)`` when that device is
  CUDA.  ``warmup`` runs through the same thread, so first-use costs land
  in warmup and not in the first request.
* **The sync happens in the device thread.**  ``compute`` ends with the
  device-to-host copy of ``pred`` and ``scores``, which is the sync; the
  one host read inside ``bucketed_cluster_scores`` (its number of rounds)
  also runs there.  Nothing on the event loop waits on the card, so
  submits, deadline timers and drain wakeups keep firing during a batch.
* **Bit equality is per merged bucket.**  A request's rows equal, bit for
  bit, a direct ``serve_batch`` of the batch it was merged into (the
  packed rows, zero-padded to the bucket).  Served alone at its own bucket
  it gets the same predictions and the same scores up to float32
  rounding, not always the same bits: the products with the weights
  (``gram(...) @ Wall``, ``kermat(...) @ Wblocks``, ``Kqs @ Wsv``) are
  ``torch.matmul`` calls whose GEMM algorithm (blocking, split-K) changes
  with the row count, on MKL and on cuBLAS, and so is the plain kernel's
  X Y' on the CPU (the CUDA ``kermat`` computes each entry alone).
  Nothing pads or reorders rows to force it.
* **No fallback.**  Requests are served on their model's device only; a
  kernel failure inside ``compute`` reaches the callers of its batch and
  is never retried on the plain version.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.predict import bucket_size
from repro_torch.launch.registry import ModelRegistry, RegistryEntry
from repro_torch.launch.serve_svm import serve_batch, serving_cache_size
from repro_torch.obs.metrics import MetricsRegistry

GroupKey = Tuple[str, int, str]        # (name, version, strategy)


class EngineOverloaded(RuntimeError):
    """Admission refused: the bounded queue is full (in-process 429)."""


class DeadlineExceeded(asyncio.TimeoutError):
    """The request's deadline expired before it reached a batch."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 256      # max query rows popped into one bucketed batch
    min_bucket: int = 8       # smallest pad bucket (predict.bucket_size lo)
    use_kernels: Optional[bool] = None
    max_queue_rows: Optional[int] = None   # admission bound on queued rows
    timeout_s: Optional[float] = None      # default per-request deadline

    @property
    def max_bucket(self) -> int:
        """Power-of-two ceiling of ``max_batch``: the largest bucket the
        batch manager forms from merged requests (a single oversized
        request still buckets past it, in ``max_bucket`` multiples)."""
        return max(self.min_bucket, 1 << (int(self.max_batch) - 1).bit_length())


@dataclasses.dataclass
class _Request:
    rid: int
    X: np.ndarray             # (nq, d) query rows, on the host
    nq: int
    future: asyncio.Future    # resolves to (pred[nq], scores[nq, C])
    t_enq: float
    deadline: Optional[float] = None            # t_enq + timeout_s
    timer: Optional[asyncio.TimerHandle] = None
    t_pop: float = 0.0        # batch-formation time (set at pop)


def _on_device(device: torch.device):
    """Make ``device`` current for the kernel wrappers' launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _host_rows(Xq, dtype: torch.dtype) -> np.ndarray:
    """A request's rows as a host array of the model's dtype."""
    X = np.asarray(Xq, dtype=torch.empty((), dtype=dtype).numpy().dtype)
    return X[None, :] if X.ndim == 1 else X


class AsyncServingEngine:
    """Single-process async serving front end over a ``ModelRegistry``."""

    def __init__(self, registry: ModelRegistry,
                 config: EngineConfig = EngineConfig(),
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry
        self.config = config
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._queues: Dict[GroupKey, Deque[_Request]] = {}
        self._inflight: Dict[GroupKey, int] = {}   # popped, not yet resolved
        self._event: Optional[asyncio.Event] = None    # work arrived
        self._served: Optional[asyncio.Event] = None   # queue progressed
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._rid = 0
        # the device thread: every serve_batch of this engine runs here
        self._device: Optional[ThreadPoolExecutor] = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-device")
        # compile accounting: everything below the mark is warmup
        self._cache_mark = serving_cache_size()
        m = self.metrics
        m.describe("serve_queue_depth", "query rows currently queued")
        m.describe("serve_batch_fill_ratio",
                   "real rows / bucket rows per served batch")
        m.describe("serve_latency_seconds",
                   "request latency, enqueue to future resolution")
        m.describe("serve_queue_wait_seconds",
                   "delivered-request wait, enqueue to batch formation")
        m.describe("serve_compute_seconds",
                   "batch compute, formation to device sync")
        m.describe("serve_shed_total",
                   "requests refused at admission (queue full)")
        m.describe("serve_deadline_exceeded_total",
                   "requests expired before batch formation")
        m.describe("serve_compiles_total",
                   "jit compiles observed after warmup (should stay 0)")

    # -- lifecycle -------------------------------------------------------
    def _device_thread(self) -> ThreadPoolExecutor:
        if self._device is None:
            raise RuntimeError("engine is closed (its device thread was "
                               "shut down by stop or close)")
        return self._device

    async def start(self) -> "AsyncServingEngine":
        if self._task is not None:
            raise RuntimeError("engine already started")
        self._device_thread()
        self._event = asyncio.Event()
        self._served = asyncio.Event()
        self._closed = False
        self._task = asyncio.get_running_loop().create_task(self._batch_loop())
        self._task.add_done_callback(self._on_loop_done)
        return self

    async def stop(self) -> None:
        """Drain every queue, stop the batch manager and shut the device
        thread down.  If the batch loop died, the drain (or the final
        await) re-raises its exception in bounded time instead of spinning
        on a queue that will never empty."""
        if self._task is None:
            return
        try:
            await self.drain()
        finally:
            self._closed = True
            self._event.set()
            task, self._task = self._task, None
            try:
                await task      # surfaces the loop's exception if it died
            finally:
                self.close()

    def close(self) -> None:
        """Shut the device thread down (``stop`` does; call it for an
        engine that was never started).  The engine takes no work after."""
        if self._task is not None:
            raise RuntimeError("engine is running; await stop() instead")
        if self._device is not None:
            self._device.shutdown(wait=True)
            self._device = None

    async def __aenter__(self) -> "AsyncServingEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- supervision -----------------------------------------------------
    def _raise_if_loop_dead(self) -> None:
        """Fail fast when the batch-loop task died with an exception:
        re-raise it from the caller (submit/drain/stop) instead of letting
        queues that will never drain hang the process."""
        t = self._task
        if t is not None and t.done() and not t.cancelled():
            exc = t.exception()
            if exc is not None:
                raise exc

    def _on_loop_done(self, task: asyncio.Task) -> None:
        """The batch loop is supervised: on death, fail every queued
        future (no caller awaits forever) and wake drainers so they
        observe the exception instead of sleeping on a dead queue."""
        exc = None if task.cancelled() else task.exception()
        if exc is not None:
            for dq in self._queues.values():
                while dq:
                    r = dq.popleft()
                    if r.timer is not None:
                        r.timer.cancel()
                    if not r.future.done():
                        r.future.set_exception(exc)
        if self._served is not None:
            self._served.set()

    # -- request path ----------------------------------------------------
    async def submit(self, Xq, name: str = "default",
                     version: Optional[int] = None,
                     strategy: str = "early",
                     timeout_s: Optional[float] = None):
        """Enqueue one request; await returns (pred, scores), numpy arrays
        of exactly the submitted rows.  Version resolution happens here,
        against the route table as of now: the hot-swap boundary.

        Raises ``EngineOverloaded`` when admission would push the queued
        rows past ``max_queue_rows``; resolves with ``DeadlineExceeded``
        when the deadline (``timeout_s`` or the engine default) expires
        before the request reaches a batch."""
        self._raise_if_loop_dead()
        if self._task is None or self._closed:
            raise RuntimeError("engine is not running (use `async with` "
                               "or await start())")
        entry = self.registry.resolve(name, version)
        man = entry.manifest
        if strategy not in man.strategies:
            raise ValueError(
                f"{name}:{man.version} does not serve {strategy!r} "
                f"(manifest allows {list(man.strategies)})")
        # requests are held on the host: queued rows cost no device memory
        X = _host_rows(Xq, entry.sm.Xsv.dtype)
        nq = int(X.shape[0])
        cap = self.config.max_queue_rows
        if cap is not None and self._depth() + nq > cap:
            self.metrics.counter("serve_shed_total", model=name).inc()
            raise EngineOverloaded(
                f"queue full: {self._depth()} queued rows + {nq} new > "
                f"max_queue_rows={cap}")
        loop = asyncio.get_running_loop()
        self._rid += 1
        tmo = timeout_s if timeout_s is not None else self.config.timeout_s
        req = _Request(rid=self._rid, X=X, nq=nq,
                       future=loop.create_future(),
                       t_enq=time.perf_counter())
        if tmo is not None:
            req.deadline = req.t_enq + tmo
            if tmo <= 0:               # pre-expired: never enqueue, never
                self._expire(req)      # take a batch slot
                return await req.future
            req.timer = loop.call_later(tmo, self._expire, req)
        key: GroupKey = (name, man.version, strategy)
        self._queues.setdefault(key, deque()).append(req)
        self.metrics.gauge("serve_queue_depth").set(self._depth())
        self._event.set()
        return await req.future

    def _expire(self, req: _Request) -> None:
        """Deadline timer body: resolve the queued request with
        ``DeadlineExceeded`` and wake the loop so the dead rows are reaped
        before the next batch forms.  Timers run on the event loop, which
        stays live during device compute, so expiry fires on time even
        mid-batch."""
        req.timer = None
        if req.future.done():
            return
        req.future.set_exception(DeadlineExceeded(
            f"request {req.rid} ({req.nq} rows) expired after "
            f"{time.perf_counter() - req.t_enq:.4f}s in queue"))
        self.metrics.counter("serve_deadline_exceeded_total").inc()
        if self._event is not None:
            self._event.set()

    # -- batch manager ---------------------------------------------------
    def _depth(self) -> int:
        return sum(r.nq for dq in self._queues.values() for r in dq)

    def _oldest_group(self) -> Optional[GroupKey]:
        live = [(dq[0].t_enq, k) for k, dq in self._queues.items() if dq]
        return min(live)[1] if live else None

    def _pop_ready(self, key: GroupKey) -> List[_Request]:
        """Continuous batching pop: drain the group's queue head until the
        next request would overflow ``max_batch`` rows (a single oversized
        request is served alone).  Requests whose future is already done
        (cancelled by the caller or expired) are reaped here, before batch
        formation: they contribute no rows, no device time and no latency
        observation.  A live request admitted into the batch has its
        deadline timer cancelled (the deadline bounds queue wait)."""
        dq = self._queues[key]
        reqs: List[_Request] = []
        total = 0
        t_pop = time.perf_counter()
        while dq:
            r = dq[0]
            if r.future.done():                    # reap dead rows
                dq.popleft()
                if r.timer is not None:
                    r.timer.cancel()
                    r.timer = None
                continue
            if reqs and total + r.nq > self.config.max_batch:
                break
            dq.popleft()
            if r.timer is not None:
                r.timer.cancel()
                r.timer = None
            r.t_pop = t_pop
            reqs.append(r)
            total += r.nq
        return reqs

    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            key = self._oldest_group()
            if key is None:
                if self._closed:
                    return
                self._event.clear()
                await self._event.wait()
                continue
            reqs = self._pop_ready(key)
            if not reqs:
                # the pop only reaped dead requests, which still progressed
                # the queue: wake drainers before the next scan
                self.metrics.gauge("serve_queue_depth").set(self._depth())
                self._served.set()
                continue
            # a batch-formation error (the popped group's entry vanished)
            # is engine-fatal: it kills the loop and surfaces through
            # submit/drain/stop.  The popped requests are failed here, the
            # still-queued ones by the supervisor (_on_loop_done).
            try:
                entry: RegistryEntry = self.registry.resolve(key[0], key[1])
            except BaseException as e:
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                raise
            try:
                await self._serve_group(loop, entry, key, reqs)
            except Exception as e:                 # noqa: BLE001 - scatter
                for r in reqs:                     # the failure to callers
                    if not r.future.done():
                        r.future.set_exception(e)
            self.metrics.gauge("serve_queue_depth").set(self._depth())
            self._served.set()

    async def _serve_group(self, loop: asyncio.AbstractEventLoop,
                           entry: RegistryEntry, key: GroupKey,
                           reqs: Sequence[_Request]) -> None:
        name, version, strategy = key
        nq = sum(r.nq for r in reqs)
        bucket = bucket_size(nq, lo=self.config.min_bucket,
                             hi=self.config.max_bucket)
        # one host buffer at exactly the bucket shape: serve_batch sees a
        # full bucket, so it pads nothing and copies it to the device once
        X = np.zeros((bucket, reqs[0].X.shape[1]), reqs[0].X.dtype)
        off = 0
        for r in reqs:
            X[off: off + r.nq] = r.X
            off += r.nq
        use_kernels = self.config.use_kernels

        def compute():
            with _on_device(entry.sm.device):
                pred, scores = serve_batch(entry.sm, torch.from_numpy(X),
                                           entry.kern, strategy,
                                           use_kernels=use_kernels,
                                           bucket=bucket)
                # device to host once each, in the device thread: this is
                # the sync; the scatter below is numpy slicing
                return pred.cpu().numpy()[:nq], scores.cpu().numpy()[:nq]

        self._inflight[key] = self._inflight.get(key, 0) + len(reqs)
        try:
            pred, scores = await loop.run_in_executor(self._device_thread(),
                                                      compute)
        finally:
            self._inflight[key] -= len(reqs)
            if not self._inflight[key]:
                del self._inflight[key]
        t_done = time.perf_counter()

        m = self.metrics
        ver = str(version)
        m.histogram("serve_batch_fill_ratio").observe(nq / bucket)
        m.histogram("serve_compute_seconds").observe(t_done - reqs[0].t_pop)
        hist = m.histogram("serve_latency_seconds", model=name, version=ver,
                           strategy=strategy)
        wait_h = m.histogram("serve_queue_wait_seconds", lo=1e-6)
        cache = serving_cache_size()
        if cache > self._cache_mark:
            m.counter("serve_compiles_total").inc(cache - self._cache_mark)
            self._cache_mark = cache
        # only delivered requests are counted and observed: a request
        # cancelled mid-compute lands neither in the histograms nor in the
        # request/query counters
        delivered = d_rows = 0
        off = 0
        for r in reqs:
            if not r.future.done():
                r.future.set_result(
                    (pred[off: off + r.nq], scores[off: off + r.nq]))
                hist.observe(t_done - r.t_enq)
                wait_h.observe(r.t_pop - r.t_enq)
                delivered += 1
                d_rows += r.nq
            off += r.nq
        if delivered:
            m.counter("serve_requests_total", model=name, version=ver,
                      strategy=strategy).inc(delivered)
            m.counter("serve_queries_total", model=name, version=ver,
                      strategy=strategy).inc(d_rows)

    # -- warmup ----------------------------------------------------------
    def warmup(self, name: Optional[str] = None,
               strategies: Optional[Sequence[str]] = None,
               buckets: Optional[Sequence[int]] = None) -> int:
        """Serve every (version, strategy, bucket) signature on the device
        thread, outside the request path, then mark the library-count
        baseline: any kernel library the engine loads afterwards increments
        ``serve_compiles_total``.  Returns the number of libraries loaded
        during warmup."""
        names = [name] if name is not None else self.registry.names()
        if buckets is None:
            b, buckets = self.config.min_bucket, []
            while b <= self.config.max_bucket:
                buckets.append(b)
                b *= 2
        entries = [self.registry.resolve(nm, ver)
                   for nm in names for ver in self.registry.versions(nm)]

        def run():
            for entry in entries:
                sm = entry.sm
                strats = (strategies if strategies is not None
                          else entry.manifest.strategies)
                with _on_device(sm.device):
                    for strat in strats:
                        for b in buckets:
                            Xz = torch.zeros((b, sm.Xsv.shape[-1]),
                                             dtype=sm.Xsv.dtype,
                                             device=sm.device)
                            pred, _ = serve_batch(
                                sm, Xz, entry.kern, strat,
                                use_kernels=self.config.use_kernels,
                                bucket=b)
                            pred.cpu()

        before = serving_cache_size()
        self._device_thread().submit(run).result()
        compiled = serving_cache_size() - before
        self.metrics.counter("serve_warmup_compiles_total").inc(compiled)
        self._cache_mark = serving_cache_size()
        return compiled

    # -- hot swap / drain ------------------------------------------------
    def _queued_matching(self, name: Optional[str],
                         version: Optional[int]) -> int:
        """Requests still owed work for (name, version): queued plus
        popped-but-in-flight (a batch can be on the device while its
        requests are off the queues)."""
        def match(nm: str, ver: int) -> bool:
            return ((name is None or nm == name)
                    and (version is None or ver == version))
        return (sum(len(dq) for (nm, ver, _), dq in self._queues.items()
                    if match(nm, ver))
                + sum(n for (nm, ver, _), n in self._inflight.items()
                      if match(nm, ver)))

    async def drain(self, name: Optional[str] = None,
                    version: Optional[int] = None) -> None:
        """Wait until no queued or in-flight request references
        (name, version); ``None`` matches everything (full drain).
        Event-driven: the batch loop sets ``_served`` after every batch
        and every reap, so a drain costs one wakeup per queue progression.
        Re-raises the batch loop's exception if it died."""
        while True:
            self._raise_if_loop_dead()
            if self._served is not None:
                self._served.clear()
            if not self._queued_matching(name, version):
                return
            if self._task is None:
                raise RuntimeError("engine is not running")
            self._event.set()
            await self._served.wait()

    async def swap(self, name: str, version: int,
                   drop_old: bool = True) -> Optional[int]:
        """Hot-swap ``name`` to ``version``: atomically repoint the route
        table (new submits resolve the new version immediately), then drain
        requests still queued on the old version and drop it.  Queued
        requests whose deadline expires during the drain are reaped, not
        served.  Returns the previous default version."""
        old = self.registry.set_default(name, version)
        if drop_old and old is not None and old != version:
            await self.drain(name, old)
            self.registry.drop(name, old)
        return old

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, object]:
        j = self.metrics.to_json()

        def total(prefix: str) -> int:
            return int(sum(v for k, v in j["counters"].items()
                           if k.startswith(prefix)))

        return {
            "queue_depth": self._depth(),
            "requests": total("serve_requests_total"),
            "queries": total("serve_queries_total"),
            "shed": total("serve_shed_total"),
            "deadline_exceeded": total("serve_deadline_exceeded_total"),
            "compiles_after_warmup": total("serve_compiles_total"),
            "models": self.registry.to_json()["route"],
        }
