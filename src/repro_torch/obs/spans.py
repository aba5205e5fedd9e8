"""Named phases: profiler labels, per-name totals and a span tree.

``span("divide/level3/cluster")`` wraps a phase in
``torch.profiler.record_function`` with the same name the reference uses
(``divide/level{l}/cluster``, ``divide/level{l}/solve``, ``conquer/refine``,
``conquer/solve``, ``spill/*``; the LM serve CLI's ``serve/prefill`` and
``serve/decode``), so a ``torch.profiler`` trace carries the labels.  It
costs next to nothing when no profiler runs.  While a ``SpanTimer`` is
activated, each span also adds its host wall time to the timer's totals;
while a ``SpanTracer`` is activated (``with tracer.activate(): fit(...)``),
each span is also a node of the tracer's tree of wall-clock spans, which
exports Chrome trace-event JSON (complete ``X`` events, microsecond
timestamps: Perfetto, chrome://tracing) and an aggregated text table.
The fit ends its phases with a device sync, so a span's time covers its
device work.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

# The activated timer and tracer; a single host thread drives a fit.
_ACTIVE: Optional["SpanTimer"] = None
_TRACER: Optional["SpanTracer"] = None


class SpanTimer:
    """Wall-clock seconds per span name, summed while activated."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    @contextmanager
    def activate(self) -> Iterator["SpanTimer"]:
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = prev


@dataclass
class Span:
    name: str
    t0: float
    t1: Optional[float] = None
    children: List["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) - self.t0


class SpanTracer:
    """Collects a tree of wall-clock spans for one fit/serve run."""

    def __init__(self) -> None:
        self.origin = time.perf_counter()
        self.roots: List[Span] = []
        self._stack: List[Span] = []

    @contextmanager
    def span(self, name: str) -> Iterator[Span]:
        s = Span(name=name, t0=time.perf_counter())
        (self._stack[-1].children if self._stack else self.roots).append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.t1 = time.perf_counter()
            self._stack.pop()

    @contextmanager
    def activate(self) -> Iterator["SpanTracer"]:
        global _TRACER
        prev, _TRACER = _TRACER, self
        try:
            yield self
        finally:
            _TRACER = prev

    def _walk(self):
        stack = [(s, 0) for s in reversed(self.roots)]
        while stack:
            s, depth = stack.pop()
            yield s, depth
            stack.extend((c, depth + 1) for c in reversed(s.children))

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: complete ``X`` events, ts/dur in µs."""
        events = [{"name": s.name, "ph": "X",
                   "ts": (s.t0 - self.origin) * 1e6,
                   "dur": max(s.duration, 0.0) * 1e6, "pid": 0, "tid": 0}
                  for s, _ in self._walk()]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def summary(self) -> str:
        """Aggregated text table: per-name count, total and self seconds."""
        agg: Dict[str, List[float]] = {}
        for s, _ in self._walk():
            child_total = sum(c.duration for c in s.children)
            tot, own, cnt = agg.get(s.name, (0.0, 0.0, 0))
            agg[s.name] = [tot + s.duration,
                           own + max(s.duration - child_total, 0.0),
                           cnt + 1]
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
        w = max([len("span")] + [len(k) for k in agg])
        lines = [f"{'span':<{w}}  {'count':>5}  {'total_s':>9}  {'self_s':>9}",
                 f"{'-' * w}  {'-' * 5}  {'-' * 9}  {'-' * 9}"]
        for name, (tot, own, cnt) in rows:
            lines.append(f"{name:<{w}}  {cnt:>5}  {tot:>9.4f}  {own:>9.4f}")
        return "\n".join(lines)


@contextmanager
def span(name: str) -> Iterator[None]:
    """Name a fit phase: a profiler label always; the timer's total and the
    tracer's span while they are activated."""
    timer, tracer = _ACTIVE, _TRACER
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            if tracer is None:
                yield
            else:
                with tracer.span(name):
                    yield
        finally:
            if timer is not None:
                timer.totals[name] = (timer.totals.get(name, 0.0)
                                      + time.perf_counter() - t0)
