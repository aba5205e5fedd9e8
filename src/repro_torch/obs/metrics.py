"""Serving metrics: labeled counters + streaming log-bucket latency
histograms, with Prometheus text-format and JSON exposition (the port's own
copy of ``repro.obs.metrics``; pure Python).

The histogram uses FIXED log-spaced bucket bounds (10 us .. 10 s, four
buckets per decade) so observation is O(log nbuckets) bisect with no
rebalancing and no per-request allocation — the serving loop can call
``observe`` at line rate.  Quantiles are estimated by linear interpolation
inside the covering bucket, the standard Prometheus-side approximation.
"""
from __future__ import annotations

import bisect
import json
import math
import os
from typing import Any, Dict, List, Tuple


def _log_bounds(lo: float, hi: float, per_decade: int) -> List[float]:
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return [lo * 10.0 ** (i / per_decade) for i in range(n)]


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written instantaneous value (queue depth, in-flight requests)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class LatencyHistogram:
    """Streaming histogram over fixed log-spaced bucket upper bounds."""

    def __init__(self, lo: float = 1e-5, hi: float = 10.0,
                 per_decade: int = 4) -> None:
        self.bounds = _log_bounds(lo, hi, per_decade)  # upper bound per bucket
        self.counts = [0] * (len(self.bounds) + 1)     # last = +Inf overflow
        self.total = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile via interpolation inside the hit bucket."""
        if self.total == 0:
            return math.nan
        rank = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else max(self.vmin, 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax) if self.vmax >= lo else hi
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.vmax

    def to_json(self) -> Dict[str, Any]:
        return {
            "count": self.total,
            "sum": self.sum,
            "min": None if self.total == 0 else self.vmin,
            "max": None if self.total == 0 else self.vmax,
            "p50": None if self.total == 0 else self.quantile(0.50),
            "p95": None if self.total == 0 else self.quantile(0.95),
            "p99": None if self.total == 0 else self.quantile(0.99),
            "buckets": {  # only occupied buckets, keyed by upper bound
                ("+Inf" if i == len(self.bounds) else f"{self.bounds[i]:.6g}"): c
                for i, c in enumerate(self.counts) if c
            },
        }


def _key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create registry of labeled counters and histograms."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, LatencyHistogram] = {}
        self._hist_meta: Dict[str, Tuple[str, Dict[str, str]]] = {}
        self._help: Dict[str, str] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, lo: float = 1e-5, hi: float = 10.0,
                  per_decade: int = 4, **labels: str) -> LatencyHistogram:
        """Get-or-create; the bucket layout (``lo``/``hi``/``per_decade``)
        only applies on first creation — later calls return the existing
        series unchanged, so every label of one metric shares one layout."""
        key = _key(name, labels)
        if key not in self._hists:
            self._hists[key] = LatencyHistogram(lo=lo, hi=hi,
                                                per_decade=per_decade)
            self._hist_meta[key] = (name, labels)
        return self._hists[key]

    def describe(self, name: str, text: str) -> None:
        """Attach a ``# HELP`` line to a metric base name."""
        self._help[name] = text

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "histograms": {k: h.to_json() for k, h in sorted(self._hists.items())},
        }
        if self._gauges:
            out["gauges"] = {k: g.value for k, g in sorted(self._gauges.items())}
        return out

    def _header(self, lines: List[str], seen: set, base: str,
                kind: str) -> None:
        """HELP + TYPE lines, once per (base name, kind).  The seen set is
        PER KIND: a counter and a histogram sharing a base name must both
        get their TYPE line (one shared set suppressed the second kind's)."""
        if base in seen:
            return
        seen.add(base)
        lines.append(f"# HELP {base} {self._help.get(base, base)}")
        lines.append(f"# TYPE {base} {kind}")

    def to_prometheus_text(self) -> str:
        lines: List[str] = []
        seen_counters: set = set()
        seen_gauges: set = set()
        seen_hists: set = set()
        for key, c in sorted(self._counters.items()):
            self._header(lines, seen_counters, key.split("{", 1)[0], "counter")
            lines.append(f"{key} {c.value}")
        for key, g in sorted(self._gauges.items()):
            self._header(lines, seen_gauges, key.split("{", 1)[0], "gauge")
            lines.append(f"{key} {g.value:g}")
        for key, h in sorted(self._hists.items()):
            name, labels = self._hist_meta[key]
            self._header(lines, seen_hists, name, "histogram")
            cum = 0
            for i, cnt in enumerate(h.counts):
                cum += cnt
                le = "+Inf" if i == len(h.bounds) else f"{h.bounds[i]:.6g}"
                lines.append(
                    f"{_key(name + '_bucket', {**labels, 'le': le})} {cum}")
            lines.append(f"{_key(name + '_sum', labels)} {h.sum:.9g}")
            lines.append(f"{_key(name + '_count', labels)} {h.total}")
        # an empty registry exposes nothing, not a bare newline
        return "\n".join(lines) + "\n" if lines else ""

    def dump(self, json_path: str) -> str:
        """Write JSON to ``json_path`` and Prometheus text next to it
        (same stem, ``.prom`` extension).  Returns the prom path."""
        with open(json_path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        prom_path = os.path.splitext(json_path)[0] + ".prom"
        with open(prom_path, "w") as f:
            f.write(self.to_prometheus_text())
        return prom_path
