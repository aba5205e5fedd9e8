"""Named phases for the profiler.

``span("divide/level3/cluster")`` wraps a phase in
``torch.profiler.record_function`` with the same name the reference uses
(``divide/level{l}/cluster``, ``divide/level{l}/solve``, ``conquer/refine``,
``conquer/solve``; the LM serve CLI's ``serve/prefill`` and
``serve/decode``), so a ``torch.profiler`` trace carries the labels.  It
costs next to nothing when no profiler runs.  While a ``SpanTimer`` is
activated, each span also adds its host wall time to the timer's totals
(the fit ends its phases with a device sync, so the time covers the
device work).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch

# The activated timer; a single host thread drives a fit.
_ACTIVE: Optional["SpanTimer"] = None


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


@contextmanager
def span(name: str) -> Iterator[None]:
    timer = _ACTIVE
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            if timer is not None:
                timer.totals[name] = (timer.totals.get(name, 0.0)
                                      + time.perf_counter() - t0)
