"""Device-resident convergence traces (port of ``repro.obs.trace``).

``ConvTrace`` is a preallocated ring: ``buf`` (..., cap, 5) float32 filled
with NaN and ``count`` (...) int64, both on the solver's device.  A solver
loop records one sample an iteration in place (``trace_record``: one
``index_copy_`` at ``count % cap`` and an add to ``count``, no host read),
so the record can sit inside a captured CUDA graph: the tensors are made
before the capture and never replaced.  The ring is fetched to the host
once, at the end of a fit (``trace_fetch``).

Columns are fixed (``TRACE_COLS``); a recorder fills the columns it knows
and leaves the rest NaN:

- box CD loops:   pg_max, objective, n_free        (+ cache_hits delta)
- equality loops: pg_max (max violation), objective, n_free
- the distributed conquer (``core.distributed``): the round's pg_max, the
  objective and n_free after it (summed over ranks, so every rank's ring
  is the same), the combination step ``gamma`` (NaN in the replicated
  mode, which has none) and the cached path's cache_hits delta

Leading dimensions are a batch of problems (the reference ``vmap``s its
solvers): each problem has its own ring and count, and ``trace_record``'s
``where`` mask records only for the problems still running, as the
reference's batched ``while_loop`` does.  When a solve runs longer than
``cap`` samples the ring keeps the LAST ``cap`` and ``trace_fetch``
reports how many leading samples were dropped.

Gating is by Python ``None``: with ``trace=None`` a solver makes no ring
tensor and records nothing, so untraced results and launches are those of
a build without traces.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

# Fixed column layout of the ring (order matters: rows are recorded and
# fetched by position).
TRACE_COLS = ("pg_max", "objective", "n_free", "gamma", "cache_hits")
NCOLS = len(TRACE_COLS)


class ConvTrace(NamedTuple):
    """Ring of per-iteration convergence samples (device resident)."""

    buf: torch.Tensor    # (..., cap, NCOLS) f32, NaN where not recorded
    count: torch.Tensor  # (...) int64, samples ever recorded


def trace_init(capacity: int, lead: tuple = (), device=None) -> ConvTrace:
    """Fresh ring with room for ``capacity`` samples, one a problem of the
    batch shape ``lead``, on ``device`` (default: the CPU)."""
    if capacity <= 0:
        raise ValueError(f"trace capacity must be positive, got {capacity}")
    lead = tuple(lead)
    return ConvTrace(
        buf=torch.full(lead + (int(capacity), NCOLS), float("nan"),
                       dtype=torch.float32, device=device),
        count=torch.zeros(lead, dtype=torch.int64, device=device))


def trace_batch(tr: ConvTrace, lead: tuple, device) -> ConvTrace:
    """``tr`` for a solver over problems of batch shape ``lead`` on
    ``device``: its own tensors where they already have that shape there
    (so the solver records into the caller's ring), else a copy of it
    broadcast to every problem."""
    lead = tuple(lead)
    cap = tr.buf.shape[-2]
    if tuple(tr.count.shape) == lead and tr.count.device == device \
            and tr.buf.device == device:
        return tr
    return ConvTrace(
        tr.buf.to(device).broadcast_to(lead + (cap, NCOLS)).clone(),
        tr.count.to(device).broadcast_to(lead).clone())


def _col(v, b: int, like: torch.Tensor) -> torch.Tensor:
    if v is None:
        return like.new_full((b,), float("nan"))
    v = torch.as_tensor(v, device=like.device)
    return v.to(torch.float32).reshape(-1).broadcast_to((b,))


def trace_record(tr: ConvTrace, pg_max=None, objective=None, n_free=None,
                 gamma=None, cache_hits=None,
                 where: Optional[torch.Tensor] = None) -> ConvTrace:
    """Append one sample row a problem, in place (no host read; wraps past
    capacity).  Columns passed as ``None`` are stored as NaN; a column is a
    scalar or one value a problem (the ring's batch shape).  ``where``
    (bool, the batch shape) records only for the problems where it holds:
    the others keep their row and count.  Returns ``tr``."""
    cap = tr.buf.shape[-2]
    b = tr.count.numel()
    flat = tr.buf.view(b * cap, NCOLS)
    count = tr.count.view(b)
    row = torch.stack([_col(v, b, flat) for v in
                       (pg_max, objective, n_free, gamma, cache_hits)], -1)
    pos = torch.remainder(count, cap)
    if b > 1:
        pos = pos + torch.arange(0, b * cap, cap, device=pos.device)
    if where is None:
        flat.index_copy_(0, pos, row)
        count.add_(1)
    else:
        w = where.reshape(b)
        flat.index_copy_(0, pos, torch.where(w[:, None], row,
                                             flat.index_select(0, pos)))
        count.add_(w)
    return tr


def _fetch_one(buf: np.ndarray, count: int) -> Dict[str, Any]:
    cap = buf.shape[0]
    kept = min(count, cap)
    if count <= cap:
        window = buf[:kept]
    else:  # ring wrapped: oldest surviving sample sits at count % cap
        start = count % cap
        window = np.concatenate([buf[start:], buf[:start]], axis=0)
    out: Dict[str, Any] = {
        "samples": int(kept),
        "dropped": int(count - kept),
    }
    for j, name in enumerate(TRACE_COLS):
        col = window[:, j]
        if kept and not np.all(np.isnan(col)):
            out[name] = [float(v) for v in col]
    return out


def _fetch(buf: np.ndarray, count: np.ndarray) -> Any:
    if count.ndim == 0:
        return _fetch_one(buf, int(count))
    return [_fetch(b, c) for b, c in zip(buf, count)]


def trace_fetch(tr: ConvTrace) -> Any:
    """Host fetch (the one device-to-host copy), chronological order.

    Returns a dict with ``samples``/``dropped`` plus one list per column
    that was ever recorded (all-NaN columns are omitted).  A ring with
    leading batch dimensions returns a nested list of dicts mirroring the
    batch shape."""
    return _fetch(tr.buf.detach().cpu().numpy(),
                  tr.count.detach().cpu().numpy())


def trace_summary(fetched: Any) -> Dict[str, Any]:
    """Compact scalar summary of a fetched trace (batched: merged over all):
    sample and drop totals plus first/last pg_max and the last objective.
    A raw (unfetched) ``ConvTrace`` is fetched first."""
    if isinstance(fetched, ConvTrace):
        fetched = trace_fetch(fetched)
    if isinstance(fetched, list):
        flat = [trace_summary(f) for f in fetched]
        out: Dict[str, Any] = {
            "samples": sum(f["samples"] for f in flat),
            "dropped": sum(f["dropped"] for f in flat),
        }
        pgs = [f for f in flat if "pg_first" in f]
        if pgs:
            out["pg_first"] = max(f["pg_first"] for f in pgs)
            out["pg_last"] = max(f["pg_last"] for f in pgs)
        return out
    out = {"samples": fetched["samples"], "dropped": fetched["dropped"]}
    pg = fetched.get("pg_max")
    if pg:
        out["pg_first"] = pg[0]
        out["pg_last"] = pg[-1]
    obj = fetched.get("objective")
    if obj:
        out["obj_last"] = obj[-1]
    return out
