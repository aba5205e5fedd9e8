"""Device-resident LRU cache of kernel rows for the conquer-step block CD
(port of ``repro.core.colcache``).

A fixed-capacity ``(cap, width)`` buffer of raw kernel rows plus int32
index tables, all on the device, so lookup, touch and evict-insert run
inside the solver's step with no host round trip and no dynamic shape (a
CUDA graph replays it).  A block of Gauss-Southwell selections is served
from the cache only when every selected row is resident; otherwise the
whole block is recomputed and inserted over the least recently used slots.
The reference picks its branch with ``lax.cond``; here both are computed
and ``torch.where`` on the device flag ``served`` selects, and the cached
rows are written only where a block was not served.

Invariants:
  * ``owner[s]``    key whose row occupies slot ``s`` (-1 empty)
  * ``slot_of[i]``  slot holding row i, or -1; when stale slots exist (a row
                    re-inserted before its old slot was evicted) ``slot_of``
                    points at the freshest copy
  * ``stamp[s]``    tick of the last touch, the LRU eviction key
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_OLD = -2 ** 30      # the stamp of an empty (or aged) slot


class ColumnCache(NamedTuple):
    cols: torch.Tensor       # (cap, width) cached raw rows (storage dtype)
    owner: torch.Tensor      # (cap,) int32 key per slot, -1 = empty
    slot_of: torch.Tensor    # (n,)   int32 slot per key, -1 = uncached
    stamp: torch.Tensor      # (cap,) int32 last-use tick (LRU key)
    tick: torch.Tensor       # ()     int32 logical clock
    hits: torch.Tensor       # ()     int32 rows served from the cache
    misses: torch.Tensor     # ()     int32 rows recomputed
    evictions: torch.Tensor  # ()     int32 live rows displaced by inserts


def init(cap: int, n: int, dtype=torch.float32, width: Optional[int] = None,
         device=None) -> ColumnCache:
    """An empty cache of ``cap`` rows of ``width`` (default ``n``) entries
    over ``n`` keys."""
    i32 = dict(dtype=torch.int32, device=device)
    return ColumnCache(
        cols=torch.zeros((cap, n if width is None else width), dtype=dtype,
                         device=device),
        owner=torch.full((cap,), -1, **i32),
        slot_of=torch.full((n,), -1, **i32),
        stamp=torch.full((cap,), _OLD, **i32),
        tick=torch.zeros((), **i32),
        hits=torch.zeros((), **i32),
        misses=torch.zeros((), **i32),
        evictions=torch.zeros((), **i32),
    )


def lookup(cache: ColumnCache, idx: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots (B,) and hit mask (B,) for a block of keys."""
    slots = cache.slot_of[idx]
    return slots, slots >= 0


def _set(t: torch.Tensor, index: torch.Tensor, values) -> torch.Tensor:
    """``t.at[index].set(values, mode="drop")`` out of place: an index equal
    to ``len(t)`` is dropped.  Indices must be unique where they write.
    ``values`` is a number, a 0-d tensor or one value an index, all written
    without a host-to-device copy (the step runs inside a CUDA graph)."""
    ext = torch.cat([t, t[:1]])
    if not isinstance(values, torch.Tensor):
        ext.index_fill_(0, index, values)
    else:
        ext.index_copy_(0, index, values.to(t.dtype).expand(index.shape[0]))
    return ext[:-1]


def _last_of_each(idx: torch.Tensor) -> torch.Tensor:
    """True at the last position of each distinct key of ``idx``: where
    a scatter with duplicate keys lands on the reference's CPU path (the
    last write wins)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    later = (idx[None, :] == idx[:, None]) & (pos[None, :] > pos[:, None])
    return ~later.any(dim=1)


def _insert_tables(cache: ColumnCache, idx: torch.Tensor, slots: torch.Tensor,
                   hit: torch.Tensor):
    """The index tables after evicting the LRU slots for block ``idx``:
    (victims, owner, slot_of, stamp, evictions)."""
    cap = cache.owner.shape[0]
    n = cache.slot_of.shape[0]
    B = idx.shape[0]
    if B > cap:
        raise ValueError(f"a block of {B} rows does not fit a cache of {cap}")
    # slots already owned by idx are duplicates-to-be: age them to the
    # front of the eviction order so re-inserts reuse their own slots first
    stamp = _set(cache.stamp, torch.where(hit, slots.long(), cap), _OLD)
    # top-k of -stamp, ties to the lower slot (lax.top_k's order)
    victims = torch.sort(-stamp, descending=True, stable=True).indices[:B]
    evicted = cache.owner[victims]
    ev_safe = torch.where(evicted >= 0, evicted, 0).long()
    # un-map evicted owners, but only where they still point at the victim
    # slot (stale duplicates keep slot_of aimed at their fresh copy)
    still = (evicted >= 0) & (cache.slot_of[ev_safe] == victims)
    slot_of = _set(cache.slot_of, torch.where(still, ev_safe, n), -1)
    owner = cache.owner.clone()
    owner[victims] = idx.to(torch.int32)
    slot_of = _set(slot_of, torch.where(_last_of_each(idx), idx.long(), n),
                   victims.to(torch.int32))
    stamp[victims] = cache.tick
    evictions = cache.evictions + still.sum(dtype=torch.int32)
    return victims, owner, slot_of, stamp, evictions


def update(cache: ColumnCache, idx: torch.Tensor, rows: torch.Tensor,
           served: torch.Tensor, slots: torch.Tensor, hit: torch.Tensor,
           active: Optional[torch.Tensor] = None) -> ColumnCache:
    """Refresh the LRU state after serving block ``idx``; returns the new
    state.  ``served`` (a device bool): the block came from the cache, so
    its slots are touched; otherwise ``rows`` (the recomputed raw rows) are
    rounded to the storage dtype and written over the LRU slots.  Hit and
    miss counters count whole blocks.  ``cols`` is written in place (the
    returned state shares it).  ``active`` (a device bool, default true):
    where false, nothing changes (a stopped solver's replayed step)."""
    nb = idx.shape[0]
    tick = cache.tick + 1
    on = served.new_ones(()) if active is None else active
    victims, owner, slot_of, stamp_ins, evictions = _insert_tables(
        cache._replace(tick=tick), idx, slots, hit)
    stamp_touch = _set(cache.stamp, torch.where(served, slots.long(),
                                                cache.stamp.shape[0]), tick)
    write = on & ~served
    cache.cols[victims] = torch.where(write, rows.to(cache.cols.dtype),
                                      cache.cols[victims])

    def pick(new_served, new_inserted, old):
        return torch.where(on, torch.where(served, new_served, new_inserted),
                           old)

    return ColumnCache(
        cols=cache.cols,
        owner=pick(cache.owner, owner, cache.owner),
        slot_of=pick(cache.slot_of, slot_of, cache.slot_of),
        stamp=pick(stamp_touch, stamp_ins, cache.stamp),
        tick=torch.where(on, tick, cache.tick),
        hits=cache.hits + torch.where(on & served, nb, 0).to(torch.int32),
        misses=cache.misses + torch.where(write, nb, 0).to(torch.int32),
        evictions=pick(cache.evictions, evictions, cache.evictions),
    )


def assign_(dst: ColumnCache, src: ColumnCache) -> None:
    """Copy the state ``src`` into the tensors of ``dst`` (static state of
    a CUDA graph); ``cols`` is shared and already up to date."""
    for a, b in zip(dst[1:], src[1:]):
        a.copy_(b)
