"""The conquer mesh (port of ``repro.launch.mesh.make_conquer_mesh``): one
flat axis of ranks of a ``torch.distributed`` process group, one device a
rank, and the three collectives the distributed DC-SVM uses.

    mesh = make_conquer_mesh("i")            # a world of one, no group
    mesh = make_conquer_mesh("i", backend="gloo", device="cpu",
                             init_method="file:///tmp/g", world_size=2,
                             rank=r)          # a rank of a spawned world

Under ``python -m torch.distributed.run`` (``WORLD_SIZE`` set) the ranks
join the group ``env://`` gives, and each rank takes ``cuda:<local rank>``
and makes it current.  The backend is chosen explicitly: ``nccl`` on CUDA
(one rank a GPU; NCCL refuses two ranks on one device) and ``gloo`` on the
CPU by default; ``gloo`` also takes several ranks on one card (the local
rank modulo the device count), with every collective staged through host
memory.  A failed initialisation raises: nothing drops to a world of one.
A world of one without a group runs the collectives as identities (the
reference on a one-device mesh).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


class ConquerMesh:
    """``size`` ranks along ``axis``; this process is ``rank`` on
    ``device``.  ``group`` is the process group (``None``: a world of one).
    Every collective takes and returns tensors on ``device``."""

    def __init__(self, axis: str, size: int, rank: int,
                 device: torch.device, group=None,
                 backend: Optional[str] = None, owns_group: bool = False):
        self.axis, self.size, self.rank = axis, size, rank
        self.device, self.group, self.backend = device, group, backend
        self._owns_group = owns_group
        # gloo moves CUDA tensors through the host: stage them explicitly
        self._staged = backend == "gloo" and device.type == "cuda"

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._staged else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along a new leading axis, in rank
        order: (size, *t.shape), as ``lax.all_gather``."""
        if self.group is None:
            return t.unsqueeze(0).clone()
        h = self._host(t.contiguous())
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        return self._back(torch.stack(parts))

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return t.clone()
        h = self._host(t).reshape(-1).clone()
        dist.all_reduce(h, op=op, group=self.group)
        return self._back(h.reshape(t.shape))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on every rank."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks, on every rank."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank."""
        if self.group is None:
            return t.clone()
        h = self._host(t.contiguous()).clone()
        dist.broadcast(h, src=src, group=self.group)
        return self._back(h)

    def close(self) -> None:
        """Destroy the process group if this mesh made it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def _rank_device(device: DeviceLike, backend: Optional[str],
                 local_rank: int) -> torch.device:
    """The rank's device: ``cpu``, an explicit ``cuda:k``, or ``cuda``
    (the default) -> ``cuda:<local rank>`` (modulo the device count under
    gloo, which takes several ranks on one card)."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    if backend == "gloo":
        return torch.device("cuda", local_rank % count)
    if local_rank >= count:
        raise ValueError(f"local rank {local_rank} has no GPU of its own "
                         f"({count} visible): NCCL takes one rank a GPU; "
                         f"use backend='gloo' for several ranks on one card")
    return torch.device("cuda", local_rank)


def make_conquer_mesh(axis: str = "shard", device: DeviceLike = None,
                      backend: Optional[str] = None,
                      init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None) -> ConquerMesh:
    """The flat one-axis mesh the distributed DC-SVM runs on.

    An initialised default group is used as it is.  Else a group is made
    when ``init_method`` is given (``file://``, ``tcp://``; with
    ``world_size`` and ``rank``) or ``WORLD_SIZE`` is set (``env://``,
    ``python -m torch.distributed.run``); ``backend`` defaults to
    ``nccl`` on CUDA and ``gloo`` on the CPU.  With neither, the world is
    one process without a group.  ``device``: ``None``/``"cuda"`` (the
    rank's GPU), ``"cuda:k"`` or ``"cpu"``; a CUDA device is made
    current."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    owns = False
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
    elif init_method is not None or "WORLD_SIZE" in os.environ:
        want = resolve_device(device)
        backend = backend or ("nccl" if want.type == "cuda" else "gloo")
        if backend == "nccl" and want.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        dev = _rank_device(device, backend, local)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=-1 if world_size is None
                                else world_size,
                                rank=-1 if rank is None else rank)
        owns = True
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device()
                               if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
        return ConquerMesh(axis, 1, 0, dev)
    size, me = dist.get_world_size(), dist.get_rank()
    if not owns:
        local = int(os.environ.get("LOCAL_RANK", me))
        dev = _rank_device(device, backend, local)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    return ConquerMesh(axis, size, me, dev, group=dist.group.WORLD,
                       backend=backend, owns_group=owns)
