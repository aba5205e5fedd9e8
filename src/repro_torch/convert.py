"""Carry a model trained by the JAX package over to the port.

``from_jax_arrays`` takes the arrays of a reference ``DCSVMModel`` as numpy
(``np.asarray`` of each field) and builds the port's model, so a model
trained on a TPU predicts the same here:

    arrays = {"X": ..., "y": ..., "alpha": ..., "beta": ...,
              "assign": ..., "idx": ..., "mask": ...,   # the partition
              "Xm": ..., "W": ..., "s": ...,            # its routing model
              "rho": ..., "rho_clusters": ...}          # equality tasks

and the task as its name and hyper-parameters (``task=`` and
``task_params=``, e.g. ``"ocsvm", {"nu": 0.1}``, the reference task's
``name`` and dataclass fields), or as a port ``Task``.

``from_jax_multiclass`` does the same for a reference ``MulticlassModel``,
with "classes" and "Y" in place of "y" and "beta".

``from_jax_baseline`` does the same for a reference comparison solver
(``repro.baselines``: ``ExactSVM``, ``CascadeSVM``, ``LLSVM``, ``RFFSVM``,
``LTPU``, by class name), its fields as numpy arrays or scalars.

``from_jax_lm`` carries a reference LM's parameter tree (nested dicts of
``np.asarray`` leaves, bf16 leaves as ``ml_dtypes.bfloat16``) over to the
port's tree, with the same paths, shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.dcsvm import DCSVMConfig, DCSVMModel
from repro_torch.core.kernels import Kernel, resolve_use_kernels
from repro_torch.core.kkmeans import KKMeansModel, Partition
from repro_torch.core.multiclass import MulticlassModel
from repro_torch.core.tasks import CSVC, TASKS, Task
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models.param import torch_dtype


def config_from(cfg) -> DCSVMConfig:
    """A port config from a reference ``DCSVMConfig`` (any object with its
    fields), field for field: ``use_pallas`` becomes ``use_kernels`` and the
    kernel's hyper-parameters a port ``Kernel``; the precision policy and
    the memory tiers (``compute_dtype``, ``host_spill``,
    ``col_cache_cap``) carry over.  A port config is returned as it is."""
    if isinstance(cfg, DCSVMConfig):
        return cfg
    kw = {}
    for f in dataclasses.fields(DCSVMConfig):
        src = "use_pallas" if f.name == "use_kernels" else f.name
        if hasattr(cfg, src):
            kw[f.name] = getattr(cfg, src)
    if kw.get("kernel") is not None:
        kw["kernel"] = _kernel(kw["kernel"])
    return DCSVMConfig(**kw)


def _kernel(k) -> Kernel:
    """A port ``Kernel`` from any object with a kernel's fields."""
    if isinstance(k, Kernel):
        return k
    return Kernel(k.kind, gamma=float(k.gamma), degree=int(k.degree),
                  coef0=float(k.coef0))


def from_jax_arrays(d: Dict[str, np.ndarray], cfg: DCSVMConfig,
                    device: DeviceLike = None, is_early: bool = False,
                    level_stats: Optional[list] = None, task=None,
                    task_params: Optional[Dict[str, Any]] = None
                    ) -> DCSVMModel:
    """Build a port ``DCSVMModel`` from a reference model's arrays.  The
    partition keys, "beta", "rho" and "rho_clusters" are optional (an
    exact-only model has no partition, a box-family model no rho).  ``task``
    is a port ``Task`` or a task name of ``core.tasks.TASKS`` built with
    ``task_params``; default C-SVC.  ``cfg`` is a port config or the
    reference's (``config_from``)."""
    dev = resolve_device(device)
    t = _tensors(d, dev)
    if task is None:
        task = CSVC()
    elif not isinstance(task, Task):
        task = TASKS[task](**(task_params or {}))
    rho = d.get("rho")
    return DCSVMModel(config=config_from(cfg), X=t("X"), y=t("y"),
                      alpha=t("alpha"),
                      partition=_partition(d, t), is_early=is_early,
                      level_stats=list(level_stats or []), task=task,
                      beta=t("beta") if "beta" in d else None,
                      rho=None if rho is None else float(np.asarray(rho)),
                      rho_clusters=(t("rho_clusters")
                                    if d.get("rho_clusters") is not None
                                    else None))


def from_jax_multiclass(d: Dict[str, np.ndarray], cfg: DCSVMConfig,
                        device: DeviceLike = None, is_early: bool = False,
                        level_stats: Optional[list] = None
                        ) -> MulticlassModel:
    """Build a port ``MulticlassModel`` from a reference one-vs-all model's
    arrays ("X", "classes", "Y", "alpha" and the optional partition keys)."""
    t = _tensors(d, resolve_device(device))
    return MulticlassModel(config=config_from(cfg), X=t("X"),
                           classes=np.asarray(d["classes"]), Y=t("Y"),
                           alpha=t("alpha"), partition=_partition(d, t),
                           is_early=is_early,
                           level_stats=list(level_stats or []))


def from_jax_baseline(kind: str, arrays: Dict[str, Any], kernel,
                      device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32):
    """The port's model of a reference comparison solver: ``kind`` its
    class name, ``arrays`` its fields (``np.asarray`` of each; "C",
    "iters", "pg_max" and "train_time" as scalars), ``kernel`` a port or
    reference ``Kernel``.  Arrays become tensors of ``dtype`` on ``device``
    (default ``cuda``), which then scores through the CUDA kernels there."""
    from repro_torch import baselines

    cls = {c.__name__: c for c in (baselines.ExactSVM, baselines.CascadeSVM,
                                   baselines.LLSVM, baselines.RFFSVM,
                                   baselines.LTPU)}.get(kind)
    if cls is None:
        raise ValueError(f"unknown baseline {kind!r}")
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "kernel":
            kw[f.name] = _kernel(kernel)
        elif f.name == "use_kernels":
            kw[f.name] = resolve_use_kernels(None, dev)
        elif f.name not in arrays:
            continue                   # a field of the port's alone
        elif f.type == "torch.Tensor":
            kw[f.name] = torch.as_tensor(np.array(arrays[f.name]),
                                         device=dev, dtype=dtype)
        elif f.type in ("float", "int"):
            kw[f.name] = (float if f.type == "float" else int)(
                np.asarray(arrays[f.name]))
        else:
            kw[f.name] = np.asarray(arrays[f.name])
    return cls(**kw)


def _tensors(d: Dict[str, np.ndarray], dev: torch.device):
    def t(name):
        return torch.as_tensor(np.array(d[name], np.float32), device=dev)
    return t


def _partition(d: Dict[str, np.ndarray], t) -> Optional[Partition]:
    if "idx" not in d:
        return None
    idx = np.asarray(d["idx"], np.int64)
    return Partition(
        assign=np.asarray(d["assign"], np.int32), idx=idx,
        mask=np.asarray(d["mask"], bool), k=idx.shape[0], nc=idx.shape[1],
        model=KKMeansModel(Xm=t("Xm"), W=t("W"), s=t("s")))


def _leaf_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # a writable copy
    if a.dtype.name == "bfloat16":     # ml_dtypes.bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def from_jax_lm(params_np: Dict[str, Any], cfg,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The port's LM parameters from a reference tree of numpy arrays.
    Raises if a path is missing or extra, or a leaf's shape or dtype is not
    the one ``build_decls_any(cfg)`` declares for ``cfg.param_dtype``."""
    dev = resolve_device(device)
    decls = M.build_decls_any(cfg)
    want_dtype = torch_dtype(cfg.param_dtype)

    def walk(d, a, path):
        if isinstance(d, dict):
            if not isinstance(a, dict) or set(a) != set(d):
                got = sorted(a) if isinstance(a, dict) else type(a).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, expected "
                                 f"{sorted(d)}")
            return {k: walk(d[k], a[k], f"{path}/{k}") for k in sorted(d)}
        t = _leaf_tensor(np.asarray(a), dev)
        dt = torch_dtype(d.dtype) if d.dtype else want_dtype
        if tuple(t.shape) != tuple(d.shape) or t.dtype != dt:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(d.shape)} {dt}")
        return t

    return walk(decls, params_np, "")
