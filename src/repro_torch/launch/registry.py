"""Versioned model registry for the serving engine (port of
``repro.launch.registry``).

The registry maps ``name -> {version -> entry}``, where every entry
carries

* the compacted ``ServingModel`` (``export_serving_model`` output), which
  stays on the device the export put it on (the trained model's), and
* a self-describing ``ModelManifest``: task, kernel hyper-parameters,
  C/eps/nu, decision offsets (rho, per-cluster rho_c), cluster count,
  allowed serving strategies and the export options that shaped the packed
  blocks.  Manifests round-trip through JSON (``to_json`` / ``from_json``),
  field for field the reference's.

Routing is a plain ``name -> default version`` table.  A hot swap is one
atomic repoint of that table (``set_default``): requests resolved after the
swap see the new version; requests already resolved keep the old entry
alive until they complete.  The engine drains the old version's queue and
only then calls ``drop``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.kernels import Kernel
from repro_torch.launch.serve_svm import ServingModel, export_serving_model

ALL_STRATEGIES = ("exact", "early", "bcm")


@dataclasses.dataclass(frozen=True)
class ModelManifest:
    """Self-describing serving metadata for one registered model version."""

    name: str
    version: int
    task: str                        # "svc" | "svr" | "ocsvm"
    kernel: Dict[str, Any]           # kind / gamma / degree / coef0
    C: float
    eps: Optional[float]             # epsilon-SVR tube half-width
    nu: Optional[float]              # one-class / nu-SVC support mass
    rho: float                       # global decision offset
    rho_c: Tuple[float, ...]         # per-cluster offsets (early ocsvm)
    k: int                           # routing clusters
    n_classes: int                   # 0 = svr, 1 = ocsvm, >= 2 = svc
    n_sv: int                        # SV union size after export
    strategies: Tuple[str, ...]      # strategies this export can serve
    max_sv_per_cluster: int          # export cap (blocks subsampled above)
    with_bcm: bool                   # BCM Grams prefactored at export
    cap_policy: str = "bucket"       # early_capacity derives from the padded
                                     # bucket shape, never the ragged batch
    created_unix: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["rho_c"] = list(self.rho_c)
        d["strategies"] = list(self.strategies)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ModelManifest":
        d = dict(d)
        d["rho_c"] = tuple(float(v) for v in d.get("rho_c", ()))
        d["strategies"] = tuple(d.get("strategies", ()))
        d["kernel"] = dict(d["kernel"])
        return cls(**d)

    def make_kernel(self) -> Kernel:
        return Kernel(**self.kernel)


def build_manifest(name: str, version: int, model, sm: ServingModel, *,
                   max_sv_per_cluster: int, with_bcm: bool) -> ModelManifest:
    """Derive the manifest from a trained model and its serving export."""
    cfg = model.config
    task = getattr(model, "task", None)
    strategies = tuple(s for s in ALL_STRATEGIES
                       if with_bcm or s != "bcm")
    return ModelManifest(
        name=name,
        version=version,
        task=sm.task,
        kernel=dataclasses.asdict(cfg.kernel),
        C=float(cfg.C),
        eps=(float(task.eps) if task is not None and hasattr(task, "eps")
             else None),
        nu=(float(task.nu) if task is not None and hasattr(task, "nu")
            else None),
        rho=sm.rho.item(),
        rho_c=tuple(sm.rho_c.double().cpu().tolist()),
        k=int(sm.k),
        n_classes=int(sm.n_classes),
        n_sv=int(sm.Xall.shape[0]),
        strategies=strategies,
        max_sv_per_cluster=int(max_sv_per_cluster),
        with_bcm=bool(with_bcm),
        created_unix=time.time(),
    )


@dataclasses.dataclass
class RegistryEntry:
    """One registered version: manifest + serving model on its device."""

    manifest: ModelManifest
    sm: ServingModel
    kern: Kernel

    @property
    def version(self) -> int:
        return self.manifest.version


class ModelRegistry:
    """Thread-safe versioned registry with an atomic default-route table."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, int], RegistryEntry] = {}
        self._route: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- registration ----------------------------------------------------
    def register(self, name: str, model, *, version: Optional[int] = None,
                 max_sv_per_cluster: int = 4096, with_bcm: bool = True,
                 make_default: Optional[bool] = None) -> ModelManifest:
        """Export ``model`` (a ``DCSVMModel`` or ``MulticlassModel``) and
        register it under ``name``.  ``version=None`` auto-increments past
        the newest registered version.  The first version of a name becomes
        the default route; later ones only when ``make_default=True``
        (``set_default`` / the engine's hot swap repoint explicitly)."""
        if version is not None:
            # coerce once at entry, so that the check below and the insert
            # key on the same (name, int) pair: "2" and 2 are one version
            version = int(version)
            if (name, version) in self._entries:
                raise ValueError(f"{name}:{version} is already registered")
        sm = export_serving_model(model,
                                  max_sv_per_cluster=max_sv_per_cluster,
                                  with_bcm=with_bcm)
        with self._lock:
            if version is None:
                version = max(self.versions(name), default=0) + 1
            if (name, version) in self._entries:
                raise ValueError(f"{name}:{version} is already registered")
            manifest = build_manifest(
                name, version, model, sm,
                max_sv_per_cluster=max_sv_per_cluster, with_bcm=with_bcm)
            self._entries[(name, version)] = RegistryEntry(
                manifest=manifest, sm=sm, kern=model.config.kernel)
            if make_default or (make_default is None
                                and name not in self._route):
                self._route[name] = version
        return manifest

    # -- resolution / routing --------------------------------------------
    def resolve(self, name: str, version: Optional[int] = None
                ) -> RegistryEntry:
        """Resolve a request's (name, version) to a concrete entry;
        ``version=None`` follows the default route table.  The route read
        and the entry lookup are one snapshot under the lock, so a
        concurrent ``drop``/``set_default`` never surfaces a half-removed
        entry."""
        with self._lock:
            if version is None:
                version = self._route.get(name)
                if version is None:
                    raise KeyError(f"no model registered under name {name!r}")
            entry = self._entries.get((name, int(version)))
        if entry is None:
            raise KeyError(f"model {name!r} has no version {version}")
        return entry

    def default_version(self, name: str) -> Optional[int]:
        return self._route.get(name)

    def set_default(self, name: str, version: int) -> Optional[int]:
        """Atomically repoint the route table (the hot-swap primitive).
        Returns the previous default version (None if first)."""
        with self._lock:
            if (name, version) not in self._entries:
                raise KeyError(f"model {name!r} has no version {version}")
            old = self._route.get(name)
            self._route[name] = version
            return old

    # -- inventory -------------------------------------------------------
    def names(self) -> List[str]:
        return sorted({n for n, _ in self._entries})

    def versions(self, name: str) -> List[int]:
        return sorted(v for n, v in self._entries if n == name)

    def drop(self, name: str, version: int) -> None:
        """Drop a version (after the engine drained it).  Refuses to drop
        the routed default: swap first."""
        with self._lock:
            if self._route.get(name) == version:
                raise ValueError(
                    f"{name}:{version} is the routed default; set_default "
                    "to another version before dropping it")
            if self._entries.pop((name, version), None) is None:
                raise KeyError(f"model {name!r} has no version {version}")

    # -- exposition ------------------------------------------------------
    def manifests(self) -> List[Dict[str, Any]]:
        return [self._entries[key].manifest.to_json()
                for key in sorted(self._entries)]

    def to_json(self) -> Dict[str, Any]:
        return {"route": dict(self._route), "models": self.manifests()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
