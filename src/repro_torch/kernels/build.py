"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <name>.cu

The build goes into ``build/repro_torch_kernels/`` at the repository root
on first use; the file name carries a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library.  All sources
compile in parallel.  Nothing here runs at import time.

``VARIANTS`` are further libraries of a source under extra flags, in the
same directory, built only when asked for (``build_all(variants=True)``,
or the first call of one of their entry points): ``bf16_gram_check`` is
``bf16_gram.cu`` with its ring check (``-DBG_RING_CHECK``).
``ring_check()`` routes the bf16 entry points to it for a stress check and
reads its counters.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("kermat", "kermatvec", "cd_update", "kmeans_assign",
           "flash_attention", "bf16_gram")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# library -> (its source, the flags it adds to NVCC_FLAGS)
VARIANTS = {"bf16_gram_check": ("bf16_gram", ["-DBG_RING_CHECK"])}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (each returns 0 or a code ops._run reads).
SIGNATURES = {
    "kermat": ("rt_kermat",
               [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _F, _I, _F,
                _P, _P]),
    "kermatvec": ("rt_kernel_matvec",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I,
                   _F, _I, _F, _P]),
    "cd_update": ("rt_cd_column_update",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                   _P]),
    "kmeans_assign": ("rt_kmeans_assign",
                      [_P, _P, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                       _I, _F, _P]),
    "kmeans_assign_scratch": ("rt_kmeans_assign_scratch",
                              [_I, _I, _I, _I, ctypes.POINTER(_L)]),
    "bf16_pack": ("rt_bf16_pack", [_P, _L, _I, _I, _P, _P, _P]),
    "kermat_bf16": ("rt_kermat_bf16",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _I,
                     _F, _P]),
    "kernel_matvec_bf16": ("rt_kernel_matvec_bf16",
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _I, _F, _P]),
    "cd_update_bf16": ("rt_cd_update_bf16",
                       [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                        _F, _P]),
    "flash_attention": ("rt_flash_attention",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                         _L, _L, _L, _L, _L, _L, _I, _I, _F, _I, _P]),
    "bg_ring_check": ("rt_bg_ring_check", [_P, _I, _I]),
}

# entry points that live in another entry's source
_SOURCE_OF = {"kmeans_assign_scratch": "kmeans_assign",
              "bf16_pack": "bf16_gram", "kermat_bf16": "bf16_gram",
              "kernel_matvec_bf16": "bf16_gram",
              "cd_update_bf16": "bf16_gram", "bg_ring_check": "bf16_gram_check"}

_lock = threading.Lock()
_loaded: Dict[tuple, object] = {}
# library -> the library its entry points are taken from (ring_check)
_route: Dict[str, str] = {}


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def nvcc_path() -> str:
    return _cuda_tool("nvcc")


def sass_counts(name: str, opcodes=("HGMMA", "UTMALDG")
                ) -> Dict[str, Dict[str, int]]:
    """How many of each SASS opcode every kernel function of the built
    ``csrc/<name>.cu`` holds, from ``cuobjdump -sass``: {function: {opcode:
    count}}."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                          str(build_all()[name])], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                if f" {op}" in line:
                    counts[fn][op] += 1
    return counts


def _source_flags(name: str):
    src, extra = VARIANTS.get(name, (name, []))
    return CSRC / f"{src}.cu", NVCC_FLAGS + extra


def _digest(name: str) -> str:
    src, flags = _source_flags(name)
    h = hashlib.sha1(" ".join(flags).encode())
    for p in sorted([src, *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(verbose: bool = False,
              variants: bool = False) -> Dict[str, Path]:
    """Compile every missing library (and with ``variants`` the
    ``VARIANTS``), one ``nvcc`` per library, all started together.  Raises
    with the compiler's output if one fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    out: Dict[str, Path] = {}
    for name in (*SOURCES, *(VARIANTS if variants else ())):
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src, flags = _source_flags(name)
        flags = flags + (["-Xptxas", "-v"] if verbose else [])
        cmd = [nvcc, *flags, "-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log, flush=True)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def kernel_fn(name: str):
    """The ctypes entry point ``name`` of ``csrc/<name>.cu`` (or of the
    source ``_SOURCE_OF`` names), building it if needed."""
    with _lock:
        source = _SOURCE_OF.get(name, name)
        source = _route.get(source, source)
        fn = _loaded.get((source, name))
        if fn is None:
            lib = build_all(variants=source in VARIANTS)[source]
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[source, name] = fn
        return fn


class RingCheck:
    """The ring check build's counters (``rt_bg_ring_check``): ``read()``
    syncs the device and returns {faults, first (check, block, warp,
    slot), expected, found, checked (exit checks run), and the last
    kernel_matvec_bf16 launch's grid, stages, xring and blocks_per_sm};
    ``reset()`` clears the counters; ``stages`` forces the matvec ring's
    entries (>= 2; 0 as sized) from the next launch on."""

    def __init__(self, stages: int = 0):
        self.stages = stages

    def _call(self, reset: bool) -> Dict[str, int]:
        words = (ctypes.c_ulonglong * 8)()
        err = kernel_fn("bg_ring_check")(ctypes.addressof(words), int(reset),
                                         int(self.stages))
        if err:
            raise RuntimeError(f"rt_bg_ring_check failed: cudaError {err}")
        where, what = words[1], words[2]
        return dict(faults=words[0], check=where >> 56,
                    block=(where >> 24) & 0xFFFFFFFF,
                    warp=(where >> 8) & 0xFFFF, slot=where & 0xFF,
                    expected=what >> 32, found=what & 0xFFFFFFFF,
                    checked=words[3], grid=words[4], stages=words[5],
                    xring=words[6], blocks_per_sm=words[7])

    def read(self) -> Dict[str, int]:
        return self._call(False)

    def reset(self) -> None:
        self._call(True)


@contextmanager
def ring_check(stages: int = 0) -> Iterator[RingCheck]:
    """Inside, the bf16 entry points (``bf16_pack``, ``kermat_bf16``,
    ``kernel_matvec_bf16``, ``cd_update_bf16``) launch the
    ``bf16_gram_check`` build; yields its counters, reset on entry."""
    check = RingCheck(stages)
    with _lock:
        _route["bf16_gram"] = "bf16_gram_check"
    try:
        check.reset()
        yield check
    finally:
        with _lock:
            _route.pop("bf16_gram", None)
        check.stages = 0
        check.reset()
