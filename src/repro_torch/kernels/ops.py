"""Wrappers around the hand-written CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity.  For a tensor on
the CPU it runs the kernel's plain version (``kernels.ref``); for a CUDA
tensor it launches the kernel or raises -- there is no fallback.  Outputs
are allocated with ``torch.empty`` and the kernels run with the tensors'
device current, on its current stream (``_launch``).  ``LAUNCHES``
counts, per kernel, the launches made by the wrappers (a plain integer,
added to where the kernel is launched and nowhere else), so a run can
show that its path went through the kernels.
A launch recorded into a CUDA graph runs only when the graph is replayed:
``recording()`` takes such launches out of ``LAUNCHES`` and
``add_launches`` puts them back once a replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"kermat": 0, "kernel_matvec": 0,
                            "cd_column_update": 0, "kmeans_assign": 0,
                            "flash_attention": 0, "bf16_pack": 0,
                            "kermat_bf16": 0, "kernel_matvec_bf16": 0,
                            "cd_column_update_bf16": 0}

_KIND = {"linear": 0, "poly": 1, "rbf": 2}
_MAX_GRID_YZ = 65535
MAX_CD_BLOCK = 256
FLASH_HEAD_DIMS = (64, 128, 256)
# Mirrors of csrc constants, for the CPU-testable ``split_tile_plan``:
SPLIT_SLICE = 64            # RTS_DC (rbf_tile.cuh): a streamed depth slice
_SMEM_BLOCK = 232448        # MV_SMEM_MAX, CD_SMEM_MAX: shared memory a block
_SMEM_SM = 233472           # CD_SMEM_SM: shared memory of an SM


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that, on exit, holds the
    launches the wrappers made inside (the graph's launches a replay), and
    takes them out of ``LAUNCHES``, since a capture runs nothing."""
    before = dict(LAUNCHES)
    captured: Dict[str, int] = {}
    try:
        yield captured
    finally:
        for name in LAUNCHES:
            captured[name] = LAUNCHES[name] - before[name]
            LAUNCHES[name] = before[name]


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` replays of a graph holding ``counts`` launches."""
    for name, k in counts.items():
        LAUNCHES[name] += k * times


def as_dtype(name) -> torch.dtype:
    """A dtype from its name ("bfloat16", "float32") or a torch dtype."""
    dt = name if isinstance(name, torch.dtype) else getattr(torch, str(name),
                                                            None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def resolve_compute_dtype(compute_dtype, ref_dtype) -> Optional[torch.dtype]:
    """The precision policy, normalised: ``None``, or a dtype equal to the
    data's own, keeps the f32 forms and the plain expressions (no cast);
    else the operand dtype."""
    if compute_dtype is None:
        return None
    cd = as_dtype(compute_dtype)
    return None if cd == ref_dtype else cd


# --- the bf16 operand forms (csrc/bf16_gram.cu) ----------------------------

BF16_ALIGN = 8      # packed rows are padded to a multiple of 8 columns


class Bf16Rows(NamedTuple):
    """An operand packed for the bf16 forms (``pack_bf16``): ``data`` (...,
    rows, dp) bfloat16, the rows rounded to nearest even and padded with
    zero columns to ``dp = bf16_width(d)``; ``norms`` (..., rows) the f32
    squared norms of the rounded rows.  The Gram operator packs X once a
    solve, so the kernels read half the bytes of the f32 rows."""
    data: torch.Tensor
    norms: torch.Tensor
    d: int

    @property
    def shape(self):
        return tuple(self.data.shape[:-1]) + (self.d,)

    @property
    def device(self):
        return self.data.device

    def dim(self) -> int:
        return self.data.dim()

    def rounded(self) -> torch.Tensor:
        """The rounded rows in f32 (exactly the values the kernels read)."""
        return self.data[..., :self.d].float()

    def index(self, idx) -> "Bf16Rows":
        """The packed rows ``idx`` (a gather, no rounding)."""
        return Bf16Rows(self.data[idx], self.norms[idx], self.d)


def bf16_width(d: int) -> int:
    return -(-int(d) // BF16_ALIGN) * BF16_ALIGN


def pack_bf16(X: torch.Tensor) -> Bf16Rows:
    """Round the rows of X (..., rows, d) to bf16 once (``Bf16Rows``).  The
    CUDA ``bf16_pack`` kernel on a CUDA tensor (float32, contiguous, any
    d >= 1), its plain version on the CPU."""
    if isinstance(X, Bf16Rows):
        return X
    d = X.shape[-1]
    dp = bf16_width(d)
    if d < 1:
        raise ValueError(f"the bf16 forms take d >= 1, got {d}")
    if _on_cpu(X):
        q = X.to(torch.bfloat16)
        data = torch.nn.functional.pad(q, (0, dp - d))
        qf = q.float()
        return Bf16Rows(data, torch.sum(qf * qf, -1), d)
    _check_cuda(X)
    data = torch.empty(tuple(X.shape[:-1]) + (dp,), device=X.device,
                       dtype=torch.bfloat16)
    norms = torch.empty(tuple(X.shape[:-1]), device=X.device,
                        dtype=torch.float32)
    rows = X.numel() // d
    if rows:
        _launch("bf16_pack", X, X.data_ptr(), rows, d, dp, data.data_ptr(),
                norms.data_ptr())
        LAUNCHES["bf16_pack"] += 1
    return Bf16Rows(data, norms, d)


def _t(X) -> torch.Tensor:
    """A tensor of the operand (its packed data for ``Bf16Rows``)."""
    return X.data if isinstance(X, Bf16Rows) else X


def _bf16_operand(X) -> Bf16Rows:
    """A wrapper's bf16 operand: a packed one as it is, else packed now."""
    if isinstance(X, Bf16Rows):
        if not X.data.is_contiguous() or not X.norms.is_contiguous():
            raise ValueError("the bf16 forms take contiguous packed rows")
        return X
    return pack_bf16(X)


def _rounded(X, cd: torch.dtype) -> torch.Tensor:
    return X.rounded() if isinstance(X, Bf16Rows) else ref.rounded(X, cd)


def _policy(compute_dtype, *ops_) -> Optional[torch.dtype]:
    """The wrappers' policy: a packed operand means bf16; else as
    ``resolve_compute_dtype`` against the first operand's dtype."""
    packed = any(isinstance(t, Bf16Rows) for t in ops_)
    first = ops_[0]
    ref_dtype = torch.float32 if isinstance(first, Bf16Rows) else first.dtype
    cd = resolve_compute_dtype(compute_dtype, ref_dtype)
    if packed and cd != torch.bfloat16:
        raise ValueError("a packed bf16 operand needs compute_dtype="
                         "'bfloat16'")
    return cd


def _check_lowp_cuda(cd: torch.dtype) -> None:
    if cd != torch.bfloat16:
        raise ValueError(f"the CUDA kernels take compute_dtype bfloat16 "
                         f"(or none), got {cd}")


def _params(kernel):
    return (_KIND[kernel.kind], float(kernel.gamma), int(kernel.degree),
            float(kernel.coef0))


def _ref_kw(kernel):
    return dict(kind=kernel.kind, gamma=float(kernel.gamma),
                degree=int(kernel.degree), coef0=float(kernel.coef0))


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


_REFUSED = 20000    # RTS_REFUSED of csrc/rbf_tile.cuh: nothing launched


def _run(name: str, *args, refused: str = "") -> None:
    _check(name, build.kernel_fn(name)(*args), refused)


def _check(name: str, err: int, refused: str) -> None:
    """Raise on a C entry's error code (0: launched)."""
    if err == _REFUSED:
        raise ValueError(refused or f"CUDA kernel {name} does not take these "
                                    "inputs")
    if err != 0:
        what = (f"CUresult {err - 10000} (a TMA tensor map was refused)"
                if err >= 10000 else f"cudaError {err}")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {what}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, on: torch.Tensor, *args, refused: str = "") -> None:
    """Launch kernel ``name`` (its C entry's arguments ``args``, the stream
    appended) for the tensor ``on``: with ``on``'s device current for the
    call, on that device's current stream.  The C entries' caches (SM
    counts, occupancy, shared-memory attributes) and their launches are
    the current device's own, so this guard makes a launch on any device
    right whatever device the calling thread has current.  The library is
    loaded (or built) first."""
    fn = build.kernel_fn(name)
    with torch.cuda.device(on.device):
        _check(name, fn(*args, _stream(on)), refused)


def split_shift(Y: torch.Tensor, kernel) -> Optional[torch.Tensor]:
    """The vector the split-TF32 kernels subtract from both operands of an
    rbf kernel: the mean of the kept operand's rows, (..., m, d) -> (...,
    d), contiguous (K depends on x - z alone, and the Gram expansion then
    cancels between smaller numbers).  None for linear and poly, which the
    kernels do not shift."""
    if kernel.kind != "rbf":
        return None
    return Y.mean(dim=-2).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


class SplitPlan(NamedTuple):
    """How a split-TF32 kernel takes a shape.  ``stages`` > 0: the resident
    form, which keeps the kept operand split whole in shared memory, with a
    cp.async ring of that many stages (1 for kernel_matvec's single Z
    stage, 2 or 3 for cd_column_update).  0: the streamed form, which
    splits both operands one depth slice of ``SPLIT_SLICE`` columns at a
    time."""
    stages: int


def _kp(d: int) -> int:                 # rts_kp (rbf_tile.cuh)
    return -(-d // 8) * 8


def _stage(rows: int, d: int) -> int:   # rts_stage: floats of a raw stage
    return -(-rows * d // 4) * 4


def _mv_smem(d: int) -> int:            # mv_smem (kermatvec.cu)
    kp = _kp(d)
    raw = max(_stage(64, d), 4 * 128)
    return (1024 + 2 * (128 + 64) * (-(-kp // 32)) * 128
            + (128 + 64 + kp + 4 + raw) * 4)


def _cd_smem(nch: int, d: int, stages: int) -> int:   # cd_smem (cd_update.cu)
    bp, kp = 64 * nch, _kp(d)
    return bp * kp * 8 + (3 * bp + kp + 4) * 4 + stages * _stage(128, d) * 4


def split_tile_plan(d: int, B: Optional[int] = None) -> SplitPlan:
    """The form a split-TF32 kernel takes feature width ``d`` in:
    ``kernel_matvec`` (``B`` None) or ``cd_column_update`` with a block of
    ``B`` columns.  The resident form keeps the split tile whole in shared
    memory (``kernel_matvec`` d <= 128; ``cd_column_update`` d <= 149 at
    B <= 64, d <= 72 at B = 256); past that the streamed form takes every
    d.  So both take every d >= 1 (and B from 1 to 256).  Raises
    ValueError on anything else.  The wrappers pass the plan to the C entry
    points, which refuse (20000) a plan whose shared memory does not fit."""
    if int(d) < 1:
        raise ValueError(f"the split-TF32 kernels take d >= 1, got {d}")
    if B is None:
        return SplitPlan(1 if _mv_smem(d) <= _SMEM_BLOCK else 0)
    if not 1 <= int(B) <= MAX_CD_BLOCK:
        raise ValueError(f"cd_column_update takes 1 <= B <= {MAX_CD_BLOCK}, "
                         f"got {B}")
    nch = -(-int(B) // 64)
    # two blocks an SM where they fit (with three stages, else two), else
    # one block with three stages, else two (rt_cd_column_update's choice)
    for blocks, stages in ((2, 3), (2, 2), (1, 3), (1, 2)):
        smem = _cd_smem(nch, d, stages)
        if (2 * (smem + 1024) <= _SMEM_SM if blocks == 2
                else smem <= _SMEM_BLOCK):
            return SplitPlan(stages)
    return SplitPlan(0)


def _same_tensor(X: torch.Tensor, Y: torch.Tensor) -> bool:
    return (X.data_ptr() == Y.data_ptr() and X.shape == Y.shape
            and X.stride() == Y.stride())


def kernel_matrix(X: torch.Tensor, Y: torch.Tensor, kernel,
                  compute_dtype=None, skip: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K(X, Y): (n, d) x (m, d) -> (n, m), or batched (b, n, d) x (b, m, d)
    -> (b, n, m) in one launch.  The CUDA kernel runs split-TF32 on the
    tensor cores, any d; given the same tensor twice it computes the tiles
    on and above the diagonal and mirrors them, so K(X, X) is symmetric bit
    for bit.  ``compute_dtype="bfloat16"`` takes the bf16 form
    (``kermat_bf16``; X and Y may be packed, ``pack_bf16``).  ``skip``: a
    one-element bool tensor on the device; where it is set the CUDA launch
    returns at once and the result is left unwritten (the cached solver's
    row form under a CUDA graph; the plain version ignores it)."""
    cd = _policy(compute_dtype, X, Y)
    if cd is not None:
        return _kermat_lowp(X, Y, kernel, cd, skip)
    _shapes_2d3d("kernel_matrix", X, Y)
    if _on_cpu(X, Y):
        return ref.kermat_ref(X, Y, **_ref_kw(kernel))
    _check_cuda(X, Y)
    Xb, Yb = (X, Y) if X.dim() == 3 else (X[None], Y[None])
    b, n, d = Xb.shape
    m = Yb.shape[1]
    if b > _MAX_GRID_YZ or -(-n // 64) * -(-m // 64) >= 2 ** 31:
        raise ValueError(f"kermat grid too large for batch {b}, n {n}, m {m}")
    out = torch.empty((b, n, m), device=X.device, dtype=torch.float32)
    if b and n and m:
        if d < 1:
            raise ValueError(f"the kermat kernel takes d >= 1, got {d}")
        shift = split_shift(Yb, kernel)
        _launch("kermat", X, Xb.data_ptr(), Yb.data_ptr(), _ptr(shift),
                out.data_ptr(), b, n, m, d, n * d, m * d,
                int(_same_tensor(X, Y)), *_params(kernel),
                _ptr(_skip(skip, X)))
        LAUNCHES["kermat"] += 1
    return out if X.dim() == 3 else out[0]


def _skip(skip: Optional[torch.Tensor], like) -> Optional[torch.Tensor]:
    if skip is None:
        return None
    if (skip.numel() != 1 or skip.dtype != torch.bool
            or skip.device != like.device):
        raise ValueError("skip is a one-element bool tensor on the kernel's "
                         "device")
    return skip


def _shapes_2d3d(name, X, Y) -> None:
    if X.dim() not in (2, 3) or Y.dim() != X.dim():
        raise ValueError(f"{name} takes two 2-D or two 3-D operands, got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    if X.shape[-1] != Y.shape[-1] or X.shape[:-2] != Y.shape[:-2]:
        raise ValueError(f"shape mismatch {tuple(X.shape)} vs "
                         f"{tuple(Y.shape)}")


def _kermat_lowp(X, Y, kernel, cd: torch.dtype, skip) -> torch.Tensor:
    """kernel_matrix's bf16 form (``kermat_bf16``; the plain version on the
    CPU).  Given the same operand twice, K(X, X) is symmetric bit for bit."""
    _shapes_2d3d("kernel_matrix", X, Y)
    sym = X is Y or (isinstance(X, torch.Tensor) and isinstance(Y, torch.Tensor)
                     and _same_tensor(X, Y))
    if _on_cpu(_t(X), _t(Y)):
        return ref.kermat_rounded(_rounded(X, cd), _rounded(Y, cd),
                                  **_ref_kw(kernel))
    _check_lowp_cuda(cd)
    Xp = _bf16_operand(X)
    Yp = Xp if sym else _bf16_operand(Y)
    three = Xp.data.dim() == 3
    b = Xp.data.shape[0] if three else 1
    n, m = Xp.data.shape[-2], Yp.data.shape[-2]
    dp = Xp.data.shape[-1]
    out = torch.empty((b, n, m), device=Xp.device, dtype=torch.float32)
    if b and n and m:
        _launch("kermat_bf16", Xp.data, Xp.data.data_ptr(),
                Xp.norms.data_ptr(), Yp.data.data_ptr(), Yp.norms.data_ptr(),
                out.data_ptr(), b, n, m, dp, int(sym),
                _ptr(_skip(skip, Xp.data)), *_params(kernel),
                refused=f"kermat_bf16 refused ({b}, {n}, {m}, dp {dp})")
        LAUNCHES["kermat_bf16"] += 1
    return out if three else out[0]


def kernel_matvec(X: torch.Tensor, Z: torch.Tensor, v: torch.Tensor, kernel,
                  compute_dtype=None) -> torch.Tensor:
    """out = K(X, Z) @ v without materialising K: (n, d), (m, d), (m,) ->
    (n,), or batched (b, n, d), (b, m, d), (b, m) -> (b, n).  The CUDA
    kernel (split-TF32 on the tensor cores) takes every d, in the form
    ``split_tile_plan(d)`` names.  ``compute_dtype="bfloat16"`` takes the
    bf16 form (``kernel_matvec_bf16``: every d; X and Z may be packed);
    v and the contraction stay f32."""
    cd = _policy(compute_dtype, X, Z)
    if cd is not None:
        return _kernel_matvec_lowp(X, Z, v, kernel, cd)
    if X.dim() not in (2, 3) or Z.dim() != X.dim() or v.dim() != X.dim() - 1:
        raise ValueError(f"kernel_matvec shapes {tuple(X.shape)}, "
                         f"{tuple(Z.shape)}, {tuple(v.shape)}")
    if (X.shape[-1] != Z.shape[-1] or X.shape[:-2] != Z.shape[:-2]
            or v.shape != Z.shape[:-1]):
        raise ValueError(f"kernel_matvec shapes {tuple(X.shape)}, "
                         f"{tuple(Z.shape)}, {tuple(v.shape)}")
    if _on_cpu(X, Z, v):
        return ref.kernel_matvec_ref(X, Z, v, **_ref_kw(kernel))
    _check_cuda(X, Z, v)
    Xb, Zb, vb = (X, Z, v) if X.dim() == 3 else (X[None], Z[None], v[None])
    b, n, d = Xb.shape
    m = Zb.shape[1]
    if b > _MAX_GRID_YZ:
        raise ValueError(f"kernel_matvec batch {b} too large")
    out = torch.empty((b, n), device=X.device, dtype=torch.float32)
    if b and n:
        plan = split_tile_plan(d)
        shift = split_shift(Zb, kernel)
        _launch("kermatvec", X, Xb.data_ptr(), Zb.data_ptr(), vb.data_ptr(),
                _ptr(shift), out.data_ptr(), b, n, m, d, n * d, m * d, m,
                *plan, *_params(kernel),
                refused=f"kernel_matvec refused d {d} with plan {plan}")
        LAUNCHES["kernel_matvec"] += 1
    return out if X.dim() == 3 else out[0]


def _kernel_matvec_lowp(X, Z, v, kernel, cd: torch.dtype) -> torch.Tensor:
    _shapes_2d3d("kernel_matvec", X, Z)
    if v.dim() != X.dim() - 1 or tuple(v.shape) != tuple(Z.shape[:-1]):
        raise ValueError(f"kernel_matvec shapes {tuple(X.shape)}, "
                         f"{tuple(Z.shape)}, {tuple(v.shape)}")
    if _on_cpu(_t(X), _t(Z), v):
        return ref.kernel_matvec_rounded(_rounded(X, cd), _rounded(Z, cd), v,
                                         **_ref_kw(kernel))
    _check_lowp_cuda(cd)
    _check_cuda(v)
    Xp = _bf16_operand(X)
    Zp = Xp if Z is X else _bf16_operand(Z)
    three = Xp.data.dim() == 3
    b = Xp.data.shape[0] if three else 1
    n, m = Xp.data.shape[-2], Zp.data.shape[-2]
    dp = Xp.data.shape[-1]
    out = torch.empty((b, n), device=v.device, dtype=torch.float32)
    if b and n:
        _launch("kernel_matvec_bf16", v, Xp.data.data_ptr(),
                Xp.norms.data_ptr(), Zp.data.data_ptr(), Zp.norms.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, n, m, dp, *_params(kernel),
                refused=f"kernel_matvec_bf16 refused ({b}, {n}, {m}, "
                        f"dp {dp})")
        LAUNCHES["kernel_matvec_bf16"] += 1
    return out if three else out[0]


def q_rows(X: torch.Tensor, y: torch.Tensor, Xb: torch.Tensor,
           yb: torch.Tensor, kernel, compute_dtype=None,
           skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Signed dual rows ``Q[b, :] = y_b * (K(X_b, X) * y)``, shape (B, n).
    ``skip`` as in ``kernel_matrix`` (the rows are then not computed)."""
    Kb = kernel_matrix(Xb, X, kernel, compute_dtype=compute_dtype, skip=skip)
    return yb[:, None] * (Kb * y[None, :])


def cd_chunks(B: int) -> Tuple[Tuple[int, int], ...]:
    """The consecutive column ranges ``cd_column_update`` launches its
    kernel on: ``ceil(B / MAX_CD_BLOCK)`` chunks of near-equal width (one
    launch for B <= 256).  A static function of B, so a CUDA graph captures
    the same launches every replay."""
    if int(B) < 1:
        return ((0, int(B)),)       # split_tile_plan refuses it
    count = -(-int(B) // MAX_CD_BLOCK)
    width = -(-int(B) // count)
    return tuple((a, min(int(B), a + width)) for a in range(0, int(B), width))


def cd_column_update(X: torch.Tensor, y: torch.Tensor, Xb: torch.Tensor,
                     w: torch.Tensor, kernel, compute_dtype=None
                     ) -> torch.Tensor:
    """dg = y * (K(X, Xb) @ w): X (n, d), y (n,), Xb (B, d), w (B,) -> (n,),
    any B >= 1.  The (n, B) kernel block never reaches device memory.  The
    CUDA kernel (split-TF32 on the tensor cores) takes B <= 256 columns,
    every d, in the form ``split_tile_plan(d, B)`` names; a wider block is
    launched once a chunk of ``cd_chunks(B)`` and the chunks' updates are
    summed in f32 (every chunk shifted by the mean of all of Xb's rows).
    ``compute_dtype="bfloat16"`` takes the bf16 form
    (``cd_column_update_bf16``: any B, every d, one launch; X and Xb may
    be packed); y, w and the skinny product stay f32."""
    cd = _policy(compute_dtype, X, Xb)
    if cd is not None:
        return _cd_column_update_lowp(X, y, Xb, w, kernel, cd)
    if (X.dim() != 2 or Xb.dim() != 2 or y.shape != X.shape[:1]
            or w.shape != Xb.shape[:1] or X.shape[1] != Xb.shape[1]):
        raise ValueError(f"cd_column_update shapes {tuple(X.shape)}, "
                         f"{tuple(y.shape)}, {tuple(Xb.shape)}, "
                         f"{tuple(w.shape)}")
    if _on_cpu(X, y, Xb, w):
        return ref.cd_column_update_ref(X, y, Xb, w, **_ref_kw(kernel))
    _check_cuda(X, y, Xb, w)
    n, d = X.shape
    B = Xb.shape[0]
    chunks = cd_chunks(B)
    plans = [split_tile_plan(d, b - a) for a, b in chunks]
    out = torch.empty(n, device=X.device, dtype=torch.float32)
    if n:
        shift = split_shift(Xb, kernel)
        part = out
        for (a, b), plan in zip(chunks, plans):
            _launch("cd_update", X, X.data_ptr(), y.data_ptr(),
                    Xb[a:b].data_ptr(), w[a:b].data_ptr(), _ptr(shift),
                    part.data_ptr(), n, b - a, d, *plan, *_params(kernel),
                    refused=f"cd_column_update refused Xb ({b - a}, {d}) "
                            f"with plan {plan}")
            LAUNCHES["cd_column_update"] += 1
            if part is not out:
                out.add_(part)
            elif len(chunks) > 1:
                part = torch.empty_like(out)
    return out


def _cd_column_update_lowp(X, y, Xb, w, kernel, cd: torch.dtype
                           ) -> torch.Tensor:
    if (X.dim() != 2 or Xb.dim() != 2 or tuple(y.shape) != tuple(X.shape[:1])
            or tuple(w.shape) != tuple(Xb.shape[:1])
            or X.shape[1] != Xb.shape[1]):
        raise ValueError(f"cd_column_update shapes {tuple(X.shape)}, "
                         f"{tuple(y.shape)}, {tuple(Xb.shape)}, "
                         f"{tuple(w.shape)}")
    if _on_cpu(_t(X), _t(Xb), y, w):
        return ref.cd_column_update_rounded(_rounded(X, cd), y,
                                            _rounded(Xb, cd), w,
                                            **_ref_kw(kernel))
    _check_lowp_cuda(cd)
    _check_cuda(y, w)
    Xp, Bp = _bf16_operand(X), _bf16_operand(Xb)
    n, B = Xp.data.shape[0], Bp.data.shape[0]
    dp = Xp.data.shape[-1]
    out = torch.empty(n, device=y.device, dtype=torch.float32)
    if n:
        _launch("cd_update_bf16", y, Xp.data.data_ptr(), Xp.norms.data_ptr(),
                y.data_ptr(), Bp.data.data_ptr(), Bp.norms.data_ptr(),
                w.data_ptr(), out.data_ptr(), n, B, dp, *_params(kernel),
                refused=f"cd_column_update_bf16 refused ({n}, {B}, dp {dp})")
        LAUNCHES["cd_column_update_bf16"] += 1
    return out


def _assign_layout(k: int) -> Tuple[int, int]:
    """(n8 blocks of score columns a pass, padded k) of the ``kmeans_assign``
    kernel: a warp keeps 16 rows by 8 x group scores in registers, group a
    power of two <= 16, and k is padded to a multiple of 8 x group; more
    centres take further passes over Xm."""
    group = 1
    while group < 16 and 8 * group < k:
        group *= 2
    width = 8 * group
    return group, -(-k // width) * width


def _assign_scratch(m: int, d: int, kp: int, group: int) -> int:
    """Floats of the ``kmeans_assign`` kernel's scratch (Xm and W split once
    into fragment order), as its C module, which alone defines the layout,
    gives them."""
    floats = ctypes.c_longlong()
    _run("kmeans_assign_scratch", m, d, kp, group, ctypes.byref(floats))
    return floats.value


def kmeans_assign(X: torch.Tensor, Xm: torch.Tensor, W: torch.Tensor,
                  s: torch.Tensor, gamma: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused RBF assignment: X (n, d), Xm (m, d), W (m, k), s (k,) ->
    (assign (n,) int64, scores (n, k)), ``scores = -2 K(X, Xm) @ W + s``
    and ``assign`` its row argmin (lowest index on ties).  The (n, m)
    cross-kernel never reaches device memory.  K(x, x) is left out (the
    caller adds it).  The CUDA kernel pads k to its column layout
    (``_assign_layout``) with zero W columns and s = +inf, runs both
    products in split-TF32 on the tensor cores (both operands of K shifted
    by the mean of Xm's rows), takes any d, and splits Xm and W once into
    a scratch buffer (``_assign_scratch``)."""
    if (X.dim() != 2 or Xm.dim() != 2 or W.dim() != 2 or s.dim() != 1
            or X.shape[1] != Xm.shape[1] or W.shape[0] != Xm.shape[0]
            or s.shape[0] != W.shape[1] or W.shape[1] == 0):
        raise ValueError(f"kmeans_assign shapes {tuple(X.shape)}, "
                         f"{tuple(Xm.shape)}, {tuple(W.shape)}, "
                         f"{tuple(s.shape)}")
    if _on_cpu(X, Xm, W, s):
        return ref.kmeans_assign_ref(X, Xm, W, s, gamma=float(gamma))
    _check_cuda(X, Xm, W, s)
    n, d = X.shape
    m, k = W.shape
    group, kp = _assign_layout(k)
    scores = torch.empty((n, k), device=X.device, dtype=torch.float32)
    assign = torch.empty(n, device=X.device, dtype=torch.int64)
    if n:
        if d < 1:
            raise ValueError(f"the kmeans_assign kernel takes d >= 1, got {d}")
        shift = Xm.mean(dim=0) if m else torch.zeros(d, device=X.device)
        floats = _assign_scratch(m, d, kp, group)
        scratch = torch.empty(floats, device=X.device, dtype=torch.float32)
        _launch("kmeans_assign", X, X.data_ptr(), Xm.data_ptr(),
                W.data_ptr(), s.data_ptr(), shift.data_ptr(),
                scratch.data_ptr(), floats, scores.data_ptr(),
                assign.data_ptr(), n, m, d, k, kp, group, float(gamma))
        LAUNCHES["kmeans_assign"] += 1
    return assign, scores


def flash_tma_strides(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> Tuple[int, ...]:
    """The bf16 kernel's input checks, which TMA sets: hd in {64, 128,
    256}, a unit stride on the last axis, a 16-byte aligned base and
    (batch, sequence, head) strides that are multiples of 8 elements (16
    bytes) and below 2^39.  Returns the nine element strides (q, k, v;
    batch, sequence, head each) that the kernel's tensor maps take: an axis
    of size 1 is never stepped, so it gets the stride of a contiguous
    tensor.  Raises ValueError on an input the kernel does not take."""
    hd = q.shape[-1]
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes hd in "
                         f"{FLASH_HEAD_DIMS}, got {hd}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention takes a unit stride on the last "
                             "axis")
        if t.data_ptr() % 16:
            raise ValueError(f"the bf16 flash_attention kernel needs {name} "
                             f"16-byte aligned (TMA), got address "
                             f"{t.data_ptr():#x}")
        B, S, H, _ = t.shape
        dense = {0: S * H * hd, 1: H * hd, 2: hd}
        for axis in (0, 1, 2):
            st = t.stride(axis) if t.shape[axis] > 1 else dense[axis]
            if st % 8 or not 0 < st < 2 ** 39:
                raise ValueError(
                    f"the bf16 flash_attention kernel needs {name}'s strides "
                    f"to be positive multiples of 8 elements (16 bytes, for "
                    f"TMA); axis {axis} has stride {t.stride(axis)}")
            strides.append(st)
    return tuple(strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Softmax attention forward, the score matrix kept on chip.

    q (B, Sq, Hq, hd) with k, v (B, Sk, Hkv, hd), Hq a multiple of Hkv
    (query head h reads kv head h // (Hq // Hkv); nothing is repeated).
    Scores are f32 times 1/sqrt(hd); under the causal mask query row i sits
    at position ``q_offset + i``.  Returns a contiguous (B, Sq, Hq, hd)
    tensor in q's dtype.  On CUDA: float32 (CUDA cores) or bfloat16
    (tensor cores, p rounded to bf16 before P.V; ``flash_tma_strides``
    says which layouts it takes), hd in {64, 128, 256}, a unit stride on
    the last axis."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv
            or Sk == 0 or q_offset < 0):
        raise ValueError(f"flash_attention shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, q_offset {q_offset}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    if q.dtype == torch.bfloat16:
        strides = flash_tma_strides(q, k, v)
    elif q.dtype == torch.float32:
        if hd not in FLASH_HEAD_DIMS:
            raise ValueError(f"the flash_attention kernel takes hd in "
                             f"{FLASH_HEAD_DIMS}, got {hd}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("flash_attention takes a unit stride on the "
                             "last axis")
        if B * Hq > _MAX_GRID_YZ:
            raise ValueError(f"flash_attention grid too large: B * Hq = "
                             f"{B * Hq}")
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    else:
        raise TypeError(f"the flash_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    o = torch.empty((B, Sq, Hq, hd), device=q.device, dtype=q.dtype)
    if B and Sq and Hq:
        _launch("flash_attention", q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), B, Sq, Sk, Hq, Hkv, hd, *strides,
                int(causal), int(q_offset), 1.0 / math.sqrt(hd),
                int(q.dtype == torch.bfloat16))
        LAUNCHES["flash_attention"] += 1
    return o
