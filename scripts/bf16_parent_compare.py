"""The bf16 forms of this tree against those of another (a parent commit
unpacked with ``git archive`` into a git-ignored directory): builds both
``csrc/bf16_gram.cu`` with nvcc, runs each form on the same covtype_like
rows (uniform rows at d = 10 for the dedup route and d = 300 for the
matvec's wide form), times each as CUDA-graph replays
(``chip_smoke.graph_ms``; the level-0 n x n matvec, about 0.1-0.2 s a
call, eagerly), and reports whether every output is bit for bit the
other's.  The matvec cases: n x n on the 464,810 packed rows, the
early-scoring bucket (4, 58101) x (4, 116203), decision_exact's (116202)
x (110349), a batched (5, 4096) x (5, 8192), the wide form at
(32768, 300)^2 (a unit's X rows staged whole) and at (16384, 600)^2 (X
streamed a slice an entry under the ring).  ``bf16_matvec_probe.py``
times the same cases (``matvec_cases``).  Needs one CUDA GPU; about two
minutes.

    python scripts/bf16_parent_compare.py [--parent build/parent]
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
LIB = ROOT / "build" / "parent_compare"
ENTRIES = ("bf16_pack", "kermat_bf16", "kernel_matvec_bf16", "cd_update_bf16")


def build_libs(pairs, *flags):
    """nvcc each ``bf16_gram.cu`` of ``pairs`` ((source, library), ...)
    into its library, all at once; returns each build's output."""
    from repro_torch.kernels import build
    procs = [subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, *flags,
                               "-I", str(build.CSRC), "-o", str(lib),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, lib in pairs]
    logs = [p.communicate()[0] for p in procs]
    for (src, _), p, log in zip(pairs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    return logs


def route(lib):
    """Route the ops wrappers of the bf16 forms to the library ``lib``."""
    from repro_torch.kernels import build
    cdll = ctypes.CDLL(str(lib))
    for key in ENTRIES:
        symbol, argtypes = build.SIGNATURES[key]
        fn = getattr(cdll, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        build._loaded[key] = fn


def matvec_cases(torch, X, gen):
    """kernel_matvec_bf16's cases on the covtype_like rows X: {name: (A, B,
    v, reps)}, f32 rows to pack (B None: B = A), and the replays of the
    CUDA graph that times the case (0: timed eagerly)."""
    dev = X.device
    n, d = X.shape

    def rows_of(count, width):
        idx = torch.arange(count * width, device=dev) % n
        return X[idx].reshape(count, width, d).contiguous()

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    return {
        "n x n": (X, None, randn(n), 0),
        "bucket": (rows_of(4, 58101).flip(0).contiguous(),
                   rows_of(4, 116203), randn(4, 116203), 3),
        "decision_exact": (rows_of(1, 116202)[0],
                           rows_of(1, 110349)[0].flip(0).contiguous(),
                           randn(110349), 5),
        "batched": (rows_of(5, 4096), rows_of(5, 8192).flip(1).contiguous(),
                    randn(5, 8192), 20),
        "wide d 300": (torch.rand(32768, 300, device=dev, generator=gen),
                       None, randn(32768), 5),
        "wide d 600, X streamed": (
            torch.rand(16384, 600, device=dev, generator=gen), None,
            randn(16384), 5)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import Kernel
    from repro_torch.data import covtype_like
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("bf16_parent_compare: needs a CUDA GPU", file=sys.stderr)
        return 1
    sources = {"parent": Path(args.parent) / "src" / "repro_torch" / "kernels"
               / "csrc" / "bf16_gram.cu",
               "this tree": build.CSRC / "bf16_gram.cu"}
    LIB.mkdir(parents=True, exist_ok=True)
    libs = {name: LIB / f"bf16_gram_{i}.so"
            for i, name in enumerate(sources)}
    build_libs([(sources[name], libs[name]) for name in sources])

    dev, BF = cs.DEV, "bfloat16"
    X = torch.from_numpy(covtype_like(np.random.default_rng(cs.SEED),
                                      cs.N_TRAIN)[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    kern = Kernel("rbf", gamma=1.0)
    n, d = X.shape
    Xc = X[torch.arange(256 * 1816, device=dev) % n].reshape(256, 1816, d)
    Qs = X[:8192].reshape(4, 2048, d).flip(0).contiguous()
    M = X[torch.arange(4 * 116203, device=dev) % n].reshape(4, 116203, d)
    ys = torch.where(torch.rand(n, device=dev, generator=gen) < 0.5, -1.0,
                     1.0)
    Xf = torch.rand(65536, 10, device=dev, generator=gen)
    cases = matvec_cases(torch, X, gen)
    ones = torch.ones(65536, device=dev)
    w64 = torch.randn(64, device=dev, generator=gen)
    outs = {}
    for name in sources:
        route(libs[name])
        P = ops.pack_bf16(X)
        Pf = ops.pack_bf16(Xf)
        rows64 = torch.arange(64, device=dev)
        Psel, Pfs = P.index(rows64), Pf.index(rows64)
        flag = torch.tensor(False, device=dev)
        out = {"pack data": P.data, "pack norms": P.norms}
        for B in (64, 257):
            w = torch.randn(B, device=dev, generator=torch.Generator(
                device=dev).manual_seed(B))
            out[f"cd_column_update B {B}"] = ops.cd_column_update(
                P, ys, P.index(torch.arange(B, device=dev)), w, kern,
                compute_dtype=BF)
        out["dedup route"] = ops.cd_column_update(Pf, ones, Pfs, w64, kern,
                                                  compute_dtype=BF)
        out["row form"] = ops.kernel_matrix(Psel, P, kern, compute_dtype=BF,
                                            skip=flag)
        out["row form, linear"] = ops.kernel_matrix(
            Psel, P, Kernel("linear"), compute_dtype=BF, skip=flag)
        out["Grams (8 of 256)"] = ops.kernel_matrix(
            Xc[:8].contiguous(), Xc[:8].contiguous(), kern, compute_dtype=BF)
        out["bucket (512 queries)"] = ops.kernel_matrix(
            Qs[:, :512].contiguous(), M.contiguous(), kern, compute_dtype=BF)
        Xcc, Mc = Xc.contiguous(), M.contiguous()
        mv = {}
        for key, (A, B, v, reps) in cases.items():
            A = P if key == "n x n" else ops.pack_bf16(A)
            mv[key] = (A, A if B is None else ops.pack_bf16(B), v, reps)
            out[f"kernel_matvec {key}"] = ops.kernel_matvec(
                *mv[key][:3], kern, compute_dtype=BF)
        times = {
            "row form": cs.graph_ms(torch, lambda: ops.kernel_matrix(
                Psel, P, kern, compute_dtype=BF, skip=flag), 20),
            "Grams": cs.graph_ms(torch, lambda: ops.kernel_matrix(
                Xcc, Xcc, kern, compute_dtype=BF), 3),
            "bucket": cs.graph_ms(torch, lambda: ops.kernel_matrix(
                Qs, Mc, kern, compute_dtype=BF), 3),
            "cd_column_update": cs.graph_ms(torch, lambda: ops.cd_column_update(
                P, ys, Psel, w64, kern, compute_dtype=BF), 20),
            "dedup route": cs.graph_ms(torch, lambda: ops.cd_column_update(
                Pf, ones, Pfs, w64, kern, compute_dtype=BF), 20),
            "bf16_pack": cs.graph_ms(torch, lambda: ops.pack_bf16(X), 20)}
        for key, (A, B, v, reps) in mv.items():
            run = lambda A=A, B=B, v=v: ops.kernel_matvec(   # noqa: E731
                A, B, v, kern, compute_dtype=BF)
            times[f"kernel_matvec {key}"] = (
                cs.graph_ms(torch, run, reps) if reps
                else cs.cuda_ms(torch, run, 3))
        print(f"{name}: ms (graph replays) "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
              flush=True)
        outs[name] = {k: v.cpu() for k, v in out.items()}
        del P, Pf, out, Xcc, Mc, mv
        torch.cuda.empty_cache()
    same = True
    for key, a in outs["parent"].items():
        b = outs["this tree"][key]
        equal = torch.equal(a, b)
        same &= equal
        print(f"{key}: " + ("bit-identical" if equal else
                            f"differs, max {float((a.float() - b.float()).abs().max()):.3e}"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
