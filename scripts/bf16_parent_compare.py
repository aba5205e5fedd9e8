"""The bf16 forms of this tree against those of another (a parent commit
unpacked with ``git archive`` into a git-ignored directory): builds both
``csrc/bf16_gram.cu`` with nvcc, runs each form on the same covtype_like
rows (uniform rows at d = 10 for the dedup route), times each as
CUDA-graph replays (``chip_smoke.graph_ms``), and reports whether every
output is bit for bit the other's.  Needs one CUDA GPU; about a minute.

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
    libs = {}
    for i, (name, src) in enumerate(sources.items()):
        libs[name] = LIB / f"bf16_gram_{i}.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(libs[name]), str(src)],
                       check=True)

    def use(name):   # route the ops wrappers to one tree's library
        lib = ctypes.CDLL(str(libs[name]))
        for key in ENTRIES:
            symbol, argtypes = build.SIGNATURES[key]
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            build._loaded[key] = fn

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
    ones = torch.ones(65536, device=dev)
    w64 = torch.randn(64, device=dev, generator=gen)
    outs = {}
    for name in sources:
        use(name)
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
        print(f"{name}: ms (graph replays) "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
              flush=True)
        outs[name] = {k: v.cpu() for k, v in out.items()}
        del P, Pf, out, Xcc, Mc
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
