"""Phase 2's bf16 operand-form cases of chip_smoke.py, alone.

Builds the kernels, makes the main path's covtype_like split and
friedman1 rows from the smoke's seeds, and runs
``chip_smoke.phase_bf16_kernels``: each bf16 form against its plain
version and float64 on the rounded operands, with its time, bound and
controls.  Needs one CUDA GPU.

    python scripts/bf16_forms_probe.py [--align 32] [--ptxas]

``--align`` pads the packed rows to another multiple of columns than
``ops.BF16_ALIGN`` (the kernels take any multiple of 8); ``--ptxas``
prints ptxas's register and spill report while building.  To compare two
trees on one card, unpack the other with ``git archive`` into a
git-ignored directory, copy this script into its ``scripts/``, and run
the two in turn (A, B, B, A) in one run.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--align", type=int, default=None)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import DCSVMConfig, Kernel
    from repro_torch.data import covtype_like, friedman1, train_test_split
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("bf16_forms_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.align:
        ops.BF16_ALIGN = args.align
    t0 = time.perf_counter()
    build.build_all(verbose=args.ptxas)
    rng = np.random.default_rng(cs.SEED)
    X, y = covtype_like(rng, cs.N_TRAIN + cs.N_TEST)
    Xtr = train_test_split(rng, X, y, test_frac=cs.N_TEST
                           / (cs.N_TRAIN + cs.N_TEST))[0]
    Xtr = torch.from_numpy(Xtr).to(cs.DEV)
    Xf = torch.from_numpy(friedman1(np.random.default_rng(cs.SEED + 2),
                                    cs.SVR_N + cs.SVR_N_TEST,
                                    d=cs.SVR_D)[0]).to(cs.DEV)
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=8.0, k=4, levels=4,
                      m=1000, gram_budget=cs.GRAM_BUDGET, seed=cs.SEED)
    rows = cs.phase_bf16_kernels(torch, Xtr, cfg, cfg.k ** cfg.levels,
                                 Xf[:cs.SVR_N].contiguous())
    for name, r in rows.items():
        print(name, {k: r.get(k) for k in ("ms", "bound_ms", "err_vs_f64",
                                           "controls_vs_f64")})
    print(f"bf16_forms_probe: {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
