"""Phase 9(a) of chip_smoke.py alone: the main path under
compute_dtype="bfloat16" with the column cache, at the full covtype split.

Builds the kernels, makes the split from the smoke's seed and runs
``chip_smoke.phase_bf16_main`` against the f32 fit's numbers given on the
command line (phase 4's, from a smoke run on the same card), so that two
trees can be compared without refitting the f32 model; then holds the
bf16 Grams at the level-3 shape (64 clusters of 7,263 rows, K(X, X)) to
their plain version.  Needs one CUDA GPU; about five minutes.

    python scripts/bf16_main_probe.py --acc-exact 0.9797 \\
        --acc-early 0.9791 --objective -100402.984375 --fit-s 169.89
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
    for name in ("acc-exact", "acc-early", "objective", "fit-s"):
        ap.add_argument(f"--{name}", type=float, required=True)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import DCSVMConfig, Kernel
    from repro_torch.data import covtype_like, train_test_split
    from repro_torch.kernels import build, ops, ref

    if not torch.cuda.is_available():
        print("bf16_main_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    rng = np.random.default_rng(cs.SEED)
    X, y = covtype_like(rng, cs.N_TRAIN + cs.N_TEST)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(cs.DEV) for a in
                          train_test_split(rng, X, y, test_frac=cs.N_TEST
                                           / (cs.N_TRAIN + cs.N_TEST)))
    cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=1.0), C=8.0, k=4, levels=4,
                      m=1000, gram_budget=cs.GRAM_BUDGET, seed=cs.SEED,
                      max_iters=cs.MAIN_ITERS)
    main_f32 = dict(acc_exact=args.acc_exact, acc_early=args.acc_early,
                    objective=args.objective, fit_s=args.fit_s)
    try:
        cs.phase_bf16_main(torch, Xtr, ytr, Xte, yte, cfg, main_f32)
        ok = True
    except AssertionError as err:
        print(f"bf16_main_probe: phase 9(a) check failed: {err}")
        ok = False
    # the level-3 Grams: 64 clusters of ceil(n / 64) rows, K(X, X)
    nc = -(-Xtr.shape[0] // 64)
    idx = torch.arange(64 * nc, device=cs.DEV) % Xtr.shape[0]
    Xc = Xtr[idx].reshape(64, nc, -1).contiguous()
    got = ops.kernel_matrix(Xc[:8], Xc[:8], cfg.kernel,
                            compute_dtype="bfloat16")
    err = 0.0
    for i in range(8):
        want = ref.kermat_bf16_ref(Xc[i], Xc[i], kind="rbf", gamma=1.0)
        err = max(err, float(((got[i] - want).abs()
                              / (1 + want.abs())).max()))
    sym = bool(torch.equal(got, got.transpose(1, 2)))
    print(f"level-3 Grams (8 of 64, {nc} rows): error of 1 + |value| "
          f"{err:.3e}, bitwise symmetric {sym}")
    print(f"bf16_main_probe: {time.perf_counter() - t0:.1f}s")
    return 0 if ok and err <= cs.KERMAT_TOL and sym else 1


if __name__ == "__main__":
    sys.exit(main())
