"""kernel_matvec's bf16 form (``kernel_matvec_bf16``, csrc/bf16_gram.cu)
in detail, at the cases of ``bf16_parent_compare.matvec_cases``: the SASS
opcodes of each ``bg_matvec_kernel`` instantiation (``cuobjdump``), the
launch geometry the profiler records (grid, block, registers, shared
memory, blocks an SM), the SM clock and power draw through the timed
calls, and each case's time on packed operands.  ptxas's registers and
spills: ``bf16_forms_probe.py --ptxas``.  Needs one CUDA GPU; about a
minute.

    python scripts/bf16_matvec_probe.py [--source PATH] [--variant NAME]
        [--sass-dump FILE] [--trace FILE]

``--source`` builds another tree's ``bf16_gram.cu`` (a ``git archive`` of
a parent unpacked into a git-ignored directory), ``--sass-dump`` writes
the matvec kernels' SASS to a file.  ``--variant`` times a diagnostic
copy of this tree's kernel (wrong outputs; it says where the time goes):
``no-transform`` sums the products' accumulators into each row instead
of transforming them, ``no-products`` drops the products (the transform
of zeros), ``pipeline`` drops both (the ring, its copies and barriers
alone), ``no-copies`` the Z rows' copies into the ring
(``pipeline-no-copies`` all three), ``split-roles`` gives half the warps
of each scheduler the products and the other half the transform
(``split-roles-no-copies`` without the copies).  A variant edits the kernel's source text, and stops with an error where
that text has changed.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
LIB = ROOT / "build" / "matvec_probe"
# the diagnostic variants: source text of bg_matvec_kernel replaced
_FOLD = """bg_mv_fold<KIND>(acc, part, xr,
                             reinterpret_cast<const float4*>(
                                 ring + sl * entry + ZR * ld) + z / 2,
                             c, gamma, degree, coef0, t);"""
_SUM = """float z_ = 0.0f;
#pragma unroll
            for (int q_ = 0; q_ < 32; ++q_) z_ += (&acc[0][0][0])[q_];
            part[0][0] += z_;"""
_PRODUCTS = "bg_chunk_f<4>(acc, A, B, ld, ch, g, t, lane);"
_COPY = """mbar_expect_tx(&full[slot], ZR * ld);
            tma_load_3d(dst, &tz, &full[slot], s0, z0, (int)b);"""
_NOCOPY = "mbar_expect_tx(&full[slot], 0);"
_ROLE = "if ((warp >> 2) & 1) "
VARIANTS = {"no-transform": ((_FOLD, _SUM),),
            "no-products": ((_PRODUCTS, ";"),),
            "pipeline": ((_FOLD, _SUM), (_PRODUCTS, ";")),
            "no-copies": ((_COPY, _NOCOPY),),
            "pipeline-no-copies": ((_FOLD, _SUM), (_PRODUCTS, ";"),
                                   (_COPY, _NOCOPY)),
            # half the warps of each scheduler (warp w runs on w % 4) only
            # multiply, the other half only transform: do one warp's
            # products run under another's exps?  (blocks of 8 or more)
            "split-roles": ((_PRODUCTS, _ROLE + _PRODUCTS),
                            (_FOLD, _ROLE + "{ " + _SUM + " } else "
                             + _FOLD)),
            "split-roles-no-copies": (
                (_PRODUCTS, _ROLE + _PRODUCTS),
                (_FOLD, _ROLE + "{ " + _SUM + " } else " + _FOLD),
                (_COPY, _NOCOPY))}


def sass_opcodes(lib: Path, key: str, dump=None):
    """{function: Counter of opcodes} of the functions whose name holds
    ``key`` (predicates dropped, modifiers kept)."""
    from repro_torch.kernels import build
    out = subprocess.run([build._cuda_tool("cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    counts, fn, lines = {}, None, []
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if key in name else None
            if fn:
                counts[fn] = Counter()
                lines.append(line)
            continue
        if fn is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m:
            counts[fn][m.group(2)] += 1
            lines.append(line)
    if dump:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text("\n".join(lines) + "\n")
    return counts


def time_cases(torch, cs, ops, kern, cases):
    """Each case's time ({name: ms}); a case the build refuses is
    reported and skipped."""
    results = {}
    for name, (A, B, v, reps) in cases.items():
        run = lambda A=A, B=B, v=v: ops.kernel_matvec(      # noqa: E731
            A, B, v, kern, compute_dtype="bfloat16")
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as err:    # a geometry this build refuses
            print(f"time {name}: {err}", flush=True)
            continue
        ms = (cs.graph_ms(torch, run, reps) if reps
              else cs.cuda_ms(torch, run, 5))
        shape = (tuple(A.data.shape), tuple(B.data.shape))
        pairs = A.data.shape[-2] * B.data.shape[-2] * (
            A.data.shape[0] if A.data.dim() == 3 else 1)
        results[name] = ms
        print(f"time {name} {shape}: {ms:.4f} ms "
              f"({'graph replays' if reps else 'eager'}); "
              f"{ms * 1e9 / pairs * 132:.4f} SM-ps a pair", flush=True)
    return results


def print_clocks(smi_log: Path) -> None:
    samples = [[float(x) for x in line.split(",")]
               for line in smi_log.read_text().splitlines()
               if line.strip() and "[" not in line]
    if samples:
        clk = sorted(c for c, _ in samples)
        pw = sorted(p for _, p in samples)
        print(f"clocks.sm MHz over {len(clk)} samples: min {clk[0]:.0f} "
              f"median {clk[len(clk) // 2]:.0f} max {clk[-1]:.0f}; power.draw "
              f"W median {pw[len(pw) // 2]:.1f} max {pw[-1]:.1f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default=None)
    ap.add_argument("--sass-dump", default=None)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from bf16_parent_compare import build_libs, matvec_cases, route
    from repro_torch.core import Kernel
    from repro_torch.data import covtype_like
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("bf16_matvec_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    src = (Path(args.source) if args.source
           else build.CSRC / "bf16_gram.cu")
    LIB.mkdir(parents=True, exist_ok=True)
    if args.variant:
        text = src.read_text()
        for old, new in VARIANTS[args.variant]:
            if old not in text:
                print(f"bf16_matvec_probe: {args.variant}: the kernel's text "
                      "has changed", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        src = LIB / f"bf16_gram_{args.variant}.cu"
        src.write_text(text)
    lib = LIB / f"bf16_gram_{args.variant or 'plain'}.so"
    build_libs([(src, lib)])
    print(f"build {time.perf_counter() - t0:.1f}s (variant "
          f"{args.variant or 'none'})", flush=True)
    for fn, c in sass_opcodes(lib, "bg_matvec", args.sass_dump).items():
        total = sum(c.values())
        print(f"sass {fn}: {total} instructions; "
              + ", ".join(f"{k} {v}" for k, v in c.most_common(40)))
    route(lib)

    dev = cs.DEV
    X = torch.from_numpy(covtype_like(np.random.default_rng(cs.SEED),
                                      cs.N_TRAIN)[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    kern = Kernel("rbf", gamma=1.0)
    cases = {}
    for name, (A, B, v, reps) in matvec_cases(torch, X, gen).items():
        A = ops.pack_bf16(A)
        cases[name] = (A, A if B is None else ops.pack_bf16(B), v, reps)
    # the SM clock and power draw through the timed calls (nvidia-smi's
    # 100 ms samples)
    smi_log = LIB / "clocks.csv"
    with open(smi_log, "w") as fh:
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"], stdout=fh,
            stderr=subprocess.DEVNULL)
    try:
        results = time_cases(torch, cs, ops, kern, cases)
    finally:
        sampler.terminate()
        sampler.wait()
    print_clocks(smi_log)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, (A, B, v, reps) in cases.items():
            if name != "n x n" and name in results:
                ops.kernel_matvec(A, B, v, kern, compute_dtype="bfloat16")
        torch.cuda.synchronize()
    trace = args.trace or str(LIB / "trace.json")
    prof.export_chrome_trace(trace)
    events = json.loads(Path(trace).read_text()).get("traceEvents", [])
    for ev in events:
        if ev.get("cat") == "kernel" and "bg_matvec" in ev.get("name", ""):
            a = ev.get("args", {})
            print("launch", ev["name"][:60], {k: a.get(k) for k in (
                "grid", "block", "registers per thread", "shared memory",
                "blocks per SM", "warps per SM",
                "est. achieved occupancy %")}, f"dur_us={ev.get('dur')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}")
    print("bf16_matvec_probe " + json.dumps(results))
    print(f"bf16_matvec_probe: {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
