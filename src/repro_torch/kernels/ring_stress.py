"""A bounded stress check of the bf16 kernels' rings (ROADMAP C4).

``kernel_matvec_bf16`` streams Z through a ring of TMA-fed entries that
mbarriers mark full, released by a shared-memory count and refilled by the
last of a block's 8 warps to release an entry (``csrc/bf16_gram.cu``,
``bg_matvec_kernel``); ``kermat_bf16`` loads its Y tiles through a ring of
three cp.async stages and ``cd_column_update_bf16`` each warp's X tiles
through a ring of four.  Their sums run in a fixed order, so a launch on
the same inputs must give the same bits every time: a launch that does
not has raced on shared memory.

``stress`` launches each of ``FORMS`` (every bf16 form at its ring's
edges: the matvec with two blocks an SM and with one, ring entries from
12 down to 4, the wide forms, X streamed under the ring, a batch; the
kermat and cd_update rings at walks several times their depth; d = 1) many
times on fixed inputs, each launch into an output the allocator has just
filled with NaN, and holds it bit for bit to the first on the device (one
host read a form, at the end).  Then it launches each matvec form again
under the ``bf16_gram_check`` build (``build.ring_check``), whose matvec
tags every Z ring entry with its place in the walk, checks the tag when
the entry is full and again at its release, after the warp's last read of
it (an entry refilled while a warp still read it fails there), checks
each slot's fill and release counts at exit, and counts a fault instead of
trapping; the forms marked ``force`` also with the ring forced down to 2
entries.
kermat's and cd_update's rings are a block's or a warp's own, so only the
repeats test them.

    python -m repro_torch.kernels.ring_stress [--launches 2000]
        [--check-launches 300] [--out chiprun_out/ring_stress.json]

needs a CUDA device; it prints one JSON line and exits 1 on a mismatch or
a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.kernels import Kernel
from repro_torch.kernels import build, ops

BF = "bfloat16"
_UNIT = 256          # X rows a matvec unit (BG_MV_WARPS * BG_MV_WR)


class Form(NamedTuple):
    name: str
    kernel: str      # the ops.LAUNCHES key it launches
    d: int
    make: Callable   # (rng, device) -> a call with no arguments
    force: bool = False   # also run with the matvec ring forced to 2 entries


def _rows(rng, shape, device):
    return torch.tensor(rng.uniform(size=shape), dtype=torch.float32,
                        device=device)


def _gauss(rng, shape, device):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=device)


def _kern(d: int) -> Kernel:
    return Kernel("rbf", gamma=min(1.0, 6.0 / d))


def _matvec(b: int, n: int, m: int, d: int):
    def make(rng, dev):
        X = ops.pack_bf16(_rows(rng, (b, n, d), dev))
        Z = ops.pack_bf16(_rows(rng, (b, m, d), dev))
        v = _gauss(rng, (b, m), dev)
        kern = _kern(d)
        return lambda: ops.kernel_matvec(X, Z, v, kern, compute_dtype=BF)
    return make


def _kermat(n: int, m: Optional[int], d: int):
    def make(rng, dev):
        X = ops.pack_bf16(_rows(rng, (n, d), dev))
        Y = X if m is None else ops.pack_bf16(_rows(rng, (m, d), dev))
        kern = _kern(d)
        return lambda: ops.kernel_matrix(X, Y, kern, compute_dtype=BF)
    return make


def _cd(n: int, B: int, d: int):
    def make(rng, dev):
        X = ops.pack_bf16(_rows(rng, (n, d), dev))
        y = torch.sign(_gauss(rng, n, dev))
        Xb = ops.pack_bf16(_rows(rng, (B, d), dev))
        w = _gauss(rng, B, dev)
        kern = _kern(d)
        return lambda: ops.cd_column_update(X, y, Xb, w, kern,
                                            compute_dtype=BF)
    return make


# Two units a block of a full persistent grid and a ragged last unit (40
# rows: two of its eight warps hold rows); Z rows ragged at an entry's
# edge (64-row entries one-slice, 32-row entries wide).  The ring's
# geometry follows the packed width (bg_mv_launch): dp 8 two blocks an SM
# and 12 entries, dp 56 two and 5, dp 200 one and 4, dp 304 wide (4
# slices an entry) one and 5, dp 600 wide with X streamed, one and 4.
_TWO = 2 * 264 * _UNIT + 40
_ONE = 2 * 132 * _UNIT + 40
FORMS: List[Form] = [
    Form("matvec d1 (dp 8: 2 an SM, 12 entries)", "kernel_matvec_bf16", 1,
         _matvec(1, _TWO, 64 * 9 + 1, 1), True),
    Form("matvec d54 (dp 56: 2 an SM, 5 entries)", "kernel_matvec_bf16", 54,
         _matvec(1, _TWO, 64 * 9 + 1, 54), True),
    Form("matvec d54 batched (5 items, 305 units)", "kernel_matvec_bf16", 54,
         _matvec(5, 256 * 60 + 1, 129, 54)),
    Form("matvec d200 (dp 200: 1 an SM, 4 entries)", "kernel_matvec_bf16",
         200, _matvec(1, _ONE, 64 * 9 + 1, 200), True),
    Form("matvec d300 wide (dp 304: 1 an SM, 5 entries)",
         "kernel_matvec_bf16", 300, _matvec(1, _ONE, 32 * 9 + 1, 300), True),
    Form("matvec d600 wide, X streamed (1 an SM, 4 entries)",
         "kernel_matvec_bf16", 600, _matvec(1, _ONE, 32 * 9 + 1, 600)),
    Form("kermat d1 K(X, X)", "kermat_bf16", 1, _kermat(4001, None, 1)),
    Form("kermat d54 K(X, X)", "kermat_bf16", 54, _kermat(4001, None, 54)),
    Form("kermat d54 (333 x 4100)", "kermat_bf16", 54, _kermat(333, 4100, 54)),
    Form("kermat d54 row form (64 x 60001)", "kermat_bf16", 54,
         _kermat(64, 60001, 54)),
    Form("kermat d300 slice form", "kermat_bf16", 300,
         _kermat(1000, 1100, 300)),
    Form("cd_update d1 (B 64)", "cd_column_update_bf16", 1, _cd(200001, 64, 1)),
    Form("cd_update d54 (B 64)", "cd_column_update_bf16", 54,
         _cd(200001, 64, 54)),
    Form("cd_update d54 (B 257)", "cd_column_update_bf16", 54,
         _cd(200001, 257, 54)),
    Form("cd_update d300 slice form (B 64)", "cd_column_update_bf16", 300,
         _cd(100001, 64, 300)),
]


def _repeat(call, first: torch.Tensor, launches: int) -> List[int]:
    """``launches`` launches of ``call``, each into the block a NaN-filled
    tensor of the output's size just left in the allocator, held bit for
    bit to ``first`` on the device; the indices that differ."""
    bad = torch.zeros(launches, dtype=torch.bool, device=first.device)
    for k in range(launches):
        poison = torch.full_like(first, float("nan"))
        del poison
        out = call()
        bad[k] = torch.ne(out, first).any()
    return torch.nonzero(bad).flatten().tolist()


def stress(launches: int = 2000, check_launches: int = 300,
           forms: Optional[List[Form]] = None, device=None, seed: int = 0,
           log: Callable[[str], None] = lambda s: None) -> Dict[str, dict]:
    """Run the check; {form name: its record}.  A record holds the
    launches and the indices of those that were not bit for bit the first
    (``mismatches``), and for a matvec form the check build's launches,
    faults, exit checks and launch geometry (``check``; with the ring
    forced to 2 entries: ``forced``)."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError("the ring stress check needs a CUDA device")
    out: Dict[str, dict] = {}
    for i, form in enumerate(forms if forms is not None else FORMS):
        rng = np.random.default_rng(seed + i)
        call = form.make(rng, dev)
        t0 = time.perf_counter()
        first = call().clone()
        torch.cuda.synchronize(dev)
        bad = _repeat(call, first, launches)
        rec = dict(kernel=form.kernel, d=form.d, launches=launches,
                   mismatches=bad)
        runs = ([] if form.kernel != "kernel_matvec_bf16" else
                [("check", 0)] + ([("forced", 2)] if form.force else []))
        for key, stages in runs:
            with build.ring_check(stages) as check:
                got = call()
                cbad = _repeat(call, got.clone(), check_launches)
                c = check.read()
            rec[key] = dict(launches=check_launches + 1, mismatches=cbad,
                            equal_to_first=bool(torch.equal(got, first)),
                            **c)
        torch.cuda.synchronize(dev)
        rec["seconds"] = time.perf_counter() - t0
        out[form.name] = rec
        log(f"{form.name}: {json.dumps(rec)}")
    return out


def failures(result: Dict[str, dict]) -> List[str]:
    """What went wrong in a ``stress`` result: mismatches, faults, a check
    build run whose exit checks did not run, or a check build whose output
    differs from the normal build's."""
    bad = []
    for name, rec in result.items():
        if rec["mismatches"]:
            bad.append(f"{name}: launches {rec['mismatches'][:10]} differ")
        for key in ("check", "forced"):
            c = rec.get(key)
            if c is None:
                continue
            if c["mismatches"] or c["faults"] or not c["checked"]:
                bad.append(f"{name} ({key}): {c}")
            if key == "check" and not c["equal_to_first"]:
                bad.append(f"{name}: the check build's output differs")
            if key == "forced" and c["stages"] != 2:
                bad.append(f"{name}: the ring was not forced to 2: {c}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=2000)
    ap.add_argument("--check-launches", type=int, default=300)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the ring stress check needs a CUDA device", file=sys.stderr)
        return 2
    build.build_all(variants=True)
    res = stress(args.launches, args.check_launches,
                 log=lambda s: print(s, flush=True))
    bad = failures(res)
    summary = dict(device=torch.cuda.get_device_name(0), forms=len(res),
                   launches=sum(r["launches"] for r in res.values()),
                   check_launches=sum(r[k]["launches"] for r in res.values()
                                      for k in ("check", "forced") if k in r),
                   mismatches=sum(len(r["mismatches"]) for r in res.values()),
                   faults=sum(r[k]["faults"] for r in res.values()
                              for k in ("check", "forced") if k in r),
                   failures=bad)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, forms=res), f, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
