#!/usr/bin/env python3
"""The fused GEMM hops' form T (rows 14 and 15) from two or more checkouts
in turns, on one GPU, each run a process of its own.

    python3 tools/fused_gemm_ab.py DIR_A DIR_B [DIR_C ...] [--rounds R] [--out FILE]

The checkouts run in a palindrome (A B B A; A B C C B A), R times over. Each
run imports ``chip_smoke`` from its checkout (which builds that checkout's
``csrc/fused_gemm.cu`` at first use) and times, with its ``time_fn`` (CUDA
events, median of groups of 20 calls, L2 warm), ``ag_hop`` and ``rs_hop``
with ``form="wgmma"`` at ``chip_smoke.py`` phase 6c's four hop shapes (row
14's accumulate and ``out_block`` hops, row 15's ``dw`` and
``row_parallel_linear`` hops), each with the exact and the int8 wire, and
``Tensor.addmm_`` of the accumulate hop's product as a control for the
card's own drift. Prints one JSON line a run and each checkout's mean a
measurement; exits non-zero if a run fails. Compare checkouts only inside
one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import functools, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from deepspeed_tpu_torch.collectives import fused_gemm as fg
from deepspeed_tpu_torch.utils.checks import block_wire, fused_gemm_qb
dev = torch.device("cuda")
n, (M, H), (_, F) = cs.FUSED_RANKS, cs.FUSED_X, cs.FUSED_W_UP
Ks = cs.FUSED_W_UP[0] // n
g = torch.Generator(device=dev).manual_seed(13)
rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
out = {}
x, gout, held, y, dx, upstream = rnd(M, H), rnd(M, F), rnd(Ks, F), rnd(M, F), rnd(M, H), rnd(Ks, F)
recv = torch.empty_like(held)
out["addmm_ accumulate"] = cs.time_fn(lambda: y.addmm_(x[:, 2 * Ks:3 * Ks], held), iters=200)
for out_block in (False, True):
    a_, o = (gout, dx) if out_block else (x, y)
    for kind in ("none", "int8"):
        qb = fused_gemm_qb(kind, Ks, F)
        up = block_wire(kind, upstream, qb)
        own = None if kind == "none" else (torch.empty_like(up[0]), torch.empty_like(up[1]))
        fn = functools.partial(fg.ag_hop, a_, held, o, 2 * Ks, up, recv, own, qb=qb,
                               out_block=out_block, form="wgmma")
        out[f"ag_hop {'out_block' if out_block else 'accumulate'} {kind}"] = cs.time_fn(fn, iters=200)
del x, gout, held, y, dx, upstream, recv
for label, (rows, Kr, Nr) in (("dw", (cs.FUSED_W_UP[0], M, F)), ("row_parallel", (M,) + cs.FUSED_W_ROW)):
    Mb = rows // n
    x, w, part, prev = rnd(rows, Kr), rnd(Kr, Nr), torch.empty(Mb, Nr, device=dev), rnd(Mb, Nr)
    for kind in ("none", "int8"):
        qb = fused_gemm_qb(kind, Mb, Nr)
        up = block_wire(kind, prev, qb)
        own = None if kind == "none" else (torch.empty_like(up[0]), torch.empty_like(up[1]))
        fn = functools.partial(fg.rs_hop, x, w, Mb, up, part, own, qb=qb, form="wgmma")
        out[f"rs_hop {label} {kind}"] = cs.time_fn(fn, iters=200)
    del x, w, part, prev
print("RESULT " + json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the runs and means as JSON to this file")
    args = ap.parse_args(argv)
    order = [d for _ in range(args.rounds) for d in args.dirs + args.dirs[::-1]]
    runs = []
    for d in order:
        p = subprocess.run([sys.executable, "-c", RUN], cwd=Path(d), capture_output=True, text=True)
        line = next((ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")), None)
        if p.returncode or line is None:
            print(f"run in {d} failed (rc {p.returncode}):\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
            return 1
        runs.append({"dir": d, "ms": json.loads(line[len("RESULT "):])})
        print(json.dumps(runs[-1]), flush=True)
    means = {d: {k: sum(r["ms"][k] for r in runs if r["dir"] == d) /
                 sum(r["dir"] == d for r in runs) for k in runs[0]["ms"]} for d in args.dirs}
    print(json.dumps({"means": means}))
    if args.out:
        Path(args.out).write_text(json.dumps({"runs": runs, "means": means}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
