#!/usr/bin/env python3
"""Mixtral-8x7B serving (``chip_smoke.py``'s phase 3d) from two or more
checkouts in turns, on one GPU, each run a process of its own.

    python3 tools/mixtral_serve_ab.py DIR_A DIR_B [DIR_C ...] [--rounds R] [--out FILE]

The checkouts run in a palindrome (A B B A; A B C C B A), R times over. Each
run imports ``chip_smoke`` from its checkout (which builds that checkout's
kernels at first use), first times the grouped GEMM wrapper's host cost at
Mixtral's decode shape (32 routed rows x [8, 4096, 14336] bf16: microseconds
of host time a call, the median of 5 loops of 100 calls issued without a
sync, once through ``grouped_matmul`` and once through every bf16 form the
checkout has), then calls ``phase_mixtral_serve``: 16 of Mixtral-8x7B's 32
layers at full width, random bf16 weights, 16 prompts, a bf16 and an int8
pool. Host-bound numbers such as decode tokens/s move by tens of percent
between machines and calls, so versions are compared only inside one call,
in turns. Prints one JSON line a run and the means of each checkout's runs;
exits non-zero if a run fails. This is the one way to compare two trees'
host-bound serving numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import importlib, json, statistics, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gm = importlib.import_module("deepspeed_tpu_torch.ops.grouped_matmul")
gen = torch.Generator(device=dev).manual_seed(0)
lhs = torch.randn(32, 4096, generator=gen, device=dev).to(torch.bfloat16)
rhs = (torch.randn(8, 4096, 14336, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
sizes = torch.full((8,), 4, dtype=torch.int32, device=dev)
calls = {"wrapper": lambda: gm.grouped_matmul(lhs, rhs, sizes)}
for form in getattr(gm, "FORMS", {}):
    if form != "simt":
        calls[form] = lambda form=form: gm._grouped_matmul_form(lhs, rhs, sizes, form)
host_us = {}
for name, fn in calls.items():
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        loops.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    host_us[name] = statistics.median(loops)
del lhs, rhs, sizes, calls
torch.cuda.empty_cache()
res = {}
if cs.phase_mixtral_serve(dev, res) is None:
    sys.exit(1)
keep = ("prefill_tok_s", "decode_tok_s", "grouped_matmul_share_of_device_time")
out = {tag: dict({k: r[k] for k in keep}, chain_wall_ms=r["profile_decode_chain"]["wall_ms"],
                 chain_device_ms=r["profile_decode_chain"]["device_busy_ms"])
       for tag, r in res.items()}
forms = {tag: r.get("grouped_matmul_launches_by_form") for tag, r in res.items()}
print("AB " + json.dumps({"serve": out, "host_us": host_us, "launches_by_form": forms}), flush=True)
"""


def run(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=checkout, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"mixtral_serve_ab: the run in {checkout} failed (exit {proc.returncode})")
    return json.loads(lines[-1][3:])


def mean_of(results: list) -> dict:
    """Key by key mean of nested dicts of numbers."""
    first = results[0]
    if isinstance(first, dict):
        return {k: mean_of([r[k] for r in results]) for k in first}
    return sum(results) / len(results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", type=Path, nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if len(args.checkouts) < 2:
        ap.error("two or more checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    order = (args.checkouts + args.checkouts[::-1]) * args.rounds
    runs = []
    for checkout in order:
        got = run(checkout.resolve())
        runs.append({"checkout": str(checkout), "results": got})
        print(json.dumps(runs[-1]), flush=True)
    means = {str(c): mean_of([{"serve": r["results"]["serve"],
                               "host_us": r["results"]["host_us"]}
                              for r in runs if r["checkout"] == str(c)])
             for c in args.checkouts}
    print(json.dumps({"means": means}), flush=True)
    if args.out:
        args.out.write_text(json.dumps({"runs": runs, "means": means}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
