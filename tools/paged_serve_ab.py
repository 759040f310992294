#!/usr/bin/env python3
"""Prefill tokens/s of the serving engines from two or more checkouts in
turns, on one GPU, each run a process of its own.

    python3 tools/paged_serve_ab.py DIR_A DIR_B [DIR_C ...] [--rounds R] [--out FILE]

The checkouts run in a palindrome (A B B A; A B C C B A), R times over. Each
run imports ``chip_smoke`` from its checkout (which builds that checkout's
kernels at first use) and serves, one model after the other on the same
card, Llama-3-8B, Bloom-7B1 (the ALiBi form) and 16 of Mixtral-8x7B's 32
layers at full width, with ``chip_smoke.py``'s random bf16 weights,
prompts and engine settings (a bf16 pool): ``InferenceEngineV2.put`` of all
the prompts (the prefill steps and their first tokens, ending in a
synchronise) timed on the host clock 4 times, the first a warm-up, each
followed by a flush of the rows. One prefill more runs under the profiler,
and the paged kernel's device ms in it (every form's kernels by name) is
recorded. Prints one JSON line a run and the means of each checkout's runs;
exits non-zero if a run fails. Host time moves between calls, so two trees
are compared only inside one call, in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import dataclasses, gc, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from deepspeed_tpu_torch.inference import InferenceEngineV2
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
KERNELS = ("paged_split_kernel", "paged_wgmma_kernel", "paged_attention_kernel")
out = {}

def prefill(tag, cfg, params, prompts):
    engine = InferenceEngineV2(cfg, params, cs.SERVE_CONFIG, device=dev)
    uids = list(range(len(prompts)))
    tokens = sum(len(p) for p in prompts)
    rates = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.put(uids, prompts)
        torch.cuda.synchronize()
        rates.append(tokens / (time.perf_counter() - t0))
        for u in uids:
            engine.flush(u)
    wall, busy, _, rows = cs.device_profile(lambda: engine.put(uids, prompts))
    paged = sum(ms for ms, _, name in rows if any(k + "<" in name or k + "(" in name for k in KERNELS))
    out[tag] = {"prefill_tok_s": rates[1:], "tokens": tokens, "profiled_wall_ms": wall,
                "device_busy_ms": busy, "paged_ms": paged}
    del engine
    gc.collect()
    torch.cuda.empty_cache()

cfg = dataclasses.replace(cs.PRESETS["llama3-8b"], dtype=torch.bfloat16)
params = cs.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
prefill("llama3-8b", cfg, params, cs.serve_prompts(cfg)[1])
del params
gc.collect()
torch.cuda.empty_cache()
cfg = cs.TransformerConfig(**cs.BLOOM_7B1, dtype=torch.bfloat16)
params = cs.bloom_params(cfg, dev)
prefill("bloom-7b1", cfg, params, cs.serve_prompts(cfg)[1])
del params
gc.collect()
torch.cuda.empty_cache()
cfg = dataclasses.replace(cs.TransformerConfig(**cs.MIXTRAL_8X7B, dtype=torch.bfloat16),
                          num_layers=cs.MIXTRAL_LAYERS)
params = cs.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
prefill("mixtral-8x7b 16 layers", cfg, params, cs.mixtral_prompts(cfg)[1])
print("AB " + json.dumps(out), flush=True)
"""


def run(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=checkout, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"paged_serve_ab: the run in {checkout} failed (exit {proc.returncode})")
    return json.loads(lines[-1][3:])


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
        runs.append({"checkout": str(checkout), "results": run(checkout.resolve())})
        print(json.dumps(runs[-1]), flush=True)
    means = {}
    for c in args.checkouts:
        mine = [r["results"] for r in runs if r["checkout"] == str(c)]
        means[str(c)] = {tag: {"prefill_tok_s": sum(sum(m[tag]["prefill_tok_s"]) for m in mine)
                               / sum(len(m[tag]["prefill_tok_s"]) for m in mine),
                               "paged_ms": sum(m[tag]["paged_ms"] for m in mine) / len(mine),
                               "device_busy_ms": sum(m[tag]["device_busy_ms"] for m in mine) / len(mine)}
                         for tag in mine[0]}
    print(json.dumps({"means": means}), flush=True)
    if args.out:
        args.out.write_text(json.dumps({"runs": runs, "means": means}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
