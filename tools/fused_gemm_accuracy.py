"""The fused GEMM hop's products against an fp64 product as the contraction grows.

Row 14's ``out_block`` hop (``collectives.fused_gemm.ag_hop``: ``out[:, col :
col + Ks] = g @ held^T``, the contraction over g's N columns) runs through
each form by name, form T (``"wgmma"``, three TF32 passes on the tensor
cores) and form S (``"simt"``, fp32 FMAs), beside the plain version (one
fp32 ``torch.matmul``, TF32 off), at K = 512 to 32768 on normal payloads
(two sigma) from a seed. For each it prints the largest error against the
same product taken in fp64, and its distance from the plain version as a
share of ``utils.checks.fused_gemm_close``'s absolute bound (1e-6 x sqrt(K)
x max|plain|), the check the card tests and ``chip_smoke.py`` apply. An
error that grows like sqrt(K) keeps that share flat; one that grows like K
(an accumulation that truncates) crosses it at some K.

Run it on a machine with a CUDA card from the root of a checkout::

    python3 tools/fused_gemm_accuracy.py [--rows 512] [--ks 512,2048,8192,32768]

The last line of the output is one JSON object: the card, and for each K and
form the error against fp64, the share of the bound and whether the check
passed.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from deepspeed_tpu_torch.collectives import fused_gemm as fg  # noqa: E402
from deepspeed_tpu_torch.utils.checks import fused_gemm_close  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=512, help="rows of g (M) and of held (Ks)")
    ap.add_argument("--ks", default="512,2048,8192,32768", help="contraction lengths")
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_gemm_accuracy: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = args.rows
    result = {"card": card(), "rows": rows, "by_k": {}}
    print(result["card"], flush=True)
    for K in (int(k) for k in args.ks.split(",")):
        g = torch.randn(rows, K, generator=gen, device=dev) * 2
        held = torch.randn(rows, K, generator=gen, device=dev) * 2
        exact = g.double() @ held.double().t()
        plain = g @ held.t()
        atol = 1e-6 * max(float(plain.abs().max()), 1.0) * K ** 0.5
        row = {"max_abs_want": float(exact.abs().max()),
               "plain": {"err_vs_fp64": float((plain.double() - exact).abs().max())}}
        for form in fg.FUSED_FORMS:
            out = torch.empty(rows, rows, device=dev)
            fg.ag_hop(g, held, out, 0, (held,), torch.empty_like(held), None, qb=rows * K,
                      out_block=True, form=form)
            torch.cuda.synchronize()
            err, ok = fused_gemm_close(out, plain, K)
            row[form] = {"err_vs_fp64": float((out.double() - exact).abs().max()),
                         "share_of_bound": err / atol, "close": ok}
        result["by_k"][K] = row
        print(f"K {K}: max|want| {row['max_abs_want']:.1f}; error against fp64: plain "
              f"{row['plain']['err_vs_fp64']:.3e}, "
              + ", ".join(f"{f} {row[f]['err_vs_fp64']:.3e} ({row[f]['share_of_bound']:.3f} of "
                          f"the bound against plain, close {row[f]['close']})"
                          for f in fg.FUSED_FORMS), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
