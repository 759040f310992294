"""Time the PyTorch port's GPT-2-125M headline training step in a fresh process.

The step is ``chip_smoke.py``'s phase 6 (``phase_train``: ``initialize`` +
``train_batch``, micro 4, gas 8, seq 1024, bf16, 2 warm-up steps, the median
of 3), without the phases that run before it there. The last line of the
output is one JSON object: the card, the step times and their median.

Run it on a machine with a CUDA card from the root of a checkout; the
checkout it runs from supplies ``chip_smoke.py`` and the package, so one copy
of this script times any commit that has both::

    python3 tools/torch_train_step.py
    cd ../parent && python3 ../repo/tools/torch_train_step.py

The step is host-bound, and its time moves more between processes than
within one: compare two commits over many processes, alternating which runs
first.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = cs.TransformerConfig(**cs.GPT2_HEADLINE_DIMS, scan_layers=False, fused_ce=False,
                               dtype=torch.bfloat16)
    results = {}
    if cs.phase_train(torch.device("cuda"), "train gpt2-125m", cfg, micro=4, seq=1024, gas=8,
                      expect_per_micro={k: cfg.num_layers for k in cs.FLASH_KERNELS},
                      results=results) is None:
        return 1
    r = results["train gpt2-125m"]
    print(json.dumps({"card": card, "checkout": os.getcwd(), "step_s": r["step_s"],
                      "median_step_s": r["median_step_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
