"""Time one of the PyTorch port's training steps in a fresh process.

The step is one of ``chip_smoke.py``'s training phases (``phase_train``:
``initialize`` + ``train_batch``, bf16, 2 warm-up steps, the median of 3),
without the phases that run before it there: ``--preset gpt2-125m`` (the
default; phase 6, micro 4, gas 8, seq 1024), ``llama3-1b`` (phase 4, micro 4,
gas 2, seq 2048) or ``bloom-560m`` (phase 4a, micro 4, gas 2, seq 2048,
through the ALiBi flash kernels). The last line of the output is one JSON
object: the card, the preset, the step times and their median.

Run it on a machine with a CUDA card from the root of a checkout; the
checkout it runs from supplies ``chip_smoke.py`` and the package, so one copy
of this script times any commit that has both::

    python3 tools/torch_train_step.py [--preset bloom-560m]
    cd ../parent && python3 ../repo/tools/torch_train_step.py [--preset bloom-560m]

GPT-2-125M's step is host-bound, and its time moves more between processes
than within one: compare two commits over many processes, alternating which
runs first.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def preset(name):
    """(config, micro, seq, gas, launches expected per micro-step, init) of
    ``name`` as ``chip_smoke.py``'s ``main`` trains it."""
    if name == "gpt2-125m":
        cfg = cs.TransformerConfig(**cs.GPT2_HEADLINE_DIMS, scan_layers=False, fused_ce=False,
                                   dtype=torch.bfloat16)
        return cfg, 4, 1024, 8, {k: cfg.num_layers for k in cs.FLASH_KERNELS}, cs.init_params
    if name == "llama3-1b":
        cfg = dataclasses.replace(cs.PRESETS["llama3-1b"], dtype=torch.bfloat16)
        expect = dict({k: cfg.num_layers for k in cs.FLASH_KERNELS}, rms_norm=2 * cfg.num_layers + 1)
        return cfg, 4, 2048, 2, expect, cs.init_params
    cfg = cs.TransformerConfig(**cs.BLOOM_560M, dtype=torch.bfloat16)
    return (cfg, 4, 2048, 2, {k: cfg.num_layers for k in cs.FLASH_ALIBI_KERNELS},
            cs.bloom_params)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="gpt2-125m",
                        choices=("gpt2-125m", "llama3-1b", "bloom-560m"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg, micro, seq, gas, expect, init = preset(args.preset)
    tag = f"train {args.preset}"
    results = {}
    if cs.phase_train(torch.device("cuda"), tag, cfg, micro=micro, seq=seq, gas=gas,
                      expect_per_micro=expect, results=results, init=init) is None:
        return 1
    r = results[tag]
    print(json.dumps({"card": card, "checkout": os.getcwd(), "preset": args.preset,
                      "step_s": r["step_s"], "median_step_s": r["median_step_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
