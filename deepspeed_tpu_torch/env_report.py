"""Environment report of the PyTorch port (counterpart of
``deepspeed_tpu/env_report.py``, the ``ds_report`` CLI).

    python -m deepspeed_tpu_torch.env_report

Prints the versions (python, torch, CUDA, ``nvcc --version``, numpy), the
CUDA devices, each by name and power limit, the op matrix of the registry
(``ops.op_report``), and for each kernel source ``csrc/*.cu`` whether its
library is built (``ops/op_builder.py`` builds it at first use).
"""

from __future__ import annotations

import platform
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.registry import op_report


def _run(cmd: List[str]) -> str:
    """The command's standard output, or why there is none."""
    if shutil.which(cmd[0]) is None:
        return "not found"
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"failed ({type(e).__name__})"
    return proc.stdout.strip() if proc.returncode == 0 else f"failed (exit {proc.returncode})"


def _nvcc_version() -> str:
    try:
        nvcc = op_builder._nvcc()
    except RuntimeError:
        return "not found"
    lines = _run([nvcc, "--version"]).splitlines()
    return lines[-1] if lines else "not found"


def collect_versions() -> Dict[str, str]:
    return {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda or "none (a CPU build of torch)",
            "nvcc": _nvcc_version(), "numpy": np.__version__,
            "deepspeed_tpu_torch": deepspeed_tpu_torch.__version__}


def collect_devices() -> List[str]:
    """One line per CUDA device: its name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    if not torch.cuda.is_available():
        return ["no CUDA device (the kernels run only on one; CPU tensors take the plain versions)"]
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    rows = smi.splitlines() if smi and not smi.startswith(("not found", "failed")) else []
    out = []
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        limit = (rows[i].split(",")[-1].strip() if i < len(rows)
                 else f"power limit unread: nvidia-smi {smi}")
        out.append(f"cuda:{i} {name}, {limit}")
    return out


def kernel_builds() -> List[Tuple[str, bool, str]]:
    """(source, built, library path) for each ``csrc/*.cu``."""
    rows = []
    for src in sorted(op_builder.CSRC_DIR.glob("*.cu")):
        lib = op_builder.library_path(src.stem)
        rows.append((src.name, lib.exists(), str(lib.relative_to(op_builder.BUILD_DIR.parents[1]))))
    return rows


def report() -> str:
    lines = ["-" * 60, "deepspeed_tpu_torch environment report (ds_report)", "-" * 60, "versions:"]
    lines += [f"  {k:<20} {v}" for k, v in collect_versions().items()]
    lines.append("devices:")
    lines += [f"  {d}" for d in collect_devices()]
    lines.append("ops (impls registered; pallas = the kernel-backed wrapper, xla = plain):")
    lines += [f"  op:{name:<22} {','.join(impls)}" for name, impls in op_report().items()]
    lines.append("kernels (csrc, built at first use by ops/op_builder.py):")
    lines += [f"  {'[BUILT]' if built else '[-----]'} {src:<30} {lib}"
              for src, built, lib in kernel_builds()]
    return "\n".join(lines)


def main() -> int:
    print(report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
