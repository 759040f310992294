"""Build and load the port's CUDA kernels (counterpart of
``deepspeed_tpu/ops/op_builder.py``).

At first use each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, written under
``build/deepspeed_tpu_torch/`` beside the package, and loaded with
``ctypes``. The file name carries a hash of the source and the flags, so an
edited kernel is rebuilt and an unchanged one is reused. ``build`` starts
one ``nvcc`` per source, all at once, and waits for them together. A failed
build raises with ``nvcc``'s own error output.

Every pointer and the stream cross into C as ``ctypes.c_void_p``; each C
entry returns ``cudaGetLastError()`` after its launch, and the wrappers
raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "deepspeed_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dtype codes shared with the C entries (csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# library name -> {C entry: argtypes}; every entry returns a cudaError_t (int)
KERNELS: Dict[str, Dict[str, list]] = {
    "rms_norm": {
        # x, scale, out, rows, dim, eps, x_dtype, scale_dtype, stream
        "ds_rms_norm": [_P, _P, _P, _I64, _I64, _F, _I, _I, _P],
    },
    "paged_attention": {
        # q, k_pool, v_pool, block_tables, q_positions, new_lens,
        # out, N, C, H, kvH, hd, P, block_size, q_scale, dtype, stream
        "ds_paged_attention": [_P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    },
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # name -> nvcc output of its last build


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> List[str]:
    """Compile every library of ``names`` not already built, one ``nvcc`` per
    source, all started together. Returns the names it compiled."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def build_all() -> List[str]:
    """Build every kernel library (in parallel); returns the names compiled."""
    return build(KERNELS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for entry, argtypes in KERNELS[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
