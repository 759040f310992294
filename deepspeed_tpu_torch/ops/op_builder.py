"""Build and load the port's CUDA kernels (counterpart of
``deepspeed_tpu/ops/op_builder.py``).

At first use each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it
includes) is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, written under
``build/deepspeed_tpu_torch/`` beside the package, and loaded with
``ctypes``. The file name carries a hash of the source, the headers and the
flags, so an
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
_U32 = ctypes.c_uint32

# library name -> {C entry: argtypes}; every entry returns a cudaError_t (int)
KERNELS: Dict[str, Dict[str, list]] = {
    "rms_norm": {
        # x, scale, out, rows, dim, eps, x_dtype, scale_dtype, stream
        "ds_rms_norm": [_P, _P, _P, _I64, _I64, _F, _I, _I, _P],
    },
    "layer_norm": {
        # x, scale, bias, out, rows, dim, eps, x_dtype, param_dtype (scale and bias), stream
        "ds_layer_norm": [_P, _P, _P, _P, _I64, _I64, _F, _I, _I, _P],
    },
    "paged_attention": {
        # q, k_pool, v_pool, slopes (or NULL), block_tables, q_positions, new_lens,
        # out, N, C, H, kvH, hd, P, block_size, q_scale, dtype, form
        # (ops/paged_attention.py PAGED_FORMS), splits, span, ws, tickets, S_flat, stream
        "ds_paged_attention": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _I, _I, _P, _P, _I, _P],
        # q, k_pool, v_pool, k_scale, v_scale, slopes (or NULL), block_tables, q_positions,
        # new_lens, out, N, C, H, kvH, hd, P, block_size, q_scale, dtype,
        # kv (1 int8 | 2 e4m3), form, splits, span, ws, tickets, S_flat, stream
        "ds_paged_attention_quant": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _I, _I, _I, _P, _P, _I,
                                                             _P],
    },
    "quantizer": {
        # x, n, block, dtype, vals, scales, stream
        "ds_quantize_int8": [_P, _I64, _I, _I, _P, _P, _P],
        # x, n, block, dtype, vals, scales, key (fmix32 of the seed), stream
        "ds_quantize_int8_stochastic": [_P, _I64, _I, _I, _P, _P, _U32, _P],
        # vals, scales, n, block, out_dtype, out, stream
        "ds_dequantize_int8": [_P, _P, _I64, _I, _I, _P, _P],
    },
    "flash_attention_fwd": {
        # q, k, v, keep (or NULL), slopes (or NULL), out, lse, B, S, H, kvH, hd, dtype,
        # form (ops/flash_attention.py FWD_FORMS), stream
        "ds_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_attention_bwd": {
        # q, k, v, keep, slopes, dout, lse, delta, dq_acc (fp32 scratch), dq, dk, dv, B, S, H,
        # kvH, hd, scale, dk_scale, dtype, stream
        "ds_flash_bwd": [_P] * 12 + [_I] * 5 + [_F, _F, _I, _P],
    },
    "flash_attention_bwd_dq": {
        # q, k, v, keep, slopes, dout, lse, delta, dq, B, S, H, kvH, hd, scale, dtype, stream
        "ds_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_attention_bwd_dkv": {
        # q, k, v, keep, slopes, dout, lse, delta, dk, dv, B, S, H, kvH, hd, dk_scale,
        # dtype, stream
        "ds_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _F, _I, _P],
    },
    "sparse_attention_fwd": {
        # q, k, v, cols, ncols, out, lse, B, H, kvH, S, hd, block, A, causal, dtype, stream
        "ds_sparse_fwd": [_P] * 7 + [_I] * 9 + [_P],
    },
    "sparse_attention_bwd_dq": {
        # q, k, v, dout, lse, delta, cols, ncols, dq, B, H, kvH, S, hd, block, A, causal,
        # dtype, stream
        "ds_sparse_bwd_dq": [_P] * 9 + [_I] * 9 + [_P],
    },
    "grouped_gemm": {
        # lhs, rhs, group_sizes, out, m, K, N, E, dtype, form (ops/grouped_matmul.py FORMS), stream
        "ds_grouped_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "sparse_attention_bwd_dkv": {
        # q, k, v, dout, lse, delta, rows, nrows, dk, dv, B, H, kvH, S, hd, block, Ar,
        # causal, dtype, stream
        "ds_sparse_bwd_dkv": [_P] * 10 + [_I] * 9 + [_P],
    },
    "ring_hop": {
        # srcs[k], dsts[k], bytes[k] (host arrays), k, stream
        "ds_permute_leaves": [_P, _P, _P, _I, _P],
        # up_q, up_s, tgt, accumulate, enc_src, own_q, own_s, n, qb,
        # code (1 int8 | 2 e4m3), stream
        "ds_fused_hop": [_P, _P, _P, _I, _P, _P, _P, _I64, _I, _I, _P],
        # device, peer
        "ds_enable_peer_access": [_I, _I],
    },
    "fused_gemm": {
        # x, ldx, col, held, out, ldo, M, N, Ks, out_block, up_w, up_s, recv, own_q, own_s,
        # qb, code (0 fp32 | 1 int8 | 2 e4m3), form (collectives/fused_gemm.py FUSED_FORMS),
        # stream
        "ds_ag_hop": [_P, _I64, _I64, _P, _P, _I64, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                      _I64, _I, _I, _P],
        # x, row0, w, Mb, K, N, up_w, up_s, part, own_q, own_s, counters, qb, code, form,
        # stream
        "ds_rs_hop": [_P, _I64, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


def launch(name: str, entry: str, *args) -> None:
    """Call C entry ``entry`` of library ``name``; raise if it reports an error."""
    err = getattr(load(name), entry)(*args)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
