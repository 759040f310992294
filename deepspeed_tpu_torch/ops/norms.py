"""RMSNorm (counterpart of ``deepspeed_tpu/ops/norms.py`` and the Pallas
``ops/pallas/norms.py:_rms_fwd_kernel``).

``rms_norm`` is the one wrapper the model calls. On a CPU tensor it runs
``rms_norm_reference``, the plain PyTorch version; on a CUDA tensor it
launches the hand-written kernel ``csrc/rms_norm.cu`` or raises. Both follow
the JAX package's math: fp32 statistics, the scale multiplied in fp32, the
output in ``x.dtype``.
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dim of ``x`` (any leading shape)."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    dim = x.shape[-1]
    if scale.device != x.device or scale.shape != (dim,):
        raise ValueError(
            f"rms_norm: scale must be [{dim}] on {x.device}, got "
            f"{tuple(scale.shape)} on {scale.device}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in op_builder.DTYPE_CODES:
            raise TypeError(f"rms_norm: {name} dtype {t.dtype} unsupported (fp32 | bf16)")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm: {name} must be contiguous")
    rows = x.numel() // dim if dim else 0
    if rows >= 2 ** 31:
        raise ValueError(f"rms_norm: {rows} rows exceed the kernel's grid")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = op_builder.load("rms_norm")
    err = lib.ds_rms_norm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, dim, ctypes.c_float(eps),
        op_builder.DTYPE_CODES[x.dtype], op_builder.DTYPE_CODES[scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rms_norm kernel launch failed: cudaError {err}")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
