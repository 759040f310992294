"""RMSNorm (counterpart of ``deepspeed_tpu/ops/norms.py`` and the Pallas
``ops/pallas/norms.py:_rms_fwd_kernel`` with its custom VJP).

``rms_norm`` is the one differentiable op the model calls. Its forward is the
kernel wrapper ``rms_norm_fwd``: on a CPU tensor it runs
``rms_norm_reference``, the plain PyTorch version; on a CUDA tensor it
launches the hand-written kernel ``csrc/rms_norm.cu`` or raises. Both follow
the JAX package's math: fp32 statistics, the scale multiplied in fp32, the
output in ``x.dtype``.

The backward ports ``_rms_p_bwd`` (``ops/pallas/norms.py:76``) in plain
PyTorch, in fp32. In the JAX package that backward is jnp, not a Pallas
kernel, so plain PyTorch is its faithful port on every device, not a plain
version standing in for a kernel.
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


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm forward over the last dim of ``x`` (any leading shape)."""
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


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float):
    """``_rms_p_bwd`` in fp32: dx = inv * (gy - x_hat * mean(gy * x_hat)) with
    gy = g * scale, dscale = sum over rows of g * x_hat; cast to the input
    dtypes."""
    xf, gf, s = x.float(), g.float(), scale.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gy = gf * s
    dx = inv * (gy - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dim of ``x`` (any leading shape),
    differentiable in ``x`` and ``scale``."""
    return _RMSNorm.apply(x, scale, eps)


rms_norm.launches = 0
