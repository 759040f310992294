"""RMSNorm and LayerNorm (counterpart of ``deepspeed_tpu/ops/norms.py`` and the
Pallas ``ops/pallas/norms.py``: ``_rms_fwd_kernel`` and ``_ln_fwd_kernel``
with their custom VJPs).

``pallas_rms_norm`` and ``pallas_layer_norm`` are the differentiable
kernel-backed ops, registered under "pallas"; ``rms_norm_reference`` and
``layer_norm_reference`` are the plain versions, registered under "xla", as
in the JAX registry. ``rms_norm`` and ``layer_norm`` are the public ops,
which pick one by ``impl``; the model calls ``pallas_rms_norm`` directly.
The forwards of the "pallas" ops are the kernel wrappers ``rms_norm_fwd`` and
``layer_norm_fwd``: on a CPU tensor each runs its plain PyTorch version
(``rms_norm_reference``, ``layer_norm_reference``); on a CUDA tensor it
launches its hand-written kernel (``csrc/rms_norm.cu``,
``csrc/layer_norm.cu``) or raises. Both follow the JAX package's math: fp32
statistics (LayerNorm's variance in two passes, the mean of (x - mean)^2),
scale and bias applied in fp32, the output in ``x.dtype``. Each kernel
launch counts in ``rms_norm.launches`` or ``layer_norm.launches``.

The backwards port ``_rms_p_bwd`` (``ops/pallas/norms.py:76``) and
``_ln_p_bwd`` (``:127``) in plain PyTorch, in fp32. In the JAX package those
backwards are jnp, not Pallas kernels, so plain PyTorch is their faithful
port on every device, not a plain version standing in for a kernel.
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.registry import dispatch, register


@register("rms_norm", "xla")
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


@register("rms_norm", "pallas")
def pallas_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dim of ``x`` (any leading shape),
    differentiable in ``x`` and ``scale``."""
    return _RMSNorm.apply(x, scale, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             impl: str = "auto") -> torch.Tensor:
    """The registry's ``rms_norm``: "pallas" (``auto``) or "xla"."""
    return dispatch("rms_norm", impl)(x, scale, eps)


rms_norm.launches = 0


# ------------------------------------------------------------------ LayerNorm
@register("layer_norm", "xla")
def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """``_xla_layer_norm``: mean, then the variance of (x - mean), in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm forward over the last dim of ``x`` (any leading shape).
    ``x`` fp32 or bf16; ``scale`` and ``bias`` ``[D]``, each fp32 or bf16: a
    mixed pair is widened (exactly) to fp32 before the launch."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    dim = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.shape != (dim,):
            raise ValueError(f"layer_norm: {name} must be [{dim}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.dtype not in op_builder.DTYPE_CODES:
            raise TypeError(f"layer_norm: {name} dtype {t.dtype} unsupported (fp32 | bf16)")
        if not t.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be contiguous")
    if scale.dtype != bias.dtype:
        scale, bias = scale.float(), bias.float()
    rows = x.numel() // dim if dim else 0
    if rows >= 2 ** 31:
        raise ValueError(f"layer_norm: {rows} rows exceed the kernel's grid")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    op_builder.launch(
        "layer_norm", "ds_layer_norm", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), rows, dim, ctypes.c_float(eps), op_builder.DTYPE_CODES[x.dtype],
        op_builder.DTYPE_CODES[scale.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    layer_norm.launches += 1
    return out


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float):
    """``_ln_p_bwd`` in fp32: with x_hat = (x - mean) * inv and gy = g * scale,
    dx = inv * (gy - mean(gy) - x_hat * mean(gy * x_hat)), dscale = the row
    sum of g * x_hat, dbias = the row sum of g. As in JAX, only (x, scale)
    are saved and dscale and dbias are both cast to ``scale.dtype``
    (autograd then casts dbias to the bias's dtype)."""
    xf, gf, s = x.float(), g.float(), scale.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    gy = gf * s
    dx = inv * (gy - gy.mean(dim=-1, keepdim=True)
                - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
    dim = x.shape[-1]
    dscale = (gf * xhat).reshape(-1, dim).sum(dim=0)
    dbias = gf.reshape(-1, dim).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


@register("layer_norm", "pallas")
def pallas_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm over the last dim of ``x`` (any leading shape),
    differentiable in ``x``, ``scale`` and ``bias``."""
    return _LayerNorm.apply(x, scale, bias, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
               impl: str = "auto") -> torch.Tensor:
    """The registry's ``layer_norm``: "pallas" (``auto``) or "xla"."""
    return dispatch("layer_norm", impl)(x, scale, bias, eps)


layer_norm.launches = 0
