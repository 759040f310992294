"""FP8 and int4 block quantisation (counterpart of ``deepspeed_tpu/ops/fp_quant.py``).

The JAX package writes these in jnp, not Pallas: XLA fuses the convert and
scale into the consuming matmul. Plain PyTorch is therefore their faithful
port on every device, not a plain version standing in for a kernel.

- fp8: e4m3 values (``torch.float8_e4m3fn``) with one fp32 scale per flat
  block, ``scale = absmax / 448`` (the shared ``ops.quant.fp8_block_math``);
  the values keep the input's shape.
- int4: symmetric [-7, 7], ``scale = absmax / 7``, rounded half to even; two
  values per uint8 in two's-complement nibbles, the low nibble the even flat
  index. The trailing dim must be even; the packed shape halves it.

Each of the four is an op of the registry with one "xla" impl
(``xla_quantize_fp8`` ...), as in JAX; the public functions pick it by
``impl``, and WOQ calls the impls directly.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.quant import (
    DEFAULT_BLOCK,
    _blocked,
    _padded,
    block_scale,
    fp8_block_math,
)
from deepspeed_tpu_torch.ops.registry import dispatch, register


def _unblock(out2: torch.Tensor, n: int, shape, dtype: torch.dtype) -> torch.Tensor:
    return out2.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


@register("quantize_fp8", "xla")
def xla_quantize_fp8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK):
    """-> (e4m3 values of ``x.shape``, fp32 scales [nb])."""
    x2, n, _ = _blocked(x, block_size)
    q, scale = fp8_block_math(x2)
    return q.reshape(-1)[:n].reshape(x.shape), scale.reshape(-1)


@register("dequantize_fp8", "xla")
def xla_dequantize_fp8(values: torch.Tensor, scales: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16,
                       block_size: int = DEFAULT_BLOCK) -> torch.Tensor:
    v2, n = _padded(values.reshape(-1).float(), scales, block_size)
    return _unblock(v2 * scales.reshape(-1, 1).float(), n, values.shape, dtype)


@register("quantize_int4", "xla")
def xla_quantize_int4(x: torch.Tensor, block_size: int = DEFAULT_BLOCK):
    """-> (packed uint8 ``[..., last / 2]``, fp32 scales [nb])."""
    if x.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even trailing dim, got {tuple(x.shape)}")
    x2, n, _ = _blocked(x, block_size)
    scale = block_scale(x2.abs().amax(dim=-1, keepdim=True), 7.0)
    q = torch.round(x2 / scale).clamp_(-7, 7).to(torch.int8).reshape(-1)[:n]
    u = (q.to(torch.int16) & 0xF).reshape(-1, 2)  # two's-complement nibbles
    packed = (u[:, 0] | (u[:, 1] << 4)).to(torch.uint8)
    return packed.reshape(*x.shape[:-1], x.shape[-1] // 2), scale.reshape(-1)


@register("dequantize_int4", "xla")
def xla_dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16,
                        block_size: int = DEFAULT_BLOCK) -> torch.Tensor:
    shape = (*packed.shape[:-1], packed.shape[-1] * 2)
    flat_p = packed.reshape(-1).to(torch.int16)
    nib = torch.stack([flat_p & 0xF, (flat_p >> 4) & 0xF], dim=1).reshape(-1)
    vals = torch.where(nib >= 8, nib - 16, nib).float()  # sign-extend
    v2, n = _padded(vals, scales, block_size)
    return _unblock(v2 * scales.reshape(-1, 1).float(), n, shape, dtype)


def quantize_fp8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK, impl: str = "auto"):
    return dispatch("quantize_fp8", impl)(x, block_size)


def dequantize_fp8(values: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16, block_size: int = DEFAULT_BLOCK,
                   impl: str = "auto") -> torch.Tensor:
    return dispatch("dequantize_fp8", impl)(values, scales, dtype, block_size)


def quantize_int4(x: torch.Tensor, block_size: int = DEFAULT_BLOCK, impl: str = "auto"):
    return dispatch("quantize_int4", impl)(x, block_size)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16, block_size: int = DEFAULT_BLOCK,
                    impl: str = "auto") -> torch.Tensor:
    return dispatch("dequantize_int4", impl)(packed, scales, dtype, block_size)
