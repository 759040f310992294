"""Rotary position embedding (counterpart of ``deepspeed_tpu/ops/rope.py``).

Two conventions, each an op of the registry with one "xla" impl (the JAX
package has no kernel for either):

- "rope": half-split (Llama/NeoX), the head dim split into two halves
  rotated against each other;
- "rope_interleaved": GPT-J/CodeGen, adjacent pairs (x[2i], x[2i+1])
  rotated together.

Math in fp32, the result cast back to ``x.dtype``, exactly as the JAX
package's ``_xla_rope`` and ``_xla_rope_interleaved``.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.registry import dispatch, register


def _tables(cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor):
    pos = positions.long()
    return cos[pos][:, :, None, :].float(), sin[pos][:, :, None, :].float()  # [B, S, 1, D/2]


@register("rope", "xla")
def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [maxS, D/2] fp32; positions: [B, S] int."""
    d2 = x.shape[-1] // 2
    cos_p, sin_p = _tables(cos, sin, positions)
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.to(x.dtype)


@register("rope_interleaved", "xla")
def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """GPT-J's rotate_every_two: the same shapes as :func:`rope_half`."""
    cos_p, sin_p = _tables(cos, sin, positions)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
         impl: str = "auto", interleaved: bool = False) -> torch.Tensor:
    """The registry's ``rope`` (or ``rope_interleaved``); the model calls
    ``rope_half`` directly."""
    return dispatch("rope_interleaved" if interleaved else "rope", impl)(x, cos, sin, positions)
