"""Rotary position embedding (counterpart of ``deepspeed_tpu/ops/rope.py``).

Half-split (Llama/NeoX) convention: the head dim splits into two halves
rotated against each other. Math in fp32, result cast back to ``x.dtype``,
exactly as the JAX package's ``_xla_rope``.
"""

from __future__ import annotations

import torch


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
         positions: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [maxS, D/2] fp32; positions: [B, S] int."""
    dtype = x.dtype
    d2 = x.shape[-1] // 2
    pos = positions.long()
    cos_p = cos[pos][:, :, None, :].float()  # [B, S, 1, D/2]
    sin_p = sin[pos][:, :, None, :].float()
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.to(dtype)
