"""Mixed-precision helpers (counterpart of ``deepspeed_tpu/runtime/precision.py``).

Master weights stay fp32; compute weights are cast from them each step.
The port trains in bf16 or fp32 only, so the loss scale is the constant 1.0
(fp16 and its dynamic loss scaling are refused by the config).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

LOSS_SCALE = 1.0


def cast_floating(tree: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast the floating leaves of a flat ``{path: tensor}`` dict to ``dtype``
    (integer and bool leaves untouched; a leaf already of ``dtype`` is returned
    as it is)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, on the device."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every leaf in place by ``min(1, max_norm / (norm + 1e-6))`` in
    fp32, as the JAX package's ``clip_by_global_norm``; returns (grads, norm)
    with the norm before clipping. Nothing leaves the device."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm
