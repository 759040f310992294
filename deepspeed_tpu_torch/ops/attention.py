"""Attention op (counterpart of ``deepspeed_tpu/ops/attention.py``).

``causal_attention`` is the one entry the model calls. The port carries the
flash path only: ``impl`` "auto" and "flash" both run
``ops/flash_attention.flash_causal_attention`` (its plain versions on the CPU,
its CUDA kernels on the card). The JAX package's scheduling knobs
(``block_q``/``block_k``/``k_splits``) are accepted and ignored, as its XLA
path does. ALiBi slopes (Bloom) pass through to the ALiBi form of the
flash kernels, as constants without a gradient (the JAX package's flash path
stops theirs too). A dense pair bias, which JAX runs on its XLA path, and
``impl="xla"`` are not ported and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.flash_attention import flash_causal_attention

PORTED_IMPLS = ("auto", "flash")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, impl: str = "auto",
                     alibi_slopes: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, **kernel_kwargs) -> torch.Tensor:
    """Grouped-query causal attention: q ``[B, S, H, hd]``, k/v
    ``[B, S, kvH, hd]``, optional key keep-mask ``[B, S]`` (1 = keep) and
    ALiBi slopes ``[H]``."""
    if impl not in PORTED_IMPLS:
        raise NotImplementedError(
            f"causal_attention impl={impl!r}: the port runs the flash path only {PORTED_IMPLS}")
    if bias is not None:
        raise NotImplementedError("causal_attention: an additive pair bias is not ported")
    return flash_causal_attention(q, k, v, mask=mask, alibi_slopes=alibi_slopes, **kernel_kwargs)
