"""Token sampling (counterpart of ``deepspeed_tpu/inference/sampling.py``):
greedy, temperature, top-k and top-p, with an explicit ``torch.Generator``
for the random draws. It runs on the logits' device inside the serving step
and the decode chain, so only token ids reach the host."""

from __future__ import annotations

from typing import Optional

import torch


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> argmax ids (int32); ties go to the first maximum,
    as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32)."""
    if not do_sample:
        return greedy_tokens(logits)
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (always keep 1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
