"""Fused LM-head + cross-entropy over a chunked vocabulary (counterpart of
``deepspeed_tpu/ops/cross_entropy.py``).

The ``[tokens, vocab]`` logits never exist whole: the forward walks vocab
chunks keeping a running max and sum-exp (an exact logsumexp) and adds the
gold term from the gathered embedding rows; the backward recomputes each
chunk's probabilities to accumulate dx and dE, as ``_fce_vjp_bwd`` does. The
chunk products are ``torch.mm`` with fp32 results, as the JAX package's are
jnp ``dot_general(preferred_element_type=f32)`` under ``lax.scan`` (no
Pallas kernel): on the card a bf16 product keeps bf16 operands and returns
fp32 (``out_dtype``), on the CPU it is taken in fp32 from the same values.
"""

from __future__ import annotations

from typing import Optional

import torch


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result and fp32 accumulation, operands as given."""
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunks(V: int, n_chunks: int):
    """Vocab ranges of the JAX chunking: C = ceil(V / n), the last one short."""
    C = _cdiv(V, n_chunks)
    return [(c0, min(c0 + C, V)) for c0 in range(0, V, C)]


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """sum_i weight_i * (logsumexp(x_i E^T) - x_i . E[label_i])."""

    @staticmethod
    def forward(ctx, x, embed, labels, weight, n_chunks):
        N = x.shape[0]
        m = torch.full((N,), float("-inf"), dtype=torch.float32, device=x.device)
        s = torch.zeros((N,), dtype=torch.float32, device=x.device)
        for c0, c1 in _chunks(embed.shape[0], n_chunks):
            lg = mm_f32(x, embed[c0:c1].t())  # [N, C]
            m_new = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[:, None]).sum(dim=-1)
            m = m_new
        logz = m + torch.log(s)
        gold = (x.float() * embed[labels].float()).sum(dim=-1)
        ctx.save_for_backward(x, embed, labels, weight, logz)
        ctx.n_chunks = n_chunks
        return ((logz - gold) * weight).sum()

    @staticmethod
    def backward(ctx, g):
        x, embed, labels, weight, logz = ctx.saved_tensors
        w = weight * g.float()  # dL/dlogz per token
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        de = torch.empty(embed.shape, dtype=torch.float32, device=x.device)
        for c0, c1 in _chunks(embed.shape[0], ctx.n_chunks):
            e_c = embed[c0:c1]
            lg = mm_f32(x, e_c.t())
            pc = (torch.exp(lg - logz[:, None]) * w[:, None]).to(x.dtype)
            dx += mm_f32(pc, e_c)
            de[c0:c1] = mm_f32(pc.t(), x)
        gold_rows = embed[labels].float()
        dx -= w[:, None] * gold_rows
        de.index_add_(0, labels, -w[:, None] * x.float())
        return dx.to(x.dtype), de.to(embed.dtype), None, None, None


def lm_head_cross_entropy(x: torch.Tensor, embed: torch.Tensor, labels: torch.Tensor,
                          pad_mask: Optional[torch.Tensor] = None, ignore_index: int = -100,
                          chunk_size: int = 8192) -> torch.Tensor:
    """Mean token cross entropy of ``x @ embed.T`` against ``labels``, fused
    and chunked: x ``[B, S, D]``, embed ``[V, D]`` (tied embedding or
    ``lm_head.T``), labels ``[B, S]`` with ``ignore_index`` marking ignored
    positions, optional pad_mask ``[B, S]`` (1 = keep). fp32 math, mean over
    the counted tokens, as ``models.transformer.cross_entropy_loss``."""
    B, S, D = x.shape
    V = embed.shape[0]
    valid = labels != ignore_index
    if pad_mask is not None:
        valid = valid & (pad_mask > 0)
    flat_valid = valid.reshape(-1)
    n_valid = flat_valid.float().sum().clamp_min(1.0)
    weight = flat_valid.float() / n_valid
    safe_labels = torch.where(flat_valid, labels.reshape(-1), torch.zeros_like(labels.reshape(-1)))
    n_chunks = max(1, _cdiv(V, chunk_size))
    return _FusedLinearCrossEntropy.apply(x.reshape(-1, D), embed, safe_labels.long(), weight,
                                          n_chunks)
