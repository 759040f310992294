"""Layer math of the serving forward (counterpart of the dense subset of
``deepspeed_tpu/inference/model.py``: ``_qkv``, ``_attn_out``, ``_mlp``,
``_logits``).

Functions over one layer's parameters (the JAX layout, see
``models/transformer.py``) and hidden states ``[N, C, E]``. The large
projections are plain ``torch.matmul``, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.transformer import TransformerConfig, _apply_norm


def _proj(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [..., In] @ kernel [In, *out] -> [..., *out]."""
    k = kernel.to(dtype)
    out = x.reshape(-1, k.shape[0]) @ k.reshape(k.shape[0], -1)
    return out.reshape(*x.shape[:-1], *k.shape[1:])


def _qkv(lp: Dict, cfg: TransformerConfig, x: torch.Tensor):
    """x [N, C, E] -> q [N, C, H, hd], k, v [N, C, kvH, hd]."""
    q = _proj(x, lp["wq"]["kernel"], cfg.dtype)
    k = _proj(x, lp["wk"]["kernel"], cfg.dtype)
    v = _proj(x, lp["wv"]["kernel"], cfg.dtype)
    return q, k, v


def _attn_out(lp: Dict, cfg: TransformerConfig, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [N, C, H, hd] -> [N, C, E]."""
    wo = lp["wo"]["kernel"].to(cfg.dtype)  # [H, hd, E]
    H, hd, E = wo.shape
    return (ctx.reshape(-1, H * hd) @ wo.reshape(H * hd, E)).reshape(*ctx.shape[:-2], E)


def _mlp(lp: Dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(_proj(x, lp["w_gate"]["kernel"], cfg.dtype)) * _proj(x, lp["w_up"]["kernel"], cfg.dtype)
    return _proj(h, lp["w_down"]["kernel"], cfg.dtype)


def _logits(params: Dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    x = _apply_norm(params["final_norm"], cfg, x)
    return _proj(x, params["lm_head"]["kernel"], cfg.dtype)
