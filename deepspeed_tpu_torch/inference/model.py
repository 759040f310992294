"""Layer math of the serving forward (counterpart of the dense subset of
``deepspeed_tpu/inference/model.py``: ``_qkv``, ``_attn_out``, ``_mlp``,
``_logits``).

Functions over one layer's parameters (the JAX layout, see
``models/transformer.py``) and hidden states ``[N, C, E]``. The large
projections are plain ``torch.matmul``, as the JAX package leaves them to
XLA. Every weight and bias is read through ``.to(cfg.dtype)``, as JAX reads
them through ``.astype``, so a leaf that weight-only quantisation turned into
a ``WOQTensor`` (Bloom's ``[L, H, hd]`` qkv biases among them) is
dequantised where it is read.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.transformer import (
    TransformerConfig,
    _activation,
    _apply_norm,
    _proj,
)


def _bias(p: Dict, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return y + p["bias"].to(dtype) if "bias" in p else y


def _qkv(lp: Dict, cfg: TransformerConfig, x: torch.Tensor):
    """x [N, C, E] -> q [N, C, H, hd], k, v [N, C, kvH, hd] (+ their biases)."""
    return tuple(_bias(lp[name], _proj(x, lp[name]["kernel"], cfg.dtype), cfg.dtype)
                 for name in ("wq", "wk", "wv"))


def _attn_out(lp: Dict, cfg: TransformerConfig, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [N, C, H, hd] -> [N, C, E] (+ the wo bias)."""
    wo = lp["wo"]["kernel"].to(cfg.dtype)  # [H, hd, E]
    H, hd, E = wo.shape
    out = (ctx.reshape(-1, H * hd) @ wo.reshape(H * hd, E)).reshape(*ctx.shape[:-2], E)
    return _bias(lp["wo"], out, cfg.dtype)


def _mlp(lp: Dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    def dense(p, y):
        return _bias(p, _proj(y, p["kernel"], cfg.dtype), cfg.dtype)

    if cfg.activation == "silu_glu":
        h = F.silu(dense(lp["w_gate"], x)) * dense(lp["w_up"], x)
    else:
        h = _activation(cfg.activation, dense(lp["w_up"], x))
    return dense(lp["w_down"], h)


def _logits(params: Dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    x = _apply_norm(params["final_norm"], cfg, x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["embedding"].to(cfg.dtype).t()
    return _proj(x, params["lm_head"]["kernel"], cfg.dtype)
