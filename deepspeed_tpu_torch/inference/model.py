"""Layer math of the serving forward (counterpart of the single-device
subset of ``deepspeed_tpu/inference/model.py``: ``_qkv``, ``_attn_out``,
``_mlp``, ``_moe``, ``_moe_ragged``, ``_logits``).

Functions over one layer's parameters (the JAX layout, see
``models/transformer.py``) and hidden states ``[N, C, E]``. The large
projections are plain ``torch.matmul``, as the JAX package leaves them to
XLA. Every weight and bias is read through ``.to(cfg.dtype)``, as JAX reads
them through ``.astype``, so a leaf that weight-only quantisation turned into
a ``WOQTensor`` (Bloom's ``[L, H, hd]`` qkv biases among them) is
dequantised where it is read.

``_moe`` is the MoE FFN at serving time: exact top-k routing in fp32 with no
capacity drops, in one of JAX's two regimes chosen by the token count T of
the forward, pad tokens included: below 2E tokens every expert runs on
every token and the gates combine them (plain matmuls, as JAX leaves that
path to XLA); from 2E tokens on, the routed (token, expert) pairs are sorted
by expert and go through the hand-written grouped GEMM
(``ops.grouped_matmul``, the counterpart of ``_grouped_matmul`` and of
megablox ``gmm`` behind ``_gmm_padded``). ``_moe.dense_calls`` and
``_moe.ragged_calls`` count the calls in each regime.
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
from deepspeed_tpu_torch.ops.grouped_matmul import grouped_matmul


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


def _route(lp: Dict, cfg: TransformerConfig, tokens: torch.Tensor):
    """Top-k routing of tokens ``[T, M]`` in fp32, as JAX's (in bf16 a near
    tie can pick another expert): ``(probs [T, E], top_p [T, k]
    renormalised, top_i [T, k])``."""
    logits = tokens.float() @ lp["gate"]["wg"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort takes the lower index first among equal
    # probabilities, as lax.top_k does (torch.topk leaves ties unordered)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.moe_top_k], top_i[:, :cfg.moe_top_k]
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_i


def _moe(lp: Dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """MoE FFN of one layer (``lp`` its ``moe`` subtree), x ``[N, C, E]`` ->
    ``[N, C, E]``."""
    B, S, M = x.shape
    tokens = x.reshape(B * S, M)
    T, E = tokens.shape[0], cfg.num_experts
    probs, top_p, top_i = _route(lp, cfg, tokens)
    ep = lp["experts"]
    if T >= 2 * E:
        _moe.ragged_calls += 1
        return _moe_ragged(cfg, ep, tokens, top_p, top_i).reshape(B, S, M)
    _moe.dense_calls += 1
    gate = torch.zeros_like(probs).scatter_(1, top_i, top_p)
    # [E, T, F]: tokens broadcast over the expert stack (the weights are read
    # as they lie, never copied)
    h1 = torch.matmul(tokens, ep["w_up"].to(cfg.dtype))
    if cfg.activation == "silu_glu":
        h1 = F.silu(torch.matmul(tokens, ep["w_gate"].to(cfg.dtype))) * h1
    else:
        h1 = _activation(cfg.activation, h1)
    out_e = torch.matmul(h1, ep["w_down"].to(cfg.dtype))  # [E, T, M]
    out = torch.einsum("te,etm->tm", gate.to(cfg.dtype), out_e)
    return out.reshape(B, S, M)


_moe.dense_calls = 0
_moe.ragged_calls = 0


def _moe_ragged(cfg: TransformerConfig, ep: Dict, tokens: torch.Tensor, top_p: torch.Tensor,
                top_i: torch.Tensor) -> torch.Tensor:
    """The T*k (token, expert) pairs sorted by expert (stably, so a token's
    pairs keep their order within a group), one grouped GEMM per projection,
    the outputs weighted by their gates and scatter-added back to their
    tokens. The group sizes stay on the device."""
    T, M = tokens.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    e_flat = top_i.reshape(-1)  # [T*k]
    order = torch.argsort(e_flat, stable=True)
    tok_idx = order // k  # source token of each sorted pair
    gates = top_p.reshape(-1)[order].to(cfg.dtype)
    # JAX's bincount, as a scatter-add: torch.bincount reads the largest
    # index back to the host on the card, a sync per layer
    group_sizes = torch.zeros(E, dtype=torch.int32, device=tokens.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat, dtype=torch.int32))

    xg = tokens[tok_idx]  # [T*k, M]
    up = grouped_matmul(xg, ep["w_up"].to(cfg.dtype), group_sizes)
    if cfg.activation == "silu_glu":
        h = F.silu(grouped_matmul(xg, ep["w_gate"].to(cfg.dtype), group_sizes)) * up
    else:
        h = _activation(cfg.activation, up)
    out_g = grouped_matmul(h, ep["w_down"].to(cfg.dtype), group_sizes)
    # each token receives k adds in an order that varies run to run on the
    # card; with k = 2 into a zero row, (0 + a) + b == (0 + b) + a exactly in
    # any dtype, so the result is fixed. With k > 2 a bf16 sum depends on the
    # order and may differ from JAX's in the last bit.
    out = torch.zeros(T, M, dtype=out_g.dtype, device=tokens.device)
    return out.index_add_(0, tok_idx, out_g * gates[:, None])


def _logits(params: Dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    x = _apply_norm(params["final_norm"], cfg, x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["embedding"].to(cfg.dtype).t()
    return _proj(x, params["lm_head"]["kernel"], cfg.dtype)
