"""Attention ops (counterpart of ``deepspeed_tpu/ops/attention.py``).

``causal_attention`` dispatches through the op registry:

- "pallas" (what "auto" and "flash" resolve to) is
  ``ops/flash_attention.flash_causal_attention``: its plain versions on the
  CPU, its CUDA kernels on the card. ALiBi slopes (Bloom) pass through to
  the ALiBi form of the flash kernels, as constants without a gradient (the
  JAX package's flash path stops theirs too). The JAX package's scheduling
  knobs (``block_q``/``block_k``/``k_splits``) are accepted and ignored.
- "xla" is ``xla_causal_attention``, the port of JAX's
  ``_xla_causal_attention``: plain PyTorch that materialises the scores,
  fully differentiable (learned slopes and a pair bias included). It
  follows JAX's XLA path, not the flash kernel: ALiBi is ``slopes * kpos``,
  masked scores are filled with -1e9, so a row with no visible key averages
  V over every key (the flash kernel returns 0 there).

A dense pair bias always takes the "xla" path, as in JAX. The model
config's ``attn_impl`` choices are the model's own
(``models/transformer.py:ATTN_IMPLS``): none of them is "xla", so the model
calls ``flash_causal_attention`` directly, not through the registry.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.flash_attention import _SCHEDULING_KWARGS, flash_causal_attention
from deepspeed_tpu_torch.ops.registry import available_impls, dispatch, register

_NEG_INF = -1e9  # JAX's mask fill (``ops/attention.py:19``)

register("causal_attention", "pallas")(flash_causal_attention)


@register("causal_attention", "xla")
def xla_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         alibi_slopes: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         causal: bool = True, **kernel_kwargs) -> torch.Tensor:
    """q ``[B, S, H, D]``, k/v ``[B, S, kvH, D]``; ``mask [B, S]`` (1 = keep
    the key), ``alibi_slopes [H]``, ``bias [H, S, S]`` or ``[B, H, S, S]``
    (added to the scores). Scores and softmax in fp32, the probabilities cast
    to v's dtype before their product with v. The flash path's scheduling
    knobs are accepted and dropped: this path has no blocking."""
    unknown = sorted(set(kernel_kwargs) - set(_SCHEDULING_KWARGS))
    if unknown:
        raise TypeError(f"xla_causal_attention: unexpected keyword arguments {unknown}")
    B, S, H, D = q.shape
    kvH = k.shape[2]
    if H % kvH:
        raise ValueError(f"query heads {H} not a multiple of kv heads {kvH}")
    G = H // kvH
    qg = q.reshape(B, S, kvH, G, D).float() * (D ** -0.5)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if alibi_slopes is not None:
        kpos = torch.arange(S, dtype=torch.float32, device=q.device)
        scores = scores + alibi_slopes.float().reshape(kvH, G)[None, :, :, None, None] * kpos
    if bias is not None:
        b5 = bias if bias.dim() == 4 else bias[None]
        scores = scores + b5.reshape(b5.shape[0], kvH, G, S, S).float()
    keep = None
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    if mask is not None:
        m = (mask > 0)[:, None, None, None, :]
        keep = m if keep is None else keep & m
    if keep is not None:
        scores = scores.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, S, H, D)


def resolves_to_flash(impl: str = "auto") -> bool:
    """Whether a model configured with this ``attn_impl`` runs the flash
    kernels, by the same resolution ``dispatch`` makes at call time.
    "sparse" and "fpdt" branch before this op, so they are never flash."""
    if impl in ("sparse", "fpdt"):
        return False
    pallas = available_impls("causal_attention").get("pallas")
    return pallas is not None and dispatch("causal_attention", impl) is pallas


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, impl: str = "auto",
                     alibi_slopes: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, **kernel_kwargs) -> torch.Tensor:
    """Grouped-query causal attention: q ``[B, S, H, hd]``, k/v
    ``[B, S, kvH, hd]``, optional key keep-mask ``[B, S]`` (1 = keep), ALiBi
    slopes ``[H]`` and an additive pair bias (which runs the "xla" path).
    ``kernel_kwargs`` are the flash path's scheduling knobs; the "xla" path
    has no blocking and drops them."""
    if bias is not None:
        return xla_causal_attention(q, k, v, mask=mask, alibi_slopes=alibi_slopes, bias=bias,
                                    **kernel_kwargs)
    return dispatch("causal_attention", impl)(q, k, v, mask=mask, alibi_slopes=alibi_slopes,
                                              **kernel_kwargs)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pair_bias: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DS4Science evoformer attention: bidirectional attention over q/k/v
    ``[B, S, H, D]`` with an additive pair bias (``[H, S, S]`` or
    ``[B, H, S, S]``) and an optional keep-mask ``[B, S]``; differentiable
    in the pair bias too."""
    return xla_causal_attention(q, k, v, mask=mask, bias=pair_bias, causal=False)
