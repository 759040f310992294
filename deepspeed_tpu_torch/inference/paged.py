"""Paged KV cache and the ragged forward step (counterpart of
``deepspeed_tpu/inference/paged.py``).

The KV pool is a flat ``[L, NB*bs + 1, kvH, hd]`` tensor per K and V; the last
slot is the trash slot that absorbs the writes of pad rows and finished rows.
A sequence's cache is addressed through its block table, and one step
processes a mixed prefill/decode ragged batch:

  - KV insert: ``index_copy_`` of the step's K/V into the pool at
    ``block_table[pos // bs] * bs + pos % bs`` (or the trash slot). The write
    is IN PLACE: the JAX pool is a functional array donated to each step;
    here the pool tensors are updated where they lie and the same
    ``PagedKVPool`` is returned.
  - paged attention: ``ops.paged_attention`` (the hand-written CUDA kernel on
    the card, the plain gather-then-attend version on the CPU), called after
    the KV write, so a prefill chunk attends to itself. The Bloom form
    (``position="alibi"``) passes its slopes, made once per head count and
    device, and takes no RoPE; ``embed_norm`` normalises the gathered
    embeddings first.

A quantised pool (``kv_quant`` 'int8' | 'fp8') holds 1-byte codes and one
fp32 scale per (layer, slot, kv head): the quantisation block is the ``hd``
head vector, so a step's KV write is one block-math call (``_kv_block_quant``)
and still one ``index_copy_`` per array, values and scales alike, and paged
attention dequantises only what it reads.

The K-step decode chain (a ``lax.scan`` in JAX) is a Python loop of K
single-token forwards with the same per-row ``emitted``/``budgets``/EOS
masking, kept on the device: the host reads its result once per chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.inference.model import _attn_out, _logits, _mlp, _moe, _qkv
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.models.transformer import (
    TransformerConfig,
    _apply_norm,
    alibi_slopes,
    apply_qk_rope,
    layer_slice,
)
from deepspeed_tpu_torch.ops.paged_attention import paged_attention
from deepspeed_tpu_torch.ops.quant import fp8_block_math, int8_block_math
from deepspeed_tpu_torch.utils.device import resolve_device

POOL_DTYPES = (torch.bfloat16, torch.float32)
KV_QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@dataclasses.dataclass
class PagedKVPool:
    """k/v: ``[L, NB*bs + 1, kvH, hd]`` flat slot-major pools; the final slot
    is the trash slot. ``k_scale``/``v_scale``: ``[L, NB*bs + 1, kvH, 1]``
    fp32 for a quantised pool, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quant(self) -> Optional[str]:
        """None | 'int8' | 'fp8', from the scales' presence and the value dtype."""
        if self.k_scale is None:
            return None
        return "fp8" if self.k.dtype == torch.float8_e4m3fn else "int8"


def init_pool(cfg: TransformerConfig, num_blocks: int, block_size: int,
              dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
              kv_quant: Optional[str] = None) -> PagedKVPool:
    """A zeroed pool: ``dtype`` values, or with ``kv_quant`` 1-byte codes and
    fp32 scales (``dtype`` is then the compute dtype and unused here)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks * block_size + 1, cfg.kv_heads, cfg.dims_per_head)
    if kv_quant is not None:
        if kv_quant not in KV_QUANT_DTYPES:
            raise ValueError(f"kv_quant must be None|'int8'|'fp8', got {kv_quant!r}")
        qdt = KV_QUANT_DTYPES[kv_quant]
        sshape = shape[:3] + (1,)
        return PagedKVPool(k=torch.zeros(shape, dtype=qdt, device=dev),
                           v=torch.zeros(shape, dtype=qdt, device=dev),
                           k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                           v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev))
    if dtype not in POOL_DTYPES:
        raise NotImplementedError(f"KV pool dtype {dtype}: bf16 | fp32 only")
    return PagedKVPool(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))


def _kv_block_quant(x: torch.Tensor, quant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[T, kvH, hd] float -> (codes [T, kvH, hd], fp32 scales [T, kvH, 1])``:
    one symmetric absmax block per (token, head) ``hd`` vector through the
    shared block math. Plain PyTorch on every device: it is jnp in the JAX
    package (``inference/paged.py:84-94``)."""
    T, kvH, hd = x.shape
    x2 = x.float().reshape(T * kvH, hd)
    q, s = int8_block_math(x2) if quant == "int8" else fp8_block_math(x2)
    return q.reshape(T, kvH, hd), s.reshape(T, kvH, 1)


def _slot_ids(block_tables: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
              block_size: int, trash: int) -> torch.Tensor:
    """Flat pool slot for each (row, token): bt[pos//bs]*bs + pos%bs, or trash.
    Page indices past the table clamp (as JAX's gather clamps); such tokens
    are never valid."""
    pages = (positions.long() // block_size).clamp_(0, block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, pages)
    slot = page * block_size + positions.long() % block_size
    return torch.where(valid, slot, torch.full_like(slot, trash))


def _forward_hidden(params: Dict, cfg: TransformerConfig, pool: PagedKVPool,
                    tokens: torch.Tensor, positions: torch.Tensor, new_lens: torch.Tensor,
                    block_tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """One mixed prefill/decode pass over the layer stack -> last-token hidden
    ``[N, E]``; writes the step's K/V into ``pool`` in place.

    tokens/positions ``[N, C]`` int32, new_lens ``[N]`` int32, block_tables
    ``[N, P]`` int32."""
    N, C = tokens.shape
    trash = pool.k.shape[1] - 1
    valid = torch.arange(C, device=tokens.device)[None, :] < new_lens[:, None]
    flat_slot = _slot_ids(block_tables, positions, valid, block_size, trash).reshape(-1)

    x = params["embed"]["embedding"][tokens.long()].to(cfg.dtype)
    if cfg.embed_norm:
        x = _apply_norm(params["embed_norm"], cfg, x)
    slopes = alibi_slopes(cfg.num_heads, x.device) if cfg.position == "alibi" else None
    layers = params["layers"]
    quant = pool.quant
    for i in range(cfg.num_layers):
        lp = layer_slice(layers, i)
        h = _apply_norm(lp["attn_norm"], cfg, x)
        q, k, v = _qkv(lp["attn"], cfg, h)
        if cfg.position == "rope":
            q, k = apply_qk_rope(cfg, q, k, positions)
        pk, pv = pool.k[i], pool.v[i]
        kvH, hd = k.shape[-2], k.shape[-1]
        if quant is None:
            pk.index_copy_(0, flat_slot, k.reshape(-1, kvH, hd).to(pk.dtype))
            pv.index_copy_(0, flat_slot, v.reshape(-1, kvH, hd).to(pv.dtype))
            psk = psv = None
        else:
            # pad rows route to the trash slot for values and scales alike
            psk, psv = pool.k_scale[i], pool.v_scale[i]
            for codes, scales, new in ((pk, psk, k), (pv, psv, v)):
                xq, xs = _kv_block_quant(new.reshape(-1, kvH, hd), quant)
                # as bytes: index_copy_ has no e4m3 form
                codes.view(torch.uint8).index_copy_(0, flat_slot, xq.view(torch.uint8))
                scales.index_copy_(0, flat_slot, xs)
        ctx = paged_attention(q, pk, pv, block_tables, positions, block_size, new_lens=new_lens,
                              k_scale=psk, v_scale=psv, alibi_slopes=slopes)
        x = x + _attn_out(lp["attn"], cfg, ctx)
        h = _apply_norm(lp["mlp_norm"], cfg, x)
        # an MoE FFN sees all N * C tokens, pads included, as JAX's does: the
        # count chooses its dispatch regime
        x = x + (_moe(lp["moe"], cfg, h) if cfg.num_experts else _mlp(lp["mlp"], cfg, h))

    last = (new_lens.long() - 1).clamp_(min=0)
    return x[torch.arange(N, device=x.device), last]


def ragged_forward(params: Dict, cfg: TransformerConfig, pool: PagedKVPool,
                   tokens: torch.Tensor, positions: torch.Tensor, new_lens: torch.Tensor,
                   block_tables: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, PagedKVPool]:
    """One mixed prefill/decode step -> (last-token logits ``[N, V]``, pool).
    The final norm and LM head run on the ``[N, E]`` last-token hiddens only.
    ``pool`` is updated in place and returned."""
    last = _forward_hidden(params, cfg, pool, tokens, positions, new_lens, block_tables, block_size)
    return _logits(params, cfg, last), pool


def ragged_decode_chain(
    params: Dict,
    cfg: TransformerConfig,
    pool: PagedKVPool,
    tokens: torch.Tensor,  # [N] int32 — last sampled token per row (next input)
    start_pos: torch.Tensor,  # [N] int32 — global position of that input token
    block_tables: torch.Tensor,  # [N, P] int32, pre-extended for the K-token window
    block_size: int,
    active: torch.Tensor,  # [N] bool — live rows (pad rows False)
    budgets: torch.Tensor,  # [N] int32 — max tokens this chain may emit per row
    generator: Optional[torch.Generator],
    k_steps: int,
    eos_id: Optional[int] = None,
    *,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, PagedKVPool]:
    """K single-token forwards + sampling, all on the device.

    A row goes inactive when it samples ``eos_id`` or exhausts its
    ``budgets`` entry; after that its KV writes route to the trash slot and
    its output slots are -1. Returns ``(out_tokens [N, K], emitted [N],
    active [N], pool)`` where ``out_tokens[i, :emitted[i]]`` are valid and
    ``emitted[i]`` is also the number of KV slots row i consumed."""
    tok, pos, live = tokens, start_pos, active
    emitted = torch.zeros_like(start_pos)
    outs = []
    for _ in range(k_steps):
        new_lens = live.to(torch.int32)
        last = _forward_hidden(params, cfg, pool, tok[:, None].contiguous(),
                               pos[:, None].contiguous(), new_lens, block_tables, block_size)
        logits = _logits(params, cfg, last)
        nxt = sample_logits(logits, generator, do_sample=do_sample, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        emitted = emitted + new_lens
        outs.append(torch.where(live, nxt, torch.full_like(nxt, -1)))
        still = live & (emitted < budgets)
        if eos_id is not None:
            still = still & (nxt != eos_id)
        tok = torch.where(live, nxt, tok)
        pos = pos + new_lens
        live = still
    return torch.stack(outs, dim=1), emitted, live, pool
