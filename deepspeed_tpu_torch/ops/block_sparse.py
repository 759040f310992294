"""Tile-skipping block-sparse attention kernels (counterpart of
``deepspeed_tpu/ops/pallas/sparse_attention.py``).

Three kernels, each with its plain PyTorch version beside it:

- ``sparse_fwd(q, k, v, cols, ncols, block, causal) -> (out, lse)``
  replaces ``_sparse_fwd_kernel``;
- ``sparse_bwd_dq(...) -> dq`` replaces ``_sparse_dq_kernel``;
- ``sparse_bwd_dkv(...) -> (dk, dv)`` replaces ``_sparse_dkv_kernel``.

Each wrapper runs its plain version (``*_reference``) on a CPU tensor and on a
CUDA tensor launches its hand-written kernel (``csrc/sparse_attention_fwd.cu``,
``sparse_attention_bwd_dq.cu``, ``sparse_attention_bwd_dkv.cu``) or raises.

The static ``[H, n, n]`` block layout becomes per-(head, query block) lists
of its live key blocks, ``cols [H, n, A]`` and ``ncols [H, n]`` int32 (the
forward and dq walk them), and the transposed lists ``rows``/``nrows`` (per
key block, its live query blocks: dkv walks them, so each key block's
gradients are summed by one thread block, without atomics). A list entry
``j`` is live when ``j < ncols`` and, with ``causal``, its key block is not
after the query block; the elementwise ``col <= row`` mask applies on the
diagonal tile only. Padding entries are never read.

Arrays are in the model's layout: q, dO and out ``[B, S, H, D]``, k and v
``[B, S, Hkv, D]`` with query head h reading kv head ``h // (H // Hkv)`` (the
GQA of the JAX model's ``jnp.repeat``, without the copy), ``S`` a multiple of
``block``. q arrives pre-scaled by ``D**-0.5``; scores and ``lse`` (fp32
``[B, H, S]``) are base e. A row with no live tile gets output 0, ``lse =
finfo(float32).min`` and zero gradients. dq, dk and dv come out in fp32
``[B, S, H, D]``: dq without the ``D**-0.5`` of the pre-scaled q, dk with it
(it used the pre-scaled q); dk and dv per query head, summed over each GQA
group by the caller.

``block_sparse_attention_kernel`` ties them together in a
``torch.autograd.Function`` with the bookkeeping of the JAX package's
``_sparse_core`` and ``_sparse_vjp_bwd``: q scaled in q's dtype, ``delta =
rowsum(dO * O)`` in fp32 from the kernel's rounded output, dq times the
Python float ``D**-0.5`` in fp32, dk and dv summed over the group in fp32,
then dq, dk and dv cast to the inputs' dtypes. ``layout_arrays`` caches a
layout's lists on the device, keyed by the layout's bytes; a caller that
holds the lists itself (the model, per config and sequence length) passes
them in.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder

NEG_INF = float(torch.finfo(torch.float32).min)
SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_BLOCKS = (16, 32, 64)


# ------------------------------------------------------------ layout lists
def layout_to_lists(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``[H, n, n]`` 0/1 -> (``cols [H, n, A]``, ``ncols [H, n]``) int32, A the
    largest row population (at least 1). A row's live columns come first, in
    order; its padding repeats its last live column (0 for an empty row)."""
    live = np.asarray(layout) != 0
    ncols = live.sum(-1).astype(np.int32)
    A = max(1, int(ncols.max()))
    order = np.argsort(~live, axis=-1, kind="stable")[..., :A].astype(np.int32)
    last = np.take_along_axis(order, np.maximum(ncols - 1, 0)[..., None], -1)
    last = np.where(ncols[..., None] > 0, last, 0)
    cols = np.where(np.arange(A) < ncols[..., None], order, last).astype(np.int32)
    return cols, ncols


def layout_to_lists_t(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The transposed lists (``rows [H, n, Ar]``, ``nrows [H, n]``): for key
    block ki, its live query blocks."""
    return layout_to_lists(np.swapaxes(layout, -1, -2))


def layout_lists(layout: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """``(cols, ncols, rows, nrows)`` of ``layout`` as int32 tensors on
    ``device``."""
    lists = (*layout_to_lists(layout), *layout_to_lists_t(layout))
    return tuple(torch.from_numpy(a).to(device) for a in lists)


# (layout shape, dtype, bytes, device) -> layout_lists; insertion-ordered, the
# oldest evicted past the cap. A pending backward keeps its own references to
# the lists, so eviction is always safe.
_LAYOUTS: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
_LAYOUT_CAP = 32


def layout_arrays(layout: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """``layout_lists`` of ``layout``, cached by the layout's bytes (as the JAX
    package's ``_layout_arrays``)."""
    layout = np.asarray(layout)
    key = (layout.shape, layout.dtype.str, layout.tobytes(), str(torch.device(device)))
    if key in _LAYOUTS:
        _LAYOUTS[key] = _LAYOUTS.pop(key)  # most recently used last
    else:
        _LAYOUTS[key] = layout_lists(layout, device)
        while len(_LAYOUTS) > _LAYOUT_CAP:
            _LAYOUTS.pop(next(iter(_LAYOUTS)))
    return _LAYOUTS[key]


def lists_to_mask(cols: torch.Tensor, ncols: torch.Tensor) -> torch.Tensor:
    """The ``[H, n, n]`` bool block mask the lists describe (padding ignored)."""
    H, n, A = cols.shape
    valid = (torch.arange(A, device=cols.device) < ncols[..., None]).to(torch.int32)
    counts = torch.zeros(H, n, n, dtype=torch.int32, device=cols.device)
    return counts.scatter_add_(2, cols.long(), valid) > 0


# ------------------------------------------------------------ plain versions
def token_mask(block_mask: torch.Tensor, block: int, causal: bool) -> torch.Tensor:
    """``[H, S, S]`` bool: the block mask expanded to tokens, with ``col <=
    row`` under ``causal``."""
    keep = block_mask.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        S = keep.shape[-1]
        keep = keep & torch.ones(S, S, dtype=torch.bool, device=keep.device).tril()
    return keep


def _head_scores(q, k, keep, h):
    """Masked fp32 scores ``[B, S, S]`` of query head h (NEG_INF where not
    kept), against its kv head."""
    G = q.shape[2] // k.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), k[:, :, h // G].float())
    return torch.where(keep[h], s, torch.full((), NEG_INF, device=s.device))


def _head_probs(s, lse_h):
    """p = exp(s - lse) with lse's sentinel read as 0 (masked p are 0)."""
    lse = lse_h[..., None]
    return torch.exp(s - torch.where(lse == NEG_INF, torch.zeros_like(lse), lse))


def sparse_fwd_reference(q, k, v, cols, ncols, block, causal=True):
    """Plain version of the forward kernel, one head at a time (a whole
    ``[B, H, S, S]`` fp32 score tensor would not fit at long S). Returns
    ``(out [B, S, H, D] in q's dtype, lse [B, H, S] fp32)``."""
    keep = token_mask(lists_to_mask(cols, ncols), block, causal)
    B, S, H, _ = q.shape
    G = H // k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for h in range(H):
        s = _head_scores(q, k, keep, h)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(m == NEG_INF, torch.zeros_like(m), m))
        l = p.sum(-1, keepdim=True)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v[:, :, h // G].float())
        out[:, :, h] = (acc / l_safe).to(q.dtype)
        lse[:, h] = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(l_safe))[..., 0]
    return out, lse


def sparse_bwd_dq_reference(q, k, v, do, lse, delta, cols, ncols, block, causal=True):
    """Plain version of the dq kernel: ``dq = ds @ k`` in fp32 with ``ds = p *
    (dO V^T - delta)`` cast to k's dtype before the product (no ``D**-0.5``)."""
    keep = token_mask(lists_to_mask(cols, ncols), block, causal)
    G = q.shape[2] // k.shape[2]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for h in range(q.shape[2]):
        p = _head_probs(_head_scores(q, k, keep, h), lse[:, h])
        dp = torch.einsum("bqd,bkd->bqk", do[:, :, h].float(), v[:, :, h // G].float())
        ds = p * (dp - delta[:, h, :, None])
        dq[:, :, h] = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(),
                                   k[:, :, h // G].float())
    return dq


def sparse_bwd_dkv_reference(q, k, v, do, lse, delta, rows, nrows, block, causal=True):
    """Plain version of the dkv kernel over the transposed lists: per query
    head, ``dv = p^T dO`` and ``dk = ds^T q`` in fp32 ``[B, S, H, D]``, with p
    and ds cast to dO's and q's dtype before their products."""
    keep = token_mask(lists_to_mask(rows, nrows).transpose(1, 2), block, causal)
    G = q.shape[2] // k.shape[2]
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for h in range(q.shape[2]):
        p = _head_probs(_head_scores(q, k, keep, h), lse[:, h])
        dv[:, :, h] = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do[:, :, h].float())
        dp = torch.einsum("bqd,bkd->bqk", do[:, :, h].float(), v[:, :, h // G].float())
        ds = p * (dp - delta[:, h, :, None])
        dk[:, :, h] = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q[:, :, h].float())
    return dk, dv


# ------------------------------------------------------------ kernel wrappers
def _check(q, k, v, lists, block, *more):
    if q.device.type != "cuda":
        raise ValueError(f"block-sparse attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            (k.shape[0], k.shape[1], k.shape[3]) != (q.shape[0], q.shape[1], q.shape[3]) or \
            k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"block-sparse attention: q [B, S, H, D] and k, v [B, S, Hkv, D] "
                         f"with Hkv dividing H expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"block-sparse attention: head_dim {D} unsupported "
                         f"(one of {SUPPORTED_HEAD_DIMS})")
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"block-sparse attention: block {block} unsupported "
                         f"(one of {SUPPORTED_BLOCKS})")
    if S % block:
        raise ValueError(f"block-sparse attention: S={S} not a multiple of block {block}")
    if B > 65535 or H > 65535 or S // block > 65535:
        raise ValueError(f"block-sparse attention: B={B}, H={H}, S={S} exceed the kernel's grid")
    if q.dtype not in op_builder.DTYPE_CODES:
        raise TypeError(f"block-sparse attention: dtype {q.dtype} unsupported (fp32 | bf16)")
    idx, counts = lists
    n = S // block
    if idx.dim() != 3 or idx.shape[:2] != (H, n) or counts.shape != (H, n):
        raise ValueError(f"block-sparse attention: lists {tuple(idx.shape)}, "
                         f"{tuple(counts.shape)} do not match [H={H}, n={n}, A]")
    tensors = [("q", q), ("k", k), ("v", v), ("list", idx), ("count", counts), *more]
    for name, t in tensors:
        want = {"lse": torch.float32, "delta": torch.float32, "list": torch.int32,
                "count": torch.int32}.get(name, q.dtype)
        if t.dtype != want:
            raise TypeError(f"block-sparse attention: {name} dtype {t.dtype}, expected {want}")
        shape = {"do": q.shape, "lse": (B, H, S), "delta": (B, H, S)}.get(name, t.shape)
        if t.shape != shape:
            raise ValueError(f"block-sparse attention: {name} {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != q.device:
            raise ValueError(f"block-sparse attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"block-sparse attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"block-sparse attention: {name} must be 16-byte aligned")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def sparse_fwd(q, k, v, cols, ncols, block, causal=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on pre-scaled q: ``(out [B, S, H, D] in q's dtype, lse [B, H, S])``."""
    if q.device.type == "cpu":
        return sparse_fwd_reference(q, k, v, cols, ncols, block, causal)
    _check(q, k, v, (cols, ncols), block)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    op_builder.launch("sparse_attention_fwd", "ds_sparse_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), cols.data_ptr(), ncols.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), B, H, k.shape[2], S, D, block, cols.shape[-1], int(causal),
                      op_builder.DTYPE_CODES[q.dtype], _stream(q))
    sparse_fwd.launches += 1
    return out, lse


def sparse_bwd_dq(q, k, v, do, lse, delta, cols, ncols, block, causal=True) -> torch.Tensor:
    """dq in fp32, without the ``D**-0.5`` of the pre-scaled q."""
    if q.device.type == "cpu":
        return sparse_bwd_dq_reference(q, k, v, do, lse, delta, cols, ncols, block, causal)
    _check(q, k, v, (cols, ncols), block, ("do", do), ("lse", lse), ("delta", delta))
    B, S, H, D = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    op_builder.launch("sparse_attention_bwd_dq", "ds_sparse_bwd_dq", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      cols.data_ptr(), ncols.data_ptr(), dq.data_ptr(), B, H, k.shape[2], S, D,
                      block,
                      cols.shape[-1], int(causal), op_builder.DTYPE_CODES[q.dtype], _stream(q))
    sparse_bwd_dq.launches += 1
    return dq


def sparse_bwd_dkv(q, k, v, do, lse, delta, rows, nrows, block,
                   causal=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in fp32 ``[B, S, H, D]``, per query head, walking the
    transposed lists."""
    if q.device.type == "cpu":
        return sparse_bwd_dkv_reference(q, k, v, do, lse, delta, rows, nrows, block, causal)
    _check(q, k, v, (rows, nrows), block, ("do", do), ("lse", lse), ("delta", delta))
    B, S, H, D = q.shape
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    op_builder.launch("sparse_attention_bwd_dkv", "ds_sparse_bwd_dkv", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      rows.data_ptr(), nrows.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                      k.shape[2], S, D, block, rows.shape[-1], int(causal),
                      op_builder.DTYPE_CODES[q.dtype], _stream(q))
    sparse_bwd_dkv.launches += 1
    return dk, dv


sparse_fwd.launches = 0
sparse_bwd_dq.launches = 0
sparse_bwd_dkv.launches = 0


# ------------------------------------------------------------ autograd
def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """q times ``D**-0.5``, the scale rounded to q's dtype and the product
    taken in q's dtype, as ``_sparse_core`` does."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)


def sparse_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in fp32, ``[B, S, H, D] -> [B, H, S]``."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def group_sum(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """Per-query-head ``[B, S, H, D]`` summed over each GQA group of ``H //
    kv_heads`` heads: ``[B, S, kv_heads, D]`` (the transpose of the JAX
    model's ``jnp.repeat``)."""
    if x.shape[2] == kv_heads:
        return x
    return x.unflatten(2, (kv_heads, x.shape[2] // kv_heads)).sum(3)


class _SparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lists, block, causal):
        qs, k, v = prescale_q(q).contiguous(), k.contiguous(), v.contiguous()
        cols, ncols, rows, nrows = lists
        out, lse = sparse_fwd(qs, k, v, cols, ncols, block, causal)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.lists, ctx.block, ctx.causal = lists, block, causal
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, out, lse = ctx.saved_tensors
        cols, ncols, rows, nrows = ctx.lists
        do = g.to(qs.dtype).contiguous()
        delta = sparse_delta(do, out)
        dq = sparse_bwd_dq(qs, k, v, do, lse, delta, cols, ncols, ctx.block, ctx.causal)
        dk, dv = sparse_bwd_dkv(qs, k, v, do, lse, delta, rows, nrows, ctx.block, ctx.causal)
        # dq was summed for the pre-scaled q: its factor in fp32 here; dk used
        # the pre-scaled q and carries it already
        dq = (dq * qs.shape[-1] ** -0.5).to(qs.dtype)
        kv_heads = k.shape[2]
        dk, dv = group_sum(dk, kv_heads).to(k.dtype), group_sum(dv, kv_heads).to(v.dtype)
        return dq, dk, dv, None, None, None


def block_sparse_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  layout: np.ndarray, block: int, causal: bool = True,
                                  lists: Optional[Tuple[torch.Tensor, ...]] = None
                                  ) -> torch.Tensor:
    """Tile-skipping forward and exact backward of q ``[B, S, H, D]`` and k, v
    ``[B, S, Hkv, D]`` over ``layout [H, S/block, S/block]`` (counterpart of
    ``block_sparse_attention_pallas``, the JAX model's GQA repeat folded in); returns
    ``[B, S, H, D]`` in q's dtype. ``lists``: the layout's ``layout_lists``
    on q's device, when the caller holds them (else ``layout_arrays``)."""
    B, S, H, D = q.shape
    n = S // block
    if S % block or np.shape(layout) != (H, n, n):
        raise ValueError(f"layout {np.shape(layout)} does not match S={S}, H={H}, block {block}")
    if k.shape[2] == 0 or H % k.shape[2] or v.shape != k.shape:
        raise ValueError(f"kv heads {tuple(k.shape)}, {tuple(v.shape)} do not divide H={H}")
    if lists is None:
        lists = layout_arrays(layout, q.device)
    return _SparseAttention.apply(q, k, v, lists, block, causal)


__all__ = [
    "NEG_INF", "block_sparse_attention_kernel", "group_sum", "layout_arrays", "layout_lists",
    "layout_to_lists", "layout_to_lists_t", "lists_to_mask", "prescale_q", "sparse_bwd_dkv",
    "sparse_bwd_dkv_reference", "sparse_bwd_dq", "sparse_bwd_dq_reference", "sparse_delta",
    "sparse_fwd", "sparse_fwd_reference", "token_mask",
]
