"""Paged GQA attention (counterpart of ``deepspeed_tpu/inference/paged.py``'s
``_xla_paged_attention`` and the Pallas ``ops/pallas/paged_attention.py:
_decode_kernel``).

``paged_attention`` is the one wrapper the serving forward calls. On a CPU
tensor it runs ``paged_attention_reference``, the plain PyTorch version; on
a CUDA tensor it launches the hand-written kernel ``csrc/paged_attention.cu``
or raises. Layouts are the JAX package's: q ``[N, C, H, hd]``, one layer's
pool ``[S_flat, kvH, hd]``, ``block_tables [N, P]``, ``q_positions [N, C]``.

The two differ in one rounding, as the JAX pair does: the kernel scales q by
``hd**-0.5`` in q's dtype before the dot, the plain version divides the fp32
scores. In fp32 that is ~1e-7 relative; in bf16 it moves a score by up to
2**-9 of its size, which is why kernel-vs-plain checks in bf16 carry a
bf16-sized tolerance.
"""

from __future__ import annotations

import ctypes
import functools
import math
import torch

from deepspeed_tpu_torch.ops import op_builder

SUPPORTED_HEAD_DIMS = (64, 128)


def paged_attention_reference(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                              new_lens):
    """Masked GQA attention of new queries against paged caches: gather the
    row's pages to ``[N, P*bs, kvH, hd]`` (slot index within the gathered view
    == global position), then causal attention over positions. ``new_lens``
    is accepted for signature parity and unused, as in the JAX version."""
    N, C, H, hd = q.shape
    P = block_tables.shape[1]
    ar = torch.arange(block_size, device=q.device)
    slot = (block_tables.long()[:, :, None] * block_size + ar[None, None, :]).reshape(N, P * block_size)
    ck = pool_k_l[slot]  # [N, P*bs, kvH, hd]
    cv = pool_v_l[slot]
    kvH = ck.shape[2]
    G = H // kvH
    qg = q.reshape(N, C, kvH, G, hd)
    scores = torch.einsum("nckgd,ntkd->nkgct", qg, ck).float()
    scores = scores / math.sqrt(hd)
    t_idx = torch.arange(P * block_size, device=q.device)
    ok = t_idx[None, None, :] <= q_positions.long()[:, :, None]  # [N, C, T]
    scores = torch.where(ok[:, None, None, :, :], scores, torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    ctx = torch.einsum("nkgct,ntkd->nckgd", probs, cv)
    return ctx.reshape(N, C, H, hd)


@functools.lru_cache(maxsize=None)
def _q_scale(hd: int, dtype: torch.dtype) -> float:
    """hd**-0.5 rounded to q's dtype, as the JAX kernel's
    ``jnp.asarray(hd ** -0.5, q.dtype)``."""
    return float(torch.tensor(hd ** -0.5, dtype=dtype))


def _check(q, pool_k_l, pool_v_l, block_tables, q_positions, new_lens):
    if q.dim() != 4 or pool_k_l.dim() != 3:
        raise ValueError(
            f"paged_attention: q must be [N, C, H, hd] and the pool [S_flat, kvH, hd], got "
            f"{tuple(q.shape)} and {tuple(pool_k_l.shape)}")
    N, C, H, hd = q.shape
    kvH = pool_k_l.shape[1]
    if pool_v_l.shape != pool_k_l.shape or pool_k_l.shape[2] != hd:
        raise ValueError(
            f"paged_attention: pools {tuple(pool_k_l.shape)}/{tuple(pool_v_l.shape)} do not "
            f"match q's head dim {hd}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} unsupported (one of {SUPPORTED_HEAD_DIMS})")
    if H % kvH:
        raise ValueError(f"paged_attention: {H} query heads not divisible by {kvH} kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != N:
        raise ValueError(f"paged_attention: block_tables must be [{N}, P], got {tuple(block_tables.shape)}")
    if q_positions.shape != (N, C):
        raise ValueError(f"paged_attention: q_positions must be [{N}, {C}], got {tuple(q_positions.shape)}")
    if new_lens.shape != (N,):
        raise ValueError(f"paged_attention: new_lens must be [{N}], got {tuple(new_lens.shape)}")
    if q.dtype not in op_builder.DTYPE_CODES or pool_k_l.dtype != q.dtype or pool_v_l.dtype != q.dtype:
        raise TypeError(
            f"paged_attention: q and pools must share one dtype of fp32 | bf16, got "
            f"{q.dtype}, {pool_k_l.dtype}, {pool_v_l.dtype}")
    ints = [("block_tables", block_tables), ("q_positions", q_positions), ("new_lens", new_lens)]
    for name, t in [("q", q), ("pool_k_l", pool_k_l), ("pool_v_l", pool_v_l)] + ints:
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("pool_k_l", pool_k_l), ("pool_v_l", pool_v_l)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte aligned")
    if N > 65535 or kvH > 65535:
        raise ValueError(f"paged_attention: N={N}, kvH={kvH} exceed the kernel's grid")


def paged_attention(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                    new_lens: torch.Tensor):
    """GQA attention of q ``[N, C, H, hd]`` over one layer's paged pool.

    ``new_lens [N]`` int32 (live new tokens per row, 0 for a pad row) bounds
    the pages the kernel reads to the row's live length."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k_l, pool_v_l, block_tables, q_positions,
                                         block_size, new_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, pool_k_l, pool_v_l, block_tables, q_positions, new_lens)
    N, C, H, hd = q.shape
    out = torch.empty_like(q)
    lib = op_builder.load("paged_attention")
    err = lib.ds_paged_attention(
        q.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr(), block_tables.data_ptr(),
        q_positions.data_ptr(), new_lens.data_ptr(),
        out.data_ptr(), N, C, H, pool_k_l.shape[1], hd, block_tables.shape[1], block_size,
        ctypes.c_float(_q_scale(hd, q.dtype)), op_builder.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
