"""Paged GQA attention (counterpart of ``deepspeed_tpu/inference/paged.py``'s
``_xla_paged_attention`` and the Pallas ``ops/pallas/paged_attention.py:
_decode_kernel``).

``pallas_paged_attention`` is the one wrapper the serving forward calls. On a CPU
tensor it runs ``paged_attention_reference``, the plain PyTorch version; on
a CUDA tensor it launches the hand-written kernel ``csrc/paged_attention.cu``
or raises. Layouts are the JAX package's: q ``[N, C, H, hd]``, one layer's
pool ``[S_flat, kvH, hd]``, ``block_tables [N, P]``, ``q_positions [N, C]``.

A quantised pool (int8 or e4m3 codes, ``k_scale``/``v_scale [S_flat, kvH,
1]`` fp32: one scale per slot and kv head) goes to ``paged_attention_quant``,
the wrapper of the kernel's quantised form (``ds_paged_attention_quant``,
the JAX kernel's ``quantized=True``), with its own launch count. Both
dequantise only what they read: the plain version the gathered slots of the
batch's block tables, the kernel each page after it is loaded, as
``float(code) * scale`` rounded to q's dtype. The full-precision pool never
exists.

``alibi_slopes`` (fp32 ``[H]``, Bloom's ALiBi; the JAX kernel's
``alibi=True``) adds ``slope[h] * (t - p)`` to the score of a query at
position ``p`` against the key at position ``t``, before the causal mask.
JAX adds ``slope[h] * t``; the two differ by ``slope[h] * p``, one constant
per query row, which the softmax cancels. The relative form keeps the
scores of the keys near the query, which carry the weight, exact in fp32,
where ``slope * t`` at position 2047 (1,720 for head 0 of 32) has an ulp of
1.2e-4. Either pool type takes it; every ALiBi launch counts in
``paged_attention.alibi_launches`` (and not in the wrapper's own count), so
a run can show that the ALiBi form ran.

``pallas_paged_attention`` (the wrapper) is the "pallas" impl of the
registry's ``paged_attention`` and ``paged_attention_reference`` its "xla"
impl (JAX's ``inference/paged.py:108`` dense-gather version); the public
``paged_attention`` picks one by ``impl`` ("auto": the wrapper). Serving
calls the wrapper directly. Its launches count in
``paged_attention.launches``.

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
from deepspeed_tpu_torch.ops.registry import dispatch, register

SUPPORTED_HEAD_DIMS = (64, 128)
# quantised pool dtypes -> the C entry's kv code
QUANT_KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}


@register("paged_attention", "xla")
def paged_attention_reference(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                              new_lens, k_scale=None, v_scale=None, alibi_slopes=None):
    """Masked GQA attention of new queries against paged caches: gather the
    row's pages to ``[N, P*bs, kvH, hd]`` (slot index within the gathered view
    == global position), then causal attention over positions. ``new_lens``
    is accepted for signature parity and unused, as in the JAX version.
    With ``k_scale``/``v_scale`` the pool holds codes, and only the gathered
    slots are dequantised (``deepspeed_tpu/inference/paged.py:127-131``).
    With ``alibi_slopes`` the scores get ``slope[h] * (t - p)`` before the
    mask (``deepspeed_tpu/inference/paged.py:137-142`` adds ``slope[h] * t``:
    the same softmax)."""
    N, C, H, hd = q.shape
    P = block_tables.shape[1]
    ar = torch.arange(block_size, device=q.device)
    slot = (block_tables.long()[:, :, None] * block_size + ar[None, None, :]).reshape(N, P * block_size)
    ck = pool_k_l[slot]  # [N, P*bs, kvH, hd]
    cv = pool_v_l[slot]
    if k_scale is not None:
        ck = (ck.float() * k_scale[slot]).to(q.dtype)
        cv = (cv.float() * v_scale[slot]).to(q.dtype)
    kvH = ck.shape[2]
    G = H // kvH
    qg = q.reshape(N, C, kvH, G, hd)
    scores = torch.einsum("nckgd,ntkd->nkgct", qg, ck).float()
    scores = scores / math.sqrt(hd)
    t_idx = torch.arange(P * block_size, device=q.device)
    if alibi_slopes is not None:
        rel = (t_idx[None, None, :] - q_positions.long()[:, :, None]).float()  # [N, C, T]
        slopes = alibi_slopes.float().reshape(kvH, G)[None, :, :, None, None]
        scores = scores + slopes * rel[:, None, None, :, :]
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


def _check(q, pool_k_l, pool_v_l, block_tables, q_positions, new_lens, k_scale=None,
           v_scale=None, alibi_slopes=None):
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
    if k_scale is None:
        if (q.dtype not in op_builder.DTYPE_CODES or pool_k_l.dtype != q.dtype
                or pool_v_l.dtype != q.dtype):
            raise TypeError(
                f"paged_attention: q and pools must share one dtype of fp32 | bf16, got "
                f"{q.dtype}, {pool_k_l.dtype}, {pool_v_l.dtype}")
        scales = []
    else:
        if (q.dtype not in op_builder.DTYPE_CODES or pool_k_l.dtype not in QUANT_KV_CODES
                or pool_v_l.dtype != pool_k_l.dtype):
            raise TypeError(
                f"paged_attention_quant: q must be fp32 | bf16 and both pools int8 | e4m3, got "
                f"{q.dtype}, {pool_k_l.dtype}, {pool_v_l.dtype}")
        want = (pool_k_l.shape[0], kvH, 1)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"paged_attention_quant: {name} must be fp32 {list(want)}, got "
                                 f"{t.dtype} {list(t.shape)}")
        scales = [("k_scale", k_scale), ("v_scale", v_scale)]
    if alibi_slopes is not None:
        if alibi_slopes.dtype != torch.float32 or tuple(alibi_slopes.shape) != (H,):
            raise ValueError(f"paged_attention: alibi_slopes must be fp32 [{H}], got "
                             f"{alibi_slopes.dtype} {list(alibi_slopes.shape)}")
        scales = scales + [("alibi_slopes", alibi_slopes)]
    ints = [("block_tables", block_tables), ("q_positions", q_positions), ("new_lens", new_lens)]
    for name, t in [("q", q), ("pool_k_l", pool_k_l), ("pool_v_l", pool_v_l)] + scales + ints:
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


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "paged_attention has no backward: call it under torch.no_grad() or on "
            "tensors that do not require grad")


def _count(wrapper, alibi_slopes) -> None:
    """One launch of ``wrapper``'s kernel: an ALiBi launch (either pool type)
    counts in ``paged_attention.alibi_launches``, any other in its own."""
    if alibi_slopes is not None:
        paged_attention.alibi_launches += 1
    else:
        wrapper.launches += 1


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


@register("paged_attention", "pallas")
def pallas_paged_attention(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                           new_lens: torch.Tensor, k_scale=None, v_scale=None,
                           alibi_slopes=None):
    """GQA attention of q ``[N, C, H, hd]`` over one layer's paged pool.

    ``new_lens [N]`` int32 (live new tokens per row, 0 for a pad row) bounds
    the pages the kernel reads to the row's live length. ``k_scale``/
    ``v_scale`` mark a quantised pool (see ``paged_attention_quant``);
    ``alibi_slopes`` fp32 ``[H]`` adds Bloom's ALiBi. It has no backward (nor
    has the JAX kernel): with grad mode on, an input that requires grad
    raises instead of returning an output with no gradient."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both k_scale and v_scale, or neither")
    if k_scale is not None:
        return paged_attention_quant(q, pool_k_l, pool_v_l, block_tables, q_positions,
                                     block_size, new_lens, k_scale, v_scale, alibi_slopes)
    _refuse_grad(q, pool_k_l, pool_v_l)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k_l, pool_v_l, block_tables, q_positions,
                                         block_size, new_lens, alibi_slopes=alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, pool_k_l, pool_v_l, block_tables, q_positions, new_lens,
           alibi_slopes=alibi_slopes)
    N, C, H, hd = q.shape
    out = torch.empty_like(q)
    lib = op_builder.load("paged_attention")
    err = lib.ds_paged_attention(
        q.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr(), _ptr(alibi_slopes),
        block_tables.data_ptr(), q_positions.data_ptr(), new_lens.data_ptr(),
        out.data_ptr(), N, C, H, pool_k_l.shape[1], hd, block_tables.shape[1], block_size,
        ctypes.c_float(_q_scale(hd, q.dtype)), op_builder.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    _count(paged_attention, alibi_slopes)
    return out


def paged_attention_quant(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                          new_lens, k_scale, v_scale, alibi_slopes=None):
    """GQA attention of q ``[N, C, H, hd]`` (fp32 | bf16) over one layer's
    quantised pool: int8 or e4m3 codes ``[S_flat, kvH, hd]`` with fp32
    ``k_scale``/``v_scale [S_flat, kvH, 1]``; ``alibi_slopes`` as in
    ``paged_attention``."""
    _refuse_grad(q, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k_l, pool_v_l, block_tables, q_positions,
                                         block_size, new_lens, k_scale, v_scale, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant: unsupported device {q.device}")
    _check(q, pool_k_l, pool_v_l, block_tables, q_positions, new_lens, k_scale, v_scale,
           alibi_slopes)
    N, C, H, hd = q.shape
    out = torch.empty_like(q)
    lib = op_builder.load("paged_attention")
    err = lib.ds_paged_attention_quant(
        q.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), _ptr(alibi_slopes), block_tables.data_ptr(), q_positions.data_ptr(),
        new_lens.data_ptr(), out.data_ptr(), N, C, H, pool_k_l.shape[1], hd,
        block_tables.shape[1], block_size, ctypes.c_float(_q_scale(hd, q.dtype)),
        op_builder.DTYPE_CODES[q.dtype], QUANT_KV_CODES[pool_k_l.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention_quant kernel launch failed: cudaError {err}")
    _count(paged_attention_quant, alibi_slopes)
    return out


def paged_attention(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                    new_lens: torch.Tensor, k_scale=None, v_scale=None, alibi_slopes=None,
                    impl: str = "auto"):
    """The registry's ``paged_attention``: "pallas" (``auto``) or "xla"."""
    return dispatch("paged_attention", impl)(q, pool_k_l, pool_v_l, block_tables, q_positions,
                                             block_size, new_lens, k_scale, v_scale,
                                             alibi_slopes)


paged_attention.launches = 0
paged_attention.alibi_launches = 0
paged_attention_quant.launches = 0
