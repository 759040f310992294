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

The kernel has three forms (``PAGED_FORMS``; ``csrc/paged_attention.cu``
sets out their designs). ``paged_form`` picks one from shapes alone, never
from a device tensor (a ``.item()`` would synchronise the decode chain):

- ``"split"`` (flash-decoding): every decode call (C == 1), any dtype,
  pool and ``block_size``. The page range is cut into ``split_plan``'s spans, one
  block each, and the block that finishes a (row, kv head)'s splits last
  merges their partials in split order, in the same launch: the output is
  bit-equal from run to run. The merge's ticket counters live in one int32
  buffer per device and stream (``_TICKETS``), zeroed when it is made and
  left at zero by every launch.
- ``"wgmma"`` (form W): bf16 q at C > 1 with hd 64 or 128 and a
  ``block_size`` that is a multiple of 8 up to 128 (TMA brings a page a
  box), every pool type; where its row tiles give fewer blocks than the
  card has SMs, the keys are split as in form "split" (``w_plan``).
- ``"simt"`` (form S, the first kernel): fp32 q at C > 1 and a
  ``block_size`` TMA cannot take; kept by name so that it can be timed.

Each wrapper counts its launches by form in ``launches_by_form``;
``_paged_attention_form`` runs one form by name (a CUDA tensor only).
``paged_attention_split_model`` is a plain model of form "split"'s
algorithm (per-split partials merged in the kernel's order) for the CPU
tests; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.registry import dispatch, register

SUPPORTED_HEAD_DIMS = (64, 128)
# quantised pool dtypes -> the C entry's kv code
QUANT_KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
# form name -> the C entry's form code (csrc/paged_attention.cu, enum Form)
PAGED_FORMS = {"simt": 0, "split": 1, "wgmma": 2}
# form "split"'s plan: (blocks an SM that ``split_plan`` aims at, the most
# pages it lets a span take) on its tensor-core path (a bf16 pool, at most 4
# rows: a block's fixed costs outweigh its chunks, so fewer, longer spans)
# and on its FMA path (int8/e4m3 and fp32 pools: each warp's chunks are the
# cost, so more, shorter ones); chip_smoke.py phase 7 sweeps the split count
SPLIT_PLAN = {True: (2, 16), False: (4, 8)}
# the most pages a form "split" block takes (its block-table slice in shared memory)
SPLIT_MAX_SPAN = 256
# the kernel's constants that the plain model of form "split" repeats: warps
# a block, tokens a warp step
SPLIT_WARPS = 4
SPLIT_CHUNK = 8
# form W: (c, g) rows a block, keys a tile (whole pages of them)
W_TILE_ROWS = 128
W_TILE_KEYS = 128


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


def paged_form(dtype: torch.dtype, hd: int, C: int, G: int, bs: int) -> str:
    """The form a call of q ``[N, C, G * kvH, hd]`` in ``dtype`` over pages of
    ``bs`` tokens runs, from shapes alone: "split" for decode (C == 1),
    "wgmma" (form W) for bf16 above that where TMA takes the pages, "simt"
    (form S) otherwise. Form W is faster from C = 2 on, at G = 1 and at
    G = 4 (the crossover measured on an H100 by chip_smoke.py phase 7's
    sweep; PERF.md), so decode alone takes form "split"."""
    if C == 1:
        return "split"
    if form_takes("wgmma", dtype, hd, bs):
        return "wgmma"
    return "simt"


def form_takes(form: str, dtype: torch.dtype, hd: int, bs: int) -> bool:
    """Whether ``form`` runs q of ``dtype`` and head dim ``hd`` over pages of
    ``bs`` tokens: form W needs bf16 and whole 8-row swizzle atoms of at most
    one 128-key tile a page; the others take every supported dtype."""
    if dtype not in op_builder.DTYPE_CODES or hd not in SUPPORTED_HEAD_DIMS:
        return False
    if form == "wgmma":
        return dtype == torch.bfloat16 and bs % 8 == 0 and 8 <= bs <= W_TILE_KEYS
    return form in PAGED_FORMS


def split_plan(N: int, kvH: int, P: int, num_sms: int,
               tensor_cores: bool = True) -> Tuple[int, int]:
    """(splits, span) of form "split", from shapes alone: the page range ``[0,
    P)`` of each (row, kv head) cut into ``splits`` fixed spans of ``span``
    pages. ``splits`` brings the N x kvH x splits blocks to about the
    ``SPLIT_PLAN`` count an SM of the kernel's path (one split where the
    pairs alone reach that), and to at least ``ceil(P / span pages)``, so
    that a long row's pages spread over several blocks whatever the pairs;
    a split past its row's live pages exits at once."""
    per_sm, span_pages = SPLIT_PLAN[tensor_cores]
    pairs = max(N * kvH, 1)
    splits = max(1, per_sm * num_sms // pairs, -(-P // span_pages))
    span = -(-P // min(splits, P))
    return -(-P // span), span


def _split_span(P: int, splits: int) -> Tuple[int, int]:
    """(splits, span) of a split count asked for by name: the span at most
    ``SPLIT_MAX_SPAN`` pages."""
    span = min(-(-P // max(1, min(splits, P))), SPLIT_MAX_SPAN)
    return -(-P // span), span


def split_rows(R: int) -> int:
    """(c, g) rows a form "split" block takes of a call's R (the kernel's
    ``rows_of``): 1, 4, or 16 in ``ceil(R / 16)`` row groups."""
    return 1 if R == 1 else 4 if R <= 4 else 16


def w_plan(N: int, kvH: int, R: int, P: int, bs: int, num_sms: int) -> Tuple[int, int]:
    """(splits, span) of form W: one split where its (row tile, kv head, row)
    blocks fill the card's SMs (one block an SM), else as many fixed spans
    as bring them to about one block an SM, each a whole number of the
    kernel's tiles."""
    units = N * kvH * -(-R // W_TILE_ROWS)
    per_tile = W_TILE_KEYS // bs
    splits = max(1, min(num_sms // units, -(-P // per_tile)))
    if splits == 1:
        return 1, P
    pages = -(-P // splits)
    span = -(-pages // per_tile) * per_tile
    return -(-P // span), span


def _live_pages(pos_max: int, row_max: int, bs: int, P: int) -> int:
    """Pages a block reads: up to the larger of its rows' positions, never
    past the row's position at new_lens - 1 or the table's P pages."""
    return min(0 if row_max < 0 else row_max // bs + 1, 0 if pos_max < 0 else pos_max // bs + 1, P)


def _merge_partials(parts, rows: int, hd: int):
    """(m, l, acc) partials merged in their order, as the kernel merges its
    warps and its splits: M = max m, L = sum l e^(m - M), acc = sum acc
    e^(m - M); a partial with m = -inf (or None) saw no key and is skipped."""
    M = torch.full((rows,), -math.inf)
    for part in parts:
        if part is not None:
            M = torch.maximum(M, part[0])
    m_safe = torch.where(M == -math.inf, torch.zeros(()), M)
    L, acc = torch.zeros(rows), torch.zeros(rows, hd)
    for part in parts:
        if part is None:
            continue
        m, l, a = part
        w = torch.where(m == -math.inf, torch.zeros(()), torch.exp(m - m_safe))
        L = L + l * w
        acc = acc + a * w[:, None]
    return M, L, acc


def paged_attention_split_model(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                                new_lens, k_scale=None, v_scale=None, alibi_slopes=None,
                                splits: int = 1, span: Optional[int] = None) -> torch.Tensor:
    """A plain model of form "split"'s algorithm, for the CPU tests (nothing on
    the main path calls it): for each (row, kv head, row group) the live
    pages (up to the group's largest position, never past the row's position
    at new_lens - 1), cut into ``splits`` spans of ``span`` pages (ceil(P /
    splits) by default; those past the live pages empty); in each
    span ``SPLIT_WARPS`` warps take the ``SPLIT_CHUNK``-token chunks w, w +
    SPLIT_WARPS, ... with their own online softmax (m, l, acc); the warps'
    partials, then the splits', merged in order (``_merge_partials``); out =
    acc / l, 0 where no key was visible. q is scaled by ``hd**-0.5`` and
    rounded in q's dtype, a quantised pool dequantised and rounded to q's
    dtype, ALiBi added as ``slope * (t - p)``, all as the kernel does; fp32
    throughout otherwise. Returns fp32 ``[N, C, H, hd]``."""
    N, C, H, hd = q.shape
    kvH, P, bs = pool_k_l.shape[1], block_tables.shape[1], block_size
    G, R = H // kvH, C * (H // kvH)
    span = span or -(-P // splits)
    qs = (q.float() * _q_scale(hd, q.dtype)).to(q.dtype).float()
    bt, qpos, lens = block_tables.long(), q_positions.long(), new_lens.long()
    rows = split_rows(R)
    out = torch.zeros(N, C, H, hd)

    def pool_rows(pool, scale, slots, kh):
        x = pool[slots, kh].float()
        return x if scale is None else (x * scale[slots, kh]).to(q.dtype).float()

    for n in range(N):
        row_max = int(qpos[n, min(max(int(lens[n]) - 1, 0), C - 1)])
        for kh in range(kvH):
            for r0 in range(0, R, rows):
                rr = torch.arange(r0, min(r0 + rows, R))
                c, g = rr // G, rr % G
                pos = qpos[n, c]
                qr = qs[n, c, kh * G + g]
                slope = None if alibi_slopes is None else alibi_slopes.float()[kh * G + g]
                n_pages = _live_pages(int(pos.max()), row_max, bs, P)
                parts = []
                for s in range(splits):
                    t_lo, t_hi = s * span * bs, min(s * span + span, n_pages) * bs
                    if t_lo >= t_hi:
                        parts.append(None)
                        continue
                    n_chunks = -(-(t_hi - t_lo) // SPLIT_CHUNK)
                    warps = []
                    for w in range(SPLIT_WARPS):
                        m = torch.full((len(rr),), -math.inf)
                        l, acc = torch.zeros(len(rr)), torch.zeros(len(rr), hd)
                        for ci in range(w, n_chunks, SPLIT_WARPS):
                            t0 = t_lo + ci * SPLIT_CHUNK
                            toks = torch.arange(t0, min(t0 + SPLIT_CHUNK, t_hi))
                            slots = bt[n, toks // bs] * bs + toks % bs
                            sc = qr @ pool_rows(pool_k_l, k_scale, slots, kh).T
                            if slope is not None:
                                sc = sc + slope[:, None] * (toks[None, :] - pos[:, None]).float()
                            sc = torch.where(toks[None, :] <= pos[:, None], sc,
                                             torch.full((), -math.inf))
                            m_new = torch.maximum(m, sc.max(1).values)
                            m_safe = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
                            alpha = torch.where(m == -math.inf, torch.zeros(()), torch.exp(m - m_safe))
                            p = torch.exp(sc - m_safe[:, None])
                            l = alpha * l + p.sum(1)
                            acc = alpha[:, None] * acc + p @ pool_rows(pool_v_l, v_scale, slots, kh)
                            m = m_new
                        warps.append((m, l, acc))
                    parts.append(_merge_partials(warps, len(rr), hd))
                _, L, acc = _merge_partials(parts, len(rr), hd)
                out[n, c, kh * G + g] = acc / torch.where(L == 0, torch.ones(()), L)[:, None]
    return out


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


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> int32 ticket counters of forms "split" and W: made
# zero on the stream that launches on them, grown when a launch needs more,
# and left at zero by every launch (the block that merges a unit resets it)
_TICKETS = {}


def _tickets(device: torch.device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _launch(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size, new_lens, k_scale,
            v_scale, alibi_slopes, form: str, splits: Optional[int] = None) -> torch.Tensor:
    """Launch ``form`` of the kernel (checked inputs on a CUDA device) and
    count it: the wrapper's ``launches`` (or ``paged_attention.alibi_launches``
    with ALiBi) and ``launches_by_form``. ``splits`` overrides the plan of
    forms "split" and W (the tests' 1, 2 and many splits)."""
    N, C, H, hd = q.shape
    kvH, P = pool_k_l.shape[1], block_tables.shape[1]
    R = C * (H // kvH)
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if form == "simt":
        splits, span, units, cap = 1, P, 0, 0
    else:
        if splits is not None:
            splits, span = _split_span(P, splits)
        elif form == "split":
            tensor_cores = q.dtype == torch.bfloat16 and k_scale is None and split_rows(R) <= 4
            splits, span = split_plan(N, kvH, P, _num_sms(index), tensor_cores)
        else:
            splits, span = w_plan(N, kvH, R, P, block_size, _num_sms(index))
        cap = split_rows(R) if form == "split" else W_TILE_ROWS
        units = N * kvH * -(-R // cap)
    stream = torch.cuda.current_stream(q.device)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(units * splits * cap * (hd + 2), dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, units)
    out = torch.empty_like(q)
    lib = op_builder.load("paged_attention")
    tail = (N, C, H, kvH, hd, P, block_size, ctypes.c_float(_q_scale(hd, q.dtype)),
            op_builder.DTYPE_CODES[q.dtype])
    plan = (PAGED_FORMS[form], splits, span, _ptr(ws), _ptr(tickets), pool_k_l.shape[0],
            stream.cuda_stream)
    if k_scale is None:
        wrapper = paged_attention
        err = lib.ds_paged_attention(
            q.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr(), _ptr(alibi_slopes),
            block_tables.data_ptr(), q_positions.data_ptr(), new_lens.data_ptr(), out.data_ptr(),
            *tail, *plan)
    else:
        wrapper = paged_attention_quant
        err = lib.ds_paged_attention_quant(
            q.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), _ptr(alibi_slopes), block_tables.data_ptr(),
            q_positions.data_ptr(), new_lens.data_ptr(), out.data_ptr(), *tail,
            QUANT_KV_CODES[pool_k_l.dtype], *plan)
    if err:
        raise RuntimeError(f"paged_attention kernel (form {form!r}) launch failed: cudaError {err}")
    if alibi_slopes is not None:
        paged_attention.alibi_launches += 1
    else:
        wrapper.launches += 1
    wrapper.launches_by_form[form] += 1
    return out


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
    raises instead of returning an output with no gradient. On a CUDA
    tensor it launches the form ``paged_form`` picks."""
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
    form = paged_form(q.dtype, hd, C, H // pool_k_l.shape[1], block_size)
    return _launch(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size, new_lens,
                   None, None, alibi_slopes, form)


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
    form = paged_form(q.dtype, hd, C, H // pool_k_l.shape[1], block_size)
    return _launch(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size, new_lens,
                   k_scale, v_scale, alibi_slopes, form)


def _paged_attention_form(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size,
                          new_lens, form: str, k_scale=None, v_scale=None, alibi_slopes=None,
                          splits: Optional[int] = None) -> torch.Tensor:
    """The kernel through the named ``form``, whatever ``paged_form`` would
    choose (and, for forms "split" and W, ``splits`` in place of the plan):
    counted as the wrappers count. A form is a kernel: a CPU tensor, a form
    that does not take the dtype or ``block_size``, and an unknown form raise
    ``ValueError``; the plain version is never run."""
    if form not in PAGED_FORMS:
        raise ValueError(f"paged_attention: unknown form {form!r}; forms are {sorted(PAGED_FORMS)}")
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: form {form!r} is a kernel; {q.device} tensor given")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both k_scale and v_scale, or neither")
    _refuse_grad(q, pool_k_l, pool_v_l, k_scale, v_scale)
    _check(q, pool_k_l, pool_v_l, block_tables, q_positions, new_lens, k_scale, v_scale,
           alibi_slopes)
    if not form_takes(form, q.dtype, q.shape[3], block_size):
        raise ValueError(f"paged_attention: form {form!r} does not take {q.dtype} q with "
                         f"block_size {block_size}")
    return _launch(q, pool_k_l, pool_v_l, block_tables, q_positions, block_size, new_lens,
                   k_scale, v_scale, alibi_slopes, form, splits)


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
paged_attention.launches_by_form = dict.fromkeys(PAGED_FORMS, 0)
paged_attention_quant.launches_by_form = dict.fromkeys(PAGED_FORMS, 0)
