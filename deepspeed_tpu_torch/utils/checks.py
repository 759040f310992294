"""Inputs and error metric shared by the kernel checks (``chip_smoke.py`` and
``tests/test_torch_kernels.py``), so that both hold a kernel to its plain
version by the same rule."""

from __future__ import annotations

import contextlib
from typing import Sequence
from unittest import mock

import numpy as np
import torch

from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.grouped_matmul import (
    _grouped_matmul_form,
    grouped_matmul,
    grouped_matmul_plain,
)

# Bound on the ALiBi form's lse error as a share of max(|lse|, 10): past a
# keep-mask's end the bias moves a row's lse to ~10^2-10^3, where one fp32 ulp
# (6e-5 at 10^3) is more than an absolute bound of 1e-5 allows. 1e-6 is about
# 8 ulps there, and 1e-5 absolute where |lse| <= 10.
LSE_ALIBI_REL = 1e-6

# grouped_matmul kernel vs plain version, (rtol, atol) per element, atol as a
# share of the output's RMS: |got - want| <= rtol |want| + atol rms(want).
# bf16: both sum exact bf16 products in fp32, in another order, and round once
# to bf16, so they differ by at most one output ulp (<= 2**-7 relative) where
# the fp32 sums straddle a rounding point. fp32 (TF32 off): summation order
# only, but the kernel sums each output's K products in one sequential fp32
# chain, whose rounding error grows as sqrt(K) eps, where cuBLAS sums in a
# tree: the first H100 run read 1.9e-5 of the RMS at K = 4096 and 3.5e-5 at
# K = 14336, so the RMS share is 1e-4.
GMM_TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-5, 1e-4)}
# a skewed set of group sizes: one group with half the rows, an empty one, a
# single row, m = 4099 not a multiple of 8
GMM_SKEWED_SIZES = (2050, 0, 1, 700, 500, 400, 300, 148)


def routed_group_sizes(tokens: int, experts: int = 8, top_k: int = 2, hidden: int = 4096,
                       seed: int = 0) -> tuple:
    """Rows per expert of real top-k routing (numpy): ``tokens`` random
    tokens through a random ``[hidden, experts]`` gate, softmax, top-k."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens, hidden), dtype=np.float32)
    logits = x @ (rng.standard_normal((hidden, experts), dtype=np.float32) * hidden ** -0.5)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :top_k]
    return tuple(int(n) for n in np.bincount(top.reshape(-1), minlength=experts))


def grouped_inputs(dev, sizes, K: int, N: int, dtype: torch.dtype, rows=None, seed: int = 0):
    """lhs ``[rows, K]`` (rows defaults to the sizes' sum) normal, rhs
    ``[E, K, N]`` normal at std ``K**-0.5`` (a model's fan-in scale), made on
    ``dev`` from a ``torch.Generator``, and group_sizes int32 ``[E]``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m = sum(sizes) if rows is None else rows
    lhs = torch.randn(m, K, generator=gen, device=dev, dtype=dtype)
    rhs = torch.randn(len(sizes), K, N, generator=gen, device=dev, dtype=dtype) * K ** -0.5
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


def check_grouped_matmul(lhs, rhs, group_sizes, form=None):
    """The grouped_matmul kernel (the form the wrapper picks, or ``form``)
    against its plain version on the same inputs, by ``GMM_TOL``; rows past
    the sizes' sum must be exactly 0. Returns (ok, max abs error, largest
    error as a share of its bound)."""
    if form is None:
        got = grouped_matmul(lhs, rhs, group_sizes)
    else:
        got = _grouped_matmul_form(lhs, rhs, group_sizes, form)
    if lhs.is_cuda:
        torch.cuda.synchronize(lhs.device)
    want = grouped_matmul_plain(lhs, rhs, group_sizes)
    covered = int(group_sizes.clamp_min(0).sum())
    if (got.shape != want.shape or got.dtype != lhs.dtype or not bool(torch.isfinite(got).all())
            or not bool((got[covered:] == 0).all())):
        return False, float("inf"), float("inf")
    rtol, atol = GMM_TOL[lhs.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = rtol * w.abs() + atol * float(w.square().mean().sqrt())
    share = float((err / bound.clamp_min(1e-30)).max()) if err.numel() else 0.0
    return share <= 1.0, float(err.max()) if err.numel() else 0.0, share


def row_rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative L2 error of a row vector (last dim). A row's norm is
    floored at 1e-3 of the tensor's RMS row norm: some rows are zero up to
    rounding by cancellation (dq of query 0, which sees only key 0, is
    p * (dO.v0 - dO.o) with o = v0), and their relative error means nothing."""
    g, w = got.float(), want.float()
    wn = w.norm(dim=-1)
    floor = max(1e-3 * float(wn.square().mean().sqrt()), 1e-30)
    return float(((g - w).norm(dim=-1) / wn.clamp_min(floor)).max())


def flash_inputs(dev, B, S, H, kvH, hd, keep_lens=None, seed=0):
    """fp32 q, k, v, dO ``[B, S, heads, hd]`` on ``dev`` from a numpy seed, and
    an int32 right-padding keep-mask ``[B, S]`` (keys past each row's length
    dropped), or None."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    q, k, v, do = t(B, S, H, hd), t(B, S, kvH, hd), t(B, S, kvH, hd), t(B, S, H, hd)
    keep = None
    if keep_lens is not None:
        keep = torch.from_numpy(
            (np.arange(S)[None, :] < np.asarray(keep_lens)[:, None]).astype(np.int32)).to(dev)
    return q, k, v, do, keep


def check_flash_kernels(q, k, v, do, keep=None, slopes=None):
    """The three flash kernels against their plain versions on the same
    inputs (``flash_inputs``'s, q unscaled; ``slopes`` fp32 ``[H]`` times
    log2(e) for the ALiBi form; the plain dq and dkv take the kernel's lse and
    delta, so each kernel is held alone). Returns ``({name: (row rel L2, max
    abs)}`` for out, dq, dk, dv; the lse's largest error over rows with a
    visible key, absolute, or with ``slopes`` as a share of ``max(|lse|, 10)``
    (the measure ``LSE_ALIBI_REL`` bounds); whether every
    row with none has output 0, dq 0 and the lse sentinel, and every key the
    keep-mask drops dk and dv 0)``."""
    qs = fa.prescale_q(q)
    out, lse = fa.flash_fwd(qs, k, v, keep, slopes)
    delta = fa.flash_delta(do, out)
    dq = fa.flash_bwd_dq(qs, k, v, keep, do, lse, delta, slopes)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, keep, do, lse, delta, slopes)
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    want_out, want_lse = fa.flash_fwd_reference(qs, k, v, keep, slopes)
    want_dq = fa.flash_bwd_dq_reference(qs, k, v, keep, do, lse, delta, slopes)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(qs, k, v, keep, do, lse, delta, slopes)
    readings = {}
    for name, got, want in (("out", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        ok = bool(torch.isfinite(got).all()) and got.dtype == q.dtype and got.shape == want.shape
        readings[name] = (row_rel_l2(got, want) if ok else float("inf"),
                          float((got.float() - want.float()).abs().max()))
    lse_err, live, kept = _lse_error(q, keep, slopes, lse, want_lse)
    dead, dropped = ~live, kept == 0
    dead_exact = (bool((out[dead] == 0).all()) and bool((dq[dead] == 0).all())
                  and bool((lse.transpose(1, 2)[dead] == fa.NEG_INF).all())
                  and bool((dk[dropped] == 0).all()) and bool((dv[dropped] == 0).all()))
    return readings, lse_err, dead_exact


def _lse_error(q, keep, slopes, lse, want_lse):
    """The lse's largest error over rows with a visible key (absolute, or
    with ``slopes`` as a share of ``max(|lse|, 10)``), the ``[B, S]`` mask
    of those rows, and the keep-mask (all ones where there is none)."""
    B, S = q.shape[:2]
    # a query row sees a key iff some key j <= i is kept
    kept = torch.ones(B, S, dtype=torch.int32, device=q.device) if keep is None else keep
    live = kept.cumsum(1) > 0  # [B, S]
    err = (lse - want_lse).abs().transpose(1, 2)[live]
    if slopes is not None:
        err = err / want_lse.abs().clamp_min(10.0).transpose(1, 2)[live]
    return (float(err.max()) if err.numel() else 0.0), live, kept


def check_flash_fwd(q, k, v, keep=None, slopes=None, form=None):
    """The forward kernel alone (the form ``flash_fwd`` picks, or ``form``
    through ``_flash_fwd_form``) against its plain version
    on the same inputs, as ``check_flash_kernels`` holds it. Returns (out's
    row rel L2, its max abs error, the lse error, whether every row with no
    visible key has output 0 and the lse sentinel, the output)."""
    qs = fa.prescale_q(q)
    if form is None:
        out, lse = fa.flash_fwd(qs, k, v, keep, slopes)
    else:
        out, lse = fa._flash_fwd_form(qs, k, v, keep, slopes, form)
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    want, want_lse = fa.flash_fwd_reference(qs, k, v, keep, slopes)
    ok = bool(torch.isfinite(out).all()) and out.dtype == q.dtype and out.shape == want.shape
    rel = row_rel_l2(out, want) if ok else float("inf")
    lse_err, live, _ = _lse_error(q, keep, slopes, lse, want_lse)
    dead = ~live
    dead_exact = (bool((out[dead] == 0).all())
                  and bool((lse.transpose(1, 2)[dead] == fa.NEG_INF).all()))
    return rel, float((out.float() - want.float()).abs().max()), lse_err, dead_exact, out


def check_flash_bwd(q, k, v, do, keep=None, slopes=None, form=None):
    """The backward alone (the form ``flash_bwd`` picks, or ``form`` through
    ``_flash_bwd_form``) against its plain version on the same inputs, lse
    and delta (the forward's, by the form ``flash_fwd`` picks). Returns
    (``{name: (row rel L2, max abs)}`` for dq, dk, dv; whether every query
    row with no visible key has dq 0 and every key the keep-mask drops dk and
    dv 0; the outputs ``(dq, dk, dv)``)."""
    qs = fa.prescale_q(q)
    out, lse = fa.flash_fwd(qs, k, v, keep, slopes)
    delta = fa.flash_delta(do, out)
    if form is None:
        got = fa.flash_bwd(qs, k, v, keep, do, lse, delta, slopes)
    else:
        got = fa._flash_bwd_form(qs, k, v, keep, do, lse, delta, slopes, form)
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    want = fa.flash_bwd_reference(qs, k, v, keep, do, lse, delta, slopes)
    readings = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        ok = bool(torch.isfinite(g).all()) and g.dtype == q.dtype and g.shape == w.shape
        readings[name] = (row_rel_l2(g, w) if ok else float("inf"),
                          float((g.float() - w.float()).abs().max()))
    B, S = q.shape[:2]
    kept = torch.ones(B, S, dtype=torch.int32, device=q.device) if keep is None else keep
    dead, dropped = kept.cumsum(1) == 0, kept == 0
    dq, dk, dv = got
    dead_exact = (bool((dq[dead] == 0).all()) and bool((dk[dropped] == 0).all())
                  and bool((dv[dropped] == 0).all()))
    return readings, dead_exact, got


def check_sparse_kernels(q, k, v, do, layout, block, causal):
    """The three block-sparse kernels against their plain versions on the same
    inputs (q, dO ``[B, S, H, D]`` and k, v ``[B, S, Hkv, D]`` as
    ``flash_inputs`` gives them; q unscaled; the plain dq and dkv take the
    kernel's lse and delta, so each kernel is held alone). Returns ``({name: (row rel L2, max abs)}
    for out, dq, dk, dv; the lse's max abs error over rows with a live key;
    whether every row with none has output 0, dq 0 and the lse sentinel)``."""
    qs = bs.prescale_q(q)
    cols, ncols, rows, nrows = bs.layout_arrays(layout, q.device)
    out, lse = bs.sparse_fwd(qs, k, v, cols, ncols, block, causal)
    delta = bs.sparse_delta(do, out)
    dq = bs.sparse_bwd_dq(qs, k, v, do, lse, delta, cols, ncols, block, causal)
    dk, dv = bs.sparse_bwd_dkv(qs, k, v, do, lse, delta, rows, nrows, block, causal)
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    want_out, want_lse = bs.sparse_fwd_reference(qs, k, v, cols, ncols, block, causal)
    want_dq = bs.sparse_bwd_dq_reference(qs, k, v, do, lse, delta, cols, ncols, block, causal)
    want_dk, want_dv = bs.sparse_bwd_dkv_reference(qs, k, v, do, lse, delta, rows, nrows,
                                                   block, causal)
    readings = {}
    for name, got, want in (("out", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        finite = bool(torch.isfinite(got).all())
        readings[name] = (row_rel_l2(got, want) if finite else float("inf"),
                          float((got.float() - want.float()).abs().max()))
    live = want_lse != bs.NEG_INF
    lse_err = float((lse - want_lse).abs()[live].max()) if bool(live.any()) else 0.0
    dead = ~live  # [B, H, S]
    dead_exact = (bool((out.transpose(1, 2)[dead] == 0).all())
                  and bool((dq.transpose(1, 2)[dead] == 0).all())
                  and bool((lse[dead] == bs.NEG_INF).all()))
    return readings, lse_err, dead_exact


@contextlib.contextmanager
def plain_collective_kernels():
    """Inside: the collectives' kernel wrappers, the hop kernels (rows 12 and
    13), the fused GEMM hops (rows 14 and 15) and the int8 quantisers the
    int8 wire calls (rows 7 and 8), replaced by their plain versions on every
    device, so that one collective can be run through the kernels and
    through the plain versions on the card."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg
    from deepspeed_tpu_torch.collectives import pallas_backend as pb
    from deepspeed_tpu_torch.ops import quant

    def quantize(x, block_size=quant.DEFAULT_BLOCK, stochastic=False, seed=0, impl="auto"):
        return quant.quantize_int8_reference(x, block_size)

    def dequantize(values, scales, shape, dtype=torch.bfloat16, block_size=quant.DEFAULT_BLOCK,
                   impl="auto"):
        return quant.dequantize_int8_reference(values, scales, shape, dtype, block_size)

    with mock.patch.multiple(pb, permute_leaves=pb.permute_leaves_plain,
                             fused_hop=pb.fused_hop_plain), \
            mock.patch.multiple(fg, ag_hop=fg.ag_hop_plain, rs_hop=fg.rs_hop_plain), \
            mock.patch.multiple(quant, quantize_int8=quantize, dequantize_int8=dequantize):
        yield


def bits_differ(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> int:
    """How many elements of two rank lists differ in their bytes (0: equal bit
    for bit; NaNs equal where their bits are)."""
    diff = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return max(g.numel(), w.numel())
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[g.element_size()]
        diff += int((g.contiguous().view(view) != w.contiguous().view(view)).sum())
    return diff


def fused_gemm_close(got: torch.Tensor, want: torch.Tensor, K: int):
    """Rows 14-15 against their plain versions: fp32 products of K terms in
    another order (the kernel: one FMA chain over K; cuBLAS: its own). Each
    element within 1e-5 relative and 1e-6 x sqrt(K) of the largest |want|.
    Returns (max abs error, ok)."""
    err = (got - want).abs()
    atol = 1e-6 * max(float(want.abs().max()), 1.0) * K ** 0.5
    return float(err.max()), bool((err <= atol + 1e-5 * want.abs()).all())


def fused_gemm_match(got: torch.Tensor, want: torch.Tensor, K: int):
    """``fused_gemm_close`` where ``want`` may hold inf or NaN: ``got`` has
    NaN where ``want`` has, the same signed inf where ``want`` has one, and
    is finite and within ``fused_gemm_close`` elsewhere. Returns (max abs
    error of the finite elements, ok)."""
    fin = torch.isfinite(want)
    inf = torch.isinf(want)
    same = (torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(got[inf], want[inf])
            and bool(torch.isfinite(got[fin]).all()))
    if not bool(fin.any()):
        return 0.0, same
    err, ok = fused_gemm_close(got[fin], want[fin], K)
    return err, ok and same


def block_wire(kind: str, values: torch.Tensor, qb: int):
    """A wire slot holding ``values``: the fp32 tensor itself for ``"none"``,
    else int8 / e4m3 codes and fp32 scales over flat blocks of ``qb``, by the
    plain block math."""
    from deepspeed_tpu_torch.collectives import pallas_backend as pb

    if kind == "none":
        return (values,)
    q = torch.empty(values.numel(), dtype=pb.WIRE_DTYPES[kind], device=values.device)
    s = torch.empty(values.numel() // qb, device=values.device)
    pb.fused_hop_plain(None, None, None, values.reshape(-1), q, s, qb=qb)
    return q, s


def fused_gemm_qb(kind: str, rows: int, cols: int, block_size=None) -> int:
    """The qb of a fused GEMM hop of ``rows`` x ``cols`` (JAX's chunk geometry)."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    c = fg._resolve_codec(None if kind == "none" else kind, block_size)
    return fg._wire_math(c, (rows // fg._chunks_of(rows)) * cols)[1]

