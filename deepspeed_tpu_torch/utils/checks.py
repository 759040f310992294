"""Inputs and error metric shared by the kernel checks (``chip_smoke.py`` and
``tests/test_torch_kernels.py``), so that both hold a kernel to its plain
version by the same rule."""

from __future__ import annotations

import numpy as np
import torch

from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_plain

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


def check_grouped_matmul(lhs, rhs, group_sizes):
    """The grouped_matmul kernel against its plain version on the same
    inputs, by ``GMM_TOL``; rows past the sizes' sum must be exactly 0.
    Returns (ok, max abs error, largest error as a share of its bound)."""
    got = grouped_matmul(lhs, rhs, group_sizes)
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
    B, S = q.shape[:2]
    # a query row sees a key iff some key j <= i is kept
    kept = torch.ones(B, S, dtype=torch.int32, device=q.device) if keep is None else keep
    live = kept.cumsum(1) > 0  # [B, S]
    err = (lse - want_lse).abs().transpose(1, 2)[live]
    scale = want_lse.abs().clamp_min(10.0).transpose(1, 2)[live]
    if slopes is not None:
        err = err / scale
    lse_err = float(err.max()) if err.numel() else 0.0
    dead, dropped = ~live, kept == 0
    dead_exact = (bool((out[dead] == 0).all()) and bool((dq[dead] == 0).all())
                  and bool((lse.transpose(1, 2)[dead] == fa.NEG_INF).all())
                  and bool((dk[dropped] == 0).all()) and bool((dv[dropped] == 0).all()))
    return readings, lse_err, dead_exact


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
