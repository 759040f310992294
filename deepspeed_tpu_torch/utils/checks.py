"""Inputs and error metric shared by the kernel checks (``chip_smoke.py`` and
``tests/test_torch_kernels.py``), so that both hold a kernel to its plain
version by the same rule."""

from __future__ import annotations

import numpy as np
import torch

from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops import flash_attention as fa

# Bound on the ALiBi form's lse error as a share of max(|lse|, 10): past a
# keep-mask's end the bias moves a row's lse to ~10^2-10^3, where one fp32 ulp
# (6e-5 at 10^3) is more than an absolute bound of 1e-5 allows. 1e-6 is about
# 8 ulps there, and 1e-5 absolute where |lse| <= 10.
LSE_ALIBI_REL = 1e-6

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
