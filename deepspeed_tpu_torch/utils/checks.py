"""Inputs and error metric shared by the kernel checks (``chip_smoke.py`` and
``tests/test_torch_kernels.py``), so that both hold a kernel to its plain
version by the same rule."""

from __future__ import annotations

import numpy as np
import torch


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
