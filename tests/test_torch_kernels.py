"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only PyTorch is installed,
the GPU machine included:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX). The ``cuda``-marked
tests build the kernels with nvcc and compare on the card; they skip without
one. The others check, on the CPU, that a CPU tensor takes the plain version
and launches nothing. Tolerances: rms_norm 1e-5 fp32 / 1e-2 bf16 (one output
ulp); paged_attention 2e-5 fp32 / 2e-2 bf16 per element (q scaled in bf16
by the kernel, scores and p rounded to bf16 by the plain version), and a
relative L2 error of each query's output vector of at most 1e-4 fp32 / 2e-2
bf16, which holds a long row's small outputs as tightly as a short row's.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _norm_inputs(rows, dim=4096, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, dim)).astype(np.float32) * 3,
            (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32))


def _paged_inputs(C, H=32, kvH=8, hd=128, bs=16, pad_row=False, garbage=False, seed=0,
                  ends=(44, 59, 89), P=8):
    """3 rows ending at positions ``ends`` with C new tokens each (row 1 a
    pad row with ``pad_row``); with ``garbage`` the block-table tails point
    at pages of +-1e4."""
    rng = np.random.default_rng(seed)
    N = 3
    NB = max(64, N * P + 8)
    q = rng.standard_normal((N, C, H, hd)).astype(np.float32)
    pk = rng.standard_normal((NB * bs + 1, kvH, hd)).astype(np.float32)
    pv = rng.standard_normal((NB * bs + 1, kvH, hd)).astype(np.float32)
    bt = (rng.permutation(NB - 8)[: N * P].reshape(N, P) + 8).astype(np.int32)
    ends = np.asarray(ends)
    pos = np.stack([np.arange(C) + e - C + 1 for e in ends]).astype(np.int32)
    lens = np.full((N,), C, np.int32)
    if garbage:
        pk[: 8 * bs], pv[: 8 * bs] = 1e4, -1e4
        for n, e in enumerate(ends):
            bt[n, e // bs + 1:] = rng.integers(0, 8, P - e // bs - 1)
    if pad_row:
        lens[1], pos[1], bt[1] = 0, 0, 0
    return q, pk, pv, bt, pos, lens, bs


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 300, 8 * 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_plain(cuda_device, rows, dtype):
    x, scale = _norm_inputs(rows)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    st = torch.from_numpy(scale).to(cuda_device, dtype)
    before = rms_norm.launches
    got = rms_norm(xt, st)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), rms_norm_reference(xt, st).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode", "long", "prefill", "pad_row", "garbage", "hd64"])
def test_paged_kernel_matches_plain(cuda_device, case, dtype):
    kw = {"decode": dict(C=1), "long": dict(C=1, ends=(200, 639, 999), P=64),
          "prefill": dict(C=40), "pad_row": dict(C=4, pad_row=True),
          "garbage": dict(C=4, garbage=True), "hd64": dict(C=5, H=8, kvH=2, hd=64)}[case]
    *arrays, bs = _paged_inputs(**kw)
    q, pk, pv, bt, pos, lens = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    q, pk, pv = q.to(dtype), pk.to(dtype), pv.to(dtype)
    before = paged_attention.launches
    got = paged_attention(q, pk, pv, bt, pos, bs, new_lens=lens)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_reference(q, pk, pv, bt, pos, bs, new_lens=lens).float()
    tol, rel_l2 = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= rel_l2, float(rel.max())


@pytest.mark.cuda
def test_paged_kernel_rejects_bad_inputs(cuda_device):
    *arrays, bs = _paged_inputs(C=1)
    q, pk, pv, bt, pos, lens = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    with pytest.raises(TypeError):
        paged_attention(q, pk, pv, bt.long(), pos, bs, new_lens=lens)
    with pytest.raises(ValueError):
        paged_attention(q[..., :96].contiguous(), pk[..., :96].contiguous(),
                        pv[..., :96].contiguous(), bt, pos, bs, new_lens=lens)


def test_cpu_tensors_take_the_plain_versions():
    x, scale = _norm_inputs(5, dim=64)
    before = rms_norm.launches
    torch.testing.assert_close(rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
                               rms_norm_reference(torch.from_numpy(x), torch.from_numpy(scale)))
    assert rms_norm.launches == before
    *arrays, bs = _paged_inputs(C=2, H=8, kvH=2, hd=64, pad_row=True)
    t = [torch.from_numpy(a) for a in arrays]
    before = paged_attention.launches
    torch.testing.assert_close(paged_attention(*t[:5], bs, new_lens=t[5]),
                               paged_attention_reference(*t[:5], bs, t[5]))
    assert paged_attention.launches == before
