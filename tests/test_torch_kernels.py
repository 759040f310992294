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
bf16, which holds a long row's small outputs as tightly as a short row's;
the same limits hold the ALiBi form over every pool type, at G = 1 (Bloom's
MHA) and G = 4, pad rows (``new_lens`` 0) included.
The three flash-attention kernels are held to their plain versions by the
relative L2 error of each (b, s, h) row vector of out, dq, dk and dv (1e-5
fp32: summation order only; 2e-2 bf16: P and dS are rounded to bf16 before
their products, in another order than the plain version's), with each row's
norm floored at 1e-3 of the RMS row norm (rows that cancel to ~0), and lse by
1e-4 absolute (fp32 scores from the same operands in both). Rows with no
visible key must be exactly 0. Their ALiBi form (Bloom's slopes times
log2(e)) is held to the same limits at G = 1 and G = 4, hd 64 and 128, S not
a multiple of the 64-row tile and a keep-mask with a keyless row, except lse:
the bias moves it to ~10^2-10^3 past a keep-mask's end, where an fp32 ulp
passes 1e-5, so its error is held to 1e-6 of max(|lse|, 10) (about 8 ulps);
ALiBi launches count in ``alibi_launches`` only. The quantiser kernels (int8 nearest and
stochastic, dequantisation) must equal their plain versions bit for bit:
both divide and round in IEEE fp32 and hash the same counters. The
quantised paged kernel (int8 and e4m3 pools) is held to the limits of the
bf16/fp32 one. The three block-sparse kernels (forward, dq, dkv) are held to
their plain versions by the flash kernels' rule and limits, over blocks 16,
32 and 64, D 64 and 128, causal and not, k and v at fewer heads than q or as
many, and a layout with empty block rows (output, dq and the lse sentinel
exact there). The grouped GEMM (``csrc/grouped_gemm.cu``) is held by
``utils.checks.check_grouped_matmul`` (``GMM_TOL``: bf16 rtol 1e-2, one
output ulp, and 1e-3 of the output's RMS; fp32 1e-5 and 1e-4 of the RMS, as
the kernel sums K products in one sequential chain) on group sizes from real
top-2 routing, a skewed set (half the rows in one group, an
empty group, a single row, m not a multiple of 8) and K and N that are not
multiples of 8 with rows past the sizes' sum (which must be 0).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_quant,
    paged_attention_reference,
)
from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention import get_sparsity_config
from deepspeed_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_plain
from deepspeed_tpu_torch.utils.checks import (
    GMM_SKEWED_SIZES,
    LSE_ALIBI_REL,
    check_flash_kernels,
    check_grouped_matmul,
    check_sparse_kernels,
    flash_inputs,
    grouped_inputs,
    routed_group_sizes,
    row_rel_l2,
)


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


def _quantised_pool(pk, pv, kv):
    """Codes and [S_flat, kvH, 1] fp32 scales of pools pk, pv (head-vector
    blocks, the serving pool's layout)."""
    from deepspeed_tpu_torch.inference.paged import _kv_block_quant

    return (*_kv_block_quant(pk, kv), *_kv_block_quant(pv, kv))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode", "long", "prefill", "pad_row", "garbage", "hd64"])
def test_paged_quant_kernel_matches_plain(cuda_device, case, dtype, kv):
    kw = {"decode": dict(C=1), "long": dict(C=1, ends=(200, 639, 999), P=64),
          "prefill": dict(C=40), "pad_row": dict(C=4, pad_row=True),
          "garbage": dict(C=4, garbage=True), "hd64": dict(C=5, H=8, kvH=2, hd=64)}[case]
    *arrays, bs = _paged_inputs(**kw)
    q, pk, pv, bt, pos, lens = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    kq, ks, vq, vs = _quantised_pool(pk, pv, kv)
    q = q.to(dtype)
    before = paged_attention_quant.launches
    got = paged_attention(q, kq, vq, bt, pos, bs, new_lens=lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_attention_quant.launches == before + 1
    want = paged_attention_reference(q, kq, vq, bt, pos, bs, lens, ks, vs).float()
    tol, rel_l2 = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= rel_l2, float(rel.max())


ALIBI_CASES = {
    # Bloom's MHA (G = 1): one live row of a 16-row decode tile
    "decode G=1": dict(C=1, H=32, kvH=32),
    "long G=1, pad row": dict(C=1, H=32, kvH=32, ends=(200, 639, 999), P=64, pad_row=True),
    "prefill G=1": dict(C=40, H=32, kvH=32),
    "pad_row G=1": dict(C=4, H=32, kvH=32, pad_row=True),
    "garbage G=1": dict(C=4, H=32, kvH=32, garbage=True),
    # GQA (G = 4): the slope of row (c, g) of kv head kh is slope[kh * 4 + g]
    "long G=4": dict(C=1, ends=(200, 639, 999), P=64),
    "prefill G=4, pad row": dict(C=40, pad_row=True),
    "hd64 G=4": dict(C=5, H=8, kvH=2, hd=64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ALIBI_CASES))
def test_paged_alibi_kernel_matches_plain(cuda_device, case, dtype, kv):
    """The ALiBi form over a pool of q's dtype (fp32 or bf16) and over int8
    and e4m3 pools, at G = 1 and G = 4, held to the limits of the forms
    without ALiBi; it counts in ``paged_attention.alibi_launches`` only."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    kw = ALIBI_CASES[case]
    *arrays, bs = _paged_inputs(**kw)
    q, pk, pv, bt, pos, lens = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    q = q.to(dtype)
    pools = dict(pool_k_l=pk.to(dtype), pool_v_l=pv.to(dtype))
    if kv is not None:
        kq, ks, vq, vs = _quantised_pool(pk, pv, kv)
        pools = dict(pool_k_l=kq, pool_v_l=vq, k_scale=ks, v_scale=vs)
    slopes = alibi_slopes(q.shape[2], cuda_device)
    before = (paged_attention.alibi_launches, paged_attention.launches,
              paged_attention_quant.launches)
    got = paged_attention(q, block_tables=bt, q_positions=pos, block_size=bs, new_lens=lens,
                          alibi_slopes=slopes, **pools)
    torch.cuda.synchronize()
    assert (paged_attention.alibi_launches, paged_attention.launches,
            paged_attention_quant.launches) == (before[0] + 1, *before[1:])
    want = paged_attention_reference(q, block_tables=bt, q_positions=pos, block_size=bs,
                                     new_lens=lens, alibi_slopes=slopes, **pools).float()
    tol, rel_l2 = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= rel_l2, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048 * 37 + 123, 2048 * 6, 100, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizer_kernels_equal_plain(cuda_device, dtype, n):
    """Codes and scales bit for bit, nearest and stochastic; dequantisation
    to fp32 and bf16 bit for bit; an all-zero block; a misaligned start
    (the scalar path)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(n + 3, generator=g, device=cuda_device) * 3).to(dtype)
    if n > 4096:
        x[2048:4096] = 0
    for xs in (x[:n], x[3:]):  # x[3:] starts off 16-byte alignment
        before = (quant.quantize_int8.launches, quant.quantize_int8_stochastic.launches)
        q, s = quant.quantize_int8(xs)
        sq, ss = quant.quantize_int8(xs, stochastic=True, seed=11)
        torch.cuda.synchronize()
        assert (quant.quantize_int8.launches, quant.quantize_int8_stochastic.launches) == \
            (before[0] + 1, before[1] + 1)
        rq, rs = quant.quantize_int8_reference(xs)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        rsq, rss = quant.quantize_int8_stochastic_reference(xs, seed=11)
        assert torch.equal(sq, rsq) and torch.equal(ss, rss)
        for out in (torch.float32, torch.bfloat16):
            got = quant.dequantize_int8(q, s, (xs.numel(),), out)
            assert torch.equal(got, quant.dequantize_int8_reference(q, s, (xs.numel(),), out))
    assert torch.equal(quant.dequantize_int8(q[1:], s, (q.numel() - 1,), torch.float32),
                       quant.dequantize_int8_reference(q[1:], s, (q.numel() - 1,), torch.float32))


@pytest.mark.cuda
def test_paged_kernel_rejects_bad_inputs(cuda_device):
    *arrays, bs = _paged_inputs(C=1)
    q, pk, pv, bt, pos, lens = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    with pytest.raises(TypeError):
        paged_attention(q, pk, pv, bt.long(), pos, bs, new_lens=lens)
    with pytest.raises(ValueError):
        paged_attention(q[..., :96].contiguous(), pk[..., :96].contiguous(),
                        pv[..., :96].contiguous(), bt, pos, bs, new_lens=lens)
    with pytest.raises(ValueError, match="alibi_slopes"):
        paged_attention(q, pk, pv, bt, pos, bs, new_lens=lens,
                        alibi_slopes=torch.ones(q.shape[2] - 1, device=cuda_device))


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
    kq, ks, vq, vs = _quantised_pool(t[1], t[2], "int8")
    before = paged_attention_quant.launches
    torch.testing.assert_close(
        paged_attention(t[0], kq, vq, *t[3:5], bs, new_lens=t[5], k_scale=ks, v_scale=vs),
        paged_attention_reference(t[0], kq, vq, *t[3:5], bs, t[5], ks, vs))
    assert paged_attention_quant.launches == before
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625, 0.03, 0.02, 0.01, 0.005])
    before = paged_attention.alibi_launches
    for scales in ({}, dict(k_scale=ks, v_scale=vs)):
        pools = (kq, vq) if scales else t[1:3]
        torch.testing.assert_close(
            paged_attention(t[0], *pools, *t[3:5], bs, new_lens=t[5], alibi_slopes=slopes,
                            **scales),
            paged_attention_reference(t[0], *pools, *t[3:5], bs, t[5], alibi_slopes=slopes,
                                      **scales))
    assert paged_attention.alibi_launches == before
    before = (quant.quantize_int8.launches, quant.quantize_int8_stochastic.launches,
              quant.dequantize_int8.launches)
    q, s = quant.quantize_int8(torch.from_numpy(x))
    quant.quantize_int8(torch.from_numpy(x), stochastic=True)
    quant.dequantize_int8(q, s, x.shape, torch.float32)
    assert (quant.quantize_int8.launches, quant.quantize_int8_stochastic.launches,
            quant.dequantize_int8.launches) == before


FLASH_CASES = {
    "mha_s100": dict(B=2, S=100, H=4, kvH=4, hd=64),
    "gqa4_s192": dict(B=2, S=192, H=8, kvH=2, hd=64),
    "gqa4_hd128_s70": dict(B=1, S=70, H=8, kvH=2, hd=128),
    "keep_right_pad": dict(B=2, S=130, H=4, kvH=1, hd=64, keep_lens=(130, 77)),
    "mha_hd128_s130": dict(B=1, S=130, H=4, kvH=4, hd=128),
    "keep_keyless_row": dict(B=3, S=130, H=8, kvH=2, hd=64, keep_lens=(130, 77, 0)),
}


def _flash_counts():
    return [(fn.launches, fn.alibi_launches) for fn in (fa.flash_fwd, fa.flash_bwd_dq,
                                                        fa.flash_bwd_dkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True], ids=["no_alibi", "alibi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda_device, case, dtype, alibi):
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    q, k, v, do, keep = flash_inputs(cuda_device, **FLASH_CASES[case], seed=3)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    slopes = fa.alibi_log2(alibi_slopes(q.shape[2], cuda_device)) if alibi else None
    before = _flash_counts()
    readings, lse_err, dead_exact = check_flash_kernels(q, k, v, do, keep, slopes)
    assert _flash_counts() == [(n + (not alibi), a + alibi) for n, a in before]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, (rel, _) in readings.items():
        assert rel <= tol, (name, rel)
    assert dead_exact
    assert lse_err <= (LSE_ALIBI_REL if alibi else 1e-4)


@pytest.mark.cuda
def test_flash_fully_masked_rows_are_zero(cuda_device):
    """Left padding: rows whose visible keys are all dropped by the keep-mask
    get output 0, the lse sentinel and zero gradients."""
    q, k, v, do, _ = flash_inputs(cuda_device, B=1, S=96, H=4, kvH=2, hd=64, seed=3)
    keep = torch.ones(1, 96, dtype=torch.int32, device=cuda_device)
    keep[:, :10] = 0
    qs = fa.prescale_q(q)
    out, lse = fa.flash_fwd(qs, k, v, keep)
    dq = fa.flash_bwd_dq(qs, k, v, keep, do, lse, fa.flash_delta(do, out))
    torch.cuda.synchronize()
    assert torch.all(out[:, :10] == 0) and torch.all(dq[:, :10] == 0)
    assert torch.all(lse[:, :, :10] == fa.NEG_INF)


@pytest.mark.cuda
def test_flash_kernels_reject_bad_inputs(cuda_device):
    q, k, v, do, _ = flash_inputs(cuda_device, B=1, S=64, H=4, kvH=2, hd=64, seed=3)
    with pytest.raises(ValueError):
        fa.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                     v[..., :32].contiguous())
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.bfloat16(), v)


def test_cpu_flash_alibi_takes_the_plain_versions():
    """On CPU tensors the ALiBi form runs the plain versions, launches
    nothing, and differs from the form without slopes; bad slopes (dtype,
    shape, device) raise before either runs."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    q, k, v, do, keep = flash_inputs("cpu", B=1, S=20, H=4, kvH=2, hd=16, keep_lens=(15,), seed=3)
    before = _flash_counts()
    q.requires_grad_(True)
    out = fa.flash_causal_attention(q, k, v, mask=keep, alibi_slopes=alibi_slopes(4))
    out.backward(do)
    assert q.grad is not None and q.grad.shape == q.shape
    assert _flash_counts() == before
    qs = fa.prescale_q(q.detach())
    slopes = fa.alibi_log2(alibi_slopes(4))
    got, lse = fa.flash_fwd(qs, k, v, keep, slopes)
    want, want_lse = fa.flash_fwd_reference(qs, k, v, keep, slopes)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    assert not torch.allclose(got, fa.flash_fwd(qs, k, v, keep)[0])
    delta = fa.flash_delta(do, got)
    for bad in (slopes.double(), slopes[:3], slopes.to("meta"), torch.stack([slopes] * 2, 1)[:, 0]):
        with pytest.raises(ValueError, match="slopes"):
            fa.flash_fwd(qs, k, v, keep, bad)
        with pytest.raises(ValueError, match="slopes"):
            fa.flash_bwd_dq(qs, k, v, keep, do, lse, delta, bad)
        with pytest.raises(ValueError, match="slopes"):
            fa.flash_bwd_dkv(qs, k, v, keep, do, lse, delta, bad)
    assert _flash_counts() == before


def test_cpu_flash_takes_the_plain_versions():
    q, k, v, do, keep = flash_inputs("cpu", B=1, S=20, H=4, kvH=2, hd=16, keep_lens=(15,), seed=3)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    q.requires_grad_(True)
    out = fa.flash_causal_attention(q, k, v, mask=keep)
    out.backward(do)
    assert q.grad is not None and q.grad.shape == q.shape
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


SPARSE_CASES = {
    # name: (sparsity config, its fields, block, S, heads, kv heads, D, causal)
    "bigbird_b16_d64": ("bigbird", {}, 16, 512, 4, 2, 64, True),
    "bigbird_b16_d128_noncausal": ("bigbird", {"num_random_blocks": 2}, 16, 256, 2, 2, 128,
                                   False),
    "fixed_b32_d128": ("fixed", {"num_local_blocks": 4}, 32, 512, 2, 1, 128, True),
    "bslongformer_b64_d64_noncausal": ("bslongformer", {"global_block_indices": (0, 3)},
                                       64, 512, 2, 2, 64, False),
    "variable_b64_d128": ("variable", {"num_random_blocks": 1, "local_window_blocks": (2, 3)},
                          64, 512, 2, 1, 128, True),
    "empty_rows_b32_d64": ("local", {"num_sliding_window_blocks": 2}, 32, 256, 3, 3, 64, True),
}


def _sparse_case(case, dev, dtype):
    mode, kw, block, S, H, kvH, D, causal = SPARSE_CASES[case]
    layout = get_sparsity_config(mode, num_heads=H, block=block, **kw).make_layout(S)
    if case.startswith("empty_rows"):
        layout[:, 2] = 0
        layout[1, 5] = 0
    q, k, v, do = (t.to(dtype) for t in flash_inputs(dev, 2, S, H, kvH, D, seed=4)[:4])
    return q, k, v, do, layout, block, causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernels_match_plain(cuda_device, case, dtype):
    before = (bs.sparse_fwd.launches, bs.sparse_bwd_dq.launches, bs.sparse_bwd_dkv.launches)
    readings, lse_err, dead_exact = check_sparse_kernels(*_sparse_case(case, cuda_device, dtype))
    after = (bs.sparse_fwd.launches, bs.sparse_bwd_dq.launches, bs.sparse_bwd_dkv.launches)
    assert after == tuple(b + 1 for b in before)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert all(rel <= tol for rel, _ in readings.values()), readings
    assert lse_err <= 1e-4 and dead_exact


@pytest.mark.cuda
def test_sparse_kernels_reject_bad_inputs(cuda_device):
    q, k, v, do, layout, block, causal = _sparse_case("bigbird_b16_d64", cuda_device,
                                                      torch.bfloat16)
    cols, ncols, _, _ = bs.layout_arrays(layout, cuda_device)
    with pytest.raises(ValueError):  # head dim 32
        bs.sparse_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                      v[..., :32].contiguous(), cols, ncols, block)
    lay8 = get_sparsity_config("bigbird", num_heads=4, block=8).make_layout(512)
    c8, n8, _, _ = bs.layout_arrays(lay8, cuda_device)
    with pytest.raises(ValueError):  # block 8
        bs.sparse_fwd(q, k, v, c8, n8, 8)
    with pytest.raises(TypeError):
        bs.sparse_fwd(q, k.float(), v, cols, ncols, block)
    k3, v3 = (torch.cat([t, t[:, :, :1]], 2) for t in (k, v))
    with pytest.raises(ValueError):  # 3 kv heads for 4 query heads
        bs.sparse_fwd(q, k3, v3, cols, ncols, block)


def test_cpu_sparse_takes_the_plain_versions():
    layout = get_sparsity_config("bigbird", num_heads=2, block=8).make_layout(32)
    q, k, v, do = flash_inputs("cpu", 1, 32, 2, 1, 16, seed=4)[:4]
    before = (bs.sparse_fwd.launches, bs.sparse_bwd_dq.launches, bs.sparse_bwd_dkv.launches)
    q.requires_grad_(True)
    k.requires_grad_(True)
    out = bs.block_sparse_attention_kernel(q, k, v, layout, 8)
    out.backward(do)
    assert q.grad is not None and q.grad.shape == q.shape and k.grad.shape == k.shape
    assert (bs.sparse_fwd.launches, bs.sparse_bwd_dq.launches, bs.sparse_bwd_dkv.launches) == before


# (group sizes, rows, K, N) of the grouped-GEMM checks
GMM_CASES = {
    "routed_512_tokens": (routed_group_sizes(512), None, 512, 1024),
    "skewed_m4099": (GMM_SKEWED_SIZES, None, 256, 384),
    "unaligned_tail_rows": ((0, 37, 1, 200, 0, 5, 64, 3), 320, 1001, 299),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_kernel_matches_plain(cuda_device, case, dtype):
    sizes, rows, K, N = GMM_CASES[case]
    lhs, rhs, gs = grouped_inputs(cuda_device, sizes, K, N, dtype, rows=rows)
    before = grouped_matmul.launches
    ok, max_abs, share = check_grouped_matmul(lhs, rhs, gs)
    assert ok, (max_abs, share)
    assert grouped_matmul.launches == before + 1


@pytest.mark.cuda
def test_grouped_matmul_rejects_bad_inputs(cuda_device):
    lhs, rhs, gs = grouped_inputs(cuda_device, (3, 5), 64, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        grouped_matmul(lhs, rhs.float(), gs)
    with pytest.raises(ValueError):  # int64 group sizes
        grouped_matmul(lhs, rhs, gs.long())
    with pytest.raises(ValueError):  # K mismatch
        grouped_matmul(lhs[:, :32].contiguous(), rhs, gs)


def test_cpu_grouped_matmul_takes_the_plain_version():
    lhs, rhs, gs = grouped_inputs("cpu", (3, 0, 5), 16, 24, torch.float32, rows=10)
    before = grouped_matmul.launches
    out = grouped_matmul(lhs, rhs, gs)
    torch.testing.assert_close(out, grouped_matmul_plain(lhs, rhs, gs))
    torch.testing.assert_close(out[3:8], lhs[3:8] @ rhs[2])
    assert bool((out[8:] == 0).all()) and grouped_matmul.launches == before
