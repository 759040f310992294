"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only PyTorch is installed,
the GPU machine included:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX). The ``cuda``-marked
tests build the kernels with nvcc and compare on the card; they skip without
one. The others check, on the CPU, that a CPU tensor takes the plain version
and launches nothing. Tolerances: rms_norm 1e-5 fp32 / 1e-2 bf16 (one output
ulp); layer_norm the same (both compute in fp32, the variance in two passes,
and round once), over rows 1, 300 and 8064 and widths 64, 1024, 4096, 4097
(the scalar tail after the vector body), 4544 (Falcon-7B), 16384 and 50000
(past the 48 KB and the 160 KB shared-memory cache), a row start off a 16-byte
boundary, a mixed-dtype scale/bias pair and channels offset by 100;
paged_attention 2e-5 fp32 / 2e-2 bf16 per element (q scaled in bf16
by the kernel, scores and p rounded to bf16 by the plain version), and a
relative L2 error of each query's output vector of at most 1e-4 fp32 / 2e-2
bf16, which holds a long row's small outputs as tightly as a short row's;
the same limits hold the ALiBi form over every pool type, at G = 1 (Bloom's
MHA) and G = 4, pad rows (``new_lens`` 0) included, and each of the paged
kernel's forms by name ("split", W and S: ``_paged_attention_form``) at the
same cases, every pool, ALiBi on and off; forms "split" and W with 1, 2 and
64 splits give the same bits twice and leave every ticket counter at 0; the
wrapper runs form W for bf16 prefill (C 2, 17 and 512) and never
for a block size that is not a multiple of 8.
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
ALiBi launches count in ``alibi_launches`` only. The forward's form W (bf16:
wgmma fed by TMA) is held alone by the same limits (``check_flash_fwd``) at S
= 1, 65, 127, 129 and 1000 (ragged keep-mask 1000, 613, 0), G = 1, 4 and 8,
hd 64 and 128, with and without ALiBi; left-padded rows with no visible key
are exactly 0 with the lse sentinel; the mma.sync form stays within the same
limits of form W. The backward's form W (bf16: one kernel for dq, dk and dv,
wgmma fed by TMA) is held alone (``check_flash_bwd``) by the same row rule
and 2e-2 on every flash case, with and without ALiBi: dq of rows with no
visible key and dk, dv of dropped keys exactly 0, dk and dv bit-equal between
two runs (dq's partial sums land in any order, so two runs' dq are held to
2e-2 of each other); the wrapper runs it for bf16, one launch counted by
form; it refuses fp32, hd 96 and a tensor off a 16-byte boundary; the mma
pair, by name, meets the same limits. The quantiser kernels (int8 nearest and stochastic,
dequantisation) must equal their plain versions bit for bit:
both divide and round in IEEE fp32 and hash the same counters. The
quantised paged kernel (int8 and e4m3 pools) is held to the limits of the
bf16/fp32 one. The three block-sparse kernels (forward, dq, dkv) are held to
their plain versions by the flash kernels' rule and limits, over blocks 16,
32 and 64, D 64 and 128, causal and not, k and v at fewer heads than q or as
many, and a layout with empty block rows (output, dq and the lse sentinel
exact there). The grouped GEMM (``csrc/grouped_gemm.cu``) is held by
``utils.checks.check_grouped_matmul`` (``GMM_TOL``: bf16 rtol 1e-2, one
output ulp, and 1e-3 of the output's RMS; fp32 1e-5 and 1e-4 of the RMS, as
the kernel sums K products in one sequential chain), the wrapper's pick and
each form by name (P "wgmma", D "stream", the mma.sync "mma", "simt") wherever it
takes the shape, on group sizes from real top-2 routing, a skewed set (half
the rows in one group, an empty group, a single row, m not a multiple of 8),
K and N that are not multiples of 8 with rows past the sizes' sum (which
must be 0), form P's edges (a group boundary inside a 128-row box, K % 64
and N % 256 not 0, an empty last group) and form D's (groups of 0 to 33 rows
about its 8- and 16-row chunks, K 14336); each form refuses what it does not
take. The ring
hop kernels (``csrc/ring_hop.cu``) must equal their plain versions bit for
bit: ``ds_permute_leaves`` copies bytes, and ``ds_fused_hop`` divides in IEEE
fp32, rounds half to even (int8) or to nearest (e4m3), and multiplies and
adds with the ``_rn`` intrinsics, never an FMA. They run as the collectives
run them, every rank of a group on one card with its own stream: n = 2, 4
and 8 ranks; rows of 1, 103 and 65,536 + 37 elements; blocks of 32 and 2048;
int8 and e4m3 wires; the reduce-scatter (accumulate) and the all-to-all.
The fused GEMM hops (``csrc/fused_gemm.cu``, rows 14 and 15) are held one
launch at a time to their plain versions on the same inputs, both gather
forms and the reduce-scatter's first and later hops, over the exact, int8
and e4m3 wires, M (or Mb) = 1, odd Ks and N, tile edges: on integer
payloads everything bit for bit; on normal ones the products by
``fused_gemm_close`` (1e-5 relative, and 1e-6 x sqrt(K) of the largest
|output|: form S sums K products in one FMA chain, form T three TF32 passes
with ~22 bits a product, cuBLAS in its own order), the received shard and
every code and scale bit for bit (the reduce-scatter's codes against the
plain block math of the kernel's own partial). Each form (T "wgmma", S
"simt") is named at every ``FG_SHAPES`` case and phase 6c's four hop shapes
(naming form T where TMA cannot describe the hop raises), gives the same
bits on a second run, and the wrapper picks form T for aligned shapes and
form S for odd ones; +-inf and NaN operands give fp32's infs and NaNs
through each form. The ops over 2 and 4 ranks equal their plain runs bit
for bit with n - 1 launches of each row a rank.
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import collectives as coll
from deepspeed_tpu_torch.collectives import codecs as coll_codecs
from deepspeed_tpu_torch.collectives import pallas_backend as hops
from deepspeed_tpu_torch.comm import RankGroup
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import norms
from deepspeed_tpu_torch.ops.norms import (
    layer_norm,
    layer_norm_reference,
    rms_norm,
    rms_norm_reference,
)
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_quant,
    paged_attention_reference,
)
from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention import get_sparsity_config
from deepspeed_tpu_torch.ops.grouped_matmul import (
    _grouped_matmul_form,
    form_takes,
    grouped_matmul,
    grouped_matmul_plain,
    pick_form,
)
from deepspeed_tpu_torch.utils.checks import (
    GMM_SKEWED_SIZES,
    LSE_ALIBI_REL,
    bits_differ,
    block_wire,
    check_flash_bwd,
    check_flash_fwd,
    check_flash_kernels,
    check_grouped_matmul,
    check_sparse_kernels,
    flash_inputs,
    fused_gemm_close,
    fused_gemm_match,
    fused_gemm_qb,
    grouped_inputs,
    plain_collective_kernels,
    routed_group_sizes,
    row_rel_l2,
)


# the paged-attention module (``ops`` re-exports its function of the same name)
pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")


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


def _ln_inputs(rows, dim, seed=3, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, dim)).astype(np.float32) * 3 + offset,
            (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
            (0.1 * rng.standard_normal(dim)).astype(np.float32))


def _ln_check(dev, x, scale, bias, tol):
    xt, st, bt = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                  for a in (x, scale, bias))
    before = layer_norm.launches
    got = layer_norm(xt, st, bt)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    assert got.dtype == xt.dtype and got.shape == xt.shape
    torch.testing.assert_close(got.float(), layer_norm_reference(xt, st, bt).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300, 8064])
@pytest.mark.parametrize("dim", [64, 1024, 4096, 4097, 4544])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda_device, rows, dim, dtype):
    x, scale, bias = (torch.from_numpy(a).to(cuda_device, dtype) for a in _ln_inputs(rows, dim))
    _ln_check(cuda_device, x, scale, bias, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_edges(cuda_device, dtype):
    """Channels offset by 100 (a one-pass variance drifts there), a row start
    one element off a 16-byte boundary, and a bf16 scale with an fp32 bias."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    x, scale, bias = _ln_inputs(300, 4096, offset=100.0)
    _ln_check(cuda_device, torch.from_numpy(x).to(cuda_device, dtype),
              torch.from_numpy(scale).to(cuda_device, dtype),
              torch.from_numpy(bias).to(cuda_device, dtype), tol)
    x, scale, bias = _ln_inputs(37, 1000)
    buf = torch.from_numpy(np.concatenate([[0.0], x.reshape(-1)]).astype(np.float32))
    shifted = buf.to(cuda_device, dtype)[1:].view(37, 1000)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    _ln_check(cuda_device, shifted, torch.from_numpy(scale).to(cuda_device, dtype),
              torch.from_numpy(bias).to(cuda_device, dtype), tol)
    _ln_check(cuda_device, torch.from_numpy(x).to(cuda_device, dtype),
              torch.from_numpy(scale).to(cuda_device, torch.bfloat16),
              torch.from_numpy(bias).to(cuda_device, torch.float32), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [16384, 50000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_wide_rows(cuda_device, dim, dtype):
    """Rows whose shared-memory cache passes 48 KB (the kernel opts in to
    more) and rows too wide for the cache (x is read again from L2)."""
    x, scale, bias = (torch.from_numpy(a).to(cuda_device, dtype) for a in _ln_inputs(3, dim))
    _ln_check(cuda_device, x, scale, bias, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_layer_norm_kernel_launches_and_refuses(cuda_device):
    """One launch per forward, none for zero rows or for the backward (plain
    PyTorch, as JAX's jnp ``_ln_p_bwd``), the plain version never called on
    CUDA tensors; bad dtypes, shapes and layouts raise."""
    x, scale, bias = (torch.from_numpy(a).to(cuda_device) for a in _ln_inputs(8, 256))
    x.requires_grad_(True)
    calls = []
    real = norms.layer_norm_reference
    norms.layer_norm_reference = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        before = layer_norm.launches
        layer_norm(x, scale, bias).sum().backward()
        assert layer_norm(x[:0], scale, bias).shape == (0, 256)
        torch.cuda.synchronize()
    finally:
        norms.layer_norm_reference = real
    assert layer_norm.launches == before + 1 and not calls
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with pytest.raises(TypeError):
        layer_norm(x.detach().half(), scale, bias)
    with pytest.raises(ValueError):
        layer_norm(x.detach(), scale[:-1], bias)
    with pytest.raises(ValueError):
        layer_norm(x.detach(), scale, bias.cpu())
    with pytest.raises(ValueError):
        norms.layer_norm_fwd(x.detach().t(), scale[:8], bias[:8])


def test_cpu_layer_norm_takes_the_plain_version():
    x, scale, bias = (torch.from_numpy(a) for a in _ln_inputs(5, 64))
    before = layer_norm.launches
    torch.testing.assert_close(layer_norm(x, scale, bias), layer_norm_reference(x, scale, bias))
    torch.testing.assert_close(layer_norm(x, scale, bias),
                               torch.nn.functional.layer_norm(x, (64,), scale, bias),
                               rtol=1e-5, atol=1e-5)
    assert layer_norm.launches == before


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


# the kernel's forms by name (``_paged_attention_form``): (form, q dtype) runs
PAGED_FORM_RUNS = {"split-bf16": ("split", torch.bfloat16), "split-fp32": ("split", torch.float32),
                   "wgmma-bf16": ("wgmma", torch.bfloat16), "simt-bf16": ("simt", torch.bfloat16),
                   "simt-fp32": ("simt", torch.float32)}
PAGED_FORM_CASES = {
    "decode": dict(C=1), "long": dict(C=1, ends=(200, 639, 999), P=64),
    "prefill": dict(C=40), "pad_row": dict(C=4, pad_row=True), "garbage": dict(C=4, garbage=True),
    "hd64": dict(C=5, H=8, kvH=2, hd=64), "decode G=1": dict(C=1, H=32, kvH=32),
    "prefill G=1, pad row, garbage": dict(C=40, H=32, kvH=32, pad_row=True, garbage=True),
}


def _paged_case(dev, kw, dtype, kv, alibi):
    """The case's batch on the card as keyword arguments of the wrappers:
    q in ``dtype``, the pools in q's dtype or as ``kv`` codes with scales,
    Bloom's slopes with ``alibi``."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    *arrays, bs = _paged_inputs(**kw)
    q, pk, pv, bt, pos, lens = (torch.from_numpy(a).to(dev) for a in arrays)
    b = dict(q=q.to(dtype), block_tables=bt, q_positions=pos, block_size=bs, new_lens=lens,
             pool_k_l=pk.to(dtype), pool_v_l=pv.to(dtype))
    if kv is not None:
        kq, ks, vq, vs = _quantised_pool(pk, pv, kv)
        b.update(pool_k_l=kq, pool_v_l=vq, k_scale=ks, v_scale=vs)
    if alibi:
        b["alibi_slopes"] = alibi_slopes(q.shape[2], dev)
    return b


def _paged_close(got, want, dtype):
    tol, rel_l2 = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    rel = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)
    assert float(rel.max()) <= rel_l2, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("run", sorted(PAGED_FORM_RUNS))
@pytest.mark.parametrize("case", sorted(PAGED_FORM_CASES))
def test_paged_forms_match_plain(cuda_device, case, run, kv, alibi):
    """Each form by name against the plain version at the wrappers' cases
    (hd 64 and 128, G 1 and 4, pad rows, garbage block-table tails), every
    pool, ALiBi on and off, by the limits of ``test_paged_kernel_matches_plain``;
    one launch, counted under its form on the wrapper that ran."""
    form, dtype = PAGED_FORM_RUNS[run]
    b = _paged_case(cuda_device, PAGED_FORM_CASES[case], dtype, kv, alibi)
    wrapper = paged_attention if kv is None else paged_attention_quant
    before = dict(wrapper.launches_by_form)
    got = pa_mod._paged_attention_form(form=form, **b)
    torch.cuda.synchronize()
    before[form] += 1
    assert wrapper.launches_by_form == before
    _paged_close(got, paged_attention_reference(**b), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("splits", [1, 2, 64])
@pytest.mark.parametrize("form", ["split", "wgmma"])
def test_paged_splits_bit_equal_and_tickets_zero(cuda_device, form, splits, kv):
    """Forms "split" and W with 1, 2 and many (one a page) splits: within the
    limits of the plain version, bit-equal over two runs (the splits merge
    in a fixed order), and every ticket counter back at zero after the call."""
    kw = dict(C=1, ends=(200, 639, 999), P=64, pad_row=True) if form == "split" else dict(
        C=40, ends=(200, 639, 999), P=64, pad_row=True)
    b = _paged_case(cuda_device, kw, torch.bfloat16, kv, alibi=True)
    got = pa_mod._paged_attention_form(form=form, splits=splits, **b)
    again = pa_mod._paged_attention_form(form=form, splits=splits, **b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert all(int(t.abs().sum()) == 0 for t in pa_mod._TICKETS.values())
    _paged_close(got, paged_attention_reference(**b), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("C", [2, 17, 512])
def test_paged_wrapper_picks_form_w_above_the_threshold(cuda_device, C, kv):
    """bf16 prefill just above decode (C = 2: 8 (c, g) rows, few
    blocks, so form W splits its keys), at C = 17 (a partial 128-row tile)
    and at C = 512: the wrapper runs form W, once, within the limits of the
    plain version."""
    kw = dict(C=C, ends=(600, 511, 700), P=48, pad_row=C < 512)
    b = _paged_case(cuda_device, kw, torch.bfloat16, kv, alibi=False)
    wrapper = paged_attention if kv is None else paged_attention_quant
    assert pa_mod.paged_form(torch.bfloat16, 128, C, 4, 16) == "wgmma"
    before = dict(wrapper.launches_by_form)
    got = paged_attention(**b)
    torch.cuda.synchronize()
    before["wgmma"] += 1
    assert wrapper.launches_by_form == before
    _paged_close(got, paged_attention_reference(**b), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 40])
@pytest.mark.parametrize("bs", [16, 12])
def test_paged_block_size_reaches_form_w_only_in_whole_atoms(cuda_device, bs, C):
    """bs 16 reaches form W above decode; bs 12 (not a multiple of 8)
    never does: the wrapper runs form "split" at decode and form S above,
    and form W named on it raises."""
    b = _paged_case(cuda_device, dict(C=C, bs=bs), torch.bfloat16, None, alibi=False)
    want_form = "split" if C == 1 else ("wgmma" if bs % 8 == 0 else "simt")
    assert pa_mod.paged_form(torch.bfloat16, 128, C, 4, bs) == want_form
    before = dict(paged_attention.launches_by_form)
    got = paged_attention(**b)
    torch.cuda.synchronize()
    before[want_form] += 1
    assert paged_attention.launches_by_form == before
    _paged_close(got, paged_attention_reference(**b), torch.bfloat16)
    if bs % 8:
        with pytest.raises(ValueError, match="does not take"):
            pa_mod._paged_attention_form(form="wgmma", **b)
        with pytest.raises(ValueError, match="does not take"):
            pa_mod._paged_attention_form(**dict(b, q=b["q"].float(), pool_k_l=b["pool_k_l"].float(),
                                                pool_v_l=b["pool_v_l"].float()), form="wgmma")


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


FWD_W_CASES = {
    "s1_g4": dict(B=1, S=1, H=8, kvH=2, hd=64),
    "s65_g1_hd128": dict(B=2, S=65, H=4, kvH=4, hd=128),
    "s127_g8": dict(B=1, S=127, H=8, kvH=1, hd=64),
    "s129_g4_hd128": dict(B=2, S=129, H=8, kvH=2, hd=128),
    "s129_g1": dict(B=2, S=129, H=4, kvH=4, hd=64),
    "s1000_keep_g4": dict(B=3, S=1000, H=8, kvH=2, hd=64, keep_lens=(1000, 613, 0)),
    "s1000_keep_g8_hd128": dict(B=3, S=1000, H=8, kvH=1, hd=128, keep_lens=(1000, 613, 0)),
}


def _fwd_w_check(dev, shape, alibi, form=None, seed=3):
    """Form W (or ``form``) on bf16 inputs of ``shape`` against the plain
    forward, by the flash kernels' limits; returns the output."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    q, k, v, _, keep = flash_inputs(dev, **shape, seed=seed)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    slopes = fa.alibi_log2(alibi_slopes(q.shape[2], dev)) if alibi else None
    rel, _, lse_err, dead_exact, out = check_flash_fwd(q, k, v, keep, slopes, form)
    assert rel <= 2e-2, rel
    assert dead_exact
    assert lse_err <= (LSE_ALIBI_REL if alibi else 1e-4), lse_err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True], ids=["no_alibi", "alibi"])
@pytest.mark.parametrize("case", sorted(FWD_W_CASES))
def test_flash_fwd_form_w_matches_plain(cuda_device, case, alibi):
    """The wrapper runs form W for bf16: one launch of it, counted by form."""
    before = dict(fa.flash_fwd.launches_by_form)
    _fwd_w_check(cuda_device, FWD_W_CASES[case], alibi)
    assert fa.flash_fwd.launches_by_form == dict(before, wgmma=before["wgmma"] + 1)


@pytest.mark.cuda
def test_flash_fwd_form_w_left_padded_rows_are_zero(cuda_device):
    """Left padding in bf16: rows whose visible keys the keep-mask all drops
    get output exactly 0 and the lse sentinel from form W."""
    q, k, v, _, _ = flash_inputs(cuda_device, B=2, S=300, H=8, kvH=2, hd=64, seed=3)
    keep = torch.ones(2, 300, dtype=torch.int32, device=cuda_device)
    keep[1, :200] = 0
    out, lse = fa.flash_fwd(fa.prescale_q(q.bfloat16()), k.bfloat16(), v.bfloat16(), keep)
    torch.cuda.synchronize()
    assert torch.all(out[1, :200] == 0) and torch.all(lse[1, :, :200] == fa.NEG_INF)
    assert torch.all(torch.isfinite(out)) and bool((out[1, 200:] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True], ids=["no_alibi", "alibi"])
def test_flash_fwd_mma_form_matches_form_w(cuda_device, alibi):
    """The mma.sync form, reached only by name, against the plain forward and
    within the same limit of form W's output."""
    shape = FWD_W_CASES["s1000_keep_g4"]
    w = _fwd_w_check(cuda_device, shape, alibi)
    mma = _fwd_w_check(cuda_device, shape, alibi, form="mma")
    assert row_rel_l2(mma, w) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True], ids=["no_alibi", "alibi"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_form_w_matches_plain(cuda_device, case, alibi):
    """The wrapper runs the backward's form W for bf16 (one launch, counted by
    form): dq, dk and dv within 2e-2 of the plain version, the empty rows and
    dropped keys exact; a second run gives bit-equal dk and dv, and dq within
    2e-2 (its partial sums land in any order)."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    q, k, v, do, keep = flash_inputs(cuda_device, **FLASH_CASES[case], seed=3)
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    slopes = fa.alibi_log2(alibi_slopes(q.shape[2], cuda_device)) if alibi else None
    before = dict(fa.flash_bwd.launches_by_form)
    readings, dead_exact, got = check_flash_bwd(q, k, v, do, keep, slopes)
    assert fa.flash_bwd.launches_by_form == dict(before, wgmma=before["wgmma"] + 1)
    for name, (rel, _) in readings.items():
        assert rel <= 2e-2, (name, rel)
    assert dead_exact
    again = check_flash_bwd(q, k, v, do, keep, slopes)[2]
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    assert row_rel_l2(again[0], got[0]) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True], ids=["no_alibi", "alibi"])
def test_flash_bwd_mma_form_matches_plain(cuda_device, alibi):
    """The mma pair, reached by name, meets the same limits as form W."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    q, k, v, do, keep = flash_inputs(cuda_device, **FLASH_CASES["keep_keyless_row"], seed=3)
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    slopes = fa.alibi_log2(alibi_slopes(q.shape[2], cuda_device)) if alibi else None
    readings, dead_exact, _ = check_flash_bwd(q, k, v, do, keep, slopes, "mma")
    assert all(rel <= 2e-2 for rel, _ in readings.values()), readings
    assert dead_exact


@pytest.mark.cuda
def test_flash_bwd_form_w_rejects_bad_inputs(cuda_device):
    """Form W takes bf16 only, hd 64 or 128, every tensor on a 16-byte
    boundary: fp32 by name, hd 96 and a misaligned dO raise, launching nothing."""
    q, k, v, do, _ = flash_inputs(cuda_device, B=1, S=64, H=4, kvH=2, hd=64, seed=3)
    qs, k, v, do = (t.bfloat16() for t in (fa.prescale_q(q), k, v, do))
    out, lse = fa.flash_fwd(qs, k, v)
    delta = fa.flash_delta(do, out)
    before = dict(fa.flash_bwd.launches_by_form)
    with pytest.raises(ValueError):
        fa._flash_bwd_form(qs.float(), k.float(), v.float(), None, do.float(), lse, delta, None,
                           "wgmma")
    with pytest.raises(ValueError):
        fa.flash_bwd(*(torch.zeros(*t.shape[:3], 96, dtype=torch.bfloat16, device=cuda_device)
                       for t in (qs, k, v)), None,
                     torch.zeros(1, 64, 4, 96, dtype=torch.bfloat16, device=cuda_device), lse, delta)
    shifted = torch.empty(do.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    shifted = shifted.view(do.shape).copy_(do)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_bwd(qs, k, v, None, shifted, lse, delta)
    assert fa.flash_bwd.launches_by_form == before


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
    # form P's edges: a group boundary inside a 128-row box, K % 64 != 0, N %
    # 256 != 0 (and % 64), rows past the sizes' sum, an empty last group
    "tma_edges": ((100, 300, 0, 129, 0), 600, 328, 392),
    # form D's edges: groups of 0-33 rows about its 8- and 16-row chunks, at
    # N 4096 and at a narrow N past K 14336 (224 k-steps, N % 64 != 0)
    "decode_rows_n4096": ((0, 1, 7, 8, 9, 15, 16, 17, 33), None, 256, 4096),
    "decode_rows_k14336": ((0, 1, 7, 8, 9, 15, 16, 17, 33), 120, 14336, 200),
}
# (form, dtype) runs: the wrapper's own pick in bf16 and fp32, then each form
# by name (``_grouped_matmul_form``) wherever it takes the case's shape
GMM_RUNS = {"pick-bf16": (None, torch.bfloat16), "pick-fp32": (None, torch.float32),
            "wgmma": ("wgmma", torch.bfloat16), "stream": ("stream", torch.bfloat16),
            "mma": ("mma", torch.bfloat16), "simt": ("simt", torch.float32)}
GMM_PARAMS = [(case, run) for case, (_, _, K, N) in sorted(GMM_CASES.items())
              for run, (form, dtype) in GMM_RUNS.items()
              if form is None or form_takes(form, dtype, K, N, aligned=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,run", GMM_PARAMS)
def test_grouped_matmul_kernel_matches_plain(cuda_device, case, run):
    form, dtype = GMM_RUNS[run]
    sizes, rows, K, N = GMM_CASES[case]
    lhs, rhs, gs = grouped_inputs(cuda_device, sizes, K, N, dtype, rows=rows)
    ran = form or pick_form(dtype, lhs.shape[0], K, N, aligned=True)
    before, by_form = grouped_matmul.launches, dict(grouped_matmul.launches_by_form)
    ok, max_abs, share = check_grouped_matmul(lhs, rhs, gs, form=form)
    assert ok, (max_abs, share)
    by_form[ran] += 1
    assert grouped_matmul.launches == before + 1 and grouped_matmul.launches_by_form == by_form


@pytest.mark.cuda
def test_grouped_matmul_rejects_bad_inputs(cuda_device):
    lhs, rhs, gs = grouped_inputs(cuda_device, (3, 5), 64, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        grouped_matmul(lhs, rhs.float(), gs)
    with pytest.raises(ValueError):  # int64 group sizes
        grouped_matmul(lhs, rhs, gs.long())
    with pytest.raises(ValueError):  # K mismatch
        grouped_matmul(lhs[:, :32].contiguous(), rhs, gs)


@pytest.mark.cuda
def test_grouped_matmul_forms_refuse_shapes(cuda_device):
    """Each form raises on a shape it does not take and launches nothing;
    the wrapper sends those bf16 shapes to the mma.sync form."""
    lhs, rhs, gs = grouped_inputs(cuda_device, (3, 5), 64, 64, torch.bfloat16)
    odd_k = grouped_inputs(cuda_device, (3, 5), 60, 64, torch.bfloat16)
    odd_n = grouped_inputs(cuda_device, (3, 5), 64, 60, torch.bfloat16)
    fp32 = grouped_inputs(cuda_device, (3, 5), 64, 64, torch.float32)
    shifted = torch.empty(8 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(8, 64)
    shifted.copy_(lhs)  # contiguous, 2 bytes off a 16-byte boundary
    before = dict(grouped_matmul.launches_by_form)
    for form in ("wgmma", "stream"):
        for args in (odd_k, odd_n, fp32, (shifted, rhs, gs)):
            with pytest.raises(ValueError):
                _grouped_matmul_form(*args, form)
    with pytest.raises(ValueError):
        _grouped_matmul_form(*fp32, "mma")
    with pytest.raises(ValueError):
        _grouped_matmul_form(lhs, rhs, gs, "simt")
    with pytest.raises(ValueError):
        _grouped_matmul_form(lhs, rhs, gs, "wmma")
    assert grouped_matmul.launches_by_form == before
    for args in (odd_k, odd_n, (shifted, rhs, gs)):
        torch.testing.assert_close(grouped_matmul(*args), grouped_matmul_plain(*args),
                                   rtol=1e-2, atol=1e-2)
    assert grouped_matmul.launches_by_form == dict(before, mma=before["mma"] + 3)


def test_cpu_grouped_matmul_takes_the_plain_version():
    lhs, rhs, gs = grouped_inputs("cpu", (3, 0, 5), 16, 24, torch.float32, rows=10)
    before = grouped_matmul.launches
    out = grouped_matmul(lhs, rhs, gs)
    torch.testing.assert_close(out, grouped_matmul_plain(lhs, rhs, gs))
    torch.testing.assert_close(out[3:8], lhs[3:8] @ rhs[2])
    assert bool((out[8:] == 0).all()) and grouped_matmul.launches == before


HOP_LENGTHS = (1, 103, 65536 + 37)


def _ranked_rows(group, L, seed, scale=3.0):
    """Every rank's [n, L] fp32 rows, with an all-zero block in rank 0's."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(group.n):
        x = torch.from_numpy((rng.standard_normal((group.n, L)) * scale).astype(np.float32))
        if r == 0:
            x[0, :32] = 0
        rows.append(x.to(group.devices[r]))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [True, False], ids=["reduce_scatter", "all_to_all"])
@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("block", [32, 2048])
@pytest.mark.parametrize("L", HOP_LENGTHS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_hop_kernel_matches_plain(cuda_device, n, L, block, codec, accumulate):
    group = RankGroup("dp", n, device=cuda_device)
    rows = _ranked_rows(group, L, seed=n * 7 + L % 13)
    c = coll_codecs.get_codec(codec, block)

    def run():
        with group.joined():
            if accumulate:
                return hops.fused_ring_reduce_scatter_rows(rows, group, c)
            return hops.fused_ring_all_to_all_rows(
                rows, group, c, perm_k=lambda k: [(s, (s + k) % n) for s in range(n)])

    before = hops.fused_hop.launches
    got = run()
    assert hops.fused_hop.launches == before + n * n  # an encode and n - 1 hops a rank
    with plain_collective_kernels():
        want = run()
    torch.cuda.synchronize()
    bad = bits_differ(got, want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert bad == 0, f"{bad} elements differ, max abs {worst}"


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "int8", "fp8"])
@pytest.mark.parametrize("L", HOP_LENGTHS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_permute_leaves_kernel_matches_plain(cuda_device, n, L, codec):
    """The all-gather relay (values and scales, encode once) and the exact
    all-reduce's hops through ds_permute_leaves, against plain copies."""
    group = RankGroup("dp", n, device=cuda_device)
    xs = [r[0] for r in _ranked_rows(group, L, seed=n + L)]
    before = hops.permute_leaves.launches
    got = coll.all_gather(xs, group, algorithm="pallas_ring", codec=codec, block_size=32)
    assert hops.permute_leaves.launches == before + n * (n - 1)
    with plain_collective_kernels():
        want = coll.all_gather(xs, group, algorithm="pallas_ring", codec=codec, block_size=32)
    assert bits_differ(got, want) == 0
    if codec == "none":
        got = coll.all_reduce(xs, group, algorithm="pallas_ring")
        with plain_collective_kernels():
            want = coll.all_reduce(xs, group, algorithm="pallas_ring")
        assert bits_differ(got, want) == 0
        assert all(bits_differ([g], [got[0]]) == 0 for g in got)


@pytest.mark.cuda
def test_permute_leaves_kernel_edges(cuda_device):
    """Leaves off a 16-byte boundary, of odd byte counts, of several dtypes
    and one empty, in one launch; then refusals."""
    base = torch.arange(4099, dtype=torch.int32, device=cuda_device)
    leaves = [base.view(torch.uint8)[1:16383], base[3:].float(), base.to(torch.bfloat16)[5:],
              base[:0], torch.randn(17, device=cuda_device)]
    before = hops.permute_leaves.launches
    got = hops.permute_leaves(leaves, cuda_device)
    torch.cuda.synchronize()
    assert hops.permute_leaves.launches == before + 1
    assert bits_differ(got, leaves) == 0
    assert all(g.data_ptr() != leaf.data_ptr() for g, leaf in zip(got[:3], leaves[:3]))
    with pytest.raises(ValueError):
        hops.permute_leaves([base[:4098].view(2, -1).t()], cuda_device)  # not contiguous
    with pytest.raises(ValueError):
        hops.permute_leaves([base] * 9, cuda_device)
    q = torch.zeros(64, dtype=torch.int8, device=cuda_device)
    s = torch.ones(2, device=cuda_device)
    row = torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError):  # 64 is not a whole number of blocks of 48
        hops.fused_hop(q, s, row, None, None, None, qb=48)
    with pytest.raises(TypeError):  # fp16 is no wire type
        hops.fused_hop(q.half(), s, row, None, None, None, qb=32)


def test_cpu_hops_take_the_plain_versions_and_count_nothing():
    group = RankGroup("dp", 4, device="cpu")
    before = (hops.permute_leaves.launches, hops.fused_hop.launches)
    xs = [r[0] for r in _ranked_rows(group, 103, seed=1)]
    out = coll.all_reduce(xs, group, algorithm="pallas_ring", codec="int8", block_size=32)
    coll.all_gather(xs, group, algorithm="pallas_ring", codec="none")
    assert (hops.permute_leaves.launches, hops.fused_hop.launches) == before
    assert all(bits_differ([o], [out[0]]) == 0 for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("alg,codec", [("ring", "none"), ("ring", "int8"), ("bidir", "none"),
                                       ("rhd", "none"), ("ring2d", "int8"),
                                       ("pallas_ring", "none"), ("pallas_ring", "int8"),
                                       ("pallas_ring2d", "fp8")])
def test_collectives_start_after_the_callers_stream(cuda_device, alg, codec):
    """Inputs written on the caller's stream behind a ~25 ms spin, and
    transposed views (a copying reshape inside the collective): the rank
    streams must read them only after both. A collective whose per-rank
    work ran on the caller's stream after the join read stale bytes here."""
    group = RankGroup("dp", 4, device=cuda_device)
    base = [torch.randn(1024, 4099, device=cuda_device) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    xs = [(b * 2).t() for b in base]
    got = coll.all_reduce(xs, group, algorithm=alg, codec=codec)
    gathered = coll.all_gather(xs, group, algorithm=alg, codec=codec, concat_axis=1)
    torch.cuda.synchronize()
    dense = [x.contiguous() for x in xs]
    with plain_collective_kernels():
        want = coll.all_reduce(dense, group, algorithm=alg, codec=codec)
        want_g = coll.all_gather(dense, group, algorithm=alg, codec=codec, concat_axis=1)
    assert bits_differ(got, want) == 0
    assert bits_differ(gathered, want_g) == 0


# ------------------------------------------------------------ fused GEMM hops
FG_WIRES = ("none", "int8", "fp8")
# (M, Ks, N): M = 1, odd Ks and N (the scalar load paths), a tile edge in
# every dimension, and a llama3-1b-like shard
FG_SHAPES = ((1, 8, 16), (6, 5, 24), (37, 7, 131), (130, 64, 200), (256, 512, 1024))


def _fg_payload(rng, shape, ints, dev):
    a = rng.integers(-4, 5, size=shape) if ints else rng.standard_normal(shape) * 2
    return torch.from_numpy(a.astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("ints", [True, False], ids=["ints", "normal"])
@pytest.mark.parametrize("shape", FG_SHAPES)
@pytest.mark.parametrize("wire", FG_WIRES)
@pytest.mark.parametrize("out_block", [False, True], ids=["accumulate", "out_block"])
def test_ag_hop_kernel_matches_plain(cuda_device, out_block, wire, shape, ints):
    """One row-14 launch against its plain version on the same inputs: the
    product (bit for bit on integer payloads, else by ``fused_gemm_close``), the
    received shard and the re-encoded own wire (bit for bit)."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    M, Ks, N = shape
    rng = np.random.default_rng(M + Ks + N)
    dev = cuda_device
    held = _fg_payload(rng, (Ks, N), ints, dev)
    x = _fg_payload(rng, (M, N) if out_block else (M, 3 * Ks), ints, dev)
    y0 = _fg_payload(rng, (M, 3 * Ks) if out_block else (M, N), ints, dev)
    upstream = _fg_payload(rng, (Ks, N), False, dev)
    qb = fused_gemm_qb(wire, Ks, N, 64)
    up = block_wire(wire, upstream, qb)

    def run(fn):
        y, recv = y0.clone(), torch.full((Ks, N), float("nan"), device=dev)
        own = None
        if wire != "none":
            own = (torch.empty(Ks * N, dtype=up[0].dtype, device=dev),
                   torch.empty(Ks * N // qb, device=dev))
        fn(x, held, y, Ks, up, recv, own, qb=qb, out_block=out_block)
        return y, recv, own

    before = fg.ag_hop.launches
    y, recv, own = run(fg.ag_hop)
    assert fg.ag_hop.launches == before + 1
    wy, wrecv, wown = run(fg.ag_hop_plain)
    torch.cuda.synchronize()
    if ints:
        assert bits_differ([y], [wy]) == 0
    else:
        assert fused_gemm_close(y, wy, N if out_block else Ks)[1]
    assert bits_differ([recv], [wrecv]) == 0
    if own is not None:
        assert bits_differ(list(own), list(wown)) == 0


# (Mb, K, N, block) beside FG_SHAPES (block 64): the encode's groups of tiles
# (csrc/fused_gemm.cu): qb 512 and 2048 dividing N (4 tiles, the full 16-tile
# width), qb 96 (groups of 3 tiles and 1), and qb not dividing N: 256 (4
# bands of 2 tile rows by 1 column) and 64 (3 bands of 1 tile row by 2 columns)
RS_GROUP_SHAPES = ((256, 64, 1024, 512), (256, 64, 2048, 2048), (64, 32, 480, 96),
                   (1024, 16, 3, 512), (384, 16, 200, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("ints", [True, False], ids=["ints", "normal"])
@pytest.mark.parametrize("shape", FG_SHAPES + RS_GROUP_SHAPES)
@pytest.mark.parametrize("wire", FG_WIRES)
@pytest.mark.parametrize("first", [True, False], ids=["first_hop", "later_hop"])
def test_rs_hop_kernel_matches_plain(cuda_device, first, wire, shape, ints):
    """One row-15 launch against its plain version: ``part = rprev + x[row0
    : row0 + Mb] @ w`` (bit for bit on integer payloads, else by
    ``fused_gemm_close``), and its codes: equal to the plain block math of the
    kernel's own partial, and to the plain version's on integer payloads."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    Mb, K, N = shape[:3]
    block = shape[3] if len(shape) > 3 else 64
    rng = np.random.default_rng(3 * Mb + K + N)
    dev = cuda_device
    x = _fg_payload(rng, (3 * Mb + 5, K), ints, dev)
    w = _fg_payload(rng, (K, N), ints, dev)
    rows = Mb + 3  # off any alignment
    qb = fused_gemm_qb(wire, Mb, N, block)
    upstream = _fg_payload(rng, (Mb, N), ints, dev)
    up = () if first else block_wire(wire, upstream, qb)

    def run(fn):
        part = torch.full((Mb, N), float("nan"), device=dev)
        own = None
        if wire != "none":
            own = (torch.empty(Mb * N, dtype=hops.WIRE_DTYPES[wire], device=dev),
                   torch.empty(Mb * N // qb, device=dev))
        fn(x, w, rows, up, part, own, qb=qb)
        return part, own

    before = fg.rs_hop.launches
    part, own = run(fg.rs_hop)
    assert fg.rs_hop.launches == before + 1
    wpart, wown = run(fg.rs_hop_plain)
    torch.cuda.synchronize()
    if ints:
        assert bits_differ([part], [wpart]) == 0
    else:
        assert fused_gemm_close(part, wpart, K)[1]
    if own is not None:
        assert bits_differ(list(own), list(block_wire(wire, part, qb))) == 0
        if ints:
            assert bits_differ(list(own), list(wown)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("wire", FG_WIRES)
@pytest.mark.parametrize("n", [2, 4])
def test_fused_gemm_ops_match_plain(cuda_device, n, wire):
    """The three ops over n ranks on the card through rows 14-15 against
    the same ops through the plain versions, on integer payloads: the exact
    wire bit for bit on every rank (and equal to the exact product); a lossy
    wire by ``fused_gemm_close`` (from the second hop on the products take decoded,
    non-integer shards, summed in the kernel's order); n - 1 launches of
    each row a rank and op, and the launches of rows 12-13 that receive or
    encode outside them."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    group = RankGroup("tp", n, device=cuda_device)
    rng = np.random.default_rng(n)
    M, Ks, N = 37, 24, 40
    x = [_fg_payload(rng, (M, n * Ks), True, cuda_device)] * n
    g = [_fg_payload(rng, (M, N), True, cuda_device)] * n
    ws = [_fg_payload(rng, (Ks, N), True, cuda_device) for _ in range(n)]
    a = [_fg_payload(rng, (n * 9, Ks), True, cuda_device) for _ in range(n)]
    kw = dict(codec=None if wire == "none" else wire, block_size=32, fused=True)

    def run():
        return (fg.all_gather_matmul(x, ws, group, **kw),
                fg.all_gather_matmul(g, ws, group, out_block=True, **kw),
                fg.matmul_reduce_scatter(a, ws, group, **kw))

    before = (fg.ag_hop.launches, fg.rs_hop.launches, hops.fused_hop.launches,
              hops.permute_leaves.launches)
    got = run()
    after = (fg.ag_hop.launches, fg.rs_hop.launches, hops.fused_hop.launches,
             hops.permute_leaves.launches)
    lossy = wire != "none"
    # lossy: one hop-0 encode a rank for each gather, one final decode-add a
    # rank for the scatter (row 13); exact: the scatter's final pull (row 12)
    assert [b - a_ for a_, b in zip(before, after)] == [
        2 * n * (n - 1), n * (n - 1), 3 * n if lossy else 0, 0 if lossy else n]
    with plain_collective_kernels():
        want = run()
    torch.cuda.synchronize()
    for got_op, want_op in zip(got, want):
        if lossy:
            assert all(fused_gemm_close(a_, b_, max(n * Ks, N))[1]
                       for a_, b_ in zip(got_op, want_op))
        else:
            assert bits_differ(got_op, want_op) == 0
    exact = torch.cat(ws) if not lossy else None
    if exact is not None:
        for r in range(n):
            assert torch.equal(got[0][r], x[r] @ exact)
            assert torch.equal(got[1][r], g[r] @ exact.t())


# phase 6c's four hop shapes (chip_smoke.py: 4 ranks at llama3-1b's MLP widths):
# row 14 accumulate (M, Ks, N), row 14 out_block, row 15's dw and row_parallel_linear
# (Mb, K, N)
FG_PHASE_AG = ((4096, 512, 8192),)
FG_PHASE_RS = ((512, 4096, 8192), (1024, 2048, 2048))
FG_FORMS = ("wgmma", "simt")


def _fg_takes(form, x, held_or_w, out, out_block=None):
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    if form == "simt":
        return True
    if out_block is None:
        return fg._rs_form(x, held_or_w, (), out, 0) == "wgmma"
    return fg._ag_form(x, held_or_w, out, out_block) == "wgmma"


def _ag_form_case(dev, form, out_block, wire, shape, ints, seed):
    """One row-14 launch through the named form against the plain version:
    (product ok, received shard bits differing, own wire bits differing,
    the outputs); None where the form does not take the shape (after
    checking that naming it raises)."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    M, Ks, N = shape
    rng = np.random.default_rng(seed)
    held = _fg_payload(rng, (Ks, N), ints, dev)
    x = _fg_payload(rng, (M, N) if out_block else (M, 3 * Ks), ints, dev)
    y0 = _fg_payload(rng, (M, 3 * Ks) if out_block else (M, N), ints, dev)
    upstream = _fg_payload(rng, (Ks, N), False, dev)
    qb = fused_gemm_qb(wire, Ks, N, 64)
    up = block_wire(wire, upstream, qb)
    if not _fg_takes(form, x, held, y0, out_block):
        with pytest.raises(ValueError, match="form 'wgmma' needs"):
            fg.ag_hop(x, held, y0.clone(), Ks, up, torch.empty(Ks, N, device=dev), qb=qb,
                      out_block=out_block, form=form)
        return None

    def run(fn, **kw):
        y, recv = y0.clone(), torch.full((Ks, N), float("nan"), device=dev)
        own = None
        if wire != "none":
            own = (torch.empty(Ks * N, dtype=up[0].dtype, device=dev),
                   torch.empty(Ks * N // qb, device=dev))
        fn(x, held, y, Ks, up, recv, own, qb=qb, out_block=out_block, **kw)
        return y, recv, own

    before = dict(fg.ag_hop.launches_by_form)
    got = run(fg.ag_hop, form=form)
    assert fg.ag_hop.launches_by_form[form] == before[form] + 1
    want = run(fg.ag_hop_plain)
    torch.cuda.synchronize()
    (y, recv, own), (wy, wrecv, wown) = got, want
    ok = bits_differ([y], [wy]) == 0 if ints else fused_gemm_close(y, wy, N if out_block else Ks)[1]
    own_bad = bits_differ(list(own), list(wown)) if own is not None else 0
    return ok, bits_differ([recv], [wrecv]), own_bad, got


@pytest.mark.cuda
@pytest.mark.parametrize("ints", [True, False], ids=["ints", "normal"])
@pytest.mark.parametrize("shape", FG_SHAPES + FG_PHASE_AG)
@pytest.mark.parametrize("wire", FG_WIRES)
@pytest.mark.parametrize("out_block", [False, True], ids=["accumulate", "out_block"])
@pytest.mark.parametrize("form", FG_FORMS)
def test_ag_hop_forms_match_plain(cuda_device, form, out_block, wire, shape, ints):
    """Each row-14 form by name against the plain version (form T only where
    it takes the shape; elsewhere naming it raises): the product bit for bit
    on integer payloads, else by ``fused_gemm_close``; the received shard and
    the re-encoded own wire bit for bit; the same bits on a second run."""
    case = _ag_form_case(cuda_device, form, out_block, wire, shape, ints, sum(shape))
    if case is None:
        return
    ok, recv_bad, own_bad, (y, recv, own) = case
    assert ok and recv_bad == 0 and own_bad == 0
    again = _ag_form_case(cuda_device, form, out_block, wire, shape, ints, sum(shape))[3]
    assert bits_differ([y, recv, *(own or ())], [again[0], again[1], *(again[2] or ())]) == 0


def _rs_form_case(dev, form, first, wire, shape, ints, seed):
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    Mb, K, N = shape[:3]
    block = shape[3] if len(shape) > 3 else 64
    rng = np.random.default_rng(seed)
    x = _fg_payload(rng, (3 * Mb + 5, K), ints, dev)
    w = _fg_payload(rng, (K, N), ints, dev)
    qb = fused_gemm_qb(wire, Mb, N, block)
    up = () if first else block_wire(wire, _fg_payload(rng, (Mb, N), ints, dev), qb)
    if not _fg_takes(form, x, w, torch.empty(Mb, N, device=dev)):
        with pytest.raises(ValueError, match="form 'wgmma' needs"):
            fg.rs_hop(x, w, Mb + 3, up, torch.empty(Mb, N, device=dev), qb=qb, form=form)
        return None

    def run(fn, **kw):
        part = torch.full((Mb, N), float("nan"), device=dev)
        own = None
        if wire != "none":
            own = (torch.empty(Mb * N, dtype=hops.WIRE_DTYPES[wire], device=dev),
                   torch.empty(Mb * N // qb, device=dev))
        fn(x, w, Mb + 3, up, part, own, qb=qb, **kw)
        return part, own

    before = dict(fg.rs_hop.launches_by_form)
    got = run(fg.rs_hop, form=form)
    assert fg.rs_hop.launches_by_form[form] == before[form] + 1
    want = run(fg.rs_hop_plain)
    torch.cuda.synchronize()
    (part, own), (wpart, wown) = got, want
    ok = bits_differ([part], [wpart]) == 0 if ints else fused_gemm_close(part, wpart, K)[1]
    if own is not None:
        ok = ok and bits_differ(list(own), list(block_wire(wire, part, qb))) == 0
        ok = ok and (not ints or bits_differ(list(own), list(wown)) == 0)
    return ok, got


@pytest.mark.cuda
@pytest.mark.parametrize("ints", [True, False], ids=["ints", "normal"])
@pytest.mark.parametrize("shape", FG_SHAPES + RS_GROUP_SHAPES + FG_PHASE_RS)
@pytest.mark.parametrize("wire", FG_WIRES)
@pytest.mark.parametrize("first", [True, False], ids=["first_hop", "later_hop"])
@pytest.mark.parametrize("form", FG_FORMS)
def test_rs_hop_forms_match_plain(cuda_device, form, first, wire, shape, ints):
    """Each row-15 form by name against the plain version: ``part`` bit for
    bit on integer payloads, else by ``fused_gemm_close``; its codes equal
    the plain block math of the kernel's own partial (and the plain
    version's on integers); the same bits on a second run."""
    case = _rs_form_case(cuda_device, form, first, wire, shape, ints, 3 * sum(shape))
    if case is None:
        return
    ok, (part, own) = case
    assert ok
    again = _rs_form_case(cuda_device, form, first, wire, shape, ints, 3 * sum(shape))[1]
    assert bits_differ([part, *(own or ())], [again[0], *(again[1] or ())]) == 0


@pytest.mark.cuda
def test_fused_gemm_wrappers_pick_form_t_where_tma_describes_the_hop(cuda_device):
    """Without a form named: aligned shapes run form T, odd N and a row
    stride off 4 floats form S, one launch counted by form."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    dev = cuda_device
    for shape, want in (((6, 5, 24), "wgmma"), ((37, 7, 131), "simt")):
        M, Ks, N = shape
        x = torch.ones(M, 4 * Ks if N % 4 == 0 else 3 * Ks, device=dev)
        held, y = torch.ones(Ks, N, device=dev), torch.zeros(M, N, device=dev)
        before = dict(fg.ag_hop.launches_by_form)
        fg.ag_hop(x, held, y, Ks, (held,), torch.empty_like(held), qb=Ks * N)
        assert {f: fg.ag_hop.launches_by_form[f] - before[f] for f in FG_FORMS} == \
            {f: int(f == want) for f in FG_FORMS}
        assert torch.equal(y, torch.full_like(y, float(Ks)))
    for K, want in ((8, "wgmma"), (7, "simt")):
        x, w, part = torch.ones(12, K, device=dev), torch.ones(K, 24, device=dev), \
            torch.empty(4, 24, device=dev)
        before = dict(fg.rs_hop.launches_by_form)
        fg.rs_hop(x, w, 4, (), part, qb=96)
        assert {f: fg.rs_hop.launches_by_form[f] - before[f] for f in FG_FORMS} == \
            {f: int(f == want) for f in FG_FORMS}
        assert torch.equal(part, torch.full_like(part, float(K)))


# a shape form T takes, the gather's column 2 past a 4-float boundary (the
# first box's skipped columns zeroed), the reduce-scatter's rows past row 0
FG_NONFINITE = (130, 64, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["accumulate", "out_block", "reduce_scatter"])
@pytest.mark.parametrize("form", FG_FORMS)
def test_fused_gemm_forms_carry_non_finite_operands_as_fp32(cuda_device, form, op):
    """+-inf and NaN in each operand, an inf meeting -inf and 0 at one k, and
    infs just outside the hop's columns or rows: each form by name (exact
    wire) has the plain version's NaNs and signed infs where it has them and
    the rest within ``fused_gemm_close`` (``fused_gemm_match``)."""
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    M, Ks, N = FG_NONFINITE
    inf, nan = float("inf"), float("nan")
    dev = cuda_device
    rng = np.random.default_rng(41)
    if op == "reduce_scatter":
        row0 = M + 3
        x = _fg_payload(rng, (3 * M + 5, Ks), False, dev)
        w = _fg_payload(rng, (Ks, N), False, dev)
        prev = _fg_payload(rng, (M, N), False, dev)
        x[row0 + 3, 10], w[10, 5], w[10, 7], x[row0 + 7, 20] = inf, -inf, 0.0, -inf
        w[30, 11], x[row0 + 12, 40], x[row0 - 1, 3], prev[20, 20] = inf, nan, inf, inf

        def run(fn, **kw):
            part = torch.full((M, N), nan, device=dev)
            fn(x, w, row0, (prev,), part, qb=M * N, **kw)
            return part

        got, want = run(fg.rs_hop, form=form), run(fg.rs_hop_plain)
    else:
        out_block = op == "out_block"
        col = Ks + 2
        held = _fg_payload(rng, (Ks, N), False, dev)
        x = _fg_payload(rng, (M, N) if out_block else (M, 3 * Ks), False, dev)
        y0 = _fg_payload(rng, (M, 3 * Ks) if out_block else (M, N), False, dev)
        if out_block:  # contraction over N
            x[3, 5], held[10, 5], x[4, 7], held[10, 7], x[12, 40], held[30, 11] = \
                inf, -inf, inf, 0.0, nan, inf
        else:
            x[3, col + 10], held[10, 5], held[10, 7], x[7, col + 20] = inf, -inf, 0.0, -inf
            held[30, 11], x[12, col + 40], x[5, col - 1], x[6, col + Ks] = inf, nan, inf, -inf

        def run(fn, **kw):
            y, recv = y0.clone(), torch.empty(Ks, N, device=dev)
            fn(x, held, y, col, (held,), recv, qb=Ks * N, out_block=out_block, **kw)
            return y

        got, want = run(fg.ag_hop, form=form), run(fg.ag_hop_plain)
    torch.cuda.synchronize()
    assert int((~torch.isfinite(want)).sum()) > 0
    err, ok = fused_gemm_match(got, want, N if op == "out_block" else Ks)
    assert ok, (err, int((torch.isnan(got) != torch.isnan(want)).sum()))


@pytest.mark.cuda
def test_fused_gemm_hops_refuse_bad_inputs(cuda_device):
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    dev = cuda_device
    held, x = torch.zeros(4, 8, device=dev), torch.zeros(3, 12, device=dev)
    y = torch.zeros(3, 8, device=dev)
    with pytest.raises(ValueError, match="do not fit"):  # columns past x
        fg.ag_hop(x, held, y, 10, (held,), torch.empty_like(held), qb=1)
    with pytest.raises(ValueError, match="contiguous 2-D fp32"):
        fg.ag_hop(x.half(), held, y, 0, (held,), torch.empty_like(held), qb=1)
    q = torch.zeros(32, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="whole number of blocks"):
        fg.ag_hop(x, held, y, 0, (q, torch.ones(2, device=dev)), torch.empty_like(held), qb=12)
    with pytest.raises(TypeError):
        fg.rs_hop(x, torch.zeros(12, 8, device=dev), 0, (q.half(),), torch.zeros(3, 8, device=dev),
                  qb=1)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        fg.rs_hop(x, torch.zeros(12, 8), 0, (), torch.zeros(3, 8, device=dev), qb=1)


def test_cpu_fused_gemm_hops_take_the_plain_versions():
    from deepspeed_tpu_torch.collectives import fused_gemm as fg

    group = RankGroup("tp", 4, device="cpu")
    rng = np.random.default_rng(0)
    ws = [_fg_payload(rng, (6, 10), True, "cpu") for _ in range(4)]
    x = [_fg_payload(rng, (5, 24), True, "cpu")] * 4
    before = (fg.ag_hop.launches, fg.rs_hop.launches)
    got = fg.all_gather_matmul(x, ws, group, codec="int8", block_size=32, fused=True)
    fg.matmul_reduce_scatter([_fg_payload(rng, (8, 6), True, "cpu") for _ in range(4)], ws, group,
                             fused=True)
    assert (fg.ag_hop.launches, fg.rs_hop.launches) == before
    assert all(torch.isfinite(o).all() for o in got)
