"""Paged attention of the PyTorch port against the JAX package.

The port's plain version (what ``paged_attention`` runs on a CPU tensor) is
held to the JAX Pallas kernel ``flash_decode_paged`` (interpret mode, as
``tests/unit/ops/test_paged_attention.py`` runs it) and to the XLA version
``_xla_paged_attention``, on the same numpy-seeded inputs: the cases of that
file (pages-per-block 1/2/8, C = 1, GQA 8/4) plus a batch with a pad row
(``new_lens == 0``) and large finite garbage in the pages the block-table
tails point at. Tolerance 2e-5 in fp32, the JAX pair's own. Neither package
gives the op a backward, so the port refuses an input that requires grad
while grad mode is on.
The quantised form (int8 and e4m3 pools with per-(slot, kv head) fp32
scales, dequantised after the gather) is held to both JAX versions on one
pool quantised once by JAX's ``_kv_block_quant`` and handed to all three, at
2e-6 as ``test_fused_pallas_loads_match_xla_fallback``.
The CUDA kernels are held to the plain version in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.paged import _kv_block_quant, _xla_paged_attention
from deepspeed_tpu.ops.pallas.paged_attention import flash_decode_paged
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_quant


def _setup(N=3, C=4, H=8, kvH=2, hd=32, P=6, bs=16, seed=0, ends=(5, 37, 90)):
    """Distinct random pages per row; row n ends at position ends[n]."""
    rng = np.random.default_rng(seed)
    S_flat = 64 * bs + 1
    q = rng.standard_normal((N, C, H, hd)).astype(np.float32)
    pk = rng.standard_normal((S_flat, kvH, hd)).astype(np.float32)
    pv = rng.standard_normal((S_flat, kvH, hd)).astype(np.float32)
    bt = rng.permutation(64)[: N * P].reshape(N, P).astype(np.int32)
    ends = np.asarray(ends)[:N]
    pos = np.stack([np.arange(C) + e - C + 1 for e in ends]).astype(np.int32)
    lens = np.full((N,), C, np.int32)
    return q, pk, pv, bt, pos, lens, bs


def _setup_pad_and_garbage(bs=16, hd=32):
    """Row 0 live (positions 16..19), row 1 a pad row (new_lens 0, position
    0, block-table row 0), row 2 live with 2 of C = 4 columns; the
    block-table entries past each live row's pages point at pages full of
    +-1e4."""
    rng = np.random.default_rng(7)
    N, C, H, kvH, P = 3, 4, 8, 2, 6
    S_flat = 32 * bs + 1
    q = rng.standard_normal((N, C, H, hd)).astype(np.float32)
    pk = rng.standard_normal((S_flat, kvH, hd)).astype(np.float32)
    pv = rng.standard_normal((S_flat, kvH, hd)).astype(np.float32)
    garbage = [20, 21, 22, 23]
    for b in garbage:
        pk[b * bs:(b + 1) * bs] = 1e4
        pv[b * bs:(b + 1) * bs] = -1e4
    bt = np.zeros((N, P), np.int32)
    bt[0] = [3, 5, 20, 21, 22, 23]   # live length 20 -> pages 0..1
    bt[2] = [7, 22, 23, 20, 21, 22]  # live length 2 -> page 0
    lens = np.asarray([4, 0, 2], np.int32)
    pos = np.zeros((N, C), np.int32)
    pos[0] = np.arange(16, 20)
    pos[2, :2] = [0, 1]  # columns past new_lens keep position 0, as the batch builder writes
    return q, pk, pv, bt, pos, lens, bs


def _port(q, pk, pv, bt, pos, lens, bs):
    t = torch.from_numpy
    return paged_attention(t(q), t(pk), t(pv), t(bt), t(pos), bs, new_lens=t(lens)).numpy()


def _check(args, ppcb=8):
    q, pk, pv, bt, pos, lens, bs = args
    j = [jnp.asarray(a) for a in (q, pk, pv, bt, pos)]
    xla = np.asarray(_xla_paged_attention(*j, bs))
    pallas = np.asarray(flash_decode_paged(*j, bs, new_lens=jnp.asarray(lens), pages_per_block=ppcb))
    got = _port(*args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ppcb", [1, 2, 8])
def test_paged_matches_jax(ppcb):
    _check(_setup(), ppcb)


def test_paged_decode_single_token():
    _check(_setup(C=1))


def test_paged_gqa_grouping():
    _check(_setup(H=8, kvH=4, hd=16))


@pytest.mark.parametrize("ppcb", [1, 8])
def test_paged_pad_row_and_garbage_tails(ppcb):
    _check(_setup_pad_and_garbage(), ppcb)


def test_paged_refuses_gradients():
    t = [torch.from_numpy(a) for a in _setup()[:6]]
    q = t[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        paged_attention(q, *t[1:5], 16, new_lens=t[5])
    with torch.no_grad():
        out = paged_attention(q, *t[1:5], 16, new_lens=t[5])
    assert out.shape == q.shape and not out.requires_grad


def _to_torch(a):
    """numpy (ml_dtypes e4m3 included) -> torch, by the bytes."""
    a = np.asarray(a)
    if str(a.dtype) == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("case", ["pages", "pad_and_garbage"])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_paged_quantized_matches_jax(quant, case):
    q, pk, pv, bt, pos, lens, bs = _setup() if case == "pages" else _setup_pad_and_garbage()
    kq, ks = _kv_block_quant(jnp.asarray(pk), quant)
    vq, vs = _kv_block_quant(jnp.asarray(pv), quant)
    j = [jnp.asarray(a) for a in (q,)] + [kq, vq] + [jnp.asarray(a) for a in (bt, pos)]
    xla = np.asarray(_xla_paged_attention(*j, bs, k_scale=ks, v_scale=vs))
    pallas = np.asarray(flash_decode_paged(*j, bs, new_lens=jnp.asarray(lens),
                                           k_scale=ks, v_scale=vs))
    t = torch.from_numpy
    args = (t(q), _to_torch(kq), _to_torch(vq), t(bt), t(pos), bs)
    scales = dict(k_scale=_to_torch(ks), v_scale=_to_torch(vs))
    got = paged_attention(*args, new_lens=t(lens), **scales).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, xla, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=2e-6)
    direct = paged_attention_quant(*args, t(lens), scales["k_scale"], scales["v_scale"])
    np.testing.assert_array_equal(direct.numpy(), got)


def test_paged_quantized_needs_both_scales():
    q, pk, pv, bt, pos, lens, bs = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                    for a in _setup())
    with pytest.raises(ValueError, match="both"):
        paged_attention(q, pk, pv, bt, pos, bs, new_lens=lens, k_scale=torch.ones(1))


# ---------------------------------------------------------------- the kernel's forms
# (the kernels themselves are held to the plain version on the card in
# test_torch_kernels.py; here the form choice, the split plan and a plain model
# of form "split"'s algorithm)

import importlib  # noqa: E402

from deepspeed_tpu_torch.inference.paged import _kv_block_quant as _port_kv_quant  # noqa: E402
from deepspeed_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention_reference,
    paged_attention_split_model,
    paged_form,
    split_plan,
)

# the module (``ops`` re-exports its function of the same name)
pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,C,G,bs,want", [
    # decode takes form "split" whatever G, dtype and bs
    (BF16, 128, 1, 4, 16, "split"), (BF16, 128, 1, 1, 16, "split"), (BF16, 64, 1, 71, 16, "split"),
    (F32, 128, 1, 32, 16, "split"), (BF16, 128, 1, 4, 5, "split"), (BF16, 128, 1, 4, 256, "split"),
    # the boundary is C: C = 1 takes form "split" at every G, C = 2 does not
    (F32, 64, 1, 1, 16, "split"), (F32, 128, 1, 4, 8, "split"),
    (BF16, 128, 1, 1, 12, "split"), (BF16, 64, 1, 8, 16, "split"),
    (BF16, 128, 2, 1, 16, "wgmma"), (BF16, 128, 2, 2, 16, "wgmma"),
    (BF16, 128, 2, 4, 16, "wgmma"), (BF16, 64, 512, 4, 16, "wgmma"),
    # above it: fp32 and the pages TMA cannot take go to form S
    (F32, 128, 2, 1, 16, "simt"), (F32, 128, 2, 2, 16, "simt"),
    (F32, 64, 512, 4, 16, "simt"),
    (BF16, 128, 512, 4, 8, "wgmma"), (BF16, 128, 512, 4, 128, "wgmma"),
    (BF16, 128, 512, 4, 12, "simt"), (BF16, 128, 512, 4, 4, "simt"), (BF16, 128, 512, 4, 1, "simt"),
    (BF16, 128, 512, 4, 136, "simt"), (BF16, 128, 512, 4, 256, "simt"),
    (BF16, 96, 512, 4, 16, "simt"),
])
def test_paged_form_boundaries(dtype, hd, C, G, bs, want):
    assert paged_form(dtype, hd, C, G, bs) == want


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("name,N,kvH,P", [
    ("llama-8b decode", 8, 8, 128), ("bloom-7b1 decode", 8, 32, 128),
    ("mixtral decode", 16, 8, 128), ("llama-8b decode, P=63", 8, 8, 63),
    ("one page", 8, 8, 1), ("one page, one pair", 1, 1, 1), ("many pairs", 64, 32, 128),
])
def test_split_plan(name, N, kvH, P, tensor_cores):
    sms = 132
    per_sm, span_pages = pa_mod.SPLIT_PLAN[tensor_cores]
    splits, span = split_plan(N, kvH, P, sms, tensor_cores)
    assert 1 <= splits <= P and span >= 1
    assert splits * span >= P and (splits - 1) * span < P  # a full-length row: every span live
    assert span <= span_pages  # a long row spreads over enough blocks
    blocks = N * kvH * splits
    if P == 1 or (N * kvH >= per_sm * sms and P <= span_pages):
        assert splits == 1
    elif P <= span_pages * per_sm * sms // (N * kvH):  # about the plan's blocks an SM
        assert per_sm * sms // 2 <= blocks <= per_sm * sms, blocks


@pytest.mark.parametrize("tensor_cores,shape,want", [
    (True, (8, 8, 128), (8, 16)),  # Llama decode, a 2048-token table: the span bound
    (True, (8, 8, 63), (4, 16)),  # its pairs: ~2 blocks an SM
    (True, (8, 32, 128), (8, 16)),  # Bloom
    (True, (16, 8, 128), (8, 16)),  # Mixtral
    (False, (8, 8, 128), (16, 8)),  # an int8 pool: more, shorter spans
    (False, (8, 8, 63), (8, 8)),
    (False, (8, 32, 128), (16, 8)),
    (True, (8, 8, 1), (1, 1)),
])
def test_split_plan_values(tensor_cores, shape, want):
    assert split_plan(*shape, 132, tensor_cores) == want


@pytest.mark.parametrize("N,kvH,R,P,bs,want", [
    (8, 8, 1008 * 4, 128, 16, (1, 128)),  # an 8-prompt prefill [8, 1008]: blocks enough
    (5, 8, 512 * 4, 62, 16, (1, 62)),  # the [5, 512] chunk of phase 7
    (8, 8, 8, 63, 16, (2, 32)),  # C = 2, G = 4: 64 blocks, 2 spans of whole tiles
    (3, 8, 20, 48, 16, (3, 16)),  # C = 5: a span of two tiles
    (1, 1, 8, 128, 32, (32, 4)),  # one unit: a tile (4 pages of 32) a span
])
def test_w_plan(N, kvH, R, P, bs, want):
    """Form W splits its keys only where its blocks do not fill the SMs, in
    spans of whole 128-key tiles."""
    splits, span = pa_mod.w_plan(N, kvH, R, P, bs, 132)
    assert (splits, span) == want
    assert span % (pa_mod.W_TILE_KEYS // bs) == 0 or splits == 1
    assert splits * span >= P and (splits - 1) * span < P


def _fp32_model_case(case, G, kv=None, alibi=False):
    """(tensors, block_size) of a model case in fp32: q, pools (codes and
    scales with ``kv``), block tables, positions, new_lens; ALiBi slopes."""
    H, kvH = (8, 8) if G == 1 else (8, 2)
    if case == "pad_and_garbage":
        q, pk, pv, bt, pos, lens, bs = _setup_pad_and_garbage()
    else:
        q, pk, pv, bt, pos, lens, bs = _setup(C=1 if case == "decode" else 4, H=H, kvH=kvH)
        if case == "nothing_visible":
            pos[1], lens[1] = -1, 0  # a row that sees no key: output 0
    if case == "pad_and_garbage" and G == 1:
        q = np.concatenate([q] * 4, axis=2)[:, :, :8]
        pk, pv = (np.concatenate([x] * 4, axis=1) for x in (pk, pv))
    t = {k: torch.from_numpy(v) for k, v in dict(q=q, pool_k_l=pk, pool_v_l=pv, block_tables=bt,
                                                   q_positions=pos, new_lens=lens).items()}
    if kv is not None:
        t["pool_k_l"], t["k_scale"] = _port_kv_quant(t["pool_k_l"], kv)
        t["pool_v_l"], t["v_scale"] = _port_kv_quant(t["pool_v_l"], kv)
    if alibi:
        t["alibi_slopes"] = torch.tensor([2.0 ** (-(i + 1) / 2) for i in range(q.shape[2])])
    return t, bs


@pytest.mark.parametrize("splits", [1, 2, 6])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("case", ["prefill", "decode", "nothing_visible", "pad_and_garbage"])
def test_split_model_matches_plain(case, G, kv, alibi, splits):
    """Form "split"'s algorithm (per-warp online softmax over 16-token chunks,
    the warps' and the splits' partials merged in the kernel's order) against
    the plain version in fp32 within 1e-6: one split, two, and one a page
    (most of them past the rows' live pages: empty partials); pad rows and
    block-table tails pointing at +-1e4 pages; a row that sees no key gives
    0 (the plain version's -1e30 fill gives it the mean of the gathered
    values, so it is held apart)."""
    t, bs = _fp32_model_case(case, G, kv, alibi)
    got = paged_attention_split_model(block_size=bs, splits=splits, **t)
    want = paged_attention_reference(block_size=bs, **t)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    dead = (t["q_positions"] < 0)  # [N, C]
    assert bool((got[dead] == 0).all())
    torch.testing.assert_close(got[~dead], want[~dead], rtol=1e-6, atol=1e-6)
    if splits > 1:  # the split only reorders the sums
        one = paged_attention_split_model(block_size=bs, splits=1, **t)
        torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)


def test_split_model_row_groups():
    """C * G = 20 rows: two row groups of 16 in the kernel, each with its own
    live pages; the model's result is the plain version's."""
    t, bs = _fp32_model_case("prefill", 4)
    t["q"] = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 5, 8, 32)).astype(np.float32))
    t["q_positions"] = torch.stack([torch.arange(5) + e - 4 for e in (5, 37, 90)]).int()
    t["new_lens"] = torch.full((3,), 5, dtype=torch.int32)
    torch.testing.assert_close(paged_attention_split_model(block_size=bs, splits=3, **t),
                               paged_attention_reference(block_size=bs, **t), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["split", "wgmma", "simt", "nope"])
def test_named_form_on_cpu_raises(form, monkeypatch):
    """A form is a kernel: named on a CPU tensor it raises and the plain
    version does not run."""
    calls = []
    monkeypatch.setattr(pa_mod, "paged_attention_reference", lambda *a, **k: calls.append(1))
    t, bs = _fp32_model_case("prefill", 4)
    before = (pa_mod.paged_attention.launches, dict(pa_mod.paged_attention.launches_by_form))
    with pytest.raises(ValueError):
        pa_mod._paged_attention_form(t["q"], t["pool_k_l"], t["pool_v_l"], t["block_tables"],
                                     t["q_positions"], bs, t["new_lens"], form)
    assert not calls
    assert (pa_mod.paged_attention.launches, pa_mod.paged_attention.launches_by_form) == before
