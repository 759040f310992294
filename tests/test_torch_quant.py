"""Block quantisation of the PyTorch port against the JAX package, on the CPU.

``quantize_int8`` / ``dequantize_int8`` (``ops/quant.py``, the wrappers of
``csrc/quantizer.cu``; on a CPU tensor their plain versions) are held to the
JAX block math run eagerly (``int8_block_math``, ``_xla_quantize_int8``) and
to the Pallas kernels in interpret mode (``pallas_quantize_int8``,
``pallas_dequantize_int8``), on the same numpy-seeded inputs: fp32 and bf16,
n a multiple of 2048, 2048 * 37 + 123 and 100, with an all-zero block.

Tolerances. Scales equal the eager JAX scales exactly. The interpret-mode
Pallas call runs under jit, where XLA's CPU compiler turns ``absmax / 127``
into a multiply by the reciprocal: its scales may sit one fp32 ulp away.
Codes are identical, or one code apart in at most 1e-4 of the entries: a
quotient that lands on a rounding tie (x / scale = k + 0.5) rounds to either
side when the two divisions differ by an ulp. Dequantisation of the same
codes is bit-equal. fp8 and int4 (jnp in JAX, plain PyTorch here) are equal.

Stochastic rounding has no JAX counterpart off the TPU (the Pallas kernel
falls back to nearest rounding there), so its plain version is held to its
rule: each code is floor or floor + 1 of x / scale, a seed gives the same
codes, another seed others, and the rounding is unbiased.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fp_quant as jax_fp
from deepspeed_tpu.ops import quant as jax_quant
from deepspeed_tpu.ops.pallas.quantizer import pallas_dequantize_int8, pallas_quantize_int8
from deepspeed_tpu_torch.ops import fp_quant, quant

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
SIZES = (2048 * 6, 2048 * 37 + 123, 100)


def _inputs(n, dtype_name, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    if n > 2 * 2048:
        x[2048:4096] = 0.0  # one all-zero block
    tdt, jdt = DTYPES[dtype_name]
    xt = torch.from_numpy(x).to(tdt)
    return xt, jnp.asarray(xt.float().numpy()).astype(jdt)


def assert_codes_tie_rule(got, want):
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max(initial=0) <= 1
    assert (diff != 0).sum() <= 1e-4 * diff.size, (diff != 0).sum()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_codes_match_jax(n, dtype):
    xt, xj = _inputs(n, dtype)
    q, s = quant.quantize_int8(xt)
    assert q.dtype == torch.int8 and q.shape == (n,)
    assert s.dtype == torch.float32 and s.shape == (-(-n // min(2048, n)),)
    qx, sx = jax_quant._xla_quantize_int8(xj)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sx))
    assert_codes_tie_rule(q.numpy(), qx)
    qp, sp = pallas_quantize_int8(xj)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sp), maxulp=1)
    assert_codes_tie_rule(q.numpy(), qp)
    if n > 2 * 2048:
        assert s[1] == 1.0 and bool((q[2048:4096] == 0).all())


def test_block_math_matches_jax():
    rng = np.random.default_rng(1)
    x2 = (rng.standard_normal((16, 256)) * 2).astype(np.float32)
    x2[3] = 0.0
    q, s = quant.int8_block_math(torch.from_numpy(x2))
    qj, sj = jax_quant.int8_block_math(jnp.asarray(x2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert_codes_tie_rule(q.numpy(), qj)
    np.testing.assert_array_equal(quant.int8_block_dequant(q, s).numpy(),
                                  np.asarray(jax_quant.int8_block_dequant(qj, sj)))
    q8, s8 = quant.fp8_block_math(torch.from_numpy(x2))
    q8j, s8j = jax_quant.fp8_block_math(jnp.asarray(x2))
    np.testing.assert_array_equal(s8.numpy(), np.asarray(s8j))
    np.testing.assert_array_equal(q8.float().numpy(), np.asarray(q8j).astype(np.float32))
    np.testing.assert_array_equal(quant.fp8_block_dequant(q8, s8).numpy(),
                                  np.asarray(jax_quant.fp8_block_dequant(q8j, s8j)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("out", sorted(DTYPES))
def test_dequant_matches_jax(n, out):
    _, xj = _inputs(n, "fp32", seed=2)
    qj, sj = pallas_quantize_int8(xj)
    tdt, jdt = DTYPES[out]
    shape = (n // 4, 4) if n % 4 == 0 else (n,)
    want = pallas_dequantize_int8(qj, sj, shape, jdt)
    got = quant.dequantize_int8(torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(sj)),
                                shape, tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(64, 96), (3, 1000, 6), (10,)])
def test_fp8_and_int4_match_jax(shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    q, s = fp_quant.quantize_fp8(torch.from_numpy(x))
    qj, sj = jax_fp.quantize_fp8(jnp.asarray(x))
    assert q.shape == qj.shape and q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(q.float().numpy(), np.asarray(qj).astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    for tdt, jdt in DTYPES.values():
        np.testing.assert_array_equal(
            fp_quant.dequantize_fp8(q, s, tdt).float().numpy(),
            np.asarray(jax_fp.dequantize_fp8(qj, sj, jdt).astype(jnp.float32)))
    p, s4 = fp_quant.quantize_int4(torch.from_numpy(x))
    pj, s4j = jax_fp.quantize_int4(jnp.asarray(x))
    assert p.dtype == torch.uint8 and p.shape == pj.shape
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(s4.numpy(), np.asarray(s4j))
    for tdt, jdt in DTYPES.values():
        np.testing.assert_array_equal(
            fp_quant.dequantize_int4(p, s4, tdt).float().numpy(),
            np.asarray(jax_fp.dequantize_int4(pj, s4j, jdt).astype(jnp.float32)))


def test_int4_rejects_odd_trailing_dim():
    with pytest.raises(ValueError, match="even trailing dim"):
        fp_quant.quantize_int4(torch.zeros(4, 3))


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_uniform_bits_are_the_murmur3_finaliser():
    """The int64-masked torch hash equals the uint32 arithmetic that
    ``csrc/quantizer.cu:uniform_bits`` does, here in Python ints."""
    idx = [0, 1, 2, 12345, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7, 3 * 2 ** 33 + 5]
    for seed in (0, 1, 2 ** 31 + 3):
        key = _fmix32(seed & 0xFFFFFFFF)
        assert quant._seed_key(seed) == key
        want = [_fmix32(_fmix32((i & 0xFFFFFFFF) ^ key) ^ (i >> 32)) for i in idx]
        got = quant._uniform_bits(torch.tensor(idx, dtype=torch.int64), seed)
        assert got.tolist() == want


def test_stochastic_plain_version_rounds_unbiased():
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(64 * 2048) * 2).astype(np.float32))
    q, s = quant.quantize_int8(x, stochastic=True, seed=7)
    q2, s2 = quant.quantize_int8(x, stochastic=True, seed=7)
    q3, _ = quant.quantize_int8(x, stochastic=True, seed=8)
    assert torch.equal(q, q2) and torch.equal(s, s2) and not torch.equal(q, q3)
    _, s_near = quant.quantize_int8(x)
    assert torch.equal(s, s_near)
    scaled = x.reshape(64, 2048) / s[:, None]
    low = torch.floor(scaled)
    codes = q.reshape(64, 2048).float()
    assert bool(((codes == low) | (codes == low + 1)).all())
    frac = scaled - low
    err = codes - scaled  # mean 0 for unbiased rounding, variance frac (1 - frac)
    sigma = float(torch.sqrt((frac * (1 - frac)).sum())) / err.numel()
    assert abs(float(err.mean())) <= 4 * sigma


def test_wrappers_take_the_plain_versions_on_cpu():
    x = torch.randn(5000)
    before = (quant.quantize_int8.launches, quant.quantize_int8_stochastic.launches,
              quant.dequantize_int8.launches)
    q, s = quant.quantize_int8(x)
    ref_q, ref_s = quant.quantize_int8_reference(x)
    assert torch.equal(q, ref_q) and torch.equal(s, ref_s)
    sq, ss = quant.quantize_int8(x, stochastic=True, seed=3)
    ref_sq, _ = quant.quantize_int8_stochastic_reference(x, seed=3)
    assert torch.equal(sq, ref_sq)
    torch.testing.assert_close(quant.dequantize_int8(q, s, (5000,), torch.float32),
                               quant.dequantize_int8_reference(q, s, (5000,), torch.float32))
    after = (quant.quantize_int8.launches, quant.quantize_int8_stochastic.launches,
             quant.dequantize_int8.launches)
    assert after == before
