"""Paged attention of the PyTorch port against the JAX package.

The port's plain version (what ``paged_attention`` runs on a CPU tensor) is
held to the JAX Pallas kernel ``flash_decode_paged`` (interpret mode, as
``tests/unit/ops/test_paged_attention.py`` runs it) and to the XLA version
``_xla_paged_attention``, on the same numpy-seeded inputs: the cases of that
file (pages-per-block 1/2/8, C = 1, GQA 8/4) plus a batch with a pad row
(``new_lens == 0``) and large finite garbage in the pages the block-table
tails point at. Tolerance 2e-5 in fp32, the JAX pair's own.
The CUDA kernel is held to the plain version in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.paged import _xla_paged_attention
from deepspeed_tpu.ops.pallas.paged_attention import flash_decode_paged
from deepspeed_tpu_torch.ops.paged_attention import paged_attention


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
