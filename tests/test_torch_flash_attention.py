"""Flash attention of the PyTorch port against the JAX package, on the CPU.

On the CPU the port's ``flash_causal_attention`` runs its three plain
versions (forward, dq, dkv) inside its ``autograd.Function``. Its output and
its q/k/v gradients for one numpy-seeded cotangent are held to the JAX
package's flash path (the Pallas kernels in interpret mode, as
``tests/unit/ops/test_pallas_kernels.py`` runs them) and to its XLA path,
and each plain piece to the JAX kernels' own values: ``lse`` of
``_flash_fwd``, and dq, dk, dv of ``_flash_bwd`` with the wrapper's
``hd**-0.5`` and ``ln 2`` applied. Cases: S 64 and 100 (not a multiple of
the 32-row blocks), MHA and G = 4, hd 16 and 32, with and without a
right-padding keep-mask. fp32, tolerance 1e-5 (the order of sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops as jops
from deepspeed_tpu.ops.attention import _xla_causal_attention
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.ops.pallas import register_all
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import causal_attention

register_all()

TOL = 1e-5
BLOCK = 32


def _inputs(S, kvH, hd, masked, B=2, H=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kvH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kvH, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    mask = None
    if masked:  # right padding: row 1 keeps its first 3/4 of the keys
        mask = np.ones((B, S), np.int32)
        mask[1, (3 * S) // 4:] = 0
    return q, k, v, do, mask


def _port(q, k, v, do, mask):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = causal_attention(qt, kt, vt, mask=None if mask is None else torch.from_numpy(mask),
                           block_q=BLOCK, block_k=BLOCK)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


def _jax(fn, q, k, v, do, mask):
    m = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, m), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


CASES = [(S, kvH, hd, masked) for S in (64, 100) for kvH in (4, 1) for hd in (16, 32)
         for masked in (False, True)]


@pytest.mark.parametrize("S,kvH,hd,masked", CASES)
def test_flash_matches_jax_flash_and_xla(S, kvH, hd, masked):
    q, k, v, do, mask = _inputs(S, kvH, hd, masked)
    got = _port(q, k, v, do, mask)
    pallas = jops.dispatch("causal_attention", "pallas")
    want_flash = _jax(lambda a, b, c, m: pallas(a, b, c, mask=m, block_q=BLOCK, block_k=BLOCK),
                      q, k, v, do, mask)
    want_xla = _jax(lambda a, b, c, m: _xla_causal_attention(a, b, c, mask=m), q, k, v, do, mask)
    for g, wf, wx in zip(got, want_flash, want_xla):
        _close(g, wf)
        _close(g, wx)


@pytest.mark.parametrize("S,kvH,masked", [(64, 1, True), (100, 4, False)])
def test_plain_pieces_match_jax_kernels(S, kvH, masked):
    """lse, dq, dk and dv of the port's plain versions against the JAX
    kernels' own outputs (interpret mode) on the same pre-scaled q."""
    hd = 16
    q, k, v, do, mask = _inputs(S, kvH, hd, masked)
    keep = np.ones((q.shape[0], S), np.int32) if mask is None else mask
    qs = fa.prescale_q(torch.from_numpy(q))
    kt, vt, dot = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do)
    keep_t = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_fwd(qs, kt, vt, keep_t)
    delta = fa.flash_delta(dot, out)
    dq = fa.flash_bwd_dq(qs, kt, vt, keep_t, dot, lse, delta)
    dk, dv = fa.flash_bwd_dkv(qs, kt, vt, keep_t, dot, lse, delta)

    # the JAX kernels on [B, H, S, hd], S padded to the block as its wrapper pads
    Sp = -(-S // BLOCK) * BLOCK
    pad = lambda a: np.pad(a, ((0, 0), (0, Sp - S), (0, 0), (0, 0))).transpose(0, 2, 1, 3)  # noqa: E731
    jq, jk, jv, jdo = (jnp.asarray(pad(a)) for a in (qs.numpy(), k, v, do))
    jkeep = jnp.asarray(np.pad(keep, ((0, 0), (0, Sp - S))))[:, None, :]
    slopes = jnp.zeros((q.shape[2], 8), jnp.float32)
    jout, jlse = jfa._flash_fwd(jq, jk, jv, jkeep, slopes, BLOCK, BLOCK, True, masked, False)
    jdq, jdk, jdv = jfa._flash_bwd(jq, jk, jv, jkeep, slopes, jout, jlse, jdo, BLOCK, BLOCK,
                                   True, masked, False)
    unpad = lambda a: np.asarray(a)[:, :, :S].transpose(0, 2, 1, 3)  # noqa: E731
    _close(out.numpy(), unpad(jout))
    _close(lse.numpy(), np.asarray(jlse)[:, :, :S, 0])
    _close(dq.numpy(), unpad(jdq) * hd ** -0.5)
    _close(dk.numpy(), unpad(jdk) * jfa._LN2)
    _close(dv.numpy(), unpad(jdv))


def test_scheduling_kwargs_accepted_alibi_and_bias_refused():
    q, k, v, _, _ = _inputs(16, 2, 16, False)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    base = causal_attention(qt, kt, vt)
    torch.testing.assert_close(causal_attention(qt, kt, vt, block_q=8, block_k=8, k_splits=2), base)
    with pytest.raises(NotImplementedError):
        causal_attention(qt, kt, vt, alibi_slopes=torch.ones(4))
    with pytest.raises(NotImplementedError):
        causal_attention(qt, kt, vt, bias=torch.zeros(4, 16, 16))
    with pytest.raises(NotImplementedError):
        causal_attention(qt, kt, vt, impl="xla")
    with pytest.raises(TypeError):
        causal_attention(qt, kt, vt, block_m=8)


@pytest.mark.parametrize("S,kvH", [(64, 4), (100, 1)])
def test_left_padded_rows_match_jax_flash(S, kvH):
    """Left padding: row 1 drops its first S/4 keys, so its first S/4 queries
    see no key at all. The port gives them output 0 and zero gradients, as
    JAX's flash kernels (interpret mode) do; every other value within 1e-5."""
    q, k, v, do, _ = _inputs(S, kvH, 16, False)
    mask = np.ones((q.shape[0], S), np.int32)
    mask[1, : S // 4] = 0
    got = _port(q, k, v, do, mask)
    pallas = jops.dispatch("causal_attention", "pallas")
    want = _jax(lambda a, b, c, m: pallas(a, b, c, mask=m, block_q=BLOCK, block_k=BLOCK),
                q, k, v, do, mask)
    for g, w in zip(got, want):
        _close(g, w)
    out, dq = got[0], got[1]
    assert np.all(out[1, : S // 4] == 0) and np.all(dq[1, : S // 4] == 0)
    assert np.all(want[0][1, : S // 4] == 0)
