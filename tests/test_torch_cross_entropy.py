"""Fused LM-head cross entropy of the PyTorch port against the JAX package.

``lm_head_cross_entropy`` (the port's ``autograd.Function`` over a chunked
vocabulary) is held to the JAX package's ``lm_head_cross_entropy`` (its
``custom_vjp``, a ``lax.scan`` over vocab chunks) on the same numpy-seeded
inputs: the loss and its gradients in x and the embedding, for one seed.
V = 101 with chunk 32 gives JAX's chunking of 4 chunks of 26 columns, the
last one short; labels carry ``ignore_index`` entries and a pad mask drops a
row's tail. Also held to the port's unfused ``cross_entropy_loss`` over the
whole logits. fp32, tolerance 1e-5 (the order of sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.cross_entropy import lm_head_cross_entropy as jax_lm_head_ce
from deepspeed_tpu_torch.models import cross_entropy_loss
from deepspeed_tpu_torch.ops.cross_entropy import lm_head_cross_entropy

TOL = 1e-5


def _inputs(B=3, S=10, D=16, V=101, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    embed = (0.5 * rng.standard_normal((V, D))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, -1] = -100
    labels[0, 2] = -100
    pad = None
    if masked:
        pad = np.ones((B, S), np.int32)
        pad[2, 6:] = 0
    return x, embed, labels, pad


def _port(x, embed, labels, pad, chunk_size):
    xt, et = (torch.from_numpy(a).requires_grad_(True) for a in (x, embed))
    loss = lm_head_cross_entropy(xt, et, torch.from_numpy(labels),
                                 None if pad is None else torch.from_numpy(pad),
                                 chunk_size=chunk_size)
    loss.backward()
    return float(loss.detach()), xt.grad.numpy(), et.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("chunk_size,masked", [(32, True), (32, False), (8192, True)])
def test_fused_ce_matches_jax(chunk_size, masked):
    x, embed, labels, pad = _inputs(masked=masked)
    jpad = None if pad is None else jnp.asarray(pad)
    want_loss, (want_dx, want_de) = jax.value_and_grad(
        lambda a, e: jax_lm_head_ce(a, e, jnp.asarray(labels), jpad, chunk_size=chunk_size),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(embed))
    loss, dx, de = _port(x, embed, labels, pad, chunk_size)
    _close(np.float32(loss), np.asarray(want_loss))
    _close(dx, np.asarray(want_dx))
    _close(de, np.asarray(want_de))


def test_fused_ce_matches_unfused_loss():
    x, embed, labels, pad = _inputs(seed=1)
    loss, dx, de = _port(x, embed, labels, pad, chunk_size=32)
    xt, et = (torch.from_numpy(a).requires_grad_(True) for a in (x, embed))
    want = cross_entropy_loss(xt @ et.t(), torch.from_numpy(labels), torch.from_numpy(pad))
    want.backward()
    _close(np.float32(loss), want.detach().numpy())
    _close(dx, xt.grad.numpy())
    _close(de, et.grad.numpy())
