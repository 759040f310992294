"""RMSNorm of the PyTorch port against the JAX package.

On the CPU the port's ``rms_norm`` runs its plain version; it is held to the
JAX Pallas kernel (interpret mode, as ``tests/unit/ops/test_pallas_kernels.py``
runs it) and to the XLA version, on the same numpy-seeded inputs. R = 300 rows
is not a multiple of the Pallas kernel's 256-row block. Tolerances: 1e-5 in
fp32 (summation order only), 1e-2 in bf16 (one bf16 ulp at |y| < 4).
The CUDA kernel is held to the plain version in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.norms import _xla_rms_norm
from deepspeed_tpu.ops.pallas.norms import pallas_rms_norm
from deepspeed_tpu_torch.ops.norms import rms_norm



DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rms_norm_matches_jax(dtype, impl):
    jdt, tdt, tol = DTYPES[dtype]
    x, scale = _inputs((300, 64))
    jfn = pallas_rms_norm if impl == "pallas" else _xla_rms_norm
    want = np.asarray(jfn(jnp.asarray(x, jdt), jnp.asarray(scale, jdt), eps=1e-5).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale).to(tdt), eps=1e-5)
    assert got.dtype == tdt and got.shape == (300, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_rms_norm_leading_dims_and_mixed_scale_dtype():
    """[N, C, E] activations with an fp32 scale on bf16 x: output keeps x's
    dtype and shape, math as the JAX version's."""
    x, scale = _inputs((3, 100, 64), seed=1)
    want = np.asarray(_xla_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale)).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 100, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
