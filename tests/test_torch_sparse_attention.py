"""Block-sparse attention of the PyTorch port against the JAX package, on the CPU.

- Every sparsity config's ``make_layout`` is bit-equal to the JAX package's
  (same numpy code, same ``RandomState`` draws) at two sequence lengths, and
  ``layout_to_lists``/``layout_to_lists_t`` equal the JAX package's.
- The kernel route (``impl="pallas"``: on the CPU the three kernels' plain
  versions inside the port's ``autograd.Function``) against JAX's
  ``block_sparse_attention(..., impl="pallas")``, whose Pallas kernels run in
  interpret mode here as ``tests/unit/ops/test_sparse_attention_pallas.py``
  runs them: output and q/k/v gradients for one numpy-seeded cotangent,
  causal and not, and with k, v at fewer heads than q against JAX on k, v
  repeated as its model repeats them, fp32 at 1e-5 (only the order of sums differs: JAX's online
  softmax against the plain version's one pass). A hand-made layout with an
  empty block row gives zeros there in both. The plain pieces (lse, raw dq,
  dk, dv) are held to the JAX kernels' own values. bf16: finite, and within
  3e-2 of JAX's bf16 result in relative L2 (bf16 rounds p, ds and the output
  in both, at points that differ by the order of sums; readings ~4e-3).
- The dense route with ALiBi slopes and a key padding mask against JAX's
  ``block_sparse_attention_dense``, fp32 at 1e-5, and the routing rules.
Sizes: S 32-64, block 8 or 16, 2-4 heads, D 16-32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import sparse_attention as jpsa
from deepspeed_tpu_torch.models.transformer import sparse_layout
from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops import sparse_attention as sa

TOL = 1e-5

CONFIGS = {
    "dense": {},
    "local": {"num_sliding_window_blocks": 2},
    "fixed": {"num_local_blocks": 2, "num_global_blocks": 1},
    "bigbird": {},
    "bigbird_seeded": {"num_random_blocks": 2, "num_sliding_window_blocks": 2, "seed": 7},
    "variable": {"num_random_blocks": 1, "local_window_blocks": (2, 3),
                 "global_block_indices": (0,)},
    "variable_ranges": {"num_random_blocks": 2, "local_window_blocks": (1, 2),
                        "global_block_indices": (0, 3), "global_block_end_indices": (1, 5),
                        "horizontal_global_attention": True, "seed": 3},
    "bslongformer": {"num_sliding_window_blocks": 2, "global_block_indices": (0, 4),
                     "global_block_end_indices": (1, 6)},
}


def _mode(name):
    return name.split("_")[0]


def _layouts(name, H, block, S):
    kw = CONFIGS[name]
    want = jsa.get_sparsity_config(_mode(name), num_heads=H, block=block, **kw).make_layout(S)
    got = sa.get_sparsity_config(_mode(name), num_heads=H, block=block, **kw).make_layout(S)
    return got, want


def _empty_row_layout(H=2, n=4):
    """Causal local window of 2 with block row 2 emptied in every head."""
    lay = sa.get_sparsity_config("local", num_heads=H, block=8,
                                 num_sliding_window_blocks=2).make_layout(8 * n)
    lay[:, 2] = 0
    return lay


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_bit_equal_to_jax(name, S):
    got, want = _layouts(name, H=3, block=8, S=S)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["bigbird", "variable_ranges", "fixed", "empty_row"])
def test_layout_lists_equal_jax(name):
    lay = _empty_row_layout() if name == "empty_row" else _layouts(name, H=3, block=8, S=128)[0]
    for port_fn, jax_fn in ((bs.layout_to_lists, jpsa.layout_to_lists),
                            (bs.layout_to_lists_t, jpsa.layout_to_lists_t)):
        got, want = port_fn(lay), jax_fn(lay)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)


def test_unknown_config_and_ragged_seq_raise():
    with pytest.raises(ValueError):
        sa.get_sparsity_config("butterfly", num_heads=2)
    with pytest.raises(ValueError):
        sa.get_sparsity_config("bigbird", num_heads=2, block=16).make_layout(40)
    with pytest.raises(ValueError):
        sa.get_sparsity_config("variable", num_heads=2, global_block_indices=(0, 2),
                               global_block_end_indices=(1,)).make_layout(64)


def _inputs(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4)]


def _port(fn, q, k, v, do, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(torch.from_numpy(do).to(dtype))
    return [t.detach().float().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


def _jax(fn, q, k, v, do, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


KERNEL_CASES = [
    # (config, heads, block, S, D, causal)
    ("bigbird", 4, 8, 64, 16, True),
    ("bigbird_seeded", 2, 16, 64, 32, False),
    ("fixed", 2, 8, 32, 16, True),
    ("bslongformer", 3, 8, 64, 16, False),
    ("empty_row", 2, 8, 32, 16, True),
]


def _case_layout(name, H, block, S):
    return _empty_row_layout(H, S // block) if name == "empty_row" else _layouts(name, H, block, S)[0]


@pytest.mark.parametrize("name,H,block,S,D,causal", KERNEL_CASES)
def test_kernel_route_matches_jax_pallas(name, H, block, S, D, causal):
    lay = _case_layout(name, H, block, S)
    q, k, v, do = _inputs(2, S, H, D)
    before = (bs.sparse_fwd.launches, bs.sparse_bwd_dq.launches, bs.sparse_bwd_dkv.launches)
    got = _port(lambda a, b, c: sa.block_sparse_attention(a, b, c, lay, block, causal,
                                                          impl="pallas"), q, k, v, do)
    # a CPU tensor takes the plain versions: nothing launched
    assert (bs.sparse_fwd.launches, bs.sparse_bwd_dq.launches,
            bs.sparse_bwd_dkv.launches) == before
    want = _jax(lambda a, b, c: jsa.block_sparse_attention(a, b, c, lay, block, causal,
                                                           impl="pallas"), q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)
    if name == "empty_row":  # block row 2 sees no key: output and dq are 0
        rows = slice(2 * block, 3 * block)
        assert np.all(got[0][:, rows] == 0) and np.all(got[1][:, rows] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_pieces_match_jax_kernels(causal):
    """lse and the raw fp32 dq, dk, dv of the port's plain versions against
    the JAX kernels' own outputs (interpret mode) on the same pre-scaled q."""
    H, block, S, D = 2, 8, 32, 16
    lay = _empty_row_layout(H, S // block)
    q, k, v, do = _inputs(2, S, H, D)  # [B, S, H, D] for the port
    qs = bs.prescale_q(torch.from_numpy(q))
    kt, vt, dot = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do)
    cols, ncols, rows, nrows = bs.layout_arrays(lay, "cpu")
    out, lse = bs.sparse_fwd(qs, kt, vt, cols, ncols, block, causal)
    delta = bs.sparse_delta(dot, out)
    dq = bs.sparse_bwd_dq(qs, kt, vt, dot, lse, delta, cols, ncols, block, causal)
    dk, dv = bs.sparse_bwd_dkv(qs, kt, vt, dot, lse, delta, rows, nrows, block, causal)

    jc, jn = jpsa.layout_to_lists(lay)
    jr, jnr = jpsa.layout_to_lists_t(lay)
    # [B, H, S, D] for the JAX kernels
    jq, jk, jv, jdo = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (qs.numpy(), k, v, do))
    jout, jlse = jpsa._sparse_fwd(jq, jk, jv, jnp.asarray(jc), jnp.asarray(jn), block, causal)
    jdq, jdk, jdv = jpsa._sparse_bwd(jq, jk, jv, jdo, jout, jlse, jnp.asarray(jc), jnp.asarray(jn),
                                     jnp.asarray(jr), jnp.asarray(jnr), block, causal)
    _close(out.transpose(1, 2).numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lse.numpy() == bs.NEG_INF, np.asarray(jlse)[..., 0] == bs.NEG_INF)
    _close(lse.numpy(), np.asarray(jlse)[..., 0])
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32
        _close(got.transpose(1, 2).numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_gqa_matches_jax_repeat(impl):
    """k and v at 2 heads for 4 query heads: the port reads kv head h // 2
    (kernel route: the dk, dv of each group summed in fp32; dense route:
    repeated inside) against JAX on k and v repeated with ``jnp.repeat``, as
    the JAX model does before its call; gradients of the unrepeated k, v."""
    H, kvH, block, S, D = 4, 2, 8, 64, 16
    lay = _layouts("bigbird", H, block, S)[0]
    q, _, _, do = _inputs(2, S, H, D, seed=5)
    k, v = _inputs(2, S, kvH, D, seed=6)[:2]
    got = _port(lambda a, b, c: sa.block_sparse_attention(a, b, c, lay, block, impl=impl),
                q, k, v, do)
    want = _jax(lambda a, b, c: jsa.block_sparse_attention(
        a, jnp.repeat(b, H // kvH, axis=2), jnp.repeat(c, H // kvH, axis=2), lay, block,
        impl=impl), q, k, v, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_bf16_kernel_route_near_jax():
    H, block, S, D = 4, 16, 64, 32
    lay = _layouts("bigbird", H, block, S)[0]
    q, k, v, do = _inputs(2, S, H, D, seed=1)
    got = _port(lambda a, b, c: sa.block_sparse_attention(a, b, c, lay, block, impl="pallas"),
                q, k, v, do, torch.bfloat16)
    want = _jax(lambda a, b, c: jsa.block_sparse_attention(a, b, c, lay, block, impl="pallas"),
                q, k, v, do, jnp.bfloat16)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 3e-2


@pytest.mark.parametrize("alibi,padded", [(True, False), (False, True), (True, True)])
def test_dense_route_matches_jax_dense(alibi, padded):
    H, block, S, D = 2, 8, 32, 16
    lay = _layouts("bigbird", H, block, S)[0]
    q, k, v, do = _inputs(2, S, H, D, seed=2)
    slopes = np.array([0.5, 0.125], np.float32) if alibi else None
    mask = None
    if padded:  # row 1: left padding of 12 keys, so its first 12 queries see no key
        mask = np.ones((2, S), np.int32)
        mask[1, :12] = 0

    def port(a, b, c):
        return sa.block_sparse_attention(
            a, b, c, lay, block, alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
            pad_mask=None if mask is None else torch.from_numpy(mask))

    got = _port(port, q, k, v, do)
    want = _jax(lambda a, b, c: jsa.block_sparse_attention_dense(
        a, b, c, lay, block, alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        pad_mask=None if mask is None else jnp.asarray(mask)), q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)
    if padded:
        assert np.all(got[0][1, :12] == 0)


def test_routing():
    H, block, S, D = 2, 8, 32, 16
    lay = _layouts("local", H, block, S)[0]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, S, H, D))
    mask = torch.ones(1, S, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        sa.block_sparse_attention(q, k, v, lay, block, impl="pallas", pad_mask=mask)
    with pytest.raises(NotImplementedError):
        sa.block_sparse_attention(q, k, v, lay, block, impl="pallas", alibi_slopes=torch.ones(H))
    with pytest.raises(ValueError):
        sa.block_sparse_attention(q, k, v, lay, block, impl="triton")
    with pytest.raises(ValueError):  # layout of another sequence length
        sa.block_sparse_attention(q, k, v, lay[:, :2, :2], block, impl="pallas")
    # auto: the kernels without extras, the dense path with them; the two agree
    # where they compute the same function
    kern = sa.block_sparse_attention(q, k, v, lay, block)
    torch.testing.assert_close(kern, sa.block_sparse_attention(q, k, v, lay, block, impl="xla"),
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(kern, sa.block_sparse_attention(q, k, v, lay, block, pad_mask=mask),
                               rtol=TOL, atol=TOL)


def test_layout_cache_keys():
    """``layout_arrays`` is keyed by the layout's bytes: an edit in place gets
    new lists, an equal copy the cached ones. The model's ``sparse_layout``
    holds its own lists per (config, heads, S, device)."""
    lay = _layouts("local", 2, 8, 32)[0]
    first = bs.layout_arrays(lay, "cpu")
    lay[:, 3, 0] = 1
    second = bs.layout_arrays(lay, "cpu")
    assert not torch.equal(first[0], second[0])
    for got, want in zip(second, (*bs.layout_to_lists(lay), *bs.layout_to_lists_t(lay))):
        np.testing.assert_array_equal(got.numpy(), want)
    assert bs.layout_arrays(lay.copy(), "cpu") is second
    frozen = (("block", 8), ("mode", "local"), ("num_sliding_window_blocks", 2))
    layout, block, lists = sparse_layout(frozen, 2, 32, torch.device("cpu"))
    assert block == 8 and np.array_equal(layout, _layouts("local", 2, 8, 32)[0])
    assert sparse_layout(frozen, 2, 32, torch.device("cpu"))[2] is lists
    for got, want in zip(lists, first):
        assert torch.equal(got, want)
