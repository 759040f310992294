"""The MoE (Mixtral) form of the PyTorch port's serving path against the JAX
package.

A tiny MoE model (vocab 256, hidden 64, FFN 128, 2 layers, 4 heads, 2 kv
heads, 8 experts, top-2) is made by the JAX ``CausalLM.init``, and the same
numpy tree goes to both packages (``params_from_numpy``).

- ``_moe`` equals JAX's ``inference/model.py:_moe`` on the same layer in both
  regimes (T < 2E: every expert, gate-weighted; T >= 2E: sorted by expert
  through the grouped matmul): fp32 within rtol 2e-5 / atol 2e-6 (the
  tolerance of JAX's own ``test_moe_ragged_prefill_matches_dense_combine``),
  bf16 within 2e-2 of the output's largest magnitude (the two packages round
  the bf16 matmul products' sums to bf16 at the same points, but their sums
  run in another order).
- ``grouped_matmul_plain`` (what ``grouped_matmul`` runs on a CPU tensor)
  equals ``jax.lax.ragged_dot`` and ``_gmm_padded(..., interpret=True)``
  (megablox ``gmm`` in interpret mode) within 1e-5 in fp32, at K, N of 128
  and 256, with an empty group, a partial last tile and m not a multiple of 8.
- ``InferenceEngineV2.generate`` gives the JAX engine's greedy tokens in
  fp32 and bf16, over a float pool and an int8 pool, with 5 prompts (ragged
  prefill, decode of 8 rows: T = 8 < 2E, dense) and with 12 (decode of 16
  rows: T = 16 = 2E, ragged); the regime counters show which ran.
- MoE training, PR-MoE's residual expert and per-layer expert counts and WOQ
  of the experts are refused by name; the ``moe`` subtree round-trips
  through ``params_from_numpy`` / ``params_to_numpy`` in both layouts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import model as jax_model
from deepspeed_tpu.models.transformer import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference import model as port_model
from deepspeed_tpu_torch.models import (
    CausalLM,
    TransformerConfig,
    params_from_numpy,
    params_to_numpy,
)
from deepspeed_tpu_torch.models.transformer import layer_slice, param_shapes
from deepspeed_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_plain

MOE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=128, num_experts=8, moe_top_k=2)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BASE = {"kv_block_size": 4, "num_kv_blocks": 128, "chunk_bucket": 8, "decode_chain": 4}


@functools.lru_cache(maxsize=None)
def make_moe(dtype="fp32", seed=0, scan_layers=True):
    """(JAX config, numpy tree, port config); the tree is shared, never written."""
    over = {} if scan_layers else {"scan_layers": False}
    jdt, tdt = DTYPES[dtype]
    jcfg = JaxConfig(**{**MOE, **over}, dtype=jdt)
    params = JaxCausalLM(jcfg).init({"params": jax.random.PRNGKey(seed)},
                                    {"input_ids": jnp.zeros((1, 8), jnp.int32)},
                                    train=False)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tree, TransformerConfig(**{**MOE, **over}, dtype=tdt)


@pytest.fixture(scope="module")
def moe_fp32():
    return make_moe("fp32")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tokens", [8, 15, 16, 40])
def test_moe_matches_jax(dtype, tokens):
    """T = 8 and 15 take the dense combine, 16 and 40 the grouped matmul."""
    jcfg, tree, cfg = make_moe(dtype)
    jdt, tdt = DTYPES[dtype]
    params = params_from_numpy(tree, cfg, device="cpu")
    x = np.random.default_rng(tokens).standard_normal((1, tokens, 64)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), tree["layers"]["moe"])
    want = np.asarray(jax_model._moe(jlp, jcfg, jnp.asarray(x, jdt)).astype(jnp.float32))
    dense, ragged = port_model._moe.dense_calls, port_model._moe.ragged_calls
    got = port_model._moe(layer_slice(params["layers"], 1)["moe"], cfg,
                          torch.from_numpy(x).to(tdt)).float().numpy()
    assert got.shape == want.shape == x.shape
    regime = (port_model._moe.dense_calls - dense, port_model._moe.ragged_calls - ragged)
    assert regime == ((0, 1) if tokens >= 2 * cfg.num_experts else (1, 0))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("K,N", [(128, 128), (256, 256), (128, 256)])
@pytest.mark.parametrize("sizes", [(7, 9, 4), (0, 16, 4), (10, 0, 0, 30), (3, 0, 130, 2, 0)])
def test_grouped_matmul_plain_matches_ragged_dot_and_gmm(K, N, sizes):
    rng = np.random.default_rng(sum(sizes) + K + N)
    E, m = len(sizes), sum(sizes)
    lhs = rng.standard_normal((m, K)).astype(np.float32)
    # weights at std K**-0.5, as a model's are: outputs of unit size, where
    # 1e-5 is ~100 fp32 ulps (megablox sums K in tiles of 128, ragged_dot and
    # the plain version in other orders)
    rhs = (rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    got = grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(gs))
    assert got.dtype == torch.float32 and got.shape == (m, N)
    ragged = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs)))
    gmm = np.asarray(jax_model._gmm_padded(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs),
                                           interpret=True))
    np.testing.assert_allclose(got.numpy(), ragged, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), gmm, rtol=1e-5, atol=1e-5)


def test_grouped_matmul_plain_edges():
    """Rows past the sizes' sum are 0 (``ragged_dot``'s rule), a bf16 input
    gives a bf16 output, and the wrapper launches nothing on the CPU."""
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(rng.standard_normal((10, 16)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    gs = torch.tensor([3, 4], dtype=torch.int32)
    before = grouped_matmul.launches
    out = grouped_matmul(lhs, rhs, gs)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs.numpy()), jnp.asarray(rhs.numpy()),
                                         jnp.asarray(gs.numpy())))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    assert bool((out[7:] == 0).all())
    assert grouped_matmul_plain(lhs.bfloat16(), rhs.bfloat16(), gs).dtype == torch.bfloat16
    assert grouped_matmul.launches == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("n_prompts", [5, 12])
def test_generate_greedy_identical_to_jax(dtype, pool, n_prompts):
    """Prompts of 2-11 tokens, chains of 4, 8 new tokens. 5 prompts: one
    ragged prefill (8 rows x 16), then decodes of 8 rows (T = 8 < 2E: dense);
    12 prompts: every forward has 16 rows or more (ragged)."""
    jcfg, tree, cfg = make_moe(dtype)
    conf = dict(BASE, dtype=dtype, **({"kv_cache_dtype": "int8"} if pool == "int8" else {}))
    rng = np.random.RandomState(n_prompts)
    prompts = [rng.randint(0, 256, (int(n),)) for n in rng.randint(2, 12, n_prompts)]
    want = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                     {**conf, "hbm_check": "off"}).generate(prompts, max_new_tokens=8)
    eng = InferenceEngineV2(cfg, params_from_numpy(tree, cfg, device="cpu"), dict(conf),
                            device="cpu")
    port_model._moe.dense_calls = port_model._moe.ragged_calls = 0
    got = eng.generate(prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    L = cfg.num_layers
    if n_prompts <= 8:  # one prefill step, then decode forwards of 8 rows
        assert port_model._moe.ragged_calls == L
        assert port_model._moe.dense_calls == L * (eng.model_forwards - 1) > 0
    else:
        assert port_model._moe.dense_calls == 0
        assert port_model._moe.ragged_calls == L * eng.model_forwards


@pytest.mark.parametrize("over,name", [
    ({"moe_use_residual": True}, "moe_use_residual"),
    ({"moe_layer_experts": (8, 0)}, "moe_layer_experts"),
])
def test_pr_moe_refused_by_name(over, name):
    with pytest.raises(NotImplementedError, match=name):
        TransformerConfig(**MOE, **over)


def test_training_and_expert_woq_refused_by_name(moe_fp32):
    _, tree, cfg = moe_fp32
    with pytest.raises(NotImplementedError, match="num_experts"):
        CausalLM(cfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="experts"):
        InferenceEngineV2(cfg, params, {**BASE, "dtype": "fp32", "quant": {"enabled": True}},
                          device="cpu")


@pytest.mark.parametrize("scan_layers", [True, False])
def test_moe_subtree_round_trips(scan_layers):
    """The JAX tree in the stacked layout and in ``layer_{i}`` subtrees
    crosses both ways leaf for leaf; the router is ``[L, M, E]``, the experts
    ``[L, E, M, F]`` and ``[L, E, F, M]``."""
    jcfg, tree, cfg = make_moe(scan_layers=scan_layers)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    params = params_from_numpy(tree, cfg, device="cpu")
    assert params["layers"]["moe"]["experts"]["w_up"].shape == (2, 8, 64, 128)
    back = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(params, cfg))[0])
    assert flat.keys() == back.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    shapes = param_shapes(cfg)
    assert shapes["layers.moe.gate.wg.kernel"] == (2, 64, 8)
    assert shapes["layers.moe.experts.w_down"] == (2, 8, 128, 64)
    assert not any(path.startswith("layers.mlp.") for path in shapes)
    assert cfg.num_params() == jcfg.num_params()
