"""The PyTorch port's serving slice against the JAX package, on the CPU.

Weights come from the JAX ``CausalLM.init`` and are carried across with
``params_from_numpy``; inputs are numpy-seeded. The port runs with
``device="cpu"``, so every kernel-backed op takes its plain version.
Tolerance for logits 1e-4 in fp32 (matmul/summation order across two
frameworks over 2 layers); greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.paged import init_pool as jax_init_pool
from deepspeed_tpu.inference.paged import ragged_forward as jax_ragged_forward
from deepspeed_tpu.inference.ragged import StateManager as JaxStateManager
from deepspeed_tpu.inference.ragged import build_ragged_batch as jax_build_ragged_batch
from deepspeed_tpu.models.transformer import CausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference import InferenceEngineV2, init_pool, ragged_forward
from deepspeed_tpu_torch.inference.ragged import StateManager, build_ragged_batch
from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy

BASE = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=128)


def make_model(seed=0):
    jcfg = JaxConfig(**BASE)
    params = CausalLM(jcfg).init({"params": jax.random.PRNGKey(seed)},
                                 {"input_ids": jnp.zeros((1, 8), jnp.int32)}, train=False)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = TransformerConfig(**BASE, dtype=torch.float32)
    return jcfg, params, cfg, params_from_numpy(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def model():
    return make_model()


def test_params_from_numpy_rejects_mismatch(model):
    jcfg, params, cfg, _ = model
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError):
        params_from_numpy(tree, dataclasses.replace(cfg, hidden_size=48), device="cpu")
    tree["extra"] = {"kernel": np.zeros(3)}
    with pytest.raises(ValueError):
        params_from_numpy(tree, cfg, device="cpu")


def test_ragged_forward_matches_jax(model):
    """A prefill step, then a mixed step (one decode, one chunked-prefill
    continuation, one fresh prompt): last-token logits equal at 1e-4."""
    jcfg, jparams, cfg, params = model
    bs, num_blocks, max_pages = 4, 32, 32
    jpool = jax_init_pool(jcfg, num_blocks, bs, jnp.float32)
    pool = init_pool(cfg, num_blocks, bs, torch.float32, device="cpu")
    jm = JaxStateManager(num_blocks, bs, max_blocks_per_seq=max_pages)
    rng = np.random.RandomState(0)
    steps = [
        ([0, 1], [rng.randint(0, 97, 12), rng.randint(0, 97, 5)]),
        ([0, 1, 2], [rng.randint(0, 97, 1), rng.randint(0, 97, 3), rng.randint(0, 97, 7)]),
    ]
    for uids, toks in steps:
        b = jax_build_ragged_batch(jm, uids, toks, max_pages, row_bucket=4, chunk_bucket=8)
        arrs = (b.tokens, b.positions, b.new_lens, b.block_tables)
        want, jpool = jax_ragged_forward(jparams, jcfg, jpool, *map(jnp.asarray, arrs), bs)
        got, pool = ragged_forward(params, cfg, pool, *map(torch.from_numpy, arrs), bs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        for u, t in zip(uids, toks):
            jm.get(u).seen_tokens += len(t)
    np.testing.assert_allclose(pool.k.numpy(), np.asarray(jpool.k), rtol=1e-4, atol=1e-4)


def _engines(model, **cfg_over):
    jcfg, jparams, cfg, params = model
    conf = {"dtype": "fp32", "kv_block_size": 4, "num_kv_blocks": 64, "chunk_bucket": 8,
            "decode_chain": 4, **cfg_over}
    return JaxEngine(jcfg, jparams, dict(conf)), InferenceEngineV2(cfg, params, dict(conf), device="cpu")


def test_generate_greedy_identical_to_jax(model):
    """4 prompts of unequal length, decode_chain 4, an EOS that fires."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 97, (n,)) for n in (7, 3, 11, 5)]
    jeng, eng = _engines(model)
    free = eng.generate(prompts, max_new_tokens=10)
    eos = int(free[1][2])  # a token the run emits: prompt 1 stops at it
    got = eng.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    want = jeng.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    assert len(got[1]) <= 3 and int(got[1][-1]) == eos
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.state.free_blocks == eng.num_kv_blocks


def test_generate_preemption_identical_to_jax(model):
    """6 blocks x 4 slots = 24 KV slots; two 8-token prompts + 8 new tokens
    each need 32 at peak, so the youngest sequence is preempted and
    re-prefilled. Same tokens and the same step schedule as JAX."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 97, (8,)) for _ in range(2)]
    jeng, eng = _engines(model, num_kv_blocks=6, max_seqs=4)
    want = jeng.generate(prompts, max_new_tokens=8)
    got = eng.generate(prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (eng.dispatch_count, eng.host_sync_count, eng.tokens_decoded) == \
        (jeng.dispatch_count, jeng.host_sync_count, jeng.tokens_decoded)
    prefill_steps = eng.dispatch_count - eng.chain_steps
    assert prefill_steps > 1  # the preempted prompt was prefilled again
    assert eng.state.free_blocks == 6


def test_put_query_flush_contract(model):
    jcfg, jparams, cfg, params = model
    eng = InferenceEngineV2(cfg, params, {"dtype": "fp32", "kv_block_size": 4,
                                          "num_kv_blocks": 16, "max_seqs": 4}, device="cpu")
    assert eng.query(0) == (0, 64)
    assert eng.can_schedule([0], [10]) and not eng.can_schedule([0], [65])
    logits = eng.put([0], [np.arange(10) % 97])
    assert logits.shape == (1, 97) and logits.dtype == np.float32
    assert eng.query(0) == (10, 13 * 4)
    eng.put([0], [[3]])
    assert eng.query(0)[0] == 11
    eng.flush(0)
    assert eng.query(0) == (0, 64)
    with pytest.raises(RuntimeError):
        eng.put([1], [np.zeros(65, np.int32)])
    jeng = JaxEngine(jcfg, jparams, {"dtype": "fp32", "kv_block_size": 4, "num_kv_blocks": 16})
    np.testing.assert_allclose(logits, jeng.put([0], [np.arange(10) % 97]), rtol=1e-4, atol=1e-4)


def test_allocator_and_batch_arrays_equal_jax():
    """A scripted sequence of extends, batches and flushes gives the same
    block ids and the same step arrays in both packages."""
    mgrs = [JaxStateManager(16, 4, max_seqs=8, max_blocks_per_seq=8),
            StateManager(16, 4, max_seqs=8, max_blocks_per_seq=8)]
    builders = [jax_build_ragged_batch, build_ragged_batch]
    script = [
        ([7, 9], [np.arange(5), np.arange(1)]),
        ([7, 9, 11], [np.arange(1), np.arange(6), np.arange(9)]),
        ([11], [np.arange(2)]),
    ]
    for uids, toks in script:
        batches = [b(m, uids, toks, max_pages=8, row_bucket=4, chunk_bucket=8)
                   for m, b in zip(mgrs, builders)]
        for name in ("tokens", "positions", "new_lens", "block_tables", "seen"):
            np.testing.assert_array_equal(getattr(batches[1], name), getattr(batches[0], name))
        for m in mgrs:
            for u, t in zip(uids, toks):
                m.get(u).seen_tokens += len(t)
        if uids == [7, 9, 11]:
            for m in mgrs:
                m.flush(9)
                assert m.can_schedule([9], [13]) and not m.can_schedule([9], [64])
    assert mgrs[0].free_blocks == mgrs[1].free_blocks
    np.testing.assert_array_equal(mgrs[1].allocator.allocate(3), mgrs[0].allocator.allocate(3))


def test_kv_pool_bytes_sizes_the_pool_as_jax(model):
    jeng, eng = _engines(model, kv_pool_bytes=3_000_000)
    assert eng.num_kv_blocks == jeng.num_kv_blocks
    assert eng.kv_bytes_per_token == jeng.kv_bytes_per_token == 2 * 2 * 2 * 8 * 4
    assert eng.pool.k.shape == (2, eng.num_kv_blocks * 4 + 1, 2, 8)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7, top_k=3), dict(top_p=0.5), dict(temperature=1.3, top_k=5, top_p=0.8),
])
def test_sampling_stays_in_the_jax_support(kw):
    """Every draw lies in the token set the JAX filters keep (numpy replica
    of its top-k/top-p rule); the draws follow the generator's seed."""
    from deepspeed_tpu_torch.inference.sampling import sample_logits

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 50)).astype(np.float32) * 2
    lg = logits / kw.get("temperature", 1.0)
    keep = np.ones_like(lg, bool)
    if kw.get("top_k"):
        keep &= lg >= np.sort(lg, -1)[:, -kw["top_k"]][:, None]
    if kw.get("top_p", 1.0) < 1.0:
        masked = np.where(keep, lg, -np.inf)
        srt = -np.sort(-masked, -1)
        p = np.exp(srt - srt[:, :1])
        p /= p.sum(-1, keepdims=True)
        cutoff = np.where(np.cumsum(p, -1) - p < kw["top_p"], srt, np.inf).min(-1, keepdims=True)
        keep &= masked >= cutoff
    draws = []
    for seed in (0, 0, 1):
        g = torch.Generator().manual_seed(seed)
        draws.append(np.stack([sample_logits(torch.from_numpy(logits), g, do_sample=True, **kw).numpy()
                               for _ in range(50)]))
    np.testing.assert_array_equal(draws[0], draws[1])
    for row in range(4):
        assert keep[row, draws[0][:, row]].all() and keep[row, draws[2][:, row]].all()
    g = torch.Generator().manual_seed(0)
    greedy = sample_logits(torch.from_numpy(logits), g, do_sample=True, top_k=1)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_generate_sampled_is_seeded(model):
    _, _, cfg, params = model
    eng = InferenceEngineV2(cfg, params, {"dtype": "fp32", "kv_block_size": 4, "num_kv_blocks": 64,
                                          "decode_chain": 4}, device="cpu")
    prompts = [np.arange(5) % 97, np.arange(9) % 97]
    kw = dict(max_new_tokens=7, do_sample=True, temperature=0.9, top_k=20)
    a, b = eng.generate(prompts, seed=3, **kw), eng.generate(prompts, seed=3, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert len(x) == 7 and x.min() >= 0 and x.max() < 97
