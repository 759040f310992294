"""The Bloom form of the PyTorch port's serving path against the JAX package.

A tiny Bloom (2 layers, hidden 64, 4 heads, vocab 256; LayerNorm, ALiBi,
tanh GELU, q/k/v/dense/MLP biases, embedding LayerNorm, tied head, as
``deepspeed_tpu/checkpoint/hf.py`` maps ``bloom``) is made by the JAX
``CausalLM.init``; every bias, LayerNorm scale and LayerNorm bias is then
overwritten with numpy-seeded noise (init makes them 0 and 1, which would hide
a missing or misplaced one), and the same numpy tree goes to both packages.

- ``alibi_slopes`` equals JAX's bit for bit at 8, 12, 32 and 112 heads
  (12 and 112 take the non-power-of-two branch).
- The plain ALiBi paged attention (what ``paged_attention`` runs on a CPU
  tensor) matches JAX's Pallas ``_decode_kernel`` in interpret mode and
  ``_xla_paged_attention`` for 1, 2 and 4 kv heads of 4 query heads, over an
  fp32 pool and int8/e4m3 pools (fp32 q) within 1e-5 absolute, and over a
  bf16 pool within 2e-2 (bf16 rounds at other points in the kernels: q scaled
  before the dot, the plain versions' scores and probabilities), also with a
  pad row and garbage block-table tails. The port adds slope * (t - p) where
  JAX adds slope * t: the same softmax.
- The engine's greedy tokens equal the JAX engine's in fp32, on an int8 and
  an e4m3 pool, and under int8 weight-only quantisation with ``min_size`` 0,
  where the ``[L, H, hd]`` qkv biases become ``WOQTensor``s in both packages
  (JAX reads them through ``.astype``, the port through ``.to``); one prefill
  and one mixed step's logits within 1e-4.
- Settings the serving forward does not carry are refused by name.
- The training forward (``CausalLM``, its flash attention's plain versions on
  the CPU) of the Bloom form, of ``embed_norm`` with RoPE and of ALiBi alone
  gives JAX ``CausalLM.apply``'s loss and gradients within 1e-5 in fp32, with
  a right-padded row; without RoPE the key bias, whose gradient is 0 in
  exact arithmetic (the softmax removes a per-row shift), within 1e-5
  absolute.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import woq as jax_woq
from deepspeed_tpu.inference.paged import _kv_block_quant, _xla_paged_attention
from deepspeed_tpu.inference.paged import init_pool as jax_init_pool
from deepspeed_tpu.inference.paged import ragged_forward as jax_ragged_forward
from deepspeed_tpu.inference.ragged import StateManager as JaxStateManager
from deepspeed_tpu.inference.ragged import build_ragged_batch as jax_build_ragged_batch
from deepspeed_tpu.models.transformer import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas.paged_attention import flash_decode_paged
from deepspeed_tpu_torch.inference import InferenceEngineV2, init_pool, ragged_forward
from deepspeed_tpu_torch.inference.woq import WOQTensor
from deepspeed_tpu_torch.models import (
    CausalLM,
    TransformerConfig,
    causal_lm_spec,
    params_from_numpy,
    params_to_numpy,
)
from deepspeed_tpu_torch.models.transformer import alibi_slopes, flatten, param_shapes
from deepspeed_tpu_torch.ops.paged_attention import paged_attention

from .test_torch_paged_attention import _setup, _setup_pad_and_garbage, _to_torch

BLOOM = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2, num_heads=4,
             max_seq_len=128, norm="layernorm", activation="gelu", position="alibi",
             qkv_bias=True, dense_bias=True, embed_norm=True, tie_embeddings=True)
BASE = {"dtype": "fp32", "kv_block_size": 4, "num_kv_blocks": 64, "chunk_bucket": 8,
        "decode_chain": 4}
WOQ = {"enabled": True, "bits": 8, "min_leaf_size": 0}
SETTINGS = {"fp32": {}, "int8_kv": {"kv_cache_dtype": "int8"}, "fp8_kv": {"kv_cache_dtype": "fp8"},
            "woq_int8": {"quant": WOQ}}


def perturb(tree, seed=0):
    """Every bias and LayerNorm scale of a numpy param tree replaced by
    seeded noise (scales 1 + 0.2 n, biases 0.2 n)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "bias":
                out[k] = (0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif k == "scale":
                out[k] = (1 + 0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree, ())


def make_bloom(seed=0, **over):
    jcfg = JaxConfig(**{**BLOOM, **over})
    params = JaxCausalLM(jcfg).init({"params": jax.random.PRNGKey(seed)},
                                    {"input_ids": jnp.zeros((1, 8), jnp.int32)},
                                    train=False)["params"]
    tree = perturb(jax.tree_util.tree_map(np.asarray, params), seed)
    cfg = TransformerConfig(**{**BLOOM, **over}, dtype=torch.float32)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, tree


@pytest.fixture(scope="module")
def bloom():
    jcfg, jparams, cfg, tree = make_bloom()
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, device="cpu"), tree


@pytest.mark.parametrize("heads", [8, 12, 32, 112])
def test_alibi_slopes_bit_equal_to_jax(heads):
    got = alibi_slopes(heads).numpy()
    want = np.asarray(jax_alibi_slopes(heads))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _pool_inputs(args, pool):
    """(port q/pools/scales, jax q/pools/scales) of one numpy setup for a
    pool type: fp32 or bf16 values, or int8/e4m3 codes quantised once by
    JAX's ``_kv_block_quant`` and handed to both."""
    q, pk, pv = args[:3]
    if pool in ("fp32", "bf16"):
        jdt, tdt = (jnp.float32, torch.float32) if pool == "fp32" else (jnp.bfloat16, torch.bfloat16)
        j = [jnp.asarray(a, jdt) for a in (q, pk, pv)]
        return [torch.from_numpy(a).to(tdt) for a in (q, pk, pv)], {}, j, {}
    kq, ks = _kv_block_quant(jnp.asarray(pk), pool)
    vq, vs = _kv_block_quant(jnp.asarray(pv), pool)
    port = [torch.from_numpy(q), _to_torch(kq), _to_torch(vq)]
    return (port, dict(k_scale=_to_torch(ks), v_scale=_to_torch(vs)),
            [jnp.asarray(q), kq, vq], dict(k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", ["kvH1", "kvH2", "kvH4", "pad_and_garbage"])
def test_paged_alibi_matches_jax_pallas(case, pool):
    if case == "pad_and_garbage":
        args = _setup_pad_and_garbage(hd=16)
        H = args[0].shape[2]
    else:
        H = 4
        args = _setup(H=H, kvH=int(case[3:]), hd=16)
    bt, pos, lens, bs = args[3:]
    port, port_scales, j, j_scales = _pool_inputs(args, pool)
    slopes = np.array(jax_alibi_slopes(H))
    t = torch.from_numpy
    got = paged_attention(*port, t(bt), t(pos), bs, new_lens=t(lens),
                          alibi_slopes=t(slopes), **port_scales).float().numpy()
    jargs = (*j, jnp.asarray(bt), jnp.asarray(pos), bs)
    pallas = flash_decode_paged(*jargs, new_lens=jnp.asarray(lens), pages_per_block=2,
                                alibi_slopes=jnp.asarray(slopes), **j_scales)
    xla = _xla_paged_attention(*jargs, alibi_slopes=jnp.asarray(slopes), **j_scales)
    tol = 2e-2 if pool == "bf16" else 1e-5
    assert np.isfinite(got).all()
    for want in (pallas, xla):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_relative_alibi_keeps_long_rows_exact():
    """Why the port adds slope * (t - p): at positions near 2047 JAX's
    slope * t reaches ~1,700 for head 0 of 32, where an fp32 ulp is 1.2e-4, so
    its fp32 scores lose their low bits; the relative form stays within 2e-6
    of an fp64 evaluation, and JAX's absolute one is several times further."""
    rng = np.random.default_rng(3)
    N, C, H, hd, bs, P = 2, 2, 32, 16, 16, 128
    q = rng.standard_normal((N, C, H, hd)).astype(np.float32)
    pk = rng.standard_normal((N * P * bs + 1, H, hd)).astype(np.float32)
    pv = rng.standard_normal((N * P * bs + 1, H, hd)).astype(np.float32)
    bt = np.arange(N * P, dtype=np.int32).reshape(N, P)
    pos = np.asarray([[2046, 2047], [1500, 1501]], np.int32)
    slopes = np.array(jax_alibi_slopes(H))
    slot = (bt[:, :, None] * bs + np.arange(bs)).reshape(N, P * bs)
    k, v = pk[slot].astype(np.float64), pv[slot].astype(np.float64)  # [N, T, H, hd]
    t_idx = np.arange(P * bs)
    s64 = np.einsum("nchd,nthd->nhct", q.astype(np.float64), k) / np.sqrt(hd)
    s64 = s64 + slopes.astype(np.float64)[None, :, None, None] * t_idx
    s64 = np.where(t_idx[None, None, None, :] <= pos[:, None, :, None], s64, -np.inf)
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    want = np.einsum("nhct,nthd->nchd", p64 / p64.sum(-1, keepdims=True), v)
    t = torch.from_numpy
    lens = np.full((N,), C, np.int32)
    got = paged_attention(t(q), t(pk), t(pv), t(bt), t(pos), bs, new_lens=t(lens),
                          alibi_slopes=t(slopes)).numpy()
    jax_abs = np.asarray(_xla_paged_attention(*map(jnp.asarray, (q, pk, pv, bt, pos)), bs,
                                              alibi_slopes=jnp.asarray(slopes)))
    port_err, jax_err = np.abs(got - want).max(), np.abs(jax_abs - want).max()
    assert port_err <= 2e-6 and jax_err >= 5 * port_err, (port_err, jax_err)


def test_param_tree_round_trip(bloom):
    """embed_norm, the q/k/v/dense/MLP biases and the tied head cross both
    ways, leaf for leaf."""
    _, _, cfg, params, tree = bloom
    flat = {k: v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    back = {k: v for k, v in jax.tree_util.tree_flatten_with_path(params_to_numpy(params, cfg))[0]}
    assert flat.keys() == back.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    shapes = param_shapes(cfg)
    assert shapes["embed_norm.bias"] == (64,) and "lm_head.kernel" not in shapes
    assert shapes["layers.attn.wq.bias"] == (2, 4, 16) and shapes["layers.mlp.w_up.bias"] == (2, 256)


def test_ragged_forward_matches_jax(bloom):
    """A prefill step, then a mixed step (a decode, a chunked-prefill
    continuation, a fresh prompt): last-token logits within 1e-4."""
    jcfg, jparams, cfg, params, _ = bloom
    bs, num_blocks, max_pages = 4, 32, 32
    jpool = jax_init_pool(jcfg, num_blocks, bs, jnp.float32)
    pool = init_pool(cfg, num_blocks, bs, torch.float32, device="cpu")
    jm = JaxStateManager(num_blocks, bs, max_blocks_per_seq=max_pages)
    rng = np.random.RandomState(0)
    steps = [([0, 1], [rng.randint(0, 256, 12), rng.randint(0, 256, 5)]),
             ([0, 1, 2], [rng.randint(0, 256, 1), rng.randint(0, 256, 3), rng.randint(0, 256, 7)])]
    for uids, toks in steps:
        b = jax_build_ragged_batch(jm, uids, toks, max_pages, row_bucket=4, chunk_bucket=8)
        arrs = (b.tokens, b.positions, b.new_lens, b.block_tables)
        want, jpool = jax_ragged_forward(jparams, jcfg, jpool, *map(jnp.asarray, arrs), bs)
        got, pool = ragged_forward(params, cfg, pool, *map(torch.from_numpy, arrs), bs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        for u, t in zip(uids, toks):
            jm.get(u).seen_tokens += len(t)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_generate_greedy_identical_to_jax(bloom, setting):
    """4 prompts of unequal length, chains of 4, 12 new tokens."""
    jcfg, jparams, cfg, params, _ = bloom
    conf = {**BASE, **SETTINGS[setting]}
    jeng = JaxEngine(jcfg, jparams, {**conf, "hbm_check": "off"})
    eng = InferenceEngineV2(cfg, params, dict(conf), device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, (n,)) for n in (7, 3, 11, 5)]
    got = eng.generate(prompts, max_new_tokens=12)
    want = jeng.generate(prompts, max_new_tokens=12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_woq_quantises_the_qkv_biases_as_jax_does(bloom):
    """With min_size 0 the 3-D ``[L, H, hd]`` qkv biases pass the
    eligibility rule in both packages (the ``[L, n]`` exemption covers 2-D
    stacks only); the 2-D stacks (wo and MLP biases, LayerNorms) stay dense."""
    jcfg, jparams, cfg, params, _ = bloom
    eng = InferenceEngineV2(cfg, params, {**BASE, "quant": WOQ}, device="cpu")
    jq = jax_woq.quantize_params(jparams, "int8", min_size=0)
    for name in ("wq", "wk", "wv"):
        bias = eng.params["layers"]["attn"][name]["bias"]
        assert isinstance(bias, WOQTensor) and bias.stacked and bias.shape == (2, 4, 16)
        assert isinstance(jq["layers"]["attn"][name]["bias"], jax_woq.WOQTensor)
    for leaf in (eng.params["layers"]["attn"]["wo"]["bias"],
                 eng.params["layers"]["mlp"]["w_up"]["bias"],
                 eng.params["embed_norm"]["scale"], eng.params["embed"]["embedding"]):
        assert isinstance(leaf, torch.Tensor)


REFUSED = {"position": "learned", "parallel_block": True, "parallel_mlp_norm": True,
           "lm_head_bias": True, "rotary_dim": 8, "rope_interleaved": True,
           "moe_use_residual": True, "moe_layer_experts": (4, 4)}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_serving_refuses_unported_settings_by_name(bloom, name):
    """Each setting the serving forward does not carry raises, naming it:
    learned positions from ``_check_servable``, the others at construction."""
    cfg = bloom[2]
    with pytest.raises(NotImplementedError, match=name):
        over = TransformerConfig(**{**cfg.__dict__, name: REFUSED[name]})
        InferenceEngineV2(over, bloom[3], BASE, device="cpu")


@pytest.mark.parametrize("over,name", [({}, "position"), ({"position": "rope"}, "embed_norm"),
                                       ({"embed_norm": False}, "position")])
def test_training_refuses_the_bloom_form(over, name):
    """The Bloom form (ALiBi and ``embed_norm``), ``embed_norm`` with RoPE and
    ALiBi alone once were refused by the training forward; each now trains:
    one forward's loss and every gradient leaf against JAX ``CausalLM.apply``
    (``name`` is the setting that was refused). Only ALiBi under
    ``attn_impl="sparse"`` stays refused, by name."""
    jcfg, jparams, cfg, tree = make_bloom(seed=2, **over)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 17:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}

    def jax_loss(p):
        return JaxCausalLM(jcfg).apply({"params": p}, jax.tree_util.tree_map(jnp.asarray, batch),
                                       train=True)[0]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(jparams)
    params = params_from_numpy(tree, cfg, device="cpu")
    flat = {path: t.requires_grad_(True) for path, t in flatten(params).items()}
    got_loss, _ = causal_lm_spec(cfg).loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got_grads = dict(zip(flat, torch.autograd.grad(got_loss, list(flat.values()))))
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_flat = flatten(params_to_numpy(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want_grads), cfg, device="cpu"), cfg))
    assert sorted(want_flat) == sorted(got_grads)
    for path, g in got_grads.items():
        g, w = g.numpy(), want_flat[path]
        if path.endswith("attn.wk.bias") and cfg.position != "rope":
            assert np.abs(g).max() <= 1e-5 and np.abs(w).max() <= 1e-5, path
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= 1e-5, (path, err)
    sparse = TransformerConfig(**{**cfg.__dict__, "attn_impl": "sparse",
                                  "sparse_attention": {"mode": "bigbird", "block": 8}})
    if sparse.position == "alibi":
        with pytest.raises(NotImplementedError, match="alibi"):
            CausalLM(sparse)
    else:
        CausalLM(sparse)
