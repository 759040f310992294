"""The port's training path against the JAX engine, on the CPU.

Both engines start from the same numpy weights (made by the port's
``init_params`` and carried across with ``params_to_numpy``) and take the
same numpy batches: 5 steps of ``gradient_accumulation_steps`` 2, AdamW with
weight decay, a linear ``WarmupLR`` and clipping at 0.5 (the gradient norm is
2-4 here, so every step clips). The JAX engine runs on a one-device mesh.
Cases: a Llama-form config (GQA, RoPE, RMSNorm, SiLU-GLU, untied head) with
``fused_ce_min_vocab`` lowered so the fused chunked cross entropy runs, and a
GPT-2-form config (LayerNorm, learned positions, GELU, tied embeddings,
biases) in the ``scan_layers=False`` layout with ``fused_ce=False``, as the
headline bench runs it, and a Bloom-form config (LayerNorm, ALiBi through
the flash path's ALiBi form, GELU, q/k/v/dense/MLP biases, a LayerNorm after
the embedding, tied head) with ``fused_ce_min_vocab`` lowered so the fused
cross entropy runs with the tied head. A padding mask drops the tail of one
row on odd steps.

Tolerances: fp32, every step's loss and gradient norm and every final weight
leaf within 1e-5 relative (L2 over the leaf); only the order of sums
differs. One exception: the key-projection bias gets no gradient in exact
arithmetic (adding one vector to every key shifts each row's scores by a
constant, which the softmax removes), so both engines feed Adam rounding
noise there and Adam turns it into steps of +-lr of either sign; that leaf
is held to its bound (|b| <= sum of the 5 lrs) in both engines instead. bf16:
the loss of every step within 5e-3 relative (bf16 rounds at other points in
the two frameworks; the readings were ~1e-3).

Block-sparse attention (``attn_impl="sparse"``, BigBird at block 8, seq 32)
is held to the same fp32 bounds on batches without a padding mask (the port
runs its sparse kernels' plain versions; the JAX engine on the CPU runs its
dense masked path) and with one (both take the dense masked path), and so is
a Variable config whose fields arrive as lists. A
dense-layout sparse config trains as the port's flash path does, within
2e-5 (the JAX package's own check of its sparse path).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import causal_lm_spec as jax_spec
from deepspeed_tpu.topology.mesh import build_mesh
from deepspeed_tpu_torch.models import TransformerConfig, causal_lm_spec, init_params, params_to_numpy
from deepspeed_tpu_torch.models.transformer import flatten

COMMON = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
              max_seq_len=32)
CASES = {
    "llama_fused_ce": dict(num_kv_heads=2, fused_ce_min_vocab=64),
    "gpt2_layer_list": dict(norm="layernorm", activation="gelu", position="learned",
                            tie_embeddings=True, scan_layers=False, fused_ce=False),
    "bloom_tied_fused_ce": dict(norm="layernorm", activation="gelu", position="alibi",
                                qkv_bias=True, dense_bias=True, embed_norm=True,
                                tie_embeddings=True, fused_ce_min_vocab=64),
}
LR = 1e-2
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                                 "warmup_num_steps": 3,
                                                 "warmup_type": "linear"}},
    "gradient_clipping": 0.5,
    "steps_per_print": 100,
}
# the key bias: no gradient in exact arithmetic (softmax shift invariance)
SHIFT_INVARIANT = ("attn.wk.bias",)


SPARSE_CASES = {
    "bigbird_kernels": (dict(num_kv_heads=2, attn_impl="sparse",
                             sparse_attention={"mode": "bigbird", "block": 8}), False),
    "bigbird_padded": (dict(num_kv_heads=2, attn_impl="sparse",
                            sparse_attention={"mode": "bigbird", "block": 8}), True),
    # list-valued fields, as a JSON or DeepSpeed-style sparsity config gives them
    "variable_lists": (dict(num_kv_heads=2, attn_impl="sparse",
                            sparse_attention={"mode": "variable", "block": 8,
                                              "local_window_blocks": [1, 2],
                                              "global_block_indices": [0, 2]}), False),
}


def _batches(steps=5, B=4, S=16, V=97, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    for step in range(steps):
        mask = np.ones((B, S), np.int32)
        if step % 2:
            mask[1, (11 * S) // 16:] = 0
        ids = rng.integers(0, V, (B, S)).astype(np.int32)
        yield {"input_ids": ids, "attention_mask": mask} if masked else {"input_ids": ids}


def _run_both(case, bf16, over=None, masked=True, S=16):
    over = CASES[case] if over is None else over
    jdt, tdt = (jax.numpy.bfloat16, torch.bfloat16) if bf16 else (jax.numpy.float32, torch.float32)
    jcfg = JaxConfig(**COMMON, **over, dtype=jdt)
    tcfg = TransformerConfig(**COMMON, **over, dtype=tdt)
    params = params_to_numpy(init_params(tcfg, seed=0, device="cpu", dtype=torch.float32), tcfg)
    config = dict(CONFIG, bf16={"enabled": bf16})
    mesh = build_mesh(devices=jax.devices()[:1], axis_sizes={"dp": 1})
    jeng, *_ = deepspeed_tpu.initialize(model=jax_spec(jcfg), config=config, mesh=mesh,
                                        model_parameters=params)
    teng, *_ = deepspeed_tpu_torch.initialize(model=causal_lm_spec(tcfg), config=config,
                                              model_parameters=params, device="cpu")
    metrics = []
    for batch in _batches(S=S, masked=masked):
        jm, tm = jeng.train_batch(batch), teng.train_batch(batch)
        metrics.append(({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")},
                        {k: float(tm[k]) for k in ("loss", "grad_norm", "lr")}))
    jax_params = {".".join(str(p.key) for p in path): np.asarray(leaf) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(jeng.module_state_dict())}
    port_params = flatten(params_to_numpy(teng.module_state_dict(), tcfg))
    return metrics, jax_params, port_params, teng


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_trajectory_matches_jax(case):
    _assert_fp32_trajectory(*_run_both(case, bf16=False))


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_fp32_trajectory_matches_jax(case):
    over, masked = SPARSE_CASES[case]
    _assert_fp32_trajectory(*_run_both(case, bf16=False, over=over, masked=masked, S=32))


def _assert_fp32_trajectory(metrics, jax_params, port_params, engine):
    for want, got in metrics:
        assert _rel(got["loss"], want["loss"]) <= 1e-5, (want, got)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= 1e-5, (want, got)
        assert _rel(got["lr"], want["lr"]) <= 1e-6, (want, got)
    assert metrics[0][0]["grad_norm"] > CONFIG["gradient_clipping"]  # the clip is exercised
    assert sorted(jax_params) == sorted(port_params)
    lr_sum = sum(w["lr"] for w, _ in metrics)
    for path, want in jax_params.items():
        got = port_params[path]
        assert got.shape == want.shape and got.dtype == np.float32, path
        if path.endswith(SHIFT_INVARIANT):
            assert np.abs(want).max() <= lr_sum and np.abs(got).max() <= lr_sum, path
            continue
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-5, (path, err)
    assert engine.global_steps == 5
    assert engine.get_lr() == pytest.approx(LR)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_loss_matches_jax(case):
    metrics, _, port_params, _ = _run_both(case, bf16=True)
    for want, got in metrics:
        assert _rel(got["loss"], want["loss"]) <= 5e-3, (want, got)
    assert all(np.isfinite(v).all() and v.dtype == np.float32 for v in port_params.values())


def test_dense_layout_sparse_trains_as_flash():
    def losses(**over):
        cfg = TransformerConfig(**COMMON, num_kv_heads=2, **over)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=causal_lm_spec(cfg), config=CONFIG,
            model_parameters=init_params(cfg, seed=0, device="cpu", dtype=torch.float32),
            device="cpu")
        return [float(engine.train_batch(b)["loss"]) for b in _batches(S=32, masked=False)]

    dense = losses(attn_impl="sparse", sparse_attention={"mode": "dense", "block": 8})
    np.testing.assert_allclose(dense, losses(attn_impl="auto"), rtol=2e-5, atol=2e-6)


def test_sparse_without_a_config_raises():
    with pytest.raises(ValueError, match="sparse_attention"):
        TransformerConfig(**COMMON, attn_impl="sparse")
    with pytest.raises(ValueError, match="sparse_attention"):
        TransformerConfig(**COMMON, attn_impl="sparse", sparse_attention=None)


def _tiny_spec(**over):
    return causal_lm_spec(TransformerConfig(**COMMON, **over))


@pytest.mark.parametrize("config_over,error", [
    ({"trian_batch_size": 4}, ValueError),
    ({"fp16": {"enabled": True}}, NotImplementedError),
    ({"zero_optimization": {"stage": 2}}, NotImplementedError),
    ({"hbm_guard": {"enabled": True}}, NotImplementedError),
    ({"activation_checkpointing": {"enabled": True}}, NotImplementedError),
    ({"optimizer": {"type": "Lamb"}}, NotImplementedError),
    ({"mesh": {"dp": 2}}, NotImplementedError),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, NotImplementedError),
    ({"zero_optimization": {"stage": 1, "overlap_com": True}}, ValueError),
])
def test_config_refusals(config_over, error):
    with pytest.raises(error):
        deepspeed_tpu_torch.initialize(model=_tiny_spec(), config=dict(CONFIG, **config_over),
                                       device="cpu")


def test_zero_section_of_a_jax_config_loads():
    """The bucketing/overlap keys shape only a sharded run's collectives: a
    JAX ZeRO-1 section with them loads on one device."""
    zero = {"stage": 1, "overlap_comm": True, "reduce_bucket_size": 5e8,
            "allgather_bucket_size": 5e8, "contiguous_gradients": True}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny_spec(), config=dict(CONFIG, zero_optimization=zero), device="cpu")
    assert engine.config.model.zero_optimization.stage == 1


@pytest.mark.parametrize("model_over", [
    {"remat": True}, {"dropout": 0.1}, {"attn_impl": "xla"},
    {"position": "alibi", "attn_impl": "sparse", "sparse_attention": {"mode": "bigbird",
                                                                      "block": 8}},
    {"sparse_embedding_grads": True},
])
def test_model_refusals(model_over):
    """Refused at construction, or (ALiBi under block-sparse attention,
    which JAX routes to its dense masked path) by the training forward, by
    name."""
    with pytest.raises(NotImplementedError, match="|".join(model_over)):
        causal_lm_spec(TransformerConfig(**COMMON, **model_over))


def test_metrics_stay_on_the_device_between_prints():
    """train_batch returns tensors (no host fetch) and the batch triad
    resolves as in the JAX package."""
    engine, optimizer, loader, _ = deepspeed_tpu_torch.initialize(
        model=_tiny_spec(num_kv_heads=2), config=dict(CONFIG, train_batch_size=4), device="cpu")
    assert (engine.train_batch_size, engine.train_micro_batch_size_per_gpu,
            engine.gradient_accumulation_steps_value) == (4, 2, 2)
    assert optimizer is engine.optimizer and loader is None
    metrics = engine.train_batch(next(_batches()))
    assert set(metrics) == {"loss", "grad_norm", "lr", "loss_scale", "overflow"}
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    assert float(metrics["loss_scale"]) == 1.0 and not bool(metrics["overflow"])
    assert engine.get_global_grad_norm() == pytest.approx(float(metrics["grad_norm"]))
    with pytest.raises(ValueError, match="train_batch_size"):
        engine.train_batch({"input_ids": np.zeros((3, 16), np.int32)})
