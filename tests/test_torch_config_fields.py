"""Every field of the JAX package's ``TransformerConfig`` (a dataclass) and
``RaggedInferenceConfig`` (pydantic) exists in the port with its JAX default,
read from the JAX classes in this process: a JAX config carried across is
never refused for spelling a field the port lacks.

Each field is either inside the ported slice, where a non-default value is
accepted (the MoE fields that configure training only among them: JAX's
serving ``_moe`` reads none of them), or outside it, where a non-default
value raises ``NotImplementedError`` naming the field. The two tables below
cover every JAX field, so a field added to JAX fails here until it is
sorted into one of them.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import RaggedInferenceConfig as JaxRaggedConfig
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference import RaggedInferenceConfig
from deepspeed_tpu_torch.models import TransformerConfig

JAX_FIELDS = {f.name: f for f in dataclasses.fields(JaxConfig)}
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}

# TransformerConfig: a non-default value the port takes, and one it refuses
MODEL_IN_SLICE = {
    "vocab_size": 256, "hidden_size": 256, "intermediate_size": 512, "num_layers": 2,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 32, "max_seq_len": 512, "norm": "layernorm",
    "activation": "gelu", "qkv_bias": True, "dense_bias": True, "mlp_bias": True,
    "position": "alibi", "rope_theta": 1e6, "embed_norm": True, "norm_eps": 1e-6,
    "tie_embeddings": True, "scan_layers": False, "attn_impl": "flash",
    "sparse_attention": {"mode": "bigbird", "block": 16}, "attn_kwargs": {"block_q": 64},
    "fused_ce": False, "fused_ce_min_vocab": 1024, "num_experts": 8, "moe_top_k": 1,
    "moe_capacity_factor": 2.0, "moe_capacity_factor_max": 4.0, "moe_min_capacity": 8,
    "moe_aux_loss_weight": 0.1, "moe_drop_tokens": False, "moe_metrics": True,
    "moe_dispatch": "collective", "moe_dispatch_algorithm": "ring", "moe_wire_codec": "int8",
}
MODEL_OUT_OF_SLICE = {
    "lm_head_bias": True, "parallel_block": True, "parallel_mlp_norm": True, "rotary_dim": 8,
    "rope_interleaved": True, "dropout": 0.1, "remat": True, "sparse_embedding_grads": True,
    "moe_use_residual": True, "moe_layer_experts": (8, 0, 8, 0), "fpdt_q_chunk": 512,
    "fpdt_kv_chunk": 512, "fpdt_offload": True, "sp_impl": "ring", "dtype": torch.float16,
}
# RaggedInferenceConfig
ENGINE_IN_SLICE = {
    "dtype": "fp32", "kv_block_size": 32, "num_kv_blocks": 64, "kv_cache_dtype": "int8",
    "kv_pool_bytes": 2 ** 20, "quant": {"enabled": True}, "max_seqs": 16, "max_seq_len": 512,
    "row_bucket": 4, "chunk_bucket": 8, "decode_chain": 4, "hbm_check": "off",
}
ENGINE_OUT_OF_SLICE = {
    "tp_size": 2, "ep_size": 2, "prefix_cache": True, "prefix_cache_fraction": 0.25,
    "prefix_cache_hash_bytes": False, "role": "prefill", "migration_depth": 4,
    "spec_decode": 2, "spec_ngram": 3, "serving_slo": {"ttft_ms": 200.0},
    "flight_recorder": True,
}


def _jax_default(field):
    if field.default_factory is not dataclasses.MISSING:
        return field.default_factory()
    return field.default


def _engine_defaults():
    """Each JAX engine field's default, sub-models as dicts."""
    out = {}
    for name, field in JaxRaggedConfig.model_fields.items():
        value = field.default if field.default_factory is None else field.default_factory()
        out[name] = value.model_dump() if hasattr(value, "model_dump") else value
    return out


def test_tables_cover_every_jax_field():
    assert set(MODEL_IN_SLICE) | set(MODEL_OUT_OF_SLICE) == set(JAX_FIELDS)
    assert not set(MODEL_IN_SLICE) & set(MODEL_OUT_OF_SLICE)
    assert set(ENGINE_IN_SLICE) | set(ENGINE_OUT_OF_SLICE) == set(JaxRaggedConfig.model_fields)
    assert not set(ENGINE_IN_SLICE) & set(ENGINE_OUT_OF_SLICE)


@pytest.mark.parametrize("name", sorted(JAX_FIELDS))
def test_model_field_at_jax_default_is_accepted(name):
    default = _jax_default(JAX_FIELDS[name])
    if name == "dtype":
        default = DTYPES[default]
    port = {f.name: f for f in dataclasses.fields(TransformerConfig)}
    assert name in port
    assert _jax_default(port[name]) == default
    assert getattr(TransformerConfig(**{name: default}), name) == (
        tuple(sorted(default.items())) if isinstance(default, dict) else default)


@pytest.mark.parametrize("name", sorted(MODEL_IN_SLICE))
def test_model_field_in_slice_accepts_a_non_default(name):
    over = {name: MODEL_IN_SLICE[name]}
    if name.startswith("moe_"):
        over["num_experts"] = 8  # the MoE fields beside experts to route to
    TransformerConfig(**over)


@pytest.mark.parametrize("name", sorted(MODEL_OUT_OF_SLICE))
def test_model_field_out_of_slice_raises_by_name(name):
    with pytest.raises(NotImplementedError, match=name):
        TransformerConfig(**{name: MODEL_OUT_OF_SLICE[name]})


@pytest.mark.parametrize("name", sorted(JaxRaggedConfig.model_fields))
def test_engine_field_at_jax_default_is_accepted(name):
    value = _engine_defaults()[name]
    cfg = RaggedInferenceConfig.from_dict({name: value})
    got = getattr(cfg, name)
    assert (dataclasses.asdict(got) if dataclasses.is_dataclass(got) else got) == value


def test_engine_config_at_every_jax_default_is_accepted():
    RaggedInferenceConfig.from_dict(_engine_defaults())


@pytest.mark.parametrize("name", sorted(ENGINE_IN_SLICE))
def test_engine_field_in_slice_accepts_a_non_default(name):
    RaggedInferenceConfig.from_dict({name: ENGINE_IN_SLICE[name]})


@pytest.mark.parametrize("name", sorted(ENGINE_OUT_OF_SLICE))
def test_engine_field_out_of_slice_raises_by_name(name):
    with pytest.raises(NotImplementedError, match=name):
        RaggedInferenceConfig.from_dict({name: ENGINE_OUT_OF_SLICE[name]})


def test_hbm_check_refuse_raises_by_name():
    """'refuse' promises a pre-flight check the port does not make."""
    with pytest.raises(NotImplementedError, match="hbm_check"):
        RaggedInferenceConfig.from_dict({"hbm_check": "refuse"})
