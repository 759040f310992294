"""Quantised serving of the PyTorch port against the JAX engine, on the CPU.

The port's ``InferenceEngineV2`` with an int8 or fp8 KV pool, with int8
weight-only quantisation (WOQ), and with both, is held to the JAX engine
with the same settings, fp32, ``kv_block_size`` 4 (as
``tests/unit/inference/test_quantized_serving.py``): ``put`` logits of a
prefill and of one decode within 1e-4 of the largest logit (summation order
across two frameworks; the int8 pool's scales also differ by one fp32 ulp in
some head vectors, because XLA compiles ``absmax / 127`` inside the jitted
step to a multiply by the reciprocal), and greedy tokens identical over 12
new tokens. Against the port's own unquantised engine the JAX tests' bounds
hold: int8 KV 3 %, fp8 KV 15 %, WOQ 8 % of the largest logit. A structural
test records every op of a decode chain on an int8 pool and finds no
floating tensor of the pool's size.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.woq import WOQTensor
from deepspeed_tpu_torch.utils.hbm import kv_pool_bytes, kv_slot_bytes

from .test_torch_engine_v2 import make_model

BASE = {"dtype": "fp32", "kv_block_size": 4, "num_kv_blocks": 64, "chunk_bucket": 8}
WOQ = {"enabled": True, "bits": 8, "min_leaf_size": 0}
SETTINGS = {
    "int8_kv": {"kv_cache_dtype": "int8"},
    "fp8_kv": {"kv_cache_dtype": "fp8"},
    "woq_int8": {"quant": WOQ},
    "int8_kv_woq_int8": {"kv_cache_dtype": "int8", "quant": WOQ},
}


@pytest.fixture(scope="module")
def model():
    return make_model()


def _port(model, **over):
    _, _, cfg, params = model
    return InferenceEngineV2(cfg, params, {**BASE, **over}, device="cpu")


def _jax(model, **over):
    jcfg, jparams, _, _ = model
    return JaxEngine(jcfg, jparams, {**BASE, "hbm_check": "off", **over})


def _put_logits(eng, prompt):
    return eng.put([0], [prompt]), eng.put([0], [[3]])


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_quantized_engine_matches_jax(model, setting):
    over = SETTINGS[setting]
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, 97, (9,))
    port, jeng = _port(model, **over), _jax(model, **over)
    assert port.kv_bytes_per_token == jeng.kv_bytes_per_token
    assert port.num_kv_blocks == jeng.num_kv_blocks
    for got, want in zip(_put_logits(port, prompt), _put_logits(jeng, prompt)):
        assert _rel(got, want) <= 1e-4
    prompts = [rng.randint(0, 97, (n,)) for n in (7, 3, 5)]
    port, jeng = _port(model, **over), _jax(model, **over)
    for got, want in zip(port.generate(prompts, max_new_tokens=12),
                         jeng.generate(prompts, max_new_tokens=12)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("setting,bound", [("int8_kv", 0.03), ("fp8_kv", 0.15), ("woq_int8", 0.08)])
def test_quantized_logits_bounded_against_dense(model, setting, bound):
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, 97, (9,))
    dense = _put_logits(_port(model), prompt)
    quant = _put_logits(_port(model, **SETTINGS[setting]), prompt)
    for got, want in zip(quant, dense):
        assert _rel(got, want) < bound


def test_woq_engine_holds_codes(model):
    _, _, cfg, _ = model
    eng = _port(model, **SETTINGS["int8_kv_woq_int8"])
    wq = eng.params["layers"]["attn"]["wq"]["kernel"]
    assert isinstance(wq, WOQTensor) and wq.stacked and wq.q.dtype == torch.int8
    assert eng.pool.k.dtype == torch.int8 and eng.pool.k_scale.dtype == torch.float32
    assert eng.pool.quant == "int8"
    pool = (eng.pool.k, eng.pool.v, eng.pool.k_scale, eng.pool.v_scale)
    assert sum(t.numel() * t.element_size() for t in pool) == kv_pool_bytes(
        cfg.num_layers, eng.num_kv_blocks * 4 + 1, cfg.kv_heads, cfg.dims_per_head, 4, "int8")
    assert _port(model, kv_cache_dtype="fp8").pool.quant == "fp8"


def test_kv_quant_chain_equals_per_token_loop(model):
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 97, (n,)) for n in (6, 4)]
    one = _port(model, kv_cache_dtype="int8", decode_chain=1).generate(prompts, max_new_tokens=10)
    four = _port(model, kv_cache_dtype="int8", decode_chain=4).generate(prompts, max_new_tokens=10)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)


def test_byte_budget_sizing_admits_more(model):
    """At one kv_pool_bytes budget the int8 pool has >= 1.8x the blocks of
    the bf16-sized one, and admission follows."""
    _, _, cfg, _ = model
    budget = 96 * 16 * kv_slot_bytes(cfg.num_layers, cfg.kv_heads, cfg.dims_per_head, 4)
    over = dict(kv_block_size=16, kv_pool_bytes=budget, max_seqs=256)
    dense, i8 = _port(model, **over), _port(model, kv_cache_dtype="int8", **over)
    assert i8.num_kv_blocks / dense.num_kv_blocks >= 1.8

    def admitted(eng):
        n = 0
        while eng.can_schedule(list(range(n + 1)), [48] * (n + 1)):
            n += 1
        return n

    assert admitted(i8) / admitted(dense) >= 1.8


def test_kv_cache_dtype_rejects_unknown(model):
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        _port(model, kv_cache_dtype="int3")


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.tensors = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.tensors.append((t.dtype, tuple(t.shape)))
        return out


def test_decode_chain_never_materializes_fp_pool(model):
    """Every op of a 4-step decode chain on an int8 pool, inputs and outputs:
    no floating tensor has the pool's S_flat dimension and last dim hd (the
    fp32 scales, last dim 1, are the pool's by design); the int8 pool itself
    is in the record."""
    _, _, cfg, _ = model
    eng = _port(model, kv_cache_dtype="int8")
    eng.put([0, 1], [np.arange(6) % 97, np.arange(3) % 97])
    s_flat = eng.pool.k.shape[1]
    assert eng.max_pages * eng.config.kv_block_size != s_flat
    with _Recorder() as rec:
        eng.decode_chain([0, 1], [5, 7], [4, 4], 4)
    pooled = [(d, s) for d, s in rec.tensors if s_flat in s]
    offenders = [(d, s) for d, s in pooled
                 if d.is_floating_point and s[-1] == cfg.dims_per_head]
    assert not offenders, offenders[:5]
    assert any(d == torch.int8 for d, _ in pooled)
