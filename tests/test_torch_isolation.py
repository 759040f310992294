"""The PyTorch port stands alone: it imports no JAX, flax, optax, pydantic or
``deepspeed_tpu``, its entry points refuse to fall back to the CPU quietly,
and settings outside the ported slice raise ``NotImplementedError``."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import collectives, comm
from deepspeed_tpu_torch.inference import InferenceEngineV2, RaggedInferenceConfig, init_pool
from deepspeed_tpu_torch.models import (
    PRESETS,
    TransformerConfig,
    causal_lm_spec,
    init_params,
    params_from_numpy,
    params_to_numpy,
)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "deepspeed_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "pydantic", "deepspeed_tpu")

_BLOCKED_IMPORT = f"""
import pkgutil, sys
for name in list(sys.modules):
    if name.split('.')[0] in {BLOCKED!r}:
        del sys.modules[name]
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import deepspeed_tpu_torch
for mod in pkgutil.walk_packages(deepspeed_tpu_torch.__path__, 'deepspeed_tpu_torch.'):
    __import__(mod.name)
import chip_smoke
loaded = sorted(n for n in sys.modules if n.split('.')[0] in {BLOCKED!r} and sys.modules[n] is not None)
assert not loaded, loaded
for name in ('deepspeed_tpu_torch.collectives.fused_gemm', 'deepspeed_tpu_torch.parallel.tp',
             'deepspeed_tpu_torch.parallel.zeropp'):
    assert name in sys.modules, name
print('isolated-ok')
"""


def _tiny():
    return TransformerConfig(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, max_seq_len=128)


def test_imports_without_jax_flax_pydantic():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated-ok")


def test_sources_name_no_blocked_module():
    """No import statement of the port or chip_smoke.py names a blocked package."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = _tiny()
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(cfg, params, {"dtype": "fp32"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_pool(cfg, 4, 16, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.RankGroup("dp", 4)
    eng = InferenceEngineV2(cfg, params, {"dtype": "fp32"}, device="cpu")
    assert eng.pool.k.device.type == "cpu"
    train_cfg = {"train_micro_batch_size_per_gpu": 1, "optimizer": {"type": "AdamW"}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=causal_lm_spec(cfg), config=train_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(params_to_numpy(params, cfg), cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(model=causal_lm_spec(cfg), config=train_cfg,
                                                device="cpu")
    assert engine.params["embed.embedding"].device.type == "cpu"


def test_init_params_is_seeded_and_shaped():
    cfg = _tiny()
    a = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    b = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    assert a["layers"]["attn"]["wq"]["kernel"].shape == (2, 32, 4, 8)
    assert torch.equal(a["lm_head"]["kernel"], b["lm_head"]["kernel"])
    assert torch.all(a["final_norm"]["scale"] == 1)
    assert PRESETS["llama3-8b"].num_params() == 8_030_261_248


@pytest.mark.parametrize("model_over", [
    {"position": "alibi"}, {"num_experts": 4}, {"embed_norm": True},
    {"position": "learned"}, {"parallel_block": True}, {"lm_head_bias": True},
])
def test_unsupported_model_config_raises(model_over):
    """Parallel blocks and an LM-head bias are not ported at all; MoE serves
    and does not train; learned positions (GPT-2) train but do not serve;
    the Bloom form's pieces (ALiBi, the embedding LayerNorm) once served
    only, and now also build a training spec whose forward gives a finite
    loss."""
    if set(model_over) & {"parallel_block", "lm_head_bias"}:
        with pytest.raises(NotImplementedError):
            TransformerConfig(**{**_tiny().__dict__, **model_over})
        return
    cfg = TransformerConfig(**{**_tiny().__dict__, **model_over})
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    if model_over == {"num_experts": 4}:
        with pytest.raises(NotImplementedError, match="num_experts"):
            causal_lm_spec(cfg)
        InferenceEngineV2(cfg, params, {"dtype": "fp32"}, device="cpu")
        return
    if model_over == {"position": "learned"}:
        with pytest.raises(NotImplementedError):
            InferenceEngineV2(cfg, params, {"dtype": "fp32"}, device="cpu")
        return
    loss, _ = causal_lm_spec(cfg).loss_fn(params, {"input_ids": torch.ones(2, 8, dtype=torch.int32)})
    assert loss.ndim == 0 and bool(torch.isfinite(loss))
    InferenceEngineV2(cfg, params, {"dtype": "fp32"}, device="cpu")


@pytest.mark.parametrize("engine_over", [
    {"kv_cache_dtype": "fp16"}, {"kv_cache_dtype": "fp32"},
    {"quant": {"enabled": True}, "tp_size": 2},
    {"prefix_cache": True}, {"spec_decode": 2}, {"tp_size": 2}, {"ep_size": 2},
    {"role": "prefill"}, {"dtype": "fp16"},
])
def test_unsupported_engine_config_raises(engine_over):
    with pytest.raises(NotImplementedError):
        RaggedInferenceConfig.from_dict(engine_over)


@pytest.mark.parametrize("case", ["auto", "codec_only", "compiled", "axis_tuple",
                                  "fused_axis_tuple"])
def test_unsupported_collective_raises(case):
    """The collectives' selector, compiled schedules and multi-axis groups are
    not ported: both entry points (the ``comm`` facade and the algorithmic
    ``collectives`` library, the fused GEMM collectives with it) refuse
    them."""
    group = comm.RankGroup("dp", 4, device="cpu")
    xs = [torch.ones(8) for _ in range(4)]
    with pytest.raises(NotImplementedError):
        if case == "auto":
            comm.all_reduce(xs, group, algorithm="auto")
        elif case == "codec_only":
            comm.reduce_scatter(xs, group, codec="int8")
        elif case == "compiled":
            collectives.all_gather(xs, group, algorithm="compiled")
        elif case == "fused_axis_tuple":
            collectives.matmul_reduce_scatter([torch.ones(8, 2)] * 4, [torch.ones(2, 3)] * 4,
                                              (group, group), fused=True)
        else:
            collectives.all_to_all(xs, (group, group), split_axis=0, concat_axis=0)


def test_unknown_engine_key_raises():
    with pytest.raises(ValueError, match="unknown config key"):
        RaggedInferenceConfig.from_dict({"kv_blok_size": 16})
    assert RaggedInferenceConfig.from_dict({"decode_chain": "auto"}).decode_chain == 8


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there is
    no CUDA device, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, alone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
