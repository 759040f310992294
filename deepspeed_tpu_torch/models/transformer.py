"""Dense decoder config, presets and parameters (counterpart of
``deepspeed_tpu/models/transformer.py``).

The port carries the dense Llama-style subset the serving path runs: RMSNorm,
half-split RoPE, SiLU-GLU MLP, GQA, an untied LM head, no biases.
``TransformerConfig`` keeps the JAX package's field names and defaults for
that subset; any other architecture raises ``NotImplementedError`` at
construction instead of being silently ignored.

Parameters are a nested dict of tensors in the JAX package's layout, with the
layers stacked ``[L, ...]``: ``embed.embedding [V, E]``,
``layers.attn.{wq,wk,wv} [L, E, heads, hd]``, ``layers.attn.wo [L, H, hd, E]``,
``layers.{attn_norm,mlp_norm}.scale [L, E]``,
``layers.mlp.{w_gate,w_up} [L, E, F]``, ``layers.mlp.w_down [L, F, E]``,
``final_norm.scale [E]``, ``lm_head.kernel [E, V]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.norms import rms_norm
from deepspeed_tpu_torch.ops.rope import rope
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1408
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # None => MHA
    head_dim: Optional[int] = None  # None => hidden // heads
    max_seq_len: int = 2048
    norm: str = "rmsnorm"
    activation: str = "silu_glu"
    qkv_bias: Optional[bool] = None
    dense_bias: Optional[bool] = None
    mlp_bias: Optional[bool] = None
    lm_head_bias: bool = False
    parallel_block: bool = False
    parallel_mlp_norm: bool = False
    position: str = "rope"
    rope_theta: float = 500000.0
    embed_norm: bool = False
    rotary_dim: Optional[int] = None
    rope_interleaved: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    num_experts: int = 0
    dtype: torch.dtype = torch.float32  # activation dtype

    def __post_init__(self):
        unsupported = {
            "norm": (self.norm, "rmsnorm"),
            "activation": (self.activation, "silu_glu"),
            "position": (self.position, "rope"),
            "qkv_bias": (bool(self.qkv_bias), False),
            "dense_bias": (bool(self.dense_bias), False),
            "mlp_bias": (bool(self.mlp_bias), False),
            "lm_head_bias": (self.lm_head_bias, False),
            "parallel_block": (self.parallel_block, False),
            "parallel_mlp_norm": (self.parallel_mlp_norm, False),
            "embed_norm": (self.embed_norm, False),
            "rope_interleaved": (self.rope_interleaved, False),
            "tie_embeddings": (self.tie_embeddings, False),
            "num_experts": (self.num_experts, 0),
        }
        for name, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f"TransformerConfig.{name}={got!r}: the PyTorch port serves the dense "
                    f"Llama-style decoder only ({name}={want!r})")
        if self.rotary_dim not in (None, self.dims_per_head):
            raise NotImplementedError(
                f"TransformerConfig.rotary_dim={self.rotary_dim}: partial rotary is not ported")
        if self.num_heads % self.kv_heads:
            raise ValueError(f"num_heads={self.num_heads} not divisible by kv heads {self.kv_heads}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"TransformerConfig.dtype={self.dtype}: fp32 | bf16 only")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def num_params(self) -> int:
        return sum(_numel(s) for s in param_shapes(self).values())


PRESETS = {
    "tiny": TransformerConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                              num_layers=2, num_heads=4, max_seq_len=128),
    "llama3-8b": TransformerConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                                   num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
                                   rope_theta=500000.0),
    "llama3-1b": TransformerConfig(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                                   num_layers=16, num_heads=32, num_kv_heads=8, max_seq_len=8192),
}


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Dotted parameter path -> shape, in the JAX package's stacked layout."""
    V, E, F, L = cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, kvH, hd = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    return {
        "embed.embedding": (V, E),
        "layers.attn_norm.scale": (L, E),
        "layers.attn.wq.kernel": (L, E, H, hd),
        "layers.attn.wk.kernel": (L, E, kvH, hd),
        "layers.attn.wv.kernel": (L, E, kvH, hd),
        "layers.attn.wo.kernel": (L, H, hd, E),
        "layers.mlp_norm.scale": (L, E),
        "layers.mlp.w_gate.kernel": (L, E, F),
        "layers.mlp.w_up.kernel": (L, E, F),
        "layers.mlp.w_down.kernel": (L, F, E),
        "final_norm.scale": (E,),
        "lm_head.kernel": (E, V),
    }


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of ``nest``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def init_params(cfg: TransformerConfig, seed: int = 0, device: Any = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random weights made directly on ``device`` from a ``torch.Generator``
    (an 8B model never passes through host memory): every matrix is normal
    with std ``fan_in**-0.5``, every norm scale is 1."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flat = {}
    for path, shape in param_shapes(cfg).items():
        t = torch.empty(shape, device=dev, dtype=dtype)
        if path.endswith(".scale"):
            t.fill_(1.0)
        else:
            # fan-in: the contracted dims (E for q/k/v/gate/up/head and the
            # embedding rows, H*hd for wo, F for w_down)
            fan_in = {"layers.attn.wo.kernel": cfg.num_heads * cfg.dims_per_head,
                      "layers.mlp.w_down.kernel": cfg.intermediate_size}.get(path, cfg.hidden_size)
            t.normal_(0.0, fan_in ** -0.5, generator=gen)
        flat[path] = t
    return nest(flat)


@functools.lru_cache(maxsize=8)
def rope_tables(seq_len: int, dim: int, theta: float,
                device: torch.device = torch.device("cpu")) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin ``[seq_len, dim/2]`` fp32 (cached per shape and device)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_qk_rope(cfg: TransformerConfig, q: torch.Tensor, k: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings on q ``[B, S, H, hd]`` and k ``[B, S, kvH, hd]``."""
    cos, sin = rope_tables(cfg.max_seq_len, q.shape[-1], cfg.rope_theta, q.device)
    return rope(q, cos, sin, positions), rope(k, cos, sin, positions)


def _apply_norm(norm_params: Dict[str, torch.Tensor], cfg: TransformerConfig,
                x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, norm_params["scale"], eps=cfg.norm_eps)
