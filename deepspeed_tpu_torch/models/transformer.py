"""Decoder-only transformer: config, presets, parameters and the training
forward (counterpart of ``deepspeed_tpu/models/transformer.py``).

One config covers the dense families of the port: Llama-style (RMSNorm,
half-split RoPE, SiLU-GLU MLP, GQA, untied head, no biases) and GPT-2-style
(LayerNorm, learned positions, GELU MLP, tied embeddings, biases), trained
with flash or block-sparse attention (``attn_impl="sparse"``), and the Bloom
form (LayerNorm, ALiBi, GELU MLP, biases, tied head, a LayerNorm after the
embedding), which both the serving forward and ``CausalLM`` carry, the latter
through the ALiBi form of the flash kernels. The Mixtral form (the Llama
form with an MoE FFN) serves and does not train. ALiBi with
``attn_impl="sparse"`` (which JAX routes to its dense masked path) is refused
by name. ``TransformerConfig`` keeps the JAX
package's field names and defaults; a setting outside those families
(parallel blocks, partial or interleaved rotary, an LM-head bias, remat,
dropout, PR-MoE's residual expert or per-layer expert counts, FPDT, another
sequence-parallel implementation) raises ``NotImplementedError`` at
construction instead of being silently ignored.
``scan_layers`` only chooses the numpy layout of ``params_from_numpy`` /
``params_to_numpy``; the port's own tree is always stacked.

Parameters are a nested dict of tensors in the JAX package's layout, with the
layers stacked ``[L, ...]``: ``embed.embedding [V, E]``, ``pos_embed [T, E]``
(learned positions), ``layers.attn.{wq,wk,wv}.kernel [L, E, heads, hd]`` (and
``.bias [L, heads, hd]``), ``layers.attn.wo.kernel [L, H, hd, E]`` (``.bias
[L, E]``), ``layers.{attn_norm,mlp_norm}.scale [L, E]`` (LayerNorm also
``.bias``), ``layers.mlp.{w_gate,w_up}.kernel [L, E, F]``,
``layers.mlp.w_down.kernel [L, F, E]`` (and biases), ``final_norm.scale
[E]``, ``lm_head.kernel [E, V]`` (untied only), ``embed_norm.{scale,bias}
[E]`` (``embed_norm``). An MoE config (``num_experts`` X > 0) has
``layers.moe.gate.wg.kernel [L, E, X]``, ``layers.moe.experts.{w_gate,w_up}
[L, X, E, F]`` and ``layers.moe.experts.w_down [L, X, F, E]`` in place of
``layers.mlp``.

MoE serves (``inference/model.py:_moe``) and does not train: ``CausalLM``
refuses ``num_experts > 0`` by name (MoE training is the JAX package's
``parallel/moe.py``).

``CausalLM`` is the training forward (``CausalLM.__call__`` of the JAX
package): embedding, its LayerNorm (``embed_norm``), learned positions,
pre-norm blocks with flash (with ALiBi slopes for ``position="alibi"``) or
block-sparse attention, final norm, then the fused chunked cross entropy or
the logits and ``cross_entropy_loss``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention import PORTED_IMPLS, causal_attention
from deepspeed_tpu_torch.ops.block_sparse import layout_lists
from deepspeed_tpu_torch.ops.cross_entropy import lm_head_cross_entropy
from deepspeed_tpu_torch.ops.norms import rms_norm
from deepspeed_tpu_torch.ops.rope import rope
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_attention, get_sparsity_config
from deepspeed_tpu_torch.utils.device import resolve_device

NORMS = ("rmsnorm", "layernorm")
ACTIVATIONS = ("silu_glu", "gelu", "gelu_exact", "relu")
POSITIONS = ("rope", "learned", "alibi")
ATTN_IMPLS = PORTED_IMPLS + ("sparse",)


def _freeze_pairs(value) -> tuple:
    """A dict (or pairs) as a sorted tuple of pairs, list values as tuples,
    so that the frozen config stays hashable."""
    def freeze(v):
        return tuple(freeze(x) for x in v) if isinstance(v, (list, tuple)) else v

    return tuple(sorted((key, freeze(v)) for key, v in dict(value).items()))


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
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu_glu"  # silu_glu | gelu (tanh approx) | gelu_exact | relu
    # bias overrides; None keeps the norm-derived default (layernorm models
    # carry biases)
    qkv_bias: Optional[bool] = None
    dense_bias: Optional[bool] = None
    mlp_bias: Optional[bool] = None
    lm_head_bias: bool = False
    parallel_block: bool = False
    parallel_mlp_norm: bool = False
    position: str = "rope"  # rope | learned | alibi
    rope_theta: float = 500000.0
    embed_norm: bool = False
    rotary_dim: Optional[int] = None
    rope_interleaved: bool = False
    norm_eps: float = 1e-5
    dropout: float = 0.0
    tie_embeddings: bool = False
    remat: bool = False
    scan_layers: bool = True  # numpy parameter layout only (stacked vs layer_{i})
    attn_impl: str = "auto"  # auto | flash | sparse
    # block-sparse attention (attn_impl="sparse"): {"mode": ..., "block": ...,
    # and the sparsity config's own fields}; frozen to a sorted tuple of pairs,
    # list values to tuples
    sparse_attention: Optional[Any] = None
    # flash scheduling knobs of the JAX kernel (block_q / block_k / k_splits),
    # accepted and ignored; frozen to a tuple of pairs
    attn_kwargs: Optional[Any] = None
    sparse_embedding_grads: bool = False
    fused_ce: bool = True
    fused_ce_min_vocab: int = 4096
    # MoE FFN (0 experts => dense MLP). Serving reads num_experts and
    # moe_top_k only, as the JAX serving ``_moe`` does; the capacity, aux-loss,
    # drop, metrics, dispatch and wire fields configure MoE training
    # (``parallel/moe.py``), which is not ported, and are accepted at any value
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_loss_weight: float = 0.01
    moe_drop_tokens: bool = True
    moe_use_residual: bool = False
    moe_layer_experts: Optional[Tuple[int, ...]] = None
    moe_metrics: bool = False
    moe_dispatch: str = "auto"
    moe_dispatch_algorithm: Optional[str] = None
    moe_wire_codec: Optional[str] = None
    moe_capacity_factor_max: Optional[float] = None
    # FPDT long-context training and the sequence-parallel implementation:
    # not ported, accepted at the JAX defaults only
    fpdt_q_chunk: int = 1024
    fpdt_kv_chunk: int = 1024
    fpdt_offload: bool = False
    sp_impl: str = "ulysses"
    dtype: torch.dtype = torch.float32  # activation dtype

    def __post_init__(self):
        for name in ("sparse_attention", "attn_kwargs"):
            if getattr(self, name) is not None:
                object.__setattr__(self, name, _freeze_pairs(getattr(self, name)))
        choices = {"norm": (self.norm, NORMS), "activation": (self.activation, ACTIVATIONS),
                   "position": (self.position, POSITIONS), "attn_impl": (self.attn_impl, ATTN_IMPLS)}
        for name, (got, allowed) in choices.items():
            if got not in allowed:
                raise NotImplementedError(
                    f"TransformerConfig.{name}={got!r} is not ported to PyTorch (one of {allowed})")
        unsupported = {
            "lm_head_bias": (self.lm_head_bias, False),
            "parallel_block": (self.parallel_block, False),
            "parallel_mlp_norm": (self.parallel_mlp_norm, False),
            "rope_interleaved": (self.rope_interleaved, False),
            # PR-MoE's residual expert and per-layer expert counts: JAX's
            # serving _moe reads neither, and a uniform [L, ...] stack cannot
            # hold a pyramid
            "moe_use_residual": (self.moe_use_residual, False),
            "moe_layer_experts": (self.moe_layer_experts, None),
            "fpdt_q_chunk": (self.fpdt_q_chunk, 1024),
            "fpdt_kv_chunk": (self.fpdt_kv_chunk, 1024),
            "fpdt_offload": (self.fpdt_offload, False),
            "sp_impl": (self.sp_impl, "ulysses"),
            "remat": (self.remat, False),
            "dropout": (self.dropout, 0.0),
            "sparse_embedding_grads": (self.sparse_embedding_grads, False),
        }
        for name, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f"TransformerConfig.{name}={got!r} is not ported to PyTorch (only {want!r})")
        if self.rotary_dim not in (None, self.dims_per_head):
            raise NotImplementedError(
                f"TransformerConfig.rotary_dim={self.rotary_dim}: partial rotary is not ported")
        if self.num_experts < 0 or (self.num_experts and not 1 <= self.moe_top_k <= self.num_experts):
            raise ValueError(f"TransformerConfig: moe_top_k={self.moe_top_k} must lie in "
                             f"[1, num_experts={self.num_experts}]")
        if self.num_heads % self.kv_heads:
            raise ValueError(f"num_heads={self.num_heads} not divisible by kv heads {self.kv_heads}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"TransformerConfig.dtype={self.dtype}: fp32 | bf16 only")
        if self.attn_impl == "sparse" and not self.sparse_attention:
            raise ValueError(
                "attn_impl='sparse' needs a sparse_attention config dict, e.g. "
                "{'mode': 'bigbird', 'block': 16, 'num_random_blocks': 1}")

    @property
    def sparse_attention_dict(self) -> Optional[dict]:
        return dict(self.sparse_attention) if self.sparse_attention else None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def biases(self) -> Tuple[bool, bool, bool]:
        """(qkv, dense, mlp) biases with the JAX package's norm-derived
        defaults (``Attention``/``MLP`` of ``models/transformer.py``)."""
        layernorm = self.norm == "layernorm"
        qkv = self.qkv_bias if self.qkv_bias is not None else layernorm
        dense = self.dense_bias if self.dense_bias is not None else layernorm
        mlp = self.mlp_bias if self.mlp_bias is not None else dense
        return qkv, dense, mlp

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token (fwd+bwd, 6ND + attention),
        the JAX package's formula."""
        attn = 12 * self.num_layers * self.hidden_size * seq_len
        return 6 * self.num_params() + attn

    def num_params(self) -> int:
        """The JAX package's count: projections, embedding (+ untied head),
        norm scales and, for MoE, every expert and the router; biases and
        learned positions are not counted there."""
        h, v, hd = self.hidden_size, self.vocab_size, self.dims_per_head
        qkv = h * hd * (self.num_heads + 2 * self.kv_heads) + hd * self.num_heads * h
        mlp = (3 if self.activation == "silu_glu" else 2) * h * self.intermediate_size
        if self.num_experts:
            mlp = self.num_experts * (mlp + h)
        total = v * h * (1 if self.tie_embeddings else 2) + h
        return total + self.num_layers * (qkv + mlp + 2 * h)


PRESETS = {
    "tiny": TransformerConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                              num_layers=2, num_heads=4, max_seq_len=128),
    "gpt2-125m": TransformerConfig(vocab_size=50257, hidden_size=768, intermediate_size=3072,
                                   num_layers=12, num_heads=12, max_seq_len=1024,
                                   norm="layernorm", activation="gelu", position="learned",
                                   tie_embeddings=True),
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
    """Dotted parameter path -> shape, in the stacked layout."""
    V, E, Fd, L = cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, kvH, hd = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    qkv_bias, dense_bias, mlp_bias = cfg.biases
    shapes: Dict[str, Tuple[int, ...]] = {"embed.embedding": (V, E)}
    if cfg.position == "learned":
        shapes["pos_embed"] = (cfg.max_seq_len, E)

    def norm(prefix: str, lead: Tuple[int, ...]):
        shapes[f"{prefix}.scale"] = (*lead, E)
        if cfg.norm == "layernorm":
            shapes[f"{prefix}.bias"] = (*lead, E)

    if cfg.embed_norm:
        norm("embed_norm", ())

    def dense(prefix: str, kernel: Tuple[int, ...], bias: Optional[Tuple[int, ...]]):
        shapes[f"{prefix}.kernel"] = kernel
        if bias is not None:
            shapes[f"{prefix}.bias"] = bias

    norm("layers.attn_norm", (L,))
    for name, heads in (("wq", H), ("wk", kvH), ("wv", kvH)):
        dense(f"layers.attn.{name}", (L, E, heads, hd), (L, heads, hd) if qkv_bias else None)
    dense("layers.attn.wo", (L, H, hd, E), (L, E) if dense_bias else None)
    norm("layers.mlp_norm", (L,))
    if cfg.num_experts:
        # the JAX MoELayer's tree: router kernel, stacked expert weights (no biases)
        X = cfg.num_experts
        shapes["layers.moe.gate.wg.kernel"] = (L, E, X)
        if cfg.activation == "silu_glu":
            shapes["layers.moe.experts.w_gate"] = (L, X, E, Fd)
        shapes["layers.moe.experts.w_up"] = (L, X, E, Fd)
        shapes["layers.moe.experts.w_down"] = (L, X, Fd, E)
    else:
        if cfg.activation == "silu_glu":
            dense("layers.mlp.w_gate", (L, E, Fd), (L, Fd) if mlp_bias else None)
        dense("layers.mlp.w_up", (L, E, Fd), (L, Fd) if mlp_bias else None)
        dense("layers.mlp.w_down", (L, Fd, E), (L, E) if mlp_bias else None)
    norm("final_norm", ())
    if not cfg.tie_embeddings:
        shapes["lm_head.kernel"] = (E, V)
    return shapes


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


def layer_slice(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked ``[L, ...]`` subtree (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def init_params(cfg: TransformerConfig, seed: int = 0, device: Any = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random weights made directly on ``device`` from a ``torch.Generator``
    (an 8B model never passes through host memory): every matrix is normal
    with std ``fan_in**-0.5``, ``pos_embed`` normal with std 0.02, norm
    scales 1, biases (LayerNorm's too) 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    # fan-in: the contracted dims (E for q/k/v/gate/up/head, the router and the
    # embedding rows, H*hd for wo, F for w_down and the experts' w_down)
    fan_in = {"layers.attn.wo.kernel": cfg.num_heads * cfg.dims_per_head,
              "layers.mlp.w_down.kernel": cfg.intermediate_size,
              "layers.moe.experts.w_down": cfg.intermediate_size}
    flat = {}
    for path, shape in param_shapes(cfg).items():
        t = torch.empty(shape, device=dev, dtype=dtype)
        if path.endswith(".scale"):
            t.fill_(1.0)
        elif path.endswith(".bias"):
            t.zero_()
        elif path == "pos_embed":
            t.normal_(0.0, 0.02, generator=gen)
        else:
            t.normal_(0.0, fan_in.get(path, cfg.hidden_size) ** -0.5, generator=gen)
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


@functools.lru_cache(maxsize=16)
def sparse_layout(sparse_attention: tuple, num_heads: int, seq_len: int, device):
    """``(layout [H, S/block, S/block], block, lists)`` of a frozen
    sparse_attention config at ``seq_len``, ``lists`` the kernels'
    ``layout_lists`` on ``device``: mode and block default to "bigbird" and
    16. Cached, as the JAX package builds the layout once at trace time;
    exact, because ``make_layout`` seeds its own generator on every call."""
    sa = dict(sparse_attention)
    mode = sa.pop("mode", "bigbird")
    block = sa.pop("block", 16)
    layout = get_sparsity_config(mode, num_heads=num_heads, block=block, **sa).make_layout(seq_len)
    layout.setflags(write=False)  # shared by every hit, and its lists are built once
    return layout, block, layout_lists(layout, device)


@functools.lru_cache(maxsize=16)
def alibi_slopes(num_heads: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Per-head ALiBi slopes fp32 ``[num_heads]``, the JAX package's
    ``alibi_slopes`` (``deepspeed_tpu/models/transformer.py:322-334``, HF's
    ``build_alibi_tensor``): computed in Python floats, then rounded to
    fp32. Cached per head count and device, so a forward reuses one tensor."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** p for p in range(1, closest + 1)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** p for p in range(1, 2 * (num_heads - closest), 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def apply_qk_rope(cfg: TransformerConfig, q: torch.Tensor, k: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings on q ``[B, S, H, hd]`` and k ``[B, S, kvH, hd]``."""
    cos, sin = rope_tables(cfg.max_seq_len, q.shape[-1], cfg.rope_theta, q.device)
    return rope(q, cos, sin, positions), rope(k, cos, sin, positions)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in fp32, as the JAX package's ``_apply_norm`` (flax's
    ``nn.LayerNorm`` on the training path, which is not a Pallas kernel)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def _apply_norm(norm_params: Dict[str, torch.Tensor], cfg: TransformerConfig,
                x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, norm_params["scale"], eps=cfg.norm_eps)
    return layer_norm(x, norm_params["scale"], norm_params["bias"], cfg.norm_eps, cfg.dtype)


def _proj(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [..., In] @ kernel [In, *out] -> [..., *out]."""
    k = kernel.to(dtype)
    out = x.reshape(-1, k.shape[0]) @ k.reshape(k.shape[0], -1)
    return out.reshape(*x.shape[:-1], *k.shape[1:])


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense``/``DenseGeneral``: x @ kernel (+ bias), in ``dtype``."""
    y = _proj(x, p["kernel"], dtype)
    return y + p["bias"].to(dtype) if "bias" in p else y


def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "gelu_exact":
        return F.gelu(x)
    return F.relu(x)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       pad_mask: Optional[torch.Tensor] = None,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean token cross entropy in fp32 with an ignore mask."""
    logits = logits.float()
    valid = labels != ignore_index
    if pad_mask is not None:
        valid = valid & (pad_mask > 0)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1)


def layer_params(params: Dict[str, Any], num_layers: int) -> List[Dict[str, Any]]:
    """Per-layer parameter dicts: ``params["layers"]`` is either the stacked
    tree or already a list of per-layer dicts (what the engine passes)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return list(layers)
    return [layer_slice(layers, i) for i in range(num_layers)]


class CausalLM(torch.nn.Module):
    """Decoder-only LM. ``forward(params, batch, train)``: batch
    ``{'input_ids': [B, S], optional 'labels', 'attention_mask',
    'position_ids'}`` -> ``(loss, logits)``. Training with the fused cross
    entropy returns ``logits=None`` (they never exist whole). The weights are
    passed per call, as flax's ``apply`` takes them."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.num_experts:
            raise NotImplementedError(
                f"TransformerConfig.num_experts={config.num_experts}: MoE training (the JAX "
                "package's parallel/moe.py) is not ported to PyTorch; MoE configs serve only")
        if config.position == "alibi" and config.attn_impl == "sparse":
            raise NotImplementedError(
                "TransformerConfig.position='alibi' with attn_impl='sparse' is not ported to "
                "PyTorch (the JAX package routes it to its dense masked path)")
        self.config = config

    def _attention(self, p: Dict[str, Any], x: torch.Tensor, mask, positions) -> torch.Tensor:
        cfg = self.config
        q = _dense(p["wq"], x, cfg.dtype)
        k = _dense(p["wk"], x, cfg.dtype)
        v = _dense(p["wv"], x, cfg.dtype)
        if cfg.position == "rope":
            q, k = apply_qk_rope(cfg, q, k, positions)
        if cfg.attn_impl == "sparse":
            layout, block, lists = sparse_layout(cfg.sparse_attention, cfg.num_heads,
                                                 q.shape[1], q.device)
            # query head h reads kv head h // G (the JAX model's jnp.repeat) in
            # the kernels; a key padding mask takes the dense path, as in JAX
            out = block_sparse_attention(q, k, v, layout, block=block, pad_mask=mask, lists=lists)
        else:
            slopes = alibi_slopes(cfg.num_heads, q.device) if cfg.position == "alibi" else None
            out = causal_attention(q, k, v, mask=mask, impl=cfg.attn_impl, alibi_slopes=slopes,
                                   **dict(cfg.attn_kwargs or ()))
        wo = p["wo"]["kernel"].to(cfg.dtype)  # [H, hd, E]
        H, hd, E = wo.shape
        y = (out.reshape(-1, H * hd) @ wo.reshape(H * hd, E)).reshape(*out.shape[:-2], E)
        return y + p["wo"]["bias"].to(cfg.dtype) if "bias" in p["wo"] else y

    def _mlp(self, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.activation == "silu_glu":
            h = F.silu(_dense(p["w_gate"], x, cfg.dtype)) * _dense(p["w_up"], x, cfg.dtype)
        else:
            h = _activation(cfg.activation, _dense(p["w_up"], x, cfg.dtype))
        return _dense(p["w_down"], h, cfg.dtype)

    def forward(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                train: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        ids = batch["input_ids"].long()
        B, S = ids.shape
        positions = batch.get("position_ids")
        if positions is None:
            positions = torch.arange(S, device=ids.device).expand(B, S)
        pad_mask = batch.get("attention_mask")

        embed = params["embed"]["embedding"]
        x = F.embedding(ids, embed.to(cfg.dtype))
        if cfg.embed_norm:
            x = _apply_norm(params["embed_norm"], cfg, x)
        if cfg.position == "learned":
            x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
        for lp in layer_params(params, cfg.num_layers):
            x = x + self._attention(lp["attn"], _apply_norm(lp["attn_norm"], cfg, x),
                                    pad_mask, positions)
            x = x + self._mlp(lp["mlp"], _apply_norm(lp["mlp_norm"], cfg, x))
        x = _apply_norm(params["final_norm"], cfg, x)

        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat([ids[:, 1:], torch.full((B, 1), -100, dtype=ids.dtype,
                                                       device=ids.device)], dim=1)
        use_fused = (train and cfg.fused_ce and cfg.vocab_size >= cfg.fused_ce_min_vocab
                     and not cfg.lm_head_bias)
        if use_fused:
            head = embed if cfg.tie_embeddings else params["lm_head"]["kernel"].t()  # [V, E]
            return lm_head_cross_entropy(x, head.to(cfg.dtype), labels, pad_mask), None
        if cfg.tie_embeddings:
            logits = x @ embed.t().to(cfg.dtype)
        else:
            logits = _proj(x, params["lm_head"]["kernel"], cfg.dtype)
        return cross_entropy_loss(logits, labels, pad_mask), logits


def causal_lm_spec(config: TransformerConfig, example_seq_len: int = 8,
                   pipeline_microbatches: int = 0, pipeline_virtual_stages: int = 1):
    """The engine-facing ``ModelSpec`` for a ``CausalLM``: fp32 weights from
    ``init_params``, the training forward as the loss. ``example_seq_len`` is
    accepted for parity (the port needs no example batch to make weights);
    pipelined execution is not ported."""
    from deepspeed_tpu_torch.runtime.model import ModelSpec

    if pipeline_microbatches > 1:
        raise NotImplementedError("causal_lm_spec: pipelined execution is not ported to PyTorch")
    module = CausalLM(config)
    return ModelSpec(
        init_fn=lambda seed, device: init_params(config, seed=seed, device=device,
                                                 dtype=torch.float32),
        loss_fn=lambda params, batch: module(params, batch, train=True),
        apply_fn=lambda params, batch: module(params, batch, train=False),
        name=f"CausalLM({config.hidden_size}x{config.num_layers})",
        model_config=config,
        stacked_prefix="layers",
    )
