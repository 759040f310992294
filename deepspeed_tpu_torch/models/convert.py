"""Carry weights between the JAX package's parameter tree and the port.

``params_from_numpy`` takes the JAX ``CausalLM`` param tree as nested dicts of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), in either
layout the JAX model has: stacked ``layers`` of shape ``[L, ...]``
(``scan_layers=True``) or ``layer_{i}`` subtrees (``scan_layers=False``),
which are stacked on the way in; an MoE model's ``moe`` subtree (router
``gate.wg.kernel``, expert stacks ``experts.{w_gate,w_up,w_down}``) crosses
like any other. It returns the port's parameters, checked leaf by leaf
against the config's shapes. ``params_to_numpy`` is the
inverse, in the layout ``cfg.scan_layers`` names, so that tests compare
weights leaf by leaf. Both take or give numpy, so they need nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig, flatten, nest, param_shapes
from deepspeed_tpu_torch.utils.device import resolve_device


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array: torch needs its own copy
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 (what JAX hands out): same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _stack_layers(flat: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """``layer_{i}.<rest>`` leaves -> ``layers.<rest>`` stacked along dim 0."""
    out = {k: v for k, v in flat.items() if not k.startswith("layer_")}
    per_layer = [{k[len(f"layer_{i}."):]: v for k, v in flat.items()
                  if k.startswith(f"layer_{i}.")} for i in range(num_layers)]
    extra = set(flat) - set(out) - {f"layer_{i}.{k}" for i, d in enumerate(per_layer) for k in d}
    if extra:
        raise ValueError(f"param tree does not match the config: extra {sorted(extra)}")
    for rest in per_layer[0] if per_layer else {}:
        if any(rest not in d for d in per_layer):
            raise ValueError(f"param tree does not match the config: missing layer_*.{rest}")
        out[f"layers.{rest}"] = np.stack([np.asarray(d[rest]) for d in per_layer])
    return out


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, device: Any = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX param tree (numpy leaves) -> port params on ``device`` (cast to
    ``dtype`` when given). Raises on a missing, extra or mis-shaped leaf."""
    dev = resolve_device(device)
    flat = flatten(tree)
    if any(k.startswith("layer_") for k in flat):
        flat = _stack_layers(flat, cfg.num_layers)
    want = param_shapes(cfg)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match the config: missing {missing}, extra {extra}")
    out = {}
    for path, shape in want.items():
        a = np.asarray(flat[path])
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, config expects {shape}")
        out[path] = _to_tensor(a).to(device=dev, dtype=dtype)
    return nest(out)


def params_to_numpy(params: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """Port params -> the JAX param tree as numpy arrays (fp32 for bf16
    leaves), in the stacked layout or, with ``cfg.scan_layers=False``, as
    ``layer_{i}`` subtrees."""
    out = {}
    for path, t in flatten(params).items():
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if path.startswith("layers.") and not cfg.scan_layers:
            rest = path[len("layers."):]
            for i in range(a.shape[0]):
                out[f"layer_{i}.{rest}"] = a[i]
        else:
            out[path] = a
    return nest(out)
