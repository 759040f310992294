"""Carry weights from the JAX package's parameter tree into the port.

``params_from_numpy`` takes the JAX ``CausalLM`` param tree as nested dicts of
numpy arrays (stacked ``layers`` of shape ``[L, ...]``, as
``jax.tree_util.tree_map(np.asarray, params)`` gives it) and returns the
port's parameters, checked leaf by leaf against the config's shapes. It takes
numpy in, so it needs nothing of JAX.
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


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, device: Any = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX param tree (numpy leaves) -> port params on ``device`` (cast to
    ``dtype`` when given). Raises on a missing, extra or mis-shaped leaf."""
    dev = resolve_device(device)
    flat = flatten(tree)
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
