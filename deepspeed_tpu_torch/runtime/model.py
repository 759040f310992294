"""Model contract handed to the engine (counterpart of
``deepspeed_tpu/runtime/model.py``).

As in the JAX package the engine wraps a pair of functions, not a module
that owns its weights: ``init_fn(seed, device)`` makes the fp32 parameter
tree, ``loss_fn(params, batch)`` returns the scalar loss or ``(loss, aux)``.
Parameters are a nested dict of tensors in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class ModelSpec:
    """Pure-function model contract.

    init_fn(seed, device) -> fp32 params tree
    loss_fn(params, batch) -> scalar loss, or (loss, aux)
    apply_fn(params, batch) -> model outputs (forward without training; optional)
    stacked_prefix: top-level key of the params tree whose leaves are stacked
        along dim 0, one entry per layer. The engine hands ``loss_fn`` a list
        of per-layer dicts there, so that each layer's gradient is a leaf of
        its own (autograd through ``stacked[i]`` views would materialise a
        full-size zero gradient per layer).
    """

    init_fn: Callable[[int, Any], Any]
    loss_fn: Callable[[Any, Any], Any]
    apply_fn: Optional[Callable[[Any, Any], Any]] = None
    name: str = "model"
    model_config: Optional[Any] = None
    stacked_prefix: Optional[str] = None
