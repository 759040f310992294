"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

The port carries Adam and AdamW, each the optax chain the JAX package builds:
``scale_by_adam -> add_decayed_weights(wd) -> scale_by_learning_rate(lr)``
(Adam with ``adam_w_mode=False`` drops the decay). The math is optax's:
bias-corrected moments with the corrections taken in fp32, ``eps`` outside
the square root, decay on every leaf (no mask), and the lr read from the
schedule at the optimizer's own update count. It runs in plain PyTorch on the
fp32 master weights, updating them and the moments in place with
``torch._foreach_*`` ops over the lists of leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.lr_schedules import Schedule, constant_schedule

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"


class AdamW:
    """optax ``scale_by_adam`` (+ ``add_decayed_weights``) + ``scale_by_learning_rate``."""

    def __init__(self, lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: Optional[float] = 0.0):
        self.lr = lr if callable(lr) else constant_schedule(float(lr))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay  # None: no decay transform in the chain
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: List[torch.Tensor]) -> None:
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> float:
        """One update of ``params`` in place from fp32 ``grads``; returns the
        lr it used."""
        count_inc = self.count + 1
        # optax: 1 - decay**count in fp32, the moment divided by it
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count_inc))
        lr = float(self.lr(self.count))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        update = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay is not None:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        self.count = count_inc
        return lr


def get_optimizer(name: str, params: Optional[Dict[str, Any]] = None,
                  learning_rate: Optional[Union[float, Callable]] = None):
    """Build the optimizer for a DeepSpeed optimizer name. Returns
    ``(optimizer, lr_schedule)``; ``learning_rate`` overrides ``params['lr']``."""
    params = dict(params or {})
    lr = learning_rate if learning_rate is not None else float(params.get("lr", 1e-3))
    wd = float(params.get("weight_decay", 0.0))
    betas = params.get("betas", (0.9, 0.999))
    common = dict(b1=float(betas[0]), b2=float(betas[1]), eps=float(params.get("eps", 1e-8)))
    key = name.lower().replace("_", "")
    if key == ADAM_OPTIMIZER:
        # FusedAdam's default adam_w_mode=True: decoupled decay
        decay = wd if params.get("adam_w_mode", True) else None
        return AdamW(lr, weight_decay=decay, **common), lr
    if key == ADAMW_OPTIMIZER:
        return AdamW(lr, weight_decay=wd, **common), lr
    raise NotImplementedError(
        f"optimizer {name!r} is not ported to PyTorch (Adam and AdamW are)")
