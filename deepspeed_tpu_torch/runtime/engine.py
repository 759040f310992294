"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``,
``DeepSpeedTPUEngine``), the single-device subset of ``_build_train_step`` and
``_update_math``.

One ``train_batch(batch)`` is one optimizer step over ``train_batch_size``
samples:

1. compute weights are cast from the fp32 masters (bf16 with
   ``bf16.enabled``, else fp32), one autograd leaf per tensor and per layer
   of a stacked tree (``ModelSpec.stacked_prefix``);
2. the global batch is reshaped ``[gas, micro, ...]``; each micro-batch's loss
   is differentiated with respect to the compute weights and the gradients
   are accumulated in fp32 (in bf16 with ``accumulate_grads_in_fp32: false``);
3. the sum is divided by ``gas``, its global norm taken, and it is clipped
   by ``gradient_clipping`` (``clip_by_global_norm``, the ``+1e-6`` included);
4. Adam/AdamW updates the masters in place.

The returned metrics ``{loss, grad_norm, lr, loss_scale, overflow}`` stay on
the device: ``train_batch`` never waits for it, except every
``steps_per_print`` steps, where one fetch feeds the log line, as in the JAX
engine. ``forward``/``backward``/``step`` and checkpoints are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.models.transformer import flatten, nest
from deepspeed_tpu_torch.runtime.lr_schedules import constant_schedule, get_lr_schedule
from deepspeed_tpu_torch.runtime.model import ModelSpec
from deepspeed_tpu_torch.runtime.optimizers import get_optimizer
from deepspeed_tpu_torch.runtime.precision import (
    LOSS_SCALE,
    cast_floating,
    clip_by_global_norm,
    global_norm,
)
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist


def _as_tensor(x: Any, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


class DeepSpeedTPUEngine:
    """Training engine (reference ``DeepSpeedEngine``), one device."""

    def __init__(self, model: ModelSpec, config: Any, optimizer: Any = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 model_parameters: Any = None, seed: Optional[int] = None,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.config = config if isinstance(config, DeepSpeedTPUConfig) else DeepSpeedTPUConfig(config)
        self.compute_dtype = self.config.compute_dtype
        bf16 = self.config.model.bf16
        self._accum_dtype = (torch.bfloat16 if bf16.enabled and not bf16.accumulate_grads_in_fp32
                             else torch.float32)
        seed = seed if seed is not None else self.config.model.seed

        # ---- optimizer + schedule
        self.lr_scheduler_fn = self._build_lr_schedule(lr_scheduler)
        if optimizer is not None:
            self.optimizer = optimizer
        else:
            opt_cfg = self.config.model.optimizer
            if opt_cfg is None:
                raise ValueError("No optimizer: pass one to initialize() or add an 'optimizer' "
                                 "section to the config")
            self.optimizer, _ = get_optimizer(opt_cfg.type, opt_cfg.params,
                                              learning_rate=self.lr_scheduler_fn)

        # ---- fp32 masters on the device, flat {dotted path: tensor}
        self.params = self._init_masters(model_parameters, seed)
        self._paths = list(self.params)
        self.optimizer.init([self.params[p] for p in self._paths])
        self._grads = {p: torch.zeros_like(t, dtype=self._accum_dtype) for p, t in self.params.items()}
        self._steps = 0
        self._last_metrics: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------ set-up
    def _build_lr_schedule(self, client_sched) -> Callable[[int], float]:
        if client_sched is not None and callable(client_sched):
            return client_sched
        sched_cfg = self.config.model.scheduler
        opt_cfg = self.config.model.optimizer
        base_lr = opt_cfg.params.get("lr") if opt_cfg is not None else None
        if sched_cfg is not None and sched_cfg.type:
            return get_lr_schedule(sched_cfg.type, sched_cfg.params, base_lr=base_lr)
        return constant_schedule(base_lr if base_lr is not None else 1e-3)

    def _init_masters(self, model_parameters, seed: int) -> Dict[str, torch.Tensor]:
        if model_parameters is None:
            tree = self.model.init_fn(seed, self.device)
        else:
            leaves = flatten(model_parameters)
            if all(isinstance(v, torch.Tensor) for v in leaves.values()):
                tree = model_parameters
            else:
                from deepspeed_tpu_torch.models.convert import params_from_numpy

                tree = params_from_numpy(model_parameters, self.model.model_config,
                                         device=self.device, dtype=torch.float32)
        # own fp32 copies: the update runs in place and must not write into
        # the caller's tensors
        return {k: v.detach().to(device=self.device, dtype=torch.float32, copy=True)
                for k, v in flatten(tree).items()}

    # ------------------------------------------------------------ the step
    def _compute_params(self) -> Tuple[Dict[str, Any], List[torch.Tensor], List[Tuple[str, Optional[int]]]]:
        """Compute weights cast from the masters: (tree for ``loss_fn``,
        autograd leaves, (master path, layer index or None) of each leaf)."""
        prefix = self.model.stacked_prefix
        flat, leaves, index = {}, [], []
        for path, w in cast_floating(self.params, self.compute_dtype).items():
            if prefix is not None and path.startswith(prefix + "."):
                per_layer = [t.detach().requires_grad_(True) for t in w.unbind(0)]
                flat[path] = per_layer
                leaves.extend(per_layer)
                index.extend((path, i) for i in range(len(per_layer)))
            else:
                leaf = w.detach().requires_grad_(True)
                flat[path] = leaf
                leaves.append(leaf)
                index.append((path, None))
        tree = nest({k: v for k, v in flat.items() if not isinstance(v, list)})
        if prefix is not None:
            stacked = {k[len(prefix) + 1:]: v for k, v in flat.items() if isinstance(v, list)}
            n_layers = len(next(iter(stacked.values()))) if stacked else 0
            tree[prefix] = [nest({k: v[i] for k, v in stacked.items()}) for i in range(n_layers)]
        return tree, leaves, index

    def _shard_global_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """[global_batch, ...] -> [gas, micro, ...] on the device."""
        gas, total = self.config.gradient_accumulation_steps, self.config.train_batch_size
        out = {}
        for key, value in batch.items():
            t = _as_tensor(value, self.device)
            if t.shape[0] != total:
                raise ValueError(f"batch leading dim {t.shape[0]} != train_batch_size {total}")
            out[key] = t.reshape(gas, total // gas, *t.shape[1:])
        return out

    def train_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``train_batch_size`` samples; ``batch`` maps
        names (``input_ids`` and optionally ``labels``, ``attention_mask``,
        ``position_ids``) to arrays with leading dim ``train_batch_size``."""
        placed = self._shard_global_batch(batch)
        gas = self.config.gradient_accumulation_steps
        tree, leaves, index = self._compute_params()
        for g in self._grads.values():
            g.zero_()
        losses = []
        for i in range(gas):
            micro = {k: v[i] for k, v in placed.items()}
            out = self.model.loss_fn(tree, micro)
            loss = out[0] if isinstance(out, tuple) else out
            grads = torch.autograd.grad(loss.float() * LOSS_SCALE, leaves,
                                        allow_unused=True, materialize_grads=True)
            for (path, layer), g in zip(index, grads):
                acc = self._grads[path] if layer is None else self._grads[path][layer]
                acc.add_(g)
            losses.append(loss.detach())
            del out, loss, grads
        del tree, leaves
        loss_mean = torch.stack(losses).float().mean()
        metrics = self._update_math(loss_mean)
        self._last_metrics = metrics
        self._steps += 1
        if self._steps % self.config.model.steps_per_print == 0:
            # the periodic sync point: one fetch per steps_per_print batches
            fetched = {k: v.item() for k, v in metrics.items()}
            log_dist(f"step={self._steps} loss={fetched['loss']:.4f} lr={fetched['lr']:.3e} "
                     f"grad_norm={fetched['grad_norm']:.3f}", ranks=[0])
        return metrics

    @torch.no_grad()
    def _update_math(self, loss_mean: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Scale / clip / optimizer update (reference ``_update_math``)."""
        gas = self.config.gradient_accumulation_steps
        clip = self.config.gradient_clipping
        grads = [self._grads[p].float() for p in self._paths]
        inv = 1.0 / (gas * LOSS_SCALE)
        if inv != 1.0:
            torch._foreach_mul_(grads, inv)
        gnorm = global_norm(grads)
        if clip and clip > 0:
            grads, gnorm = clip_by_global_norm(grads, clip, norm=gnorm)
        step = self._steps
        self.optimizer.step([self.params[p] for p in self._paths], grads)
        dev = self.device
        return {
            "loss": loss_mean,
            "grad_norm": gnorm,
            "lr": torch.full((), float(self.lr_scheduler_fn(step)), dtype=torch.float32, device=dev),
            "loss_scale": torch.full((), LOSS_SCALE, dtype=torch.float32, device=dev),
            "overflow": torch.zeros((), dtype=torch.bool, device=dev),
        }

    # ------------------------------------------------------------ accessors
    @property
    def global_steps(self) -> int:
        return self._steps

    def get_lr(self) -> float:
        return float(self.lr_scheduler_fn(self._steps))

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's gradient norm before clipping (a host sync), or
        None before the first step."""
        return None if self._last_metrics is None else float(self._last_metrics["grad_norm"])

    @property
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps_value(self) -> int:
        return self.config.gradient_accumulation_steps

    def module_state_dict(self) -> Dict[str, Any]:
        """The fp32 master weights as a nested dict of host tensors (the JAX
        package's layout), as the reference's ``module_state_dict``."""
        return nest({k: v.detach().cpu() for k, v in self.params.items()})
