"""``deepspeed_tpu_torch.initialize()`` (counterpart of
``deepspeed_tpu/runtime/engine_builder.py``).

Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``, the
shape of the reference's ``deepspeed.initialize``. The engine runs on the
card unless ``device="cpu"`` is passed. The data loader, pipeline modules and
a caller-built mesh are not ported: ``training_data`` and ``mesh`` raise.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine
from deepspeed_tpu_torch.runtime.model import ModelSpec
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.version import __version__


def initialize(
    args: Any = None,
    model: Any = None,
    optimizer: Any = None,
    model_parameters: Any = None,
    training_data: Any = None,
    lr_scheduler: Any = None,
    mesh: Any = None,
    dist_init_required: Optional[bool] = None,
    config: Any = None,
    config_params: Any = None,
    seed: Optional[int] = None,
    device: Any = "cuda",
) -> Tuple[DeepSpeedTPUEngine, Any, None, Any]:
    """Create the training engine.

    model: a ``ModelSpec`` (``models.causal_lm_spec(cfg)``).
    model_parameters: initial weights, the JAX layout as numpy arrays or as
    the port's tensors; without them the spec's ``init_fn(seed)`` makes them.
    config: dict or path to JSON (``config_params`` accepted for parity).
    """
    log_dist(f"deepspeed_tpu_torch {__version__} initialize", ranks=[0])
    if not isinstance(model, ModelSpec):
        raise TypeError(f"model must be a ModelSpec (models.causal_lm_spec), got {type(model)}")
    if training_data is not None:
        raise NotImplementedError("initialize(training_data=...): the data loader is not ported")
    if mesh is not None:
        raise NotImplementedError("initialize(mesh=...): the port trains on one device")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("config (dict or JSON path) is required")
    engine = DeepSpeedTPUEngine(model=model, config=DeepSpeedTPUConfig(config),
                                optimizer=optimizer, lr_scheduler=lr_scheduler,
                                model_parameters=model_parameters, seed=seed, device=device)
    return engine, engine.optimizer, None, lr_scheduler
