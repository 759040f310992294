"""Training runtime of the PyTorch port: config-driven engine, optimizer,
schedules and precision helpers (counterpart of ``deepspeed_tpu/runtime``)."""

from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine
from deepspeed_tpu_torch.runtime.engine_builder import initialize
from deepspeed_tpu_torch.runtime.model import ModelSpec

__all__ = ["DeepSpeedTPUEngine", "ModelSpec", "initialize"]
