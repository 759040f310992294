"""Models of the PyTorch port."""

from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.transformer import PRESETS, TransformerConfig, init_params

__all__ = ["PRESETS", "TransformerConfig", "init_params", "params_from_numpy"]
