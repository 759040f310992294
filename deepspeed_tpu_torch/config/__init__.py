"""Config machinery of the PyTorch port."""

from deepspeed_tpu_torch.config.config_utils import DeepSpeedConfigModel

__all__ = ["DeepSpeedConfigModel"]
