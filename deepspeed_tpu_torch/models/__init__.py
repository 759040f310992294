"""Models of the PyTorch port."""

from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.transformer import (
    PRESETS,
    CausalLM,
    TransformerConfig,
    causal_lm_spec,
    cross_entropy_loss,
    init_params,
    sparse_layout,
)

__all__ = ["PRESETS", "CausalLM", "TransformerConfig", "causal_lm_spec", "cross_entropy_loss",
           "init_params", "params_from_numpy", "params_to_numpy", "sparse_layout"]
