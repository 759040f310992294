"""Inference config sections (counterpart of ``deepspeed_tpu/inference/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from deepspeed_tpu_torch.config.config_utils import DeepSpeedConfigModel


@dataclasses.dataclass
class QuantConfig(DeepSpeedConfigModel):
    """Weight-only quantisation (implementation ``inference/woq.py``), with the
    JAX package's fields and defaults.

    ``qtype`` 'int' quantises to int8 or int4 by ``bits``; 'fp' to e4m3.
    ``min_leaf_size``: kernels with fewer elements stay dense.
    ``tensor_classes`` (``woq.TENSOR_CLASSES``: 'attn', 'mlp', 'experts',
    'lm_head') selects the weight families that quantise; None = every
    eligible kernel. ``group_size`` is accepted and unused, exactly as in the
    JAX package: WOQ blocks are always 2048 flat elements (``woq._BLOCK``).
    """

    enabled: bool = False
    bits: int = 8
    group_size: int = 128
    qtype: str = "int"
    min_leaf_size: int = 1 << 16
    tensor_classes: Optional[List[str]] = None
