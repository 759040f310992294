"""Ops of the PyTorch port: plain tensor code and the wrappers of the
hand-written CUDA kernels (``csrc/``)."""

from deepspeed_tpu_torch.ops.attention import causal_attention
from deepspeed_tpu_torch.ops.cross_entropy import lm_head_cross_entropy
from deepspeed_tpu_torch.ops.flash_attention import flash_causal_attention
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference
from deepspeed_tpu_torch.ops.rope import rope

__all__ = ["causal_attention", "flash_causal_attention", "lm_head_cross_entropy",
           "paged_attention", "paged_attention_reference", "rms_norm", "rms_norm_reference",
           "rope"]
