"""Ops of the PyTorch port: plain tensor code and the wrappers of the
hand-written CUDA kernels (``csrc/``)."""

from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference
from deepspeed_tpu_torch.ops.rope import rope

__all__ = ["paged_attention", "paged_attention_reference", "rms_norm", "rms_norm_reference", "rope"]
