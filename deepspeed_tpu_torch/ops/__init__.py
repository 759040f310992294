"""Ops of the PyTorch port: plain tensor code and the wrappers of the
hand-written CUDA kernels (``csrc/``)."""

from deepspeed_tpu_torch.ops.attention import causal_attention
from deepspeed_tpu_torch.ops.block_sparse import block_sparse_attention_kernel
from deepspeed_tpu_torch.ops.cross_entropy import lm_head_cross_entropy
from deepspeed_tpu_torch.ops.flash_attention import flash_causal_attention
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference
from deepspeed_tpu_torch.ops.rope import rope
from deepspeed_tpu_torch.ops.sparse_attention import (
    block_sparse_attention,
    block_sparse_attention_dense,
    get_sparsity_config,
)

__all__ = ["block_sparse_attention", "block_sparse_attention_dense",
           "block_sparse_attention_kernel", "causal_attention", "flash_causal_attention",
           "get_sparsity_config", "lm_head_cross_entropy", "paged_attention",
           "paged_attention_reference", "rms_norm", "rms_norm_reference", "rope"]
