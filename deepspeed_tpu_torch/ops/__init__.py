"""Ops of the PyTorch port: plain tensor code and the wrappers of the
hand-written CUDA kernels (``csrc/``), with the JAX package's op entry point
(counterpart of ``deepspeed_tpu/ops/__init__.py``).

Ops are registered per implementation ("pallas": the kernel-backed wrapper;
"xla": the plain version) and resolved through the registry at call time
(``ops/registry.py``). Importing this package imports every op module, so
the registry is complete.
"""

from deepspeed_tpu_torch.ops.registry import available_impls, dispatch, op_report, register
from deepspeed_tpu_torch.ops.attention import (
    causal_attention,
    evoformer_attention,
    resolves_to_flash,
    xla_causal_attention,
)
from deepspeed_tpu_torch.ops.block_sparse import block_sparse_attention_kernel
from deepspeed_tpu_torch.ops.cross_entropy import lm_head_cross_entropy
from deepspeed_tpu_torch.ops.flash_attention import flash_causal_attention
from deepspeed_tpu_torch.ops.fp_quant import (
    dequantize_fp8,
    dequantize_int4,
    quantize_fp8,
    quantize_int4,
)
from deepspeed_tpu_torch.ops.norms import (
    layer_norm,
    layer_norm_reference,
    rms_norm,
    rms_norm_reference,
)
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference
from deepspeed_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from deepspeed_tpu_torch.ops.rope import rope, rope_interleaved
from deepspeed_tpu_torch.ops.sparse_attention import (
    block_sparse_attention,
    block_sparse_attention_dense,
    get_sparsity_config,
)

__all__ = ["available_impls", "block_sparse_attention", "block_sparse_attention_dense",
           "block_sparse_attention_kernel", "causal_attention", "dequantize_fp8",
           "dequantize_int4", "dequantize_int8", "dispatch", "evoformer_attention",
           "flash_causal_attention", "get_sparsity_config", "layer_norm", "layer_norm_reference",
           "lm_head_cross_entropy", "op_report", "paged_attention", "paged_attention_reference",
           "quantize_fp8", "quantize_int4", "quantize_int8", "register", "resolves_to_flash",
           "rms_norm", "rms_norm_reference", "rope", "rope_interleaved", "xla_causal_attention"]
