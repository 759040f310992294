"""deepspeed_tpu_torch.inference: the v2 continuous-batching engine over a
paged KV cache (counterpart of ``deepspeed_tpu/inference``)."""

from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2, RaggedInferenceConfig
from deepspeed_tpu_torch.inference.paged import PagedKVPool, init_pool, ragged_decode_chain, ragged_forward
from deepspeed_tpu_torch.inference.ragged import BlockedAllocator, StateManager, build_ragged_batch
from deepspeed_tpu_torch.inference.sampling import greedy_tokens, sample_logits

__all__ = [
    "BlockedAllocator", "InferenceEngineV2", "PagedKVPool", "RaggedInferenceConfig",
    "StateManager", "build_ragged_batch", "greedy_tokens", "init_pool", "ragged_decode_chain",
    "ragged_forward", "sample_logits",
]
