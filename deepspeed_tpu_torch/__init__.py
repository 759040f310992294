"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

A package of its own beside ``deepspeed_tpu`` (the JAX reference, which it
never imports). It mirrors the reference's module paths. Plain tensor code is
PyTorch; every Pallas kernel of the reference on a ported path is a CUDA
kernel written by hand for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at
first use (``ops/op_builder.py``). Entry points run on the card unless the
caller passes ``device="cpu"``, where the kernels' plain PyTorch versions run.

Ported so far: serving a dense Llama-style decoder through
``inference.InferenceEngineV2`` (RMSNorm and paged attention kernels), and
training Llama- and GPT-2-style decoders on one device through
``initialize(model=models.causal_lm_spec(cfg), config=...)`` and
``engine.train_batch`` (flash-attention forward, dq and dkv kernels, and
the RMSNorm kernel with its backward); later slices added the quantised,
Bloom and Mixtral forms, block-sparse attention, the op entry point
(``ops``) and the collectives library (``comm`` over a ``comm.RankGroup``,
``collectives``) with its ring hop kernels.
"""

from deepspeed_tpu_torch.runtime.engine_builder import initialize
from deepspeed_tpu_torch.version import __version__

__all__ = ["__version__", "initialize"]
