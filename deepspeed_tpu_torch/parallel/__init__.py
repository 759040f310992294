"""deepspeed_tpu_torch.parallel (counterpart of ``deepspeed_tpu/parallel``):
the tensor-parallel linears (``tp.py``) and ZeRO-3's fused-gather product
(``zeropp.sharded_matmul``). The rest of the JAX package's ``parallel/`` is
not ported."""

from deepspeed_tpu_torch.parallel.tp import column_parallel_linear, row_parallel_linear
from deepspeed_tpu_torch.parallel.zeropp import sharded_matmul

__all__ = ["column_parallel_linear", "row_parallel_linear", "sharded_matmul"]
