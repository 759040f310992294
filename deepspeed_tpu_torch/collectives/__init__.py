"""deepspeed_tpu_torch.collectives: the algorithmic collectives library
(counterpart of ``deepspeed_tpu/collectives``): hop-composed algorithms
(``algorithms.py``), wire codecs applied per hop (``codecs.py``) and the hop
kernels' backend (``pallas_backend.py``), and the fused GEMM collectives
(``fused_gemm.py``). The selector, cost model, decision tables, compiled
schedules, observatory and overlap helper are not ported."""

from deepspeed_tpu_torch.collectives.algorithms import (
    ALGORITHMS,
    all_gather,
    all_reduce,
    all_to_all,
    reduce_scatter,
)
from deepspeed_tpu_torch.collectives.codecs import CODECS, Codec, Wire, get_codec
from deepspeed_tpu_torch.collectives.fused_gemm import all_gather_matmul, matmul_reduce_scatter
from deepspeed_tpu_torch.collectives.pallas_backend import PALLAS_ALGORITHMS

__all__ = ["ALGORITHMS", "CODECS", "Codec", "PALLAS_ALGORITHMS", "Wire", "all_gather",
           "all_gather_matmul", "all_reduce", "all_to_all", "get_codec", "matmul_reduce_scatter",
           "reduce_scatter"]
