"""deepspeed_tpu_torch.collectives: the algorithmic collectives library
(counterpart of ``deepspeed_tpu/collectives``): hop-composed algorithms
(``algorithms.py``), wire codecs applied per hop (``codecs.py``) and the hop
kernels' backend (``pallas_backend.py``). The selector, cost model, decision
tables, compiled schedules, observatory, overlap helper and the fused GEMM
collectives are not ported."""

from deepspeed_tpu_torch.collectives.algorithms import (
    ALGORITHMS,
    all_gather,
    all_reduce,
    all_to_all,
    reduce_scatter,
)
from deepspeed_tpu_torch.collectives.codecs import CODECS, Codec, Wire, get_codec
from deepspeed_tpu_torch.collectives.pallas_backend import PALLAS_ALGORITHMS

__all__ = ["ALGORITHMS", "CODECS", "Codec", "PALLAS_ALGORITHMS", "Wire", "all_gather",
           "all_reduce", "all_to_all", "get_codec", "reduce_scatter"]
