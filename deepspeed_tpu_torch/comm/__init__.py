"""deepspeed_tpu_torch.comm: the collectives facade, its logger and the rank
group (counterpart of ``deepspeed_tpu/comm``)."""

from deepspeed_tpu_torch.comm.comm import (
    CommsLogger,
    all_gather,
    all_reduce,
    all_to_all,
    broadcast,
    comms_logger,
    configure,
    log_summary,
    ppermute,
    reduce_scatter,
)
from deepspeed_tpu_torch.comm.group import RankGroup, shards_from_numpy, shards_to_numpy

__all__ = ["CommsLogger", "RankGroup", "all_gather", "all_reduce", "all_to_all", "broadcast",
           "comms_logger", "configure", "log_summary", "ppermute", "reduce_scatter",
           "shards_from_numpy", "shards_to_numpy"]
