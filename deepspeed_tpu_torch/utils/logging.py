"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

``logger`` is the process logger; ``log_dist`` logs on the listed ranks of
``torch.distributed`` (rank 0 when no process group is initialised).
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Iterable, Optional

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    lg.addHandler(handler)
    return lg


logger = _create_logger(
    level=getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(), logging.INFO)
)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (default: rank 0 only);
    ``ranks=[-1]`` logs on every rank."""
    my_rank = _rank()
    ranks = list(ranks) if ranks is not None else [0]
    if -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
