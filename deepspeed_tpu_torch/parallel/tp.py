"""Tensor-parallel linears over the fused GEMM collectives (counterpart of
``deepspeed_tpu/parallel/tp.py``).

Megatron-style row/column-parallel linears on rank lists of a
``comm.RankGroup``. The row-parallel boundary, the one that moves bytes,
runs through :mod:`deepspeed_tpu_torch.collectives.fused_gemm` when its knob
is on (one row-15 kernel launch a hop); with the knob off both helpers are
the plain composition. fp32 out, as the fused ops. The rest of JAX's
``parallel/`` (``autotp.py``, ``moe.py``, pipelines, sequence parallelism)
is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deepspeed_tpu_torch.collectives import fused_gemm
from deepspeed_tpu_torch.comm import comm as dist


def column_parallel_linear(x: Sequence[torch.Tensor], w_col: Sequence[torch.Tensor]
                           ) -> List[torch.Tensor]:
    """Every rank's ``x [M, K] @ w_col [K, N/n] -> [M, N/n]``: the
    column-parallel half moves no bytes (input replicated, output
    column-sharded); it exists so a column -> row pair reads as a pair."""
    return [xr.float() @ wr.float() for xr, wr in zip(x, w_col)]


def row_parallel_linear(x_shard: Sequence[torch.Tensor], w_row: Sequence[torch.Tensor], axis, *,
                        scatter_output: bool = True, quantize: bool = False,
                        block: Optional[int] = None) -> List[torch.Tensor]:
    """``x_shard [M, K/n] @ w_row [K/n, N]`` summed over the group.

    ``scatter_output=True`` gives the sequence-parallel form: rank ``i`` gets
    row block ``i`` of ``[M/n, N]`` (``fused_gemm.matmul_reduce_scatter``:
    fused, each hop's partial product in the launch that moves it; unfused,
    one product and a sum-scatter). ``False`` gives the replicated ``[M, N]``
    by one product and the facade's native sum. ``quantize`` puts the int8
    block wire on the fused hops."""
    if not scatter_output:
        p = [xr.float() @ wr.float() for xr, wr in zip(x_shard, w_row)]
        return dist.all_reduce(p, axis) if axis.n > 1 else p
    return fused_gemm.matmul_reduce_scatter(x_shard, w_row, axis,
                                            codec="int8" if quantize else None, block_size=block)
