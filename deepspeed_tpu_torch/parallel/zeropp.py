"""ZeRO-3's fused-gather product (counterpart of ``sharded_matmul``,
``deepspeed_tpu/parallel/zeropp.py:309-352``).

Only :func:`sharded_matmul` is ported. The rest of JAX's ``zeropp.py`` (the
per-leaf comm plans, the quantised weight gathers and gradient reductions of
qwZ / qgZ with LoCo error feedback, and the engine's wiring of them) comes
with multi-GPU data parallelism and ZeRO (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from deepspeed_tpu_torch.collectives import fused_gemm

DEFAULT_BLOCK = 2048


class _ShardedMatmul(torch.autograd.Function):
    """Rank lists through autograd: ``forward(ctx, group, quantize, block, n,
    *x, *w_shard)`` returns the ``n`` ranks' products."""

    @staticmethod
    def forward(ctx, group, quantize, block, n, *tensors):
        xs, ws = list(tensors[:n]), list(tensors[n:])
        ctx.group, ctx.quantize, ctx.block, ctx.n = group, quantize, block, n
        ctx.save_for_backward(*tensors)
        return tuple(fused_gemm.all_gather_matmul(
            xs, ws, group, codec="int8" if quantize else None, block_size=block))

    @staticmethod
    def backward(ctx, *gs):
        n, group = ctx.n, ctx.group
        saved = ctx.saved_tensors
        xs, ws = saved[:n], saved[n:]
        gs = [torch.zeros(x.shape[0], w.shape[1], device=x.device) if g is None else g.float()
              for g, x, w in zip(gs, xs, ws)]
        codec = "int8" if ctx.quantize else None
        dx = fused_gemm.all_gather_matmul(gs, list(ws), group, codec=codec, block_size=ctx.block,
                                          out_block=True)
        dw = fused_gemm.matmul_reduce_scatter([x.t() for x in xs], gs, group, codec=codec,
                                              block_size=ctx.block)
        return (None, None, None, None, *[d.to(x.dtype) for d, x in zip(dx, xs)],
                *[d.to(w.dtype) for d, w in zip(dw, ws)])


def sharded_matmul(x: Sequence[torch.Tensor], w_shard: Sequence[torch.Tensor], axis,
                   quantize: bool = False, block: int = DEFAULT_BLOCK) -> List[torch.Tensor]:
    """Every rank's ``x [M, K] @ W [K, N]``, ``W`` row-sharded over the group
    (rank r holds ``w_shard[r] [K/n, N]``) and the ZeRO-3 weight gather fused
    into the product (``fused_gemm.all_gather_matmul``): the forward never
    materialises the full weight.

    Backward: ``dw_shard`` through ``matmul_reduce_scatter(x^T, g)`` (the sum
    over the ranks, as per-rank-batch partials add), ``dx = g @ W^T``
    through the gather's column-block form; ``dx`` in ``x``'s dtype and
    ``dw`` in ``w``'s. ``quantize`` puts the int8 block wire on every fused
    hop. With the knob off (``fused_gemm.configure``) every path is the
    unfused composition. fp32 out."""
    n = len(x)
    return list(_ShardedMatmul.apply(axis, quantize, block, n, *x, *w_shard))
