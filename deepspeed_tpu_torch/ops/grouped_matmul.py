"""Grouped matmul of expert-contiguous rows (counterpart of
``deepspeed_tpu/inference/model.py:234 _gmm_padded``, JAX's megablox ``gmm``
Pallas kernel, and of ``:253 _grouped_matmul``, which picks it on a TPU and
``lax.ragged_dot`` elsewhere).

``grouped_matmul(lhs, rhs, group_sizes)`` computes ``out[rows of g] =
lhs[rows of g] @ rhs[g]``: ``lhs [m, K]`` holds the rows of group 0, then of
group 1, and so on, ``rhs [E, K, N]`` one matrix per group and
``group_sizes [E]`` int32 the row counts. Accumulation is in fp32 and the
output in ``lhs``'s dtype. Rows past the sum of the group sizes are 0, as in
``ragged_dot``. On a CPU tensor the wrapper runs ``grouped_matmul_plain``; on
a CUDA tensor it launches the hand-written kernel ``csrc/grouped_gemm.cu``
(one launch for every group; the group sizes stay on the device) or raises.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops import op_builder


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain version: a loop of per-group ``lhs[rows] @ rhs[g]`` in fp32,
    cast to ``lhs.dtype``. A negative size counts as 0 and groups past row
    ``m`` are cut at ``m``, as the kernel does."""
    m = lhs.shape[0]
    out = torch.zeros(m, rhs.shape[-1], dtype=lhs.dtype, device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), m)
        if end > start:
            out[start:end] = (lhs[start:end].float() @ rhs[g].float()).to(lhs.dtype)
        start = end
    return out


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``[m, K] x [E, K, N]`` by ``group_sizes [E]`` -> ``[m, N]`` in lhs's dtype."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"grouped_matmul: lhs [m, K] and rhs [E, K, N] expected, got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    E = rhs.shape[0]
    if group_sizes.shape != (E,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"grouped_matmul: group_sizes must be int32 [{E}], got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    for name, t in (("lhs", lhs), ("rhs", rhs), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(f"grouped_matmul: {name} on {t.device}, lhs on {lhs.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_matmul: {name} must be contiguous")
    if lhs.dtype not in op_builder.DTYPE_CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul: lhs {lhs.dtype} and rhs {rhs.dtype}: both fp32 or "
                        "both bf16")
    m, K = lhs.shape
    N = rhs.shape[2]
    if max(m, K) >= 2 ** 31 or N > 64 * 65535:
        raise ValueError(f"grouped_matmul: m={m}, K={K}, N={N} exceed the kernel's int32 "
                         "sizes or its grid (N <= 64 * 65535)")
    out = torch.empty(m, N, dtype=lhs.dtype, device=lhs.device)
    if m == 0 or N == 0:
        return out
    op_builder.launch("grouped_gemm", "ds_grouped_matmul", lhs.data_ptr(), rhs.data_ptr(),
                      group_sizes.data_ptr(), out.data_ptr(), m, K, N, E,
                      op_builder.DTYPE_CODES[lhs.dtype],
                      torch.cuda.current_stream(lhs.device).cuda_stream)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
