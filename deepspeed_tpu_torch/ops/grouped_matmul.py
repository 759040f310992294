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
a CUDA tensor it launches one form of the hand-written kernel
``csrc/grouped_gemm.cu`` (one launch for every group; the group sizes stay on
the device) or raises.

The forms (``FORMS``), picked by ``pick_form`` from the dtype, the routed
row count m, K, N and the pointers' alignment, never from the group sizes:

- ``"wgmma"`` (form P, prefill): bf16, wgmma tiles fed by TMA;
- ``"stream"`` (form D, decode, ``m <= GMM_DECODE_MAX_ROWS``): bf16, the
  operands swapped so that the expert weights stream through a deep TMA ring;
- ``"mma"``: bf16 shapes the TMA forms do not take (K or N not a multiple of
  8, or a pointer off 16 bytes), mma.sync tiles fed by cp.async;
- ``"simt"``: fp32, FMA on the CUDA cores.

m decides which form the wrapper picks, not which form can run: forms P and
D take any m. ``_grouped_matmul_form`` runs one named form (tests, timing).
Each form counts its launches in ``grouped_matmul.launches_by_form``;
``grouped_matmul.launches`` is their sum.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops import op_builder

# form name -> the C entry's form code (csrc/grouped_gemm.cu, enum Form)
FORMS = {"simt": 0, "mma": 1, "wgmma": 2, "stream": 3}
# The most routed rows that still take form D: at Mixtral-8x7B's up and down
# projections (8 experts, top-2) form D is the faster form up to here and
# form P past it (chip_smoke.py's crossover sweep, NVIDIA H100 80GB HBM3).
GMM_DECODE_MAX_ROWS = 64


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


def form_takes(form: str, dtype: torch.dtype, K: int, N: int, aligned: bool) -> bool:
    """Whether ``form`` can run a ``[m, K] x [E, K, N]`` product of ``dtype``
    whose lhs and rhs start on 16-byte boundaries (``aligned``). The TMA forms
    need K and N multiples of 8 (16-byte row strides) and K > 0."""
    if form == "simt":
        return dtype == torch.float32
    if form == "mma":
        return dtype == torch.bfloat16
    if form in ("wgmma", "stream"):
        return dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0 and aligned
    raise ValueError(f"grouped_matmul: unknown form {form!r}; forms are {sorted(FORMS)}")


def pick_form(dtype: torch.dtype, m: int, K: int, N: int, aligned: bool) -> str:
    """The form the wrapper runs for this product."""
    if dtype == torch.float32:
        return "simt"
    if not form_takes("wgmma", dtype, K, N, aligned):
        return "mma"
    return "stream" if m <= GMM_DECODE_MAX_ROWS else "wgmma"


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> None:
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


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
            form: str) -> torch.Tensor:
    """Allocate the output and launch ``form``; count the launch."""
    m, K = lhs.shape
    E, _, N = rhs.shape
    out = torch.empty(m, N, dtype=lhs.dtype, device=lhs.device)
    if m == 0 or N == 0:
        return out
    op_builder.launch("grouped_gemm", "ds_grouped_matmul", lhs.data_ptr(), rhs.data_ptr(),
                      group_sizes.data_ptr(), out.data_ptr(), m, K, N, E,
                      op_builder.DTYPE_CODES[lhs.dtype], FORMS[form],
                      torch.cuda.current_stream(lhs.device).cuda_stream)
    grouped_matmul.launches_by_form[form] += 1
    grouped_matmul.launches += 1
    return out


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``[m, K] x [E, K, N]`` by ``group_sizes [E]`` -> ``[m, N]`` in lhs's dtype."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_sizes)
    _check(lhs, rhs, group_sizes)
    form = pick_form(lhs.dtype, lhs.shape[0], lhs.shape[1], rhs.shape[2], _aligned(lhs, rhs))
    return _launch(lhs, rhs, group_sizes, form)


def _grouped_matmul_form(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                         form: str) -> torch.Tensor:
    """``grouped_matmul`` through the named form, whatever ``pick_form`` would
    choose; raises ``ValueError`` for a shape, dtype or alignment the form
    does not take, and for a CPU tensor (a form is a kernel)."""
    _check(lhs, rhs, group_sizes)
    if not form_takes(form, lhs.dtype, lhs.shape[1], rhs.shape[2], _aligned(lhs, rhs)):
        raise ValueError(f"grouped_matmul: form {form!r} does not take {lhs.dtype} "
                         f"[{lhs.shape[0]}, {lhs.shape[1]}] x {list(rhs.shape)} (aligned: "
                         f"{_aligned(lhs, rhs)})")
    return _launch(lhs, rhs, group_sizes, form)


grouped_matmul.launches = 0
grouped_matmul.launches_by_form = dict.fromkeys(FORMS, 0)
