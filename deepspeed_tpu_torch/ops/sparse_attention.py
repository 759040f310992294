"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention.py``).

The six sparsity configs (Dense, LocalSlidingWindow, Fixed, BigBird,
Variable, BSLongformer) build the JAX package's ``[H, S/block, S/block]``
0/1 block layouts in numpy, the same code in the same order: BigBird's and
Variable's random blocks come from ``np.random.RandomState(seed)``, drawn in
the same sequence, so the layouts are bit-equal to the JAX package's.

``block_sparse_attention`` routes on its arguments only, as the JAX function
does: ``impl="pallas"`` (the JAX name, kept so that configs read the same)
runs the hand-written tile-skipping kernels of ``ops/block_sparse.py`` (their
plain versions on a CPU tensor); ``impl="xla"`` runs
``block_sparse_attention_dense``, the plain masked-softmax path that also
takes ALiBi slopes and a key padding mask; ``impl="auto"`` takes the kernels
unless one of those extras is given. The route never depends on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.block_sparse import block_sparse_attention_kernel

IMPLS = ("auto", "pallas", "xla")


# ----------------------------------------------------------- sparsity configs
@dataclasses.dataclass
class SparsityConfig:
    """Base: ``make_layout(seq_len)`` gives a ``[num_heads, S/block, S/block]``
    int8 0/1 block mask."""

    num_heads: int
    block: int = 16

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _empty(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), np.int8)


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks active."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self._empty(seq_len)
        layout[:] = 1
        return layout


@dataclasses.dataclass
class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """A causal window of ``num_sliding_window_blocks`` blocks."""

    num_sliding_window_blocks: int = 3

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self._empty(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks
        for i in range(n):
            layout[:, i, max(0, i - w + 1): i + 1] = 1
        return layout


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks`` plus the last
    ``num_global_blocks`` of every earlier window, clamped to the causal part."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self._empty(seq_len)
        n = layout.shape[1]
        L = self.num_local_blocks
        for i in range(n):
            layout[:, i, i // L * L: i + 1] = 1
            for g in range(L - self.num_global_blocks, i, L):
                if 0 <= g <= i:
                    layout[:, i, g: min(g + self.num_global_blocks, i + 1)] = 1
        return layout


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Random, sliding-window and global blocks, per head."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self._empty(seq_len)
        n = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        w, g = self.num_sliding_window_blocks, self.num_global_blocks
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w + 1): i + 1] = 1
                layout[h, i, :min(g, i + 1)] = 1
                if i > 0:
                    picks = rng.choice(i + 1, size=min(self.num_random_blocks, i + 1),
                                       replace=False)
                    layout[h, i, picks] = 1
        return layout


def _global_ranges(starts, ends):
    """(start, end) block ranges from paired index lists; with no ends each
    start is a single-block range."""
    starts = tuple(starts)
    if ends is None:
        return tuple((s, s + 1) for s in starts)
    ends = tuple(ends)
    if len(starts) != len(ends):
        raise ValueError(f"global_block_indices length {len(starts)} != "
                         f"global_block_end_indices length {len(ends)}")
    for s, e in zip(starts, ends):
        if e <= s:
            raise ValueError(f"global block range ({s}, {e}) is empty")
    return tuple(zip(starts, ends))


def _apply_global(layout: np.ndarray, ranges, horizontal: bool) -> None:
    """Global columns (every row attends them, causally clamped) and, with
    ``horizontal``, global rows (a global block attends everything up to it)."""
    n = layout.shape[1]
    for s, e in ranges:
        for i in range(n):
            lo, hi = min(s, i + 1), min(e, i + 1)
            if hi > lo:
                layout[:, i, lo:hi] = 1
        if horizontal:
            for g in range(s, min(e, n)):
                layout[:, g, : g + 1] = 1


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Consecutive local windows of the given sizes (the last repeats), global
    block ranges and per-head random blocks (causal form)."""

    num_random_blocks: int = 0
    local_window_blocks: tuple = (4,)
    global_block_indices: tuple = (0,)
    global_block_end_indices: Optional[tuple] = None
    horizontal_global_attention: bool = False
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self._empty(seq_len)
        n = layout.shape[1]
        sizes = list(self.local_window_blocks)
        start = 0
        while start < n:
            w = sizes[0] if len(sizes) == 1 else sizes.pop(0)
            end = min(start + w, n)
            for i in range(start, end):
                layout[:, i, start: i + 1] = 1
            start = end
        _apply_global(layout, _global_ranges(self.global_block_indices,
                                             self.global_block_end_indices),
                      self.horizontal_global_attention)
        if self.num_random_blocks:
            rng = np.random.RandomState(self.seed)
            for h in range(self.num_heads):
                for i in range(1, n):
                    picks = rng.choice(i + 1, size=min(self.num_random_blocks, i + 1),
                                       replace=False)
                    layout[h, i, picks] = 1
        return layout


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window plus global block ranges that attend and are attended
    (causal form)."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)
    global_block_end_indices: Optional[tuple] = None

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self._empty(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks
        for i in range(n):
            layout[:, i, max(0, i - w + 1): i + 1] = 1
        _apply_global(layout, _global_ranges(self.global_block_indices,
                                             self.global_block_end_indices),
                      horizontal=True)
        return layout


SPARSITY_CONFIGS = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "local": LocalSlidingWindowSparsityConfig,
    "sliding_window": LocalSlidingWindowSparsityConfig,
    "variable": VariableSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "longformer": BSLongformerSparsityConfig,
}


def get_sparsity_config(name: str, num_heads: int, block: int = 16, **kw) -> SparsityConfig:
    if name not in SPARSITY_CONFIGS:
        raise ValueError(f"unknown sparsity config {name!r} (have {sorted(SPARSITY_CONFIGS)})")
    return SPARSITY_CONFIGS[name](num_heads=num_heads, block=block, **kw)


# ----------------------------------------------------------- compute paths
def block_sparse_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 layout: np.ndarray, block: int, causal: bool = True,
                                 alibi_slopes: Optional[torch.Tensor] = None,
                                 pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense masked path: q ``[B, S, H, D]``, k, v ``[B, S, Hkv, D]``
    (repeated to H heads here, as the JAX model's ``jnp.repeat`` does before
    its call), the full fp32 score tensor masked by the layout expanded to
    tokens, the causal mask and an optional key padding mask ``[B, S]`` (1 =
    keep), with optional ALiBi slopes ``[H]`` times the key position. Masked
    scores are -1e30; a row with no kept key gives 0. The softmax output is
    cast to v's dtype before its product, as the JAX package does."""
    B, S, H, D = q.shape
    n = S // block
    if layout.shape != (H, n, n):
        raise ValueError(f"layout {layout.shape} != {(H, n, n)}")
    if k.shape[2] != H:
        k, v = k.repeat_interleave(H // k.shape[2], 2), v.repeat_interleave(H // k.shape[2], 2)
    lay = torch.as_tensor(np.asarray(layout) != 0, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, k.float())
    if alibi_slopes is not None:
        kpos = torch.arange(S, dtype=torch.float32, device=q.device)
        scores = scores + alibi_slopes.float()[None, :, None, None] * kpos
    keep = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)[None]
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    if pad_mask is not None:
        keep = keep & (pad_mask != 0)[:, None, None, :]
    probs = torch.softmax(torch.where(keep, scores, torch.full((), -1e30, device=q.device)), -1)
    probs = torch.where(keep.any(-1, keepdim=True), probs, torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()).to(v.dtype)
    return out.to(q.dtype)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout: np.ndarray, block: int, causal: bool = True,
                           impl: str = "auto", alibi_slopes: Optional[torch.Tensor] = None,
                           pad_mask: Optional[torch.Tensor] = None,
                           lists: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Block-sparse attention of q ``[B, S, H, D]`` and k, v ``[B, S, Hkv, D]``
    (query head h reads kv head ``h // (H // Hkv)``) over ``layout``;
    differentiable in q, k and v. See the module docstring for ``impl``;
    ``lists``: the layout's ``layout_lists`` on q's device, for the kernel
    route, when the caller holds them."""
    if impl not in IMPLS:
        raise ValueError(f"block_sparse_attention impl={impl!r} (one of {IMPLS})")
    extras = alibi_slopes is not None or pad_mask is not None
    if impl == "auto":
        impl = "xla" if extras else "pallas"
    elif impl == "pallas" and extras:
        raise NotImplementedError(
            "the tile-skipping kernels do not fuse alibi/padding; use impl='auto' "
            "(routes to the dense path) or impl='xla'")
    if impl == "xla":
        return block_sparse_attention_dense(q, k, v, layout, block, causal,
                                            alibi_slopes=alibi_slopes, pad_mask=pad_mask)
    return block_sparse_attention_kernel(q, k, v, layout, block, causal, lists=lists)


__all__ = [
    "BSLongformerSparsityConfig", "BigBirdSparsityConfig", "DenseSparsityConfig",
    "FixedSparsityConfig", "LocalSlidingWindowSparsityConfig", "SPARSITY_CONFIGS",
    "SparsityConfig", "VariableSparsityConfig", "block_sparse_attention",
    "block_sparse_attention_dense", "get_sparsity_config",
]
