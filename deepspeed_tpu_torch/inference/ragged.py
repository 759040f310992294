"""Ragged-batch state management for continuous batching (counterpart of
``deepspeed_tpu/inference/ragged.py``).

Host-side bookkeeping in numpy, copied from the JAX package with its
bucketing unchanged: ``BlockedAllocator`` (a free stack plus a free bitmap and
per-block reference counts), ``SequenceDescriptor`` (a preallocated block-table
row per sequence), ``StateManager`` (uid -> sequence, admission checks),
``RaggedBatch`` and ``BatchStaging`` (reused per-(rows, chunk) staging
buffers), and ``build_ragged_batch``. The device sees only the dense arrays a
``RaggedBatch`` assembles: padded token/position matrices plus per-sequence
block tables into the paged KV pool; pad rows write to the pool's trash slot
(see ``paged.py``). The prefix cache is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BlockedAllocator:
    """O(1)-per-block free-list allocator for KV-cache blocks (reference
    ``BlockedAllocator`` inference/v2/ragged/blocked_allocator.py:11).

    A list free stack plus a ``bytearray`` free bitmap: C-level slice
    pops/extends move whole batches, the bitmap gives ~40ns double-free
    detection per block, and no numpy call overhead rides the small-alloc
    path (a decode step allocates a handful of blocks; numpy's per-call
    fixed cost would dominate it). ``allocate`` returns an int32 ndarray so
    downstream block-table writes stay vectorized. ``free`` validates the
    whole batch before mutating — a bad call leaves the allocator unchanged.

    Ref-counted sharing: every allocated block
    carries a reference count (``allocate`` sets it to 1). ``share`` adds a
    holder, ``release`` drops one and returns the block to the free stack at
    zero. ``free`` keeps the strict single-owner contract: freeing a block
    another holder still references raises. All four ops validate the whole
    batch before mutating and roll back on error — a bad call leaves the
    bitmap, the refcounts, and the stack unchanged (invariant:
    ``_refs[b] == 0  <=>  _state[b] == 1`` i.e. free).
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free_stack: List[int] = list(range(num_blocks - 1, -1, -1))
        self._state = bytearray(b"\x01" * num_blocks)  # 1 = free
        self._refs: List[int] = [0] * num_blocks  # holders per block

    @property
    def free_blocks(self) -> int:
        return len(self._free_stack)

    def refcount(self, block: int) -> int:
        """Holders of ``block`` (0 = free)."""
        return self._refs[block]

    def allocate(self, n: int) -> np.ndarray:
        stack = self._free_stack
        if n > len(stack):
            raise RuntimeError(f"cannot allocate {n} blocks ({len(stack)} free)")
        if n == 0:
            return np.empty((0,), np.int32)
        out = stack[-n:]
        del stack[-n:]
        state = self._state
        refs = self._refs
        for b in out:
            state[b] = 0
            refs[b] = 1
        return np.asarray(out, dtype=np.int32)

    def free(self, blocks: Sequence[int]) -> None:
        """Strict single-owner free: every block must have exactly one holder.
        Freeing a shared block (refcount > 1) raises — use ``release`` for
        refcounted holders."""
        lst = blocks.tolist() if isinstance(blocks, np.ndarray) else list(blocks)
        if not lst:
            return
        state = self._state
        refs = self._refs
        num = self.num_blocks
        i = 0
        try:
            for i, b in enumerate(lst):
                if b < 0 or b >= num or state[b]:  # bitmap catches in-call dupes too
                    raise ValueError(f"bad free of block {b}")
                if refs[b] != 1:
                    raise ValueError(
                        f"free of shared block {b} (refcount {refs[b]}); "
                        "holders must release, not free")
                state[b] = 1
                refs[b] = 0
        except ValueError:
            for b in lst[:i]:  # roll back: a bad call leaves state unchanged
                state[b] = 0
                refs[b] = 1
            raise
        self._free_stack.extend(lst)

    def share(self, blocks: Sequence[int]) -> None:
        """Add one holder to each allocated block (batch-validated: a bad id
        or a free block anywhere in the call leaves every refcount
        unchanged)."""
        lst = blocks.tolist() if isinstance(blocks, np.ndarray) else list(blocks)
        if not lst:
            return
        refs = self._refs
        num = self.num_blocks
        i = 0
        try:
            for i, b in enumerate(lst):
                if b < 0 or b >= num or refs[b] < 1:
                    raise ValueError(f"share of unallocated block {b}")
                refs[b] += 1
        except ValueError:
            for b in lst[:i]:
                refs[b] -= 1
            raise
        return None

    def release(self, blocks: Sequence[int]) -> int:
        """Drop one holder from each block; blocks reaching zero holders
        return to the free stack. Releasing a free block (double release)
        raises, with full rollback. Returns how many blocks became free."""
        lst = blocks.tolist() if isinstance(blocks, np.ndarray) else list(blocks)
        if not lst:
            return 0
        state = self._state
        refs = self._refs
        num = self.num_blocks
        freed: List[int] = []
        i = 0
        try:
            for i, b in enumerate(lst):
                if b < 0 or b >= num or refs[b] < 1:
                    raise ValueError(f"double release of block {b}")
                refs[b] -= 1
                if refs[b] == 0:
                    state[b] = 1
                    freed.append(b)
        except ValueError:
            for b in lst[:i]:  # roll back refcounts AND the bitmap
                if refs[b] == 0:
                    state[b] = 0
                refs[b] += 1
            raise
        self._free_stack.extend(freed)
        return len(freed)


@dataclasses.dataclass
class SequenceDescriptor:
    """Per-sequence tracking (reference ``DSSequenceDescriptor``).

    The block table is a preallocated int32 row (``_table[:n_blocks]``) so
    batch assembly copies it with one vectorized write.
    """

    uid: int
    seen_tokens: int = 0
    n_blocks: int = 0
    _table: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((8,), np.int32))

    @property
    def blocks(self) -> np.ndarray:
        """Live block ids (view — do not mutate)."""
        return self._table[: self.n_blocks]

    def append_blocks(self, new: np.ndarray) -> None:
        need = self.n_blocks + len(new)
        if need > len(self._table):
            cap = max(need, 2 * len(self._table))
            table = np.zeros((cap,), np.int32)
            table[: self.n_blocks] = self._table[: self.n_blocks]
            self._table = table
        self._table[self.n_blocks: need] = new
        self.n_blocks = need

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        total = self.seen_tokens + new_tokens
        need = -(-total // block_size)  # ceil
        return max(0, need - self.n_blocks)


class StateManager:
    """uid -> sequence state + block accounting (reference ``DSStateManager``
    inference/v2/ragged/ragged_manager.py:19)."""

    def __init__(self, num_blocks: int, block_size: int, max_seqs: int = 256,
                 max_blocks_per_seq: Optional[int] = None):
        self.allocator = BlockedAllocator(num_blocks)
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq
        self._seqs: Dict[int, SequenceDescriptor] = {}

    @property
    def n_active(self) -> int:
        return len(self._seqs)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def utilization(self) -> float:
        """Fraction of the KV pool's blocks currently allocated (the
        ``serving/kv_pool_utilization`` gauge)."""
        total = self.allocator.num_blocks
        return (total - self.allocator.free_blocks) / total

    def get(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid not in self._seqs:
            if len(self._seqs) >= self.max_seqs:
                raise RuntimeError(f"max_seqs={self.max_seqs} active sequences reached")
            cap = self.max_blocks_per_seq or 8
            self._seqs[uid] = SequenceDescriptor(uid, _table=np.zeros((cap,), np.int32))
        return self._seqs[uid]

    def can_schedule(self, uids: Sequence[int], token_counts: Sequence[int]) -> bool:
        """Admission check (reference ``InferenceEngineV2.can_schedule`` :184)."""
        need = 0
        fresh = 0
        for uid, n in zip(uids, token_counts):
            seq = self._seqs.get(uid)
            if seq is None:
                fresh += 1
                total_blocks = -(-n // self.block_size)
                need += total_blocks
            else:
                total_blocks = seq.n_blocks + seq.blocks_needed(n, self.block_size)
                need += seq.blocks_needed(n, self.block_size)
            if self.max_blocks_per_seq is not None and total_blocks > self.max_blocks_per_seq:
                return False  # sequence would exceed engine max_seq_len
        if len(self._seqs) + fresh > self.max_seqs:
            return False
        return need <= self.allocator.free_blocks

    def extend(self, uid: int, new_tokens: int) -> SequenceDescriptor:
        """Ensure blocks exist for ``new_tokens`` more tokens of ``uid``."""
        seq = self.get_or_create(uid)
        need = seq.blocks_needed(new_tokens, self.block_size)
        if need:
            seq.append_blocks(self.allocator.allocate(need))
        return seq

    def flush(self, uid: int) -> None:
        """Release a finished sequence (reference ``flush_uid`` engine_v2.py).
        Refcount-aware: blocks the prefix cache still holds stay allocated
        (the sequence drops its reference); exclusively-owned blocks return
        to the free stack — identical to ``free`` when nothing is shared."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.n_blocks:
            self.allocator.release(seq.blocks)


@dataclasses.dataclass
class RaggedBatch:
    """Dense view of one scheduling step (reference ``RaggedBatchWrapper``).

    Rows are sequences; pad rows have ``new_lens == 0``. ``tokens`` is
    right-padded to the chunk bucket; ``block_tables`` is padded with 0 (pad
    slots never read: masked by position; never written: writes route to the
    trash slot).

    When assembled through a ``BatchStaging``, the arrays are views into that
    staging pool and are overwritten by the next assembly of the same
    (rows, chunk) bucket — copy to the device before rebuilding.
    """

    uids: List[int]
    tokens: np.ndarray  # [N, C] int32
    positions: np.ndarray  # [N, C] int32 (global position of each new token)
    new_lens: np.ndarray  # [N] int32
    block_tables: np.ndarray  # [N, P] int32
    seen: np.ndarray  # [N] int32 (tokens already in cache, before this step)

    @property
    def n_rows(self) -> int:
        return self.tokens.shape[0]


class BatchStaging:
    """Reusable per-(rows, chunk)-bucket staging buffers for batch assembly.

    One set of host arrays per bucket, zeroed and refilled in place each step
    — the device copy (``torch.from_numpy(...).to(device)`` at dispatch) is the only per-step
    allocation left. ``allocations``/``reuses`` are exposed so tests and the
    serving benchmark can assert steady-state reuse.
    """

    def __init__(self, max_pages: int):
        self.max_pages = max_pages
        self._bufs: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self._dirty_rows: Dict[Tuple[int, int], int] = {}
        self.allocations = 0
        self.reuses = 0

    def acquire(self, rows: int, chunk: int) -> Dict[str, np.ndarray]:
        key = (rows, chunk)
        b = self._bufs.get(key)
        if b is None:
            b = {
                "tokens": np.zeros((rows, chunk), np.int32),
                "positions": np.zeros((rows, chunk), np.int32),
                "new_lens": np.zeros((rows,), np.int32),
                "block_tables": np.zeros((rows, self.max_pages), np.int32),
                "seen": np.zeros((rows,), np.int32),
            }
            self._bufs[key] = b
            self.allocations += 1
        else:
            self.reuses += 1
            d = self._dirty_rows.get(key, rows)
            if d:  # zero only the rows the previous step touched
                b["tokens"][:d] = 0
                b["positions"][:d] = 0
                b["new_lens"][:d] = 0
                b["block_tables"][:d] = 0
                b["seen"][:d] = 0
        return b

    def mark_dirty(self, rows: int, chunk: int, used_rows: int) -> None:
        self._dirty_rows[(rows, chunk)] = used_rows


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def build_ragged_batch(
    manager: StateManager,
    uids: Sequence[int],
    token_lists: Sequence[np.ndarray],
    max_pages: int,
    row_bucket: int = 8,
    chunk_bucket: int = 8,
    staging: Optional[BatchStaging] = None,
) -> RaggedBatch:
    """Allocate blocks and assemble the dense step arrays.

    Caller must have checked ``can_schedule`` and pass distinct uids; this
    raises if blocks run out. With ``staging``, the returned arrays are the
    staging pool's buffers (zero allocation in steady state); without, fresh
    arrays are allocated.
    """
    n = len(uids)
    assert n == len(token_lists) and n > 0
    lens = np.fromiter((len(t) for t in token_lists), dtype=np.int64, count=n)
    chunk = _round_up(max(int(lens.max()), 1), chunk_bucket)
    rows = _round_up(n, row_bucket)

    if staging is not None:
        buf = staging.acquire(rows, chunk)
        if staging.max_pages != max_pages:
            raise ValueError(
                f"staging max_pages={staging.max_pages} != requested {max_pages}")
        tokens, positions = buf["tokens"], buf["positions"]
        new_lens, block_tables, seen = buf["new_lens"], buf["block_tables"], buf["seen"]
        staging.mark_dirty(rows, chunk, n)
    else:
        tokens = np.zeros((rows, chunk), np.int32)
        positions = np.zeros((rows, chunk), np.int32)
        new_lens = np.zeros((rows,), np.int32)
        block_tables = np.zeros((rows, max_pages), np.int32)
        seen = np.zeros((rows,), np.int32)

    # --- block allocation: one vectorized allocator call for the whole step
    seqs = [manager.get_or_create(uid) for uid in uids]
    seen_v = np.fromiter((s.seen_tokens for s in seqs), dtype=np.int32, count=n)
    have_v = np.fromiter((s.n_blocks for s in seqs), dtype=np.int64, count=n)
    bs = manager.block_size
    need_v = np.maximum(-(-(seen_v.astype(np.int64) + lens) // bs) - have_v, 0)
    over = (have_v + need_v) > max_pages
    if over.any():
        i = int(np.argmax(over))
        raise RuntimeError(
            f"uid {uids[i]}: {int(have_v[i] + need_v[i])} blocks exceeds "
            f"max_pages={max_pages} (sequence longer than engine max_seq_len)"
        )
    fresh = manager.allocator.allocate(int(need_v.sum()))
    ends = np.cumsum(need_v)
    for i, s in enumerate(seqs):
        if need_v[i]:
            s.append_blocks(fresh[ends[i] - need_v[i]: ends[i]])

    # --- vectorized fills (no per-token Python loops)
    new_lens[:n] = lens
    seen[:n] = seen_v
    if int(lens.max()) == 1:
        # decode fast path: one token per row, position == seen (a
        # zero-length row stays a pad: new_lens==0 masks it device-side)
        positions[:n, 0] = seen_v
        tokens[:n, 0] = np.fromiter(
            (t[0] if len(t) else 0 for t in token_lists), dtype=np.int64, count=n)
    else:
        col = np.arange(chunk)
        valid = col[None, :] < lens[:, None]  # [n, chunk]
        positions[:n] = np.where(valid, seen_v[:, None] + col[None, :], 0)
        # row-major boolean scatter == concatenation order of the ragged lists
        tokens[:n][valid] = np.concatenate(
            [np.asarray(t, np.int32) for t in token_lists])
    for i, s in enumerate(seqs):
        block_tables[i, : s.n_blocks] = s._table[: s.n_blocks]

    return RaggedBatch(
        uids=list(uids), tokens=tokens, positions=positions,
        new_lens=new_lens, block_tables=block_tables, seen=seen,
    )
