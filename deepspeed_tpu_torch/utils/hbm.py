"""KV-pool byte math (counterpart of ``deepspeed_tpu/utils/hbm.py``).

One definition of what a token slot of the paged pool costs, shared by the
engine's pool sizing (``kv_pool_bytes`` budgets) and its log line.
"""

from __future__ import annotations


def kv_slot_bytes(num_layers: int, kv_heads: int, head_dim: int, dtype_bytes: int = 2) -> int:
    """Bytes ONE token slot occupies in the paged KV pool (k + v)."""
    return 2 * num_layers * kv_heads * head_dim * dtype_bytes


def kv_blocks_for_bytes(pool_bytes: int, num_layers: int, block_size: int,
                        kv_heads: int, head_dim: int, dtype_bytes: int = 2) -> int:
    """How many KV blocks of ``block_size`` slots fit a byte budget."""
    per_block = block_size * kv_slot_bytes(num_layers, kv_heads, head_dim, dtype_bytes)
    return max(int(pool_bytes) // per_block, 1)
