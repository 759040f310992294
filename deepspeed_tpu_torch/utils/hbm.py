"""KV-pool byte math (counterpart of ``deepspeed_tpu/utils/hbm.py:38-70``).

One definition of what a token slot of the paged pool costs, shared by the
engine's pool sizing (``kv_pool_bytes`` budgets) and its log line. A
quantised pool (``kv_quant`` 'int8' | 'fp8') holds one byte per element plus
one fp32 scale per (layer, slot, kv head) head vector: ``hd + 4`` bytes per
head vector, the layout ``inference/paged.py`` writes.
"""

from __future__ import annotations

from typing import Optional

KV_SCALE_BYTES = 4  # fp32 scale per (slot, head) quantisation block


def kv_slot_bytes(num_layers: int, kv_heads: int, head_dim: int, dtype_bytes: int = 2,
                  kv_quant: Optional[str] = None) -> int:
    """Bytes ONE token slot occupies in the paged KV pool (k + v)."""
    per_head = head_dim * dtype_bytes if kv_quant is None else head_dim + KV_SCALE_BYTES
    return 2 * num_layers * kv_heads * per_head


def kv_pool_bytes(num_layers: int, num_slots: int, kv_heads: int, head_dim: int,
                  dtype_bytes: int = 2, kv_quant: Optional[str] = None) -> int:
    """Bytes of a paged pool holding ``num_slots`` token slots (pass
    ``num_blocks * block_size + 1`` to include the trash slot)."""
    return num_slots * kv_slot_bytes(num_layers, kv_heads, head_dim, dtype_bytes, kv_quant)


def kv_blocks_for_bytes(pool_bytes: int, num_layers: int, block_size: int,
                        kv_heads: int, head_dim: int, dtype_bytes: int = 2,
                        kv_quant: Optional[str] = None) -> int:
    """How many KV blocks of ``block_size`` slots fit a byte budget: at one
    budget an int8 pool holds ~1.9x the blocks of a bf16 pool (head_dim 128:
    256 / 132)."""
    per_block = block_size * kv_slot_bytes(num_layers, kv_heads, head_dim, dtype_bytes, kv_quant)
    return max(int(pool_bytes) // per_block, 1)
