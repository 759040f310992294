"""The hop backend behind ``algorithm="pallas_ring"`` / ``"pallas_ring2d"``
(counterpart of ``deepspeed_tpu/collectives/pallas_backend.py``; the name is
kept so a reader finds the JAX file's twin).

Instead of a plain copy of the peer's wire per leaf (the ``ppermute`` of the
other algorithms), every hop of a pallas algorithm is a hand-written kernel
of ``csrc/ring_hop.cu``, one launch per receiving rank on its own stream:

- :func:`permute_leaves` (row 12, replaces ``_permute_leaves_kernel``,
  ``pallas_backend.py:237``): one launch copies every live leaf of a wire
  (values, scales) from the sending rank's buffers into new buffers of the
  receiving rank. The receiver pulls: on two cards a peer read over NVLink,
  on one card an HBM read. Used by the encode-once gather relay and by
  reduce paths whose codec cannot fuse (exact wires, integer payloads).
- :func:`fused_hop` (row 13, replaces ``_fused_hop_kernel``, ``:321``): the
  EQuARX hop. One launch reads the upstream rank's wire slot (1-byte codes
  and fp32 scales), dequantises it, adds it into a row of the rank's fp32
  accumulator (or, for the all-to-all, writes it there) and, unless it is
  the last hop, requantises a row into the rank's own wire slot for the
  next hop. The row a rank sends at hop k is the row it accumulated at hop
  k-1 (``fused_ring_reduce_scatter_rows``), so the TPU kernel's quantise ->
  move -> dequantise-accumulate chain becomes one launch a hop.

The TPU kernels' entry barrier and sender credits become CUDA events: the
host records one on every rank's stream after its launch k and, before
launch k + 1, has each rank's stream wait on the events of the ranks whose
buffers it reads (upstream) and of those that read the slot it overwrites
(downstream). All ranks live in one process and the host enqueues hop k for
every rank before any rank's hop k + 1, so no wait can precede its event and
no kernel spin-waits on another launch. The fused hop's wire slots alternate
by hop parity; the relay's receive buffers are new tensors each hop, and a
buffer one rank's stream reads from another's is held from the allocator
until that read is done (``RankGroup.crossed``).

Each kernel has its plain PyTorch version beside it
(``permute_leaves_plain``, ``fused_hop_plain``). A wrapper runs the plain
version only for CPU tensors; for CUDA tensors it launches its kernel or
raises. Launches count in ``permute_leaves.launches`` and
``fused_hop.launches``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.collectives.codecs import Codec, Wire
from deepspeed_tpu_torch.ops import op_builder, quant

PALLAS_ALGORITHMS = ("pallas_ring", "pallas_ring2d")

# chunk target (elements) of JAX's fused hop grid; it sets the rows' zero
# padding (``_chunk_geometry``), which the kernel here keeps for parity
_CHUNK_TARGET = 16384

# wire value dtypes of the fused hop and their codes in csrc/ring_hop.cu
WIRE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_WIRE_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
_MAX_LEAVES = 8  # csrc/ring_hop.cu:kMaxLeaves


def is_pallas(algorithm) -> bool:
    return isinstance(algorithm, str) and algorithm in PALLAS_ALGORITHMS


def base_algorithm(algorithm: str) -> str:
    """The schedule a pallas algorithm runs (``pallas_ring`` -> ``ring``)."""
    return algorithm[len("pallas_"):] if is_pallas(algorithm) else algorithm


def available(group) -> bool:
    """True when the hop kernels can run for ``group``: its ranks are on CUDA."""
    return group.is_cuda


def hop_backend(algorithm: str) -> str:
    """``"xla"`` for the native reduction, ``"pallas"`` for the hop kernels,
    ``"ppermute"`` for plain-copy hops."""
    if algorithm == "lax":
        return "xla"
    return "pallas" if is_pallas(algorithm) else "ppermute"


def fusable(codec: Codec, dtype: torch.dtype) -> bool:
    """The fused hop speaks the 1-byte block wires over float payloads."""
    return codec.name in WIRE_DTYPES and dtype.is_floating_point


def neighbors(n: int, perm: Sequence[Tuple[int, int]]) -> Tuple[List[int], List[int]]:
    """(dst, src) of every rank under ``perm``, a full permutation of ``n``
    ranks (the rank-list form of ``_neighbor_logicals``)."""
    dst, src = [-1] * n, [-1] * n
    for s, d in perm:
        dst[s], src[d] = d, s
    if min(dst) < 0 or min(src) < 0:
        raise ValueError(f"perm is not a full permutation of {n} ranks: {perm}")
    return dst, src


# ---------------------------------------------------------------- row 12
def permute_leaves_plain(leaves: Sequence[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
    """Copies of ``leaves`` on ``device``."""
    return [leaf.to(device, copy=True) for leaf in leaves]


def permute_leaves(leaves: Sequence[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
    """Copies of every leaf on ``device``, in one launch of
    ``ds_permute_leaves`` on the current stream (the receiver's)."""
    leaves = list(leaves)
    if not leaves:
        return []
    if all(leaf.device.type == "cpu" for leaf in leaves) and device.type == "cpu":
        return permute_leaves_plain(leaves, device)
    if device.type != "cuda" or any(leaf.device.type != "cuda" for leaf in leaves):
        raise ValueError(f"permute_leaves: CUDA leaves and device expected, got "
                         f"{[str(leaf.device) for leaf in leaves]} -> {device}")
    if len(leaves) > _MAX_LEAVES:
        raise ValueError(f"permute_leaves: at most {_MAX_LEAVES} leaves a launch, got {len(leaves)}")
    if any(not leaf.is_contiguous() for leaf in leaves):
        raise ValueError("permute_leaves: leaves must be contiguous")
    outs = [torch.empty(leaf.shape, dtype=leaf.dtype, device=device) for leaf in leaves]
    k = len(leaves)
    srcs = (ctypes.c_void_p * k)(*[leaf.data_ptr() for leaf in leaves])
    dsts = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    nbytes = (ctypes.c_int64 * k)(*[leaf.numel() * leaf.element_size() for leaf in leaves])
    op_builder.launch("ring_hop", "ds_permute_leaves", ctypes.addressof(srcs),
                      ctypes.addressof(dsts), ctypes.addressof(nbytes), k,
                      torch.cuda.current_stream(device).cuda_stream)
    permute_leaves.launches += 1
    return outs


permute_leaves.launches = 0


def permute_wire(wires: Sequence[Wire], group, perm, *, pallas: bool = False) -> List[Wire]:
    """Every rank's wire moved one hop along ``perm``: rank d receives the
    wire of the rank that sends to it, on its own stream after the sender's
    event. Zero-size leaves (passthrough scales) pass through; with
    ``pallas`` the live ones move in one ``permute_leaves`` launch a rank,
    else as plain copies (the ``ppermute`` of the other algorithms)."""
    hop = permute_leaves if pallas else permute_leaves_plain
    events = [group.record(r) for r in range(group.n)]
    _, src = neighbors(group.n, perm)
    out = []
    for d in range(group.n):
        wire = wires[src[d]]
        live = [leaf for leaf in wire if leaf.numel() > 0]
        with group.on(d):
            group.wait(d, events[src[d]])
            group.crossed(live, d)
            moved = iter(hop(live, group.devices[d]))
        out.append(Wire(*(next(moved) if leaf.numel() > 0 else leaf for leaf in wire)))
    return out


# ---------------------------------------------------------------- row 13
def _wire_kind(dtype: torch.dtype) -> str:
    for name, wd in WIRE_DTYPES.items():
        if wd == dtype:
            return name
    raise TypeError(f"fused_hop: wire dtype {dtype} is not int8 or float8_e4m3fn")


def fused_hop_plain(up_q: Optional[torch.Tensor], up_s: Optional[torch.Tensor],
                    tgt: Optional[torch.Tensor], enc_src: Optional[torch.Tensor],
                    own_q: Optional[torch.Tensor], own_s: Optional[torch.Tensor], *,
                    qb: int, accumulate: bool = True) -> None:
    """The plain version of one fused hop, in place: with ``up_q``, ``tgt
    (+)= dequant(up_q, up_s)`` in fp32; then, with ``own_q``, ``(own_q,
    own_s) = quant(enc_src)`` (``enc_src`` may be ``tgt``, read after the
    add). Blocks of ``qb`` elements from element 0 of the flat rows."""
    if up_q is not None:
        dequant = (quant.int8_block_dequant if _wire_kind(up_q.dtype) == "int8"
                   else quant.fp8_block_dequant)
        deq = dequant(up_q.reshape(-1, qb), up_s.reshape(-1, 1)).reshape(tgt.shape)
        tgt.copy_(tgt + deq if accumulate else deq)
    if own_q is not None:
        encode = (quant.int8_block_math if _wire_kind(own_q.dtype) == "int8"
                  else quant.fp8_block_math)
        q, s = encode(enc_src.reshape(-1, qb))
        own_q.copy_(q.reshape(own_q.shape))
        own_s.copy_(s.reshape(own_s.shape))


def fused_hop(up_q: Optional[torch.Tensor], up_s: Optional[torch.Tensor],
              tgt: Optional[torch.Tensor], enc_src: Optional[torch.Tensor],
              own_q: Optional[torch.Tensor], own_s: Optional[torch.Tensor], *,
              qb: int, accumulate: bool = True) -> None:
    """One fused hop (see :func:`fused_hop_plain`) in one launch of
    ``ds_fused_hop`` on the current stream. ``up_q`` / ``up_s`` may lie on
    another card of the group (a peer read)."""
    given = [t for t in (up_q, up_s, tgt, enc_src, own_q, own_s) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        return fused_hop_plain(up_q, up_s, tgt, enc_src, own_q, own_s, qb=qb,
                               accumulate=accumulate)
    if any(t.device.type != "cuda" for t in given):
        raise ValueError(f"fused_hop: all CUDA or all CPU tensors expected, got "
                         f"{[str(t.device) for t in given]}")
    if (up_q is None) != (tgt is None) or (own_q is None) != (enc_src is None):
        raise ValueError("fused_hop: up_q needs tgt and own_q needs enc_src")
    rows = [t for t in (tgt, enc_src) if t is not None]
    if not rows:
        raise ValueError("fused_hop: nothing to do")
    n = rows[0].numel()
    if qb <= 0 or n % qb or qb >= 2 ** 31:
        raise ValueError(f"fused_hop: row of {n} is not a whole number of blocks of {qb}")
    for t in rows:
        if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError("fused_hop: tgt and enc_src must be contiguous fp32 rows of one length")
    code = None
    for q, s in ((up_q, up_s), (own_q, own_s)):
        if q is None:
            continue
        c = _WIRE_CODES.get(q.dtype)
        if c is None or (code is not None and c != code):
            raise TypeError(f"fused_hop: wire values must be int8 or float8_e4m3fn, one kind, "
                            f"got {q.dtype}")
        code = c
        if (q.numel() != n or s.dtype != torch.float32 or s.numel() != n // qb
                or not (q.is_contiguous() and s.is_contiguous())):
            raise ValueError("fused_hop: a wire slot is values [n] and fp32 scales [n / qb]")
    dev = rows[0].device
    ptr = lambda t: None if t is None else t.data_ptr()
    op_builder.launch("ring_hop", "ds_fused_hop", ptr(up_q), ptr(up_s), ptr(tgt),
                      int(accumulate), ptr(enc_src), ptr(own_q), ptr(own_s), n, qb, code,
                      torch.cuda.current_stream(dev).cuda_stream)
    fused_hop.launches += 1


fused_hop.launches = 0


def _chunk_geometry(L: int, block_size: int) -> Tuple[int, int, int]:
    """(C, B, qb): JAX's kernel chunks of B elements, each a whole number of
    quantisation blocks of qb, covering L once padded to C * B."""
    qb = max(min(int(block_size), L), 1)
    per_chunk = max(_CHUNK_TARGET // qb, 1)
    B = qb * min(per_chunk, -(-L // qb))
    C = -(-L // B)
    return C, B, qb


def _padded_acc(group, rows, Lp):
    """Every rank's rows as a new fp32 ``[n, Lp]`` accumulator (zero padding)."""
    acc = []
    for r in range(group.n):
        with group.on(r):
            a = torch.zeros(rows[r].shape[0], Lp, dtype=torch.float32, device=group.devices[r])
            a[:, :rows[r].shape[1]] = rows[r]
            acc.append(a)
    return acc


def _slots(group, codec: Codec, Lp: int, qb: int):
    """Every rank's two wire slots: values ``[2, Lp]``, scales ``[2, Lp / qb]``."""
    qs, ss = [], []
    for r in range(group.n):
        with group.on(r):
            qs.append(torch.empty(2, Lp, dtype=WIRE_DTYPES[codec.name], device=group.devices[r]))
            ss.append(torch.empty(2, Lp // qb, dtype=torch.float32, device=group.devices[r]))
    return qs, ss


def fused_ring_reduce_scatter_rows(rows: Sequence[torch.Tensor], group, codec: Codec, *,
                                   reverse: bool = False, sub: Optional[tuple] = None
                                   ) -> List[torch.Tensor]:
    """Ring reduce-scatter of every rank's ``[n, L]`` chunk rows, each hop
    one ``fused_hop`` launch a rank: the schedule of
    ``algorithms._ring_reduce_scatter_rows`` (with ring2d's ``sub`` form).
    Returns each rank's fully reduced chunk ``[L]`` in fp32.

    Launch 0 encodes ``acc[send_idx(0)]`` into slot 0. Launch m >= 1 waits
    on the upstream and downstream ranks' events m - 1, adds the upstream's
    slot (m - 1) % 2 into ``acc[recv_idx(m - 1)]`` and, before the last
    hop, requantises that sum into its own slot m % 2."""
    from deepspeed_tpu_torch.collectives.algorithms import _ring_perm

    if sub is not None:
        n, pos, perm, _label = sub
        step = 1
    else:
        n = group.n
        pos = list(range(n))
        step = -1 if reverse else 1
        perm = _ring_perm(n, reverse)
    L = rows[0].shape[1]
    if n == 1:
        return [r[0].float() for r in rows]
    _C, _B, qb = _chunk_geometry(L, codec.block_size)
    Lp = _C * _B
    acc = _padded_acc(group, rows, Lp)
    slot_q, slot_s = _slots(group, codec, Lp, qb)
    down, up = neighbors(group.n, perm)
    for r in range(group.n):
        with group.on(r):
            send_idx = (pos[r] - step) % n
            fused_hop(None, None, None, acc[r][send_idx], slot_q[r][0], slot_s[r][0], qb=qb)
    events = [group.record(r) for r in range(group.n)]
    for m in range(1, n):
        last = m == n - 1
        for r in range(group.n):
            u = up[r]
            with group.on(r):
                group.wait(r, events[u])
                group.wait(r, events[down[r]])
                group.crossed((slot_q[u], slot_s[u]), r)
                recv = acc[r][(pos[r] - step * (1 + m)) % n]
                fused_hop(slot_q[u][(m - 1) % 2], slot_s[u][(m - 1) % 2], recv,
                          None if last else recv,
                          None if last else slot_q[r][m % 2],
                          None if last else slot_s[r][m % 2], qb=qb)
        events = [group.record(r) for r in range(group.n)]
    return [acc[r][pos[r], :L] for r in range(group.n)]


def fused_ring_all_to_all_rows(rows: Sequence[torch.Tensor], group, codec: Codec, *,
                               perm_k) -> List[torch.Tensor]:
    """All-to-all of every rank's ``[n, L]`` destination rows with each phase
    one ``fused_hop`` launch a rank (``accumulate=False``): the shift
    schedule of ``algorithms._ring_all_to_all_rows``, phase k moving the row
    destined k ranks ahead by the distance-k permutation ``perm_k(k)``. Each
    row is quantised once; the own row never leaves its rank and stays raw.
    Returns ``[n, L]`` rows ordered by source rank, in the payload dtype.

    Phase p's wire sits in slot p % 2. Launch 0 encodes phase 1's row; launch
    k >= 1 waits on event k - 1 of the rank sending to it at phase k and of
    the rank that read the slot it now overwrites (its phase k - 1
    receiver), writes the dequantised row and encodes phase k + 1's row."""
    n = group.n
    L = rows[0].shape[1]
    if n == 1:
        return list(rows)
    _C, _B, qb = _chunk_geometry(L, codec.block_size)
    Lp = _C * _B
    acc = _padded_acc(group, rows, Lp)
    out = []
    for r in range(n):
        with group.on(r):
            o = torch.empty(n, Lp, dtype=torch.float32, device=group.devices[r])
            o[r] = acc[r][r]  # own row: raw, no wire crossed
            out.append(o)
    slot_q, slot_s = _slots(group, codec, Lp, qb)
    for r in range(n):
        with group.on(r):
            fused_hop(None, None, None, acc[r][(r + 1) % n], slot_q[r][1], slot_s[r][1], qb=qb)
    events = [group.record(r) for r in range(n)]
    for k in range(1, n):
        _, src = neighbors(n, perm_k(k))
        prev_dst = neighbors(n, perm_k(k - 1))[0] if k > 1 else None
        last = k == n - 1
        for r in range(n):
            u = src[r]
            with group.on(r):
                group.wait(r, events[u])
                if prev_dst is not None:
                    group.wait(r, events[prev_dst[r]])
                group.crossed((slot_q[u], slot_s[u]), r)
                nxt = (k + 1) % 2
                fused_hop(slot_q[u][k % 2], slot_s[u][k % 2], out[r][(r - k) % n],
                          None if last else acc[r][(r + k + 1) % n],
                          None if last else slot_q[r][nxt],
                          None if last else slot_s[r][nxt], qb=qb, accumulate=False)
        events = [group.record(r) for r in range(n)]
    res = []
    for r in range(n):
        with group.on(r):
            res.append(out[r][:, :L].to(rows[r].dtype))
    return res
