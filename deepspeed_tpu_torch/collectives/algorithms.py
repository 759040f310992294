"""Hop-composed collective algorithms over a rank group (counterpart of
``deepspeed_tpu/collectives/algorithms.py``).

Every function takes a sharded value as a rank list (rank r's tensor on
rank r's device, see ``comm/group.py``) and returns one. The schedules are
JAX's, hop for hop:

- ``ring``    n-1 hop ring;
- ``bidir``   the payload halved onto two counter-rotating rings;
- ``rhd``     recursive halving/doubling, log2(n) hops, power-of-two n;
- ``ring2d``  the axis factored a x b (rank = u*b + v, a <= b nearest the
  square root): intra-group reduce-scatter, inter-group all-reduce of the
  shard, intra-group all-gather;
- ``pallas_ring`` / ``pallas_ring2d`` the ring / ring2d schedules with every
  hop a kernel of ``pallas_backend`` (row 12 copies a wire, row 13 fuses
  the int8/fp8 reduce and all-to-all hops).

Codecs apply per hop: gathers encode once at the source and relay the wire,
reduce paths decode-accumulate-re-encode each hop (``err=`` turns on LoCo
error feedback for ``ring``). Float payloads accumulate in fp32 through the
whole chain and round once at the reduce-scatter -> all-gather boundary;
integer payloads accumulate in their own dtype. After an all-reduce every
rank holds the same bytes: a sender's own row comes from its decoded wire.
The dispatch passes ``pallas=True`` down the schedule for the pallas
algorithms; a hop with ``pallas=False`` is a plain copy of the peer's wire,
as ``ppermute`` is. ``algorithm="compiled"`` (``schedule.py``) and axis tuples
are not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.collectives import pallas_backend
from deepspeed_tpu_torch.collectives.codecs import Codec, Wire, get_codec
from deepspeed_tpu_torch.collectives.pallas_backend import PALLAS_ALGORITHMS

ALGORITHMS = ("ring", "bidir", "rhd", "ring2d")


def _each(group, fn) -> list:
    """``fn(r)`` for every rank, each on its own stream. Every op on a rank's
    tensors runs through here: an op on the caller's stream inside a
    collective (a copying ``reshape``, a pad) is not ordered before the rank
    streams that read its result."""
    out = []
    for r in range(group.n):
        with group.on(r):
            out.append(fn(r))
    return out


def _ring_perm(n: int, reverse: bool = False):
    if reverse:
        return [(s, (s - 1) % n) for s in range(n)]
    return [(s, (s + 1) % n) for s in range(n)]


def _check_axis(axis, what: str):
    if isinstance(axis, (tuple, list)):
        raise NotImplementedError(
            f"algorithmic {what} over the axis tuple {tuple(axis)}: multi-axis groups "
            "(_hier_all_reduce_axes, the compiled schedules) are not ported")
    return axis


def _no_compiled(algorithm: str):
    if algorithm == "compiled" or algorithm.startswith("compiled:"):
        raise NotImplementedError(
            f"algorithm {algorithm!r}: the synthesised schedules (collectives/schedule.py) "
            "are not ported")


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


# ---------------------------------------------------------------- all-gather
def _ring_all_gather_flat(xs, group, codec: Codec, *, reverse: bool = False,
                          sub: Optional[tuple] = None, pallas: bool = False):
    """Ring all-gather of every rank's flat block: ``[L] -> [n, L]`` ordered
    by source. Encode once at the source, relay the wire n-1 hops, decode
    on arrival. ``sub = (n, positions, perm, label)`` runs the schedule on
    sub-rings of the axis (ring2d's groups): ``positions[r]`` is rank r's
    place in its sub-ring and ``perm`` connects each sub-ring's members."""
    if sub is not None:
        n, pos, perm, _label = sub
        step = 1
    else:
        n, pos = group.n, list(range(group.n))
        step = -1 if reverse else 1
        perm = _ring_perm(n, reverse)
    L = xs[0].shape[0]
    if n == 1:
        return [x[None] for x in xs]
    wires = _each(group, lambda r: codec.encode_rows(xs[r][None]))

    def first(r):
        out = torch.empty((n, L), dtype=xs[r].dtype, device=xs[r].device)
        # the sender's own row from its DECODED wire: every rank sees the
        # same bytes for every block, or replicas drift apart
        out[pos[r]] = codec.decode_rows(wires[r], L, xs[r].dtype)[0]
        return out

    outs = _each(group, first)
    for k in range(1, n):
        wires = pallas_backend.permute_wire(wires, group, perm, pallas=pallas)
        for r in range(group.n):
            with group.on(r):
                outs[r][(pos[r] - step * k) % n] = codec.decode_rows(wires[r], L, xs[r].dtype)[0]
    return outs


def _moved_flat(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.movedim(x, dim, 0).reshape(-1)


def ring_all_gather(xs, group, codec: Codec, *, concat_axis: int = 0, bidir: bool = False,
                    pallas: bool = False):
    """All-gather along ``concat_axis`` (tiled ``lax.all_gather`` semantics)."""
    n = group.n
    moved = torch.movedim(xs[0], concat_axis, 0)
    lead, rest = moved.shape[0], tuple(moved.shape[1:])
    flat = _each(group, lambda r: _moved_flat(xs[r], concat_axis))
    if bidir and flat[0].shape[0] >= 2:
        h = flat[0].shape[0] // 2
        ga = _ring_all_gather_flat([f[:h] for f in flat], group, codec)
        gb = _ring_all_gather_flat([f[h:] for f in flat], group, codec, reverse=True)
        gathered = _each(group, lambda r: torch.cat([ga[r], gb[r]], dim=1))
    else:
        gathered = _ring_all_gather_flat(flat, group, codec, pallas=pallas)
    return _each(group, lambda r: torch.movedim(
        gathered[r].reshape((n * lead,) + rest), 0, concat_axis))


def rhd_all_gather(xs, group, codec: Codec, *, concat_axis: int = 0):
    """Recursive-doubling all-gather: log2(n) hops, the payload doubling a
    hop, kept in wire form so lossy codecs quantise once at the source."""
    n = group.n
    if n & (n - 1):
        raise ValueError(f"rhd needs a power-of-two axis size, got {n}")
    moved = torch.movedim(xs[0], concat_axis, 0)
    lead, rest = moved.shape[0], tuple(moved.shape[1:])
    L = moved.numel()
    wires = _each(group, lambda r: codec.encode_rows(_moved_flat(xs[r], concat_axis)[None]))
    d = 1
    while d < n:
        recv = pallas_backend.permute_wire(wires, group, [(s, s ^ d) for s in range(n)])

        def join(r):
            upper = (r & d) != 0
            return Wire(*(torch.cat([rc, own] if upper else [own, rc], dim=0)
                          for own, rc in zip(wires[r], recv[r])))

        wires = _each(group, join)
        d *= 2
    return _each(group, lambda r: torch.movedim(
        codec.decode_rows(wires[r], L, xs[r].dtype).reshape((n * lead,) + rest), 0, concat_axis))


# ------------------------------------------------------------ reduce-scatter
def _chunk_rows(group, flats, n: int):
    """Every rank's flat payload zero-padded to ``n`` chunks: (``[n, chunk]``
    rows, the payload length, chunk)."""
    N = flats[0].shape[0]
    chunk = -(-N // n)
    pad = lambda f: f if chunk * n == N else torch.nn.functional.pad(f, (0, chunk * n - N))
    return _each(group, lambda r: pad(flats[r]).reshape(n, chunk)), N, chunk


def _ring_reduce_scatter_rows(rows, group, codec: Codec, *, err=None, reverse: bool = False,
                              sub: Optional[tuple] = None, pallas: bool = False):
    """Ring reduce-scatter of every rank's ``[n, L]`` chunk rows: returns each
    rank's fully reduced chunk ``[L]`` (and the refreshed error-feedback
    rows when ``err`` is given). At hop k rank i sends its accumulated chunk
    ``(i - 1 - k) % n`` and adds the one it receives into chunk
    ``(i - 2 - k) % n``."""
    if err is None and pallas and pallas_backend.fusable(codec, rows[0].dtype):
        # the fused transport: encode -> hop -> decode-accumulate in one
        # kernel a hop; exact wires and integer payloads take the loop below,
        # whose hops are permute_leaves launches
        return pallas_backend.fused_ring_reduce_scatter_rows(
            rows, group, codec, reverse=reverse, sub=sub), None
    if sub is not None:
        n, pos, perm, _label = sub
        step = 1
    else:
        n, pos = group.n, list(range(group.n))
        step = -1 if reverse else 1
        perm = _ring_perm(n, reverse)
    L = rows[0].shape[1]
    if n == 1:
        return [r[0] for r in rows], err
    acc_dtype = _acc_dtype(rows[0].dtype)
    acc = _each(group, lambda r: rows[r].to(acc_dtype, copy=True))
    new_err = None if err is None else _each(group, lambda r: err[r].clone())
    for k in range(n - 1):
        def send(r):
            idx = (pos[r] - step * (1 + k)) % n
            v = acc[r][idx:idx + 1]
            if new_err is None:
                return codec.encode_rows(v)
            wire, e2 = codec.encode_rows_ef(v, new_err[r][idx:idx + 1])
            new_err[r][idx] = e2[0]
            return wire

        wires = pallas_backend.permute_wire(_each(group, send), group, perm, pallas=pallas)
        for r in range(group.n):
            with group.on(r):
                idx = (pos[r] - step * (2 + k)) % n
                acc[r][idx] = acc[r][idx] + codec.decode_rows(wires[r], L, acc_dtype)[0]
    return [acc[r][pos[r]] for r in range(group.n)], new_err


def _rhd_reduce_scatter_rows(rows, group, codec: Codec):
    """Recursive-halving reduce-scatter of ``[n, L]`` rows -> each rank's
    summed chunk ``[L]``; log2(n) hops, the payload halving a hop."""
    n = group.n
    if n & (n - 1):
        raise ValueError(f"rhd needs a power-of-two axis size, got {n}")
    if n == 1:
        return [r[0] for r in rows]
    acc_dtype = _acc_dtype(rows[0].dtype)
    bufs = _each(group, lambda r: rows[r].to(acc_dtype))
    d = n >> 1
    while d >= 1:
        m = bufs[0].shape[0]
        upper = [(r & d) != 0 for r in range(n)]
        sends = [bufs[r][:m // 2] if upper[r] else bufs[r][m // 2:] for r in range(n)]
        keeps = [bufs[r][m // 2:] if upper[r] else bufs[r][:m // 2] for r in range(n)]
        wires = _each(group, lambda r: codec.encode_rows(sends[r].reshape(1, -1)))
        wires = pallas_backend.permute_wire(wires, group, [(s, s ^ d) for s in range(n)])
        bufs = _each(group, lambda r: keeps[r] + codec.decode_rows(
            wires[r], sends[r].numel(), acc_dtype).reshape(sends[r].shape))
        d >>= 1
    return [b[0] for b in bufs]


def _scatter_rows(xs, group, scatter_axis: int):
    n = group.n
    moved = torch.movedim(xs[0], scatter_axis, 0)
    lead, rest = moved.shape[0], tuple(moved.shape[1:])
    if lead % n:
        raise ValueError(f"reduce_scatter dim {lead} not divisible by axis size {n}")
    rows = _each(group, lambda r: torch.movedim(xs[r], scatter_axis, 0).reshape(n, -1))
    return rows, lead, rest


def _finish_scatter(outs, group, xs, lead, rest, scatter_axis: int, op: str):
    n = group.n
    res = _each(group, lambda r: torch.movedim(
        outs[r].reshape((lead // n,) + rest).to(xs[r].dtype), 0, scatter_axis))
    if op in ("mean", "avg"):
        return _each(group, lambda r: res[r] / n)
    if op != "sum":
        raise ValueError(f"reduce op {op!r} unsupported by algorithmic reduce_scatter")
    return res


def ring_reduce_scatter(xs, group, codec: Codec, *, scatter_axis: int = 0, op: str = "sum",
                        bidir: bool = False, err=None, pallas: bool = False):
    """Reduce-scatter along ``scatter_axis`` (tiled ``lax.psum_scatter``: rank
    i gets slice i of the sum). ``err`` (each rank's ``[n, L]`` rows)
    enables error feedback and makes the return ``(out, new_err)``."""
    rows, lead, rest = _scatter_rows(xs, group, scatter_axis)
    new_err = None
    if bidir and err is None and rows[0].shape[1] >= 2:
        h = rows[0].shape[1] // 2
        oa, _ = _ring_reduce_scatter_rows([r[:, :h] for r in rows], group, codec)
        ob, _ = _ring_reduce_scatter_rows([r[:, h:] for r in rows], group, codec, reverse=True)
        outs = _each(group, lambda r: torch.cat([oa[r], ob[r]], dim=0))
    else:
        outs, new_err = _ring_reduce_scatter_rows(rows, group, codec, err=err, pallas=pallas)
    out = _finish_scatter(outs, group, xs, lead, rest, scatter_axis, op)
    return (out, new_err) if err is not None else out


def rhd_reduce_scatter(xs, group, codec: Codec, *, scatter_axis: int = 0, op: str = "sum"):
    rows, lead, rest = _scatter_rows(xs, group, scatter_axis)
    outs = _rhd_reduce_scatter_rows(rows, group, codec)
    return _finish_scatter(outs, group, xs, lead, rest, scatter_axis, op)


# ---------------------------------------------------------------- all-reduce
def _flat_all_reduce_ring(flats, group, codec: Codec, *, bidir: bool = False,
                          pallas: bool = False):
    """Ring all-reduce of flat payloads: pad to n chunks, ring
    reduce-scatter, ring all-gather of the shard in the payload dtype."""
    n = group.n
    if n == 1:
        return flats
    dtype = flats[0].dtype
    rows, N, chunk = _chunk_rows(group, flats, n)
    if bidir and chunk >= 2:
        h = chunk // 2
        ra, _ = _ring_reduce_scatter_rows([r[:, :h] for r in rows], group, codec)
        rb, _ = _ring_reduce_scatter_rows([r[:, h:] for r in rows], group, codec, reverse=True)
        ga = _ring_all_gather_flat(_each(group, lambda r: ra[r].to(dtype)), group, codec)
        gb = _ring_all_gather_flat(_each(group, lambda r: rb[r].to(dtype)), group, codec,
                                   reverse=True)
        return _each(group, lambda r: torch.cat([ga[r], gb[r]], dim=1).reshape(-1)[:N])
    red, _ = _ring_reduce_scatter_rows(rows, group, codec, pallas=pallas)
    out = _ring_all_gather_flat(_each(group, lambda r: red[r].to(dtype)), group, codec,
                                pallas=pallas)
    return _each(group, lambda r: out[r].reshape(-1)[:N])


def _flat_all_reduce_rhd(flats, group, codec: Codec):
    n = group.n
    if n == 1:
        return flats
    rows, N, _chunk = _chunk_rows(group, flats, n)
    red = _rhd_reduce_scatter_rows(rows, group, codec)
    out = rhd_all_gather(_each(group, lambda r: red[r].to(flats[r].dtype)), group, codec)
    return _each(group, lambda r: out[r].reshape(-1)[:N])


def _factor_near_square(n: int) -> Tuple[int, int]:
    """n = a * b with a <= b and a as close to sqrt(n) as divides."""
    a = int(math.isqrt(n))
    while a > 1 and n % a:
        a -= 1
    return a, n // a


def _flat_all_reduce_ring2d(flats, group, codec: Codec,
                            factors: Optional[Tuple[int, int]] = None, pallas: bool = False):
    """Hierarchical all-reduce on one axis factored a x b (rank = u*b + v):
    intra-group (b contiguous ranks) reduce-scatter, inter-group (a, stride
    b) ring all-reduce of the shard, intra-group all-gather."""
    n = group.n
    if n == 1:
        return flats
    a, b = factors if factors else _factor_near_square(n)
    if a * b != n:
        raise ValueError(f"ring2d factors {a}x{b} != axis size {n}")
    if a == 1 or b == 1:
        return _flat_all_reduce_ring(flats, group, codec, pallas=pallas)
    dtype = flats[0].dtype
    us = [r // b for r in range(n)]
    vs = [r % b for r in range(n)]
    intra = [(s, (s // b) * b + ((s % b) + 1) % b) for s in range(n)]
    inter = [(s, ((s // b + 1) % a) * b + (s % b)) for s in range(n)]

    # phase 1: intra-group ring reduce-scatter over the v sub-axis
    rows, N, _chunk = _chunk_rows(group, flats, b)
    shard, _ = _ring_reduce_scatter_rows(
        rows, group, codec,
        sub=(b, vs, intra, "all_reduce:ring2d/intra-rs"), pallas=pallas)
    # phase 2: inter-group ring all-reduce of the shard over the u sub-axis
    srows, SN, _schunk = _chunk_rows(group, shard, a)
    sred, _ = _ring_reduce_scatter_rows(
        srows, group, codec,
        sub=(a, us, inter, "all_reduce:ring2d/inter-rs"), pallas=pallas)
    sout = _ring_all_gather_flat(
        _each(group, lambda r: sred[r].to(dtype)), group, codec,
        sub=(a, us, inter, "all_reduce:ring2d/inter-ag"), pallas=pallas)
    shard_full = _each(group, lambda r: sout[r].reshape(-1)[:SN].to(dtype))
    # phase 3: intra-group ring all-gather of the reduced shard
    out = _ring_all_gather_flat(shard_full, group, codec,
                                sub=(b, vs, intra, "all_reduce:ring2d/intra-ag"), pallas=pallas)
    return _each(group, lambda r: out[r].reshape(-1)[:N].to(dtype))


# ---------------------------------------------------------------- all-to-all
# The payload is each rank's [n] destination rows (row d = its block for
# rank d). ring: phase k moves the row destined k ranks ahead directly by a
# distance-k permutation; bidir pairs phase k with its mirror distance;
# ring2d (a x b) exchanges a-row bundles on the intra sub-ring, then b-row
# bundles on the inter sub-ring, relaying the wire. Every row is encoded
# once at its source and decoded once at its destination; the own row never
# crosses a link and stays raw.
def _wire_take(wire: Wire, idx) -> Wire:
    """Rows ``idx`` of a blocked-rows wire (empty leaves pass through)."""
    return Wire(*(leaf if leaf.numel() == 0 else leaf[idx] for leaf in wire))


def _wire_update(wire: Wire, rows: Wire, idx) -> None:
    """Write ``rows`` into ``wire`` at leading index ``idx``, in place."""
    for leaf, r in zip(wire, rows):
        if leaf.numel():
            leaf[idx] = r


def _shift_perm(n: int, k: int):
    """Distance-k right-shift permutation of the whole axis."""
    return [(s, (s + k) % n) for s in range(n)]


def _ring_all_to_all_rows(rows, group, codec: Codec, *, bidir: bool = False,
                          pallas: bool = False):
    """All-to-all of every rank's ``[n, L]`` destination rows -> ``[n, L]``
    rows ordered by source rank."""
    n = group.n
    L = rows[0].shape[1]
    if n == 1:
        return rows
    perm_k = lambda k: _shift_perm(n, k)
    if pallas and not bidir and pallas_backend.fusable(codec, rows[0].dtype):
        return pallas_backend.fused_ring_all_to_all_rows(rows, group, codec, perm_k=perm_k)
    wires = _each(group, lambda r: codec.encode_rows(rows[r]))

    def own(r):
        out = torch.empty((n, L), dtype=rows[r].dtype, device=rows[r].device)
        out[r] = rows[r][r]  # own row: raw
        return out

    outs = _each(group, own)
    phases = range(1, n // 2 + 1) if bidir else range(1, n)
    for k in phases:
        for d in ([k] if (not bidir or 2 * k == n) else [k, n - k]):
            sends = _each(group, lambda r: _wire_take(wires[r], (r + d) % n))
            recv = pallas_backend.permute_wire(sends, group, perm_k(d), pallas=pallas)
            for r in range(n):
                with group.on(r):
                    one = Wire(*(leaf if leaf.numel() == 0 else leaf[None] for leaf in recv[r]))
                    outs[r][(r - d) % n] = codec.decode_rows(one, L, rows[r].dtype)[0]
    return outs


def _ring2d_all_to_all_rows(rows, group, codec: Codec, *, pallas: bool = False):
    """Sub-ring factored all-to-all (rank = u*b + v): a-row bundles on the
    intra (v) sub-ring grouped by target column, then b-row bundles on the
    inter (u) sub-ring grouped by target row, relayed in wire form."""
    n = group.n
    L = rows[0].shape[1]
    if n == 1:
        return rows
    a, b = _factor_near_square(n)
    if a == 1 or b == 1:
        return _ring_all_to_all_rows(rows, group, codec, pallas=pallas)
    intra_k = lambda k: [(s, (s // b) * b + ((s % b) + k) % b) for s in range(n)]
    inter_k = lambda k: [(s, (((s // b) + k) % a) * b + (s % b)) for s in range(n)]
    ar_a, ar_b = torch.arange(a), torch.arange(b)
    wires = _each(group, lambda r: codec.encode_rows(rows[r]))
    empty = lambda w, lead: Wire(*(leaf if leaf.numel() == 0 else
                                   torch.empty((lead,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                                               device=leaf.device) for leaf in w))
    # buf1[r][w * a + u'] = the row source (u, w) -> destination (u', v)
    buf1 = _each(group, lambda r: empty(wires[r], b * a))
    for r in range(n):
        with group.on(r):
            v = r % b
            _wire_update(buf1[r], _wire_take(wires[r], ar_a * b + v), v * a + ar_a)
    for k in range(1, b):
        bundles = _each(group, lambda r: _wire_take(wires[r], ar_a * b + (r % b + k) % b))
        recv = pallas_backend.permute_wire(bundles, group, intra_k(k), pallas=pallas)
        for r in range(n):
            with group.on(r):
                _wire_update(buf1[r], recv[r], ((r % b) - k) % b * a + ar_a)
    # phase 2: bundle by target row u' (for each source column w), exchange
    # on the inter sub-ring; rows end ordered by global source rank
    out_wire = _each(group, lambda r: empty(wires[r], n))
    for r in range(n):
        with group.on(r):
            u = r // b
            _wire_update(out_wire[r], _wire_take(buf1[r], ar_b * a + u), u * b + ar_b)
    for k in range(1, a):
        bundles = _each(group, lambda r: _wire_take(buf1[r], ar_b * a + (r // b + k) % a))
        recv = pallas_backend.permute_wire(bundles, group, inter_k(k), pallas=pallas)
        for r in range(n):
            with group.on(r):
                _wire_update(out_wire[r], recv[r], ((r // b) - k) % a * b + ar_b)

    def finish(r):
        out = codec.decode_rows(out_wire[r], L, rows[r].dtype)
        out[r] = rows[r][r]  # the own row never crossed a link: raw
        return out

    return _each(group, finish)


def all_to_all(xs, axis, *, split_axis: int, concat_axis: int, algorithm: str = "ring",
               codec="none", block_size: Optional[int] = None):
    """Algorithmic all-to-all with ``lax.all_to_all(tiled=True)`` semantics:
    each rank's ``split_axis`` divides into n blocks (block d to rank d) and
    the received blocks concatenate along ``concat_axis`` by source rank."""
    group = _check_axis(axis, "all_to_all")
    _no_compiled(algorithm)
    if algorithm == "rhd":
        raise ValueError(
            "all_to_all has no recursive-halving schedule (every block has exactly one "
            "destination); use ring / bidir / ring2d")
    known = tuple(a for a in ALGORITHMS if a != "rhd") + PALLAS_ALGORITHMS
    if algorithm not in known:
        raise ValueError(f"unknown algorithm {algorithm!r} (one of {known})")
    c = get_codec(codec, block_size)
    n = group.n
    x0 = xs[0]
    if x0.shape[split_axis] % n:
        raise ValueError(f"all_to_all split dim {x0.shape[split_axis]} not divisible by axis "
                         f"size {n}")
    m = x0.shape[split_axis] // n
    rest = tuple(torch.movedim(x0, split_axis, 0).shape[1:])
    with group.joined():
        rows = _each(group, lambda r: torch.movedim(xs[r], split_axis, 0).reshape(n, -1))
        if algorithm == "pallas_ring":
            out_rows = _ring_all_to_all_rows(rows, group, c, pallas=True)
        elif algorithm == "pallas_ring2d":
            out_rows = _ring2d_all_to_all_rows(rows, group, c, pallas=True)
        elif algorithm == "ring":
            out_rows = _ring_all_to_all_rows(rows, group, c)
        elif algorithm == "bidir":
            out_rows = _ring_all_to_all_rows(rows, group, c, bidir=True)
        else:
            out_rows = _ring2d_all_to_all_rows(rows, group, c)
        shape = list(x0.shape)
        shape[split_axis] = m
        shape[concat_axis] = shape[concat_axis] * n if concat_axis != split_axis else n * m

        def assemble(r):
            blocks = out_rows[r].reshape((n, m) + rest)
            blocks = torch.movedim(blocks, 1, split_axis + 1)
            return torch.movedim(blocks, 0, concat_axis).reshape(shape)

        return _each(group, assemble)


# ------------------------------------------------------------------ dispatch
def all_reduce(xs, axis, *, algorithm: str = "ring", codec="none", op: str = "sum",
               block_size: Optional[int] = None):
    """Algorithmic all-reduce (sum/mean) of every rank's tensor."""
    group = _check_axis(axis, "all_reduce")
    _no_compiled(algorithm)
    c = get_codec(codec, block_size)
    if op not in ("sum", "mean", "avg"):
        raise ValueError(f"reduce op {op!r} unsupported by algorithmic all_reduce")
    with group.joined():
        flats = _each(group, lambda r: xs[r].reshape(-1))
        if algorithm == "pallas_ring":
            out = _flat_all_reduce_ring(flats, group, c, pallas=True)
        elif algorithm == "pallas_ring2d":
            out = _flat_all_reduce_ring2d(flats, group, c, pallas=True)
        elif algorithm == "ring":
            out = _flat_all_reduce_ring(flats, group, c)
        elif algorithm == "bidir":
            out = _flat_all_reduce_ring(flats, group, c, bidir=True)
        elif algorithm == "rhd":
            out = _flat_all_reduce_rhd(flats, group, c)
        elif algorithm == "ring2d":
            out = _flat_all_reduce_ring2d(flats, group, c)
        else:
            raise ValueError(
                f"unknown algorithm {algorithm!r} (one of {ALGORITHMS + PALLAS_ALGORITHMS})")
        out = _each(group, lambda r: out[r].reshape(xs[r].shape))
        if op in ("mean", "avg"):
            out = _each(group, lambda r: (out[r].float() / group.n).to(xs[r].dtype))
        return out


def all_gather(xs, axis, *, algorithm: str = "ring", codec="none", concat_axis: int = 0,
               block_size: Optional[int] = None):
    group = _check_axis(axis, "all_gather")
    _no_compiled(algorithm)
    c = get_codec(codec, block_size)
    with group.joined():
        if algorithm in PALLAS_ALGORITHMS:
            # no reduction to fuse: the encode-once relay over permute_leaves
            # hops (ring2d is a plain ring for a gather, as below)
            return ring_all_gather(xs, group, c, concat_axis=concat_axis, pallas=True)
        if algorithm in ("ring", "ring2d"):
            return ring_all_gather(xs, group, c, concat_axis=concat_axis)
        if algorithm == "bidir":
            return ring_all_gather(xs, group, c, concat_axis=concat_axis, bidir=True)
        if algorithm == "rhd":
            return rhd_all_gather(xs, group, c, concat_axis=concat_axis)
    raise ValueError(f"unknown algorithm {algorithm!r} (one of {ALGORITHMS + PALLAS_ALGORITHMS})")


def reduce_scatter(xs, axis, *, algorithm: str = "ring", codec="none", scatter_axis: int = 0,
                   op: str = "sum", block_size: Optional[int] = None, err=None):
    if err is not None and algorithm != "ring":
        raise ValueError(
            f"error feedback is implemented for algorithm='ring' only, got {algorithm!r}")
    group = _check_axis(axis, "reduce_scatter")
    _no_compiled(algorithm)
    c = get_codec(codec, block_size)
    with group.joined():
        if algorithm in PALLAS_ALGORITHMS:
            # a fusable codec runs the fused hop (ring2d is a plain ring for a
            # lone reduce-scatter, as below)
            return ring_reduce_scatter(xs, group, c, scatter_axis=scatter_axis, op=op, pallas=True)
        if algorithm in ("ring", "ring2d"):
            return ring_reduce_scatter(xs, group, c, scatter_axis=scatter_axis, op=op,
                                       err=err if algorithm == "ring" else None)
        if algorithm == "bidir":
            return ring_reduce_scatter(xs, group, c, scatter_axis=scatter_axis, op=op, bidir=True)
        if algorithm == "rhd":
            return rhd_reduce_scatter(xs, group, c, scatter_axis=scatter_axis, op=op)
    raise ValueError(f"unknown algorithm {algorithm!r} (one of {ALGORITHMS + PALLAS_ALGORITHMS})")
