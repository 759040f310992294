"""Collectives facade over a rank group, with a comms logger (counterpart of
``deepspeed_tpu/comm/comm.py``).

Every op takes a sharded value as a rank list (rank r's tensor on rank r's
device) and the group (``comm/group.py:RankGroup``) in JAX's ``axis``
argument, and returns a rank list. ``algorithm=`` / ``codec=`` route through
``deepspeed_tpu_torch.collectives`` (a concrete name: ``ring``, ``bidir``,
``rhd``, ``ring2d``, or ``pallas_ring`` / ``pallas_ring2d`` for the hop
kernels); ``algorithm=None`` with no codec is JAX's ``jax.lax`` branch, here
the native reduction over the rank list. ``algorithm="auto"``, or a codec
without an algorithm, asks the selector (``collectives/selector.py``), which
is not ported, and raises. An empty axis tuple (``axis=()``) is JAX's native
no-op: each rank's value comes back as it is (the mean of an integer payload
as float32, as ``lax.pmean`` gives it), and nothing is routed or quantised.
The multi-process control plane
(``init_distributed``, ``get_world_size``, ``get_rank``, ``barrier``) belongs
with multi-process data parallelism and is not ported either.

``CommsLogger`` counts every facade call by (op, group axis) with its
per-rank bytes, as JAX's trace-time logger does (reference
``utils/comms_logging.py:67``); ``log_summary`` prints the bus traffic by the
reference's algo -> bus factors.
"""

from __future__ import annotations

import collections
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from deepspeed_tpu_torch.utils.logging import logger


@dataclass
class _OpRecord:
    count: int = 0
    total_bytes: int = 0
    sizes: collections.Counter = field(default_factory=collections.Counter)


class CommsLogger:
    """Collective telemetry (reference ``CommsLogger``)."""

    def __init__(self, enabled: bool = False, verbose: bool = False, debug: bool = False):
        self.enabled, self.verbose, self.debug = enabled, verbose, debug
        self._lock = threading.Lock()
        self._records: Dict[str, _OpRecord] = collections.defaultdict(_OpRecord)

    def configure(self, enabled: bool = True, verbose: bool = False, debug: bool = False):
        self.enabled, self.verbose, self.debug = enabled, verbose, debug

    def reset(self):
        with self._lock:
            self._records.clear()

    def record(self, op_name: str, axis: str, nbytes: int, world: int):
        if not self.enabled:
            return
        key = f"{op_name}@{axis}"
        with self._lock:
            rec = self._records[key]
            rec.count += 1
            rec.total_bytes += nbytes
            rec.sizes[(nbytes, world)] += 1
        if self.verbose:
            logger.info(f"comm: {key} size={nbytes}B world={world}")

    @staticmethod
    def _bus_factor(op_name: str, n: int) -> float:
        if n <= 1:
            return 0.0
        if op_name.startswith("all_reduce"):
            return 2 * (n - 1) / n
        return (n - 1) / n  # all_gather / reduce_scatter / all_to_all

    def summary(self) -> List[dict]:
        rows = []
        with self._lock:
            for key, rec in sorted(self._records.items()):
                op, _, axis = key.partition("@")
                rows.append({
                    "op": op, "axis": axis, "count": rec.count, "total_bytes": rec.total_bytes,
                    "bus_bytes": int(sum(self._bus_factor(op, w) * b * c
                                         for (b, w), c in rec.sizes.items())),
                })
        return rows

    def log_summary(self):
        rows = self.summary()
        if not rows:
            logger.info("comm summary: no collectives recorded")
            return rows
        width = max(len(r["op"] + r["axis"]) for r in rows) + 4
        logger.info(f"{'op@axis':<{width}} {'count':>8} {'total':>12} {'bus-traffic':>12}")
        for r in rows:
            logger.info(f"{r['op'] + '@' + r['axis']:<{width}} {r['count']:>8} "
                        f"{_fmt_bytes(r['total_bytes']):>12} {_fmt_bytes(r['bus_bytes']):>12}")
        return rows


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n:.1f}TB"


comms_logger = CommsLogger(enabled=os.environ.get("DSTPU_COMMS_LOGGER", "") == "1")


def configure(enabled: bool = True, verbose: bool = False, debug: bool = False):
    comms_logger.configure(enabled=enabled, verbose=verbose, debug=debug)


def log_summary():
    """Reference ``deepspeed.comm.log_summary()``."""
    return comms_logger.log_summary()


def _group(axis, op_name: str):
    """The rank group of ``axis``, or None for the empty axis tuple (the
    native no-op)."""
    if isinstance(axis, (tuple, list)):
        if not axis:
            return None
        raise NotImplementedError(
            f"{op_name} over the axis tuple {tuple(axis)}: multi-axis groups "
            "(collectives/algorithms.py:_hier_all_reduce_axes) are not ported")
    return axis


def _record(op_name: str, group, xs: Sequence[torch.Tensor]) -> None:
    """One facade call into the comms logger: the per-rank bytes, as JAX
    records a shard's (over the empty axis tuple: axis "" and world 1)."""
    x = xs[0]
    axis, world = ("", 1) if group is None else (group.axis, group.n)
    comms_logger.record(op_name, axis, x.numel() * x.element_size(), world)


def _mean_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``lax.pmean`` returns: a float payload keeps its dtype, an
    integer or bool one comes back as float32."""
    return dtype if dtype.is_floating_point or dtype.is_complex else torch.float32


def _unchanged(xs) -> List[torch.Tensor]:
    """A copy of each rank's value: the facade over the empty axis tuple,
    where nothing crosses a wire."""
    return [t.clone() for t in xs]


def _algorithmic(algorithm: Optional[str], codec: Optional[str]):
    """(algorithm, codec) of the algorithmic path, or None for the native one."""
    if algorithm is None and codec is None:
        return None  # no facade defaults without the selector: the native path
    if algorithm == "lax":
        return None
    if algorithm in (None, "auto"):
        raise NotImplementedError(
            f"algorithm={algorithm!r} with codec={codec!r} asks the selector "
            "(collectives/selector.py), which is not ported: name an algorithm")
    return algorithm, codec or "none"


def _on_each(group, fn) -> List[torch.Tensor]:
    with group.joined():
        out = []
        for r in range(group.n):
            with group.on(r):
                out.append(fn(r))
        return out


def _native_sum(xs, group, r, reduce=torch.sum):
    """Every rank's tensor reduced over the rank list, on rank r's device."""
    return reduce(torch.stack([x.to(group.devices[r]) for x in xs]), 0)


def all_reduce(x, axis, op: str = "sum", *, algorithm: Optional[str] = None,
               codec: Optional[str] = None, block_size: Optional[int] = None):
    """Sum / mean / max / min over the group (reference ``all_reduce``)."""
    group = _group(axis, "all_reduce")
    if group is None:  # JAX's facade routes nothing here (comm/comm.py:240-244)
        _record(f"all_reduce_{op}", group, x)
        if op in ("mean", "avg"):
            return [t.to(_mean_dtype(t.dtype), copy=True) for t in x]
        if op not in ("sum", "max", "min"):
            raise ValueError(f"unsupported reduce op {op!r}")
        return _unchanged(x)
    route = _algorithmic(algorithm, codec)
    _record(f"all_reduce_{op}", group, x)
    if route is not None:
        from deepspeed_tpu_torch import collectives

        return collectives.all_reduce(x, group, algorithm=route[0], codec=route[1], op=op,
                                      block_size=block_size)
    reducers = {"sum": torch.sum, "max": lambda t, d: t.amax(d), "min": lambda t, d: t.amin(d)}
    if op in ("mean", "avg"):  # lax.pmean: psum, then a true division by the axis size
        return _on_each(group, lambda r: (_native_sum(x, group, r) / group.n).to(
            _mean_dtype(x[r].dtype)))
    if op not in reducers:
        raise ValueError(f"unsupported reduce op {op!r}")
    return _on_each(group, lambda r: _native_sum(x, group, r, reducers[op]).to(x[r].dtype))


def all_gather(x, axis, *, concat_axis: int = 0, tiled: bool = True,
               algorithm: Optional[str] = None, codec: Optional[str] = None,
               block_size: Optional[int] = None):
    """All-gather over the group (reference ``all_gather_into_tensor``)."""
    group = _group(axis, "all_gather")
    if not tiled and (algorithm is not None or codec is not None):
        raise ValueError("algorithmic all_gather supports tiled=True only")
    if group is None:
        _record("all_gather", group, x)
        return _unchanged(x)
    route = _algorithmic(algorithm, codec)
    _record("all_gather", group, x)
    if route is not None:
        from deepspeed_tpu_torch import collectives

        return collectives.all_gather(x, group, algorithm=route[0], codec=route[1],
                                      concat_axis=concat_axis, block_size=block_size)
    join = torch.cat if tiled else torch.stack
    return _on_each(group, lambda r: join([t.to(group.devices[r]) for t in x], dim=concat_axis))


def reduce_scatter(x, axis, *, scatter_axis: int = 0, tiled: bool = True,
                   algorithm: Optional[str] = None, codec: Optional[str] = None,
                   block_size: Optional[int] = None):
    """Sum and scatter: rank i gets slice i (reference ``reduce_scatter_tensor``)."""
    group = _group(axis, "reduce_scatter")
    if not tiled and (algorithm is not None or codec is not None):
        raise ValueError("algorithmic reduce_scatter supports tiled=True only")
    if group is None:
        _record("reduce_scatter", group, x)
        return _unchanged(x)
    route = _algorithmic(algorithm, codec)
    _record("reduce_scatter", group, x)
    if route is not None:
        from deepspeed_tpu_torch import collectives

        return collectives.reduce_scatter(x, group, algorithm=route[0], codec=route[1],
                                          scatter_axis=scatter_axis, block_size=block_size)
    n = group.n
    if x[0].shape[scatter_axis] % n or (not tiled and x[0].shape[scatter_axis] != n):
        raise ValueError(f"reduce_scatter dim {x[0].shape[scatter_axis]} does not split over "
                         f"axis size {n}")

    def part(r):
        total = _native_sum(x, group, r)
        piece = total.chunk(n, dim=scatter_axis)[r]
        return piece if tiled else piece.squeeze(scatter_axis)

    return _on_each(group, part)


def all_to_all(x, axis, *, split_axis: int, concat_axis: int, tiled: bool = True,
               algorithm: Optional[str] = None, codec: Optional[str] = None,
               block_size: Optional[int] = None):
    """All-to-all (reference ``all_to_all_single``; MoE dispatch / combine)."""
    group = _group(axis, "all_to_all")
    if not tiled and (algorithm is not None or codec is not None):
        raise ValueError("algorithmic all_to_all supports tiled=True only")
    if group is None:
        if not tiled:  # lax.all_to_all over () asks for a split dim of size 1
            raise ValueError("untiled all_to_all over the empty axis tuple: the split dim must "
                             "equal the axis size, 1")
        _record("all_to_all", group, x)
        return _unchanged(x)
    route = _algorithmic(algorithm, codec)
    _record("all_to_all", group, x)
    if route is not None:
        from deepspeed_tpu_torch import collectives

        return collectives.all_to_all(x, group, split_axis=split_axis, concat_axis=concat_axis,
                                      algorithm=route[0], codec=route[1], block_size=block_size)
    n = group.n
    if x[0].shape[split_axis] % n or (not tiled and x[0].shape[split_axis] != n):
        raise ValueError(f"all_to_all split dim {x[0].shape[split_axis]} does not split over "
                         f"axis size {n}")

    def gather(r):
        blocks = [t.to(group.devices[r]).chunk(n, dim=split_axis)[r] for t in x]
        if tiled:
            return torch.cat(blocks, dim=concat_axis)
        blocks = [b.squeeze(split_axis) for b in blocks]
        return torch.stack(blocks, dim=concat_axis)

    return _on_each(group, gather)


def ppermute(x, axis, perm):
    """Rank d receives rank s's tensor for every (s, d) of ``perm``; ranks no
    pair sends to get zeros (reference p2p ``send`` / ``recv``)."""
    group = _group(axis, "ppermute")
    _record("ppermute", group, x)
    src = {d: s for s, d in perm}
    if group is None:  # one rank on the axis: (0, 0) keeps the value, no pair gives zeros
        return _unchanged(x) if 0 in src else [torch.zeros_like(t) for t in x]
    return _on_each(group, lambda r: x[src[r]].to(group.devices[r], copy=True) if r in src
                    else torch.zeros_like(x[r]))


def broadcast(x, axis, root: int = 0):
    """Every rank gets the root's tensor (reference ``broadcast``)."""
    group = _group(axis, "broadcast")
    if group is None:
        # JAX's broadcast indexes its gather's first dim (comm/comm.py:443-444),
        # which over () is the payload's own first dim, not a no-op
        raise NotImplementedError("broadcast over the empty axis tuple: JAX's facade returns "
                                  "x[root] of the payload there, not the value; not ported")
    _record("broadcast", group, x)
    return _on_each(group, lambda r: x[root].to(group.devices[r], copy=True))
