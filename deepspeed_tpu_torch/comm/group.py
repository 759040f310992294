"""A rank group: the port's counterpart of one bound mesh axis.

In the JAX package a collective runs inside a full-manual ``shard_map``: each
device runs the same body on its own shard, ``lax.axis_index`` names its rank
and ``utils/compat.axis_size`` the axis size. The port keeps the single
controller: one process holds every rank, and a sharded value is a list of
``n`` tensors, rank r's on rank r's device, the per-rank view a ``shard_map``
body sees.

``RankGroup(axis, n, device="cuda")`` places the ranks round-robin over the
visible cards (on one card all share ``cuda:0``) and gives each rank a
``torch.cuda.Stream``. A collective starts with every rank's stream waiting
on the caller's stream and ends with the caller's stream waiting on every
rank's (``joined``); between the two, a rank's work runs on its own stream
(``on``), and one rank's read of another's buffer is ordered by a CUDA event
the host records on the writer's stream and has the reader's stream wait on
(``record`` / ``wait``), with ``crossed`` keeping the buffer from the
allocator until the reader is done. ``device="cpu"`` runs every rank on the
CPU, where the kernels' plain versions run and streams and events are no-ops.

Ranks on different cards read each other's memory directly, which needs peer
access (``cudaDeviceCanAccessPeer``); a group whose cards lack it raises.
Groups over several mesh axes (JAX's axis tuples and
``collectives/algorithms.py:_hier_all_reduce_axes``) are not ported.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.utils.device import resolve_device


class RankGroup:
    """``n`` ranks named ``axis``, each with its device and (on CUDA) stream."""

    def __init__(self, axis: str, n: int, device="cuda"):
        if isinstance(axis, (tuple, list)):
            raise NotImplementedError(
                f"rank group over the axis tuple {tuple(axis)}: multi-axis groups "
                "(collectives/algorithms.py:_hier_all_reduce_axes) are not ported")
        if int(n) < 1:
            raise ValueError(f"a rank group needs at least one rank, got {n}")
        dev = resolve_device(device)
        self.axis, self.n = str(axis), int(n)
        if dev.type == "cpu":
            self.devices = [dev] * self.n
            self.streams: Optional[List[torch.cuda.Stream]] = None
            return
        cards = [dev.index] if dev.index is not None else list(range(torch.cuda.device_count()))
        self.devices = [torch.device("cuda", cards[r % len(cards)]) for r in range(self.n)]
        used = sorted({d.index for d in self.devices})
        for a in used:
            for b in used:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise RuntimeError(
                        f"rank group {self.axis!r}: cuda:{a} cannot access cuda:{b} "
                        "(no peer access); its ranks cannot read each other's buffers")
        if len(used) > 1:
            from deepspeed_tpu_torch.ops import op_builder

            for a in used:
                for b in used:
                    if a != b:
                        op_builder.launch("ring_hop", "ds_enable_peer_access", a, b)
        self.streams = [torch.cuda.Stream(device=d) for d in self.devices]

    @property
    def is_cuda(self) -> bool:
        return self.streams is not None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RankGroup({self.axis!r}, {self.n}, devices={sorted(set(map(str, self.devices)))})"

    # ------------------------------------------------------------ streams
    def on(self, r: int):
        """Context in which rank ``r``'s work runs: its stream (and card)."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[r])

    def record(self, r: int) -> Optional[torch.cuda.Event]:
        """An event at the end of the work enqueued so far on rank ``r``'s stream."""
        if self.streams is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[r])
        return ev

    def wait(self, r: int, event: Optional[torch.cuda.Event]) -> None:
        """Rank ``r``'s stream waits for ``event`` before its later work."""
        if event is not None:
            self.streams[r].wait_event(event)

    def crossed(self, tensors: Sequence[torch.Tensor], r: int) -> None:
        """``tensors`` are read on rank ``r``'s stream: the allocator keeps
        their memory until that read is done."""
        if self.streams is not None:
            for t in tensors:
                if t.is_cuda and t.numel():
                    t.record_stream(self.streams[r])

    @contextlib.contextmanager
    def joined(self) -> Iterator[None]:
        """One collective: every rank's stream starts after the caller's
        stream, and the caller's stream continues after every rank's."""
        if self.streams is None:
            yield
            return
        for r, s in enumerate(self.streams):
            s.wait_stream(torch.cuda.current_stream(self.devices[r]))
        yield
        for r, s in enumerate(self.streams):
            torch.cuda.current_stream(self.devices[r]).wait_stream(s)


def shards_from_numpy(array: np.ndarray, group: RankGroup,
                      dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``[n, ...]`` numpy -> a rank list: rank r's tensor ``array[r]`` on its
    device (the shard a ``shard_map`` body with ``in_specs=P(axis)`` sees,
    less its leading 1)."""
    array = np.asarray(array)
    if array.shape[0] != group.n:
        raise ValueError(f"leading dim {array.shape[0]} != group size {group.n}")
    out = []
    for r in range(group.n):
        t = torch.from_numpy(np.array(array[r]))  # a writable copy
        out.append(t.to(device=group.devices[r], dtype=dtype or t.dtype))
    return out


def shards_to_numpy(shards: Sequence[torch.Tensor]) -> np.ndarray:
    """A rank list -> ``[n, ...]`` numpy (bf16 as fp32, which holds it exactly)."""
    host = [s.detach().cpu() for s in shards]
    return np.stack([(h.float() if h.dtype == torch.bfloat16 else h).numpy() for h in host])
