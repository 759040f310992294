"""Fused matmul-collective ops over a rank group (counterpart of
``deepspeed_tpu/collectives/fused_gemm.py``).

- :func:`all_gather_matmul`: ``y = x @ all_gather(w_shard, rows)``, the
  ZeRO-3 weight gather fused into its consumer product. Hop ``k`` holds one
  originating rank's shard ``[Ks, N]``: it contracts it against the matching
  columns of ``x`` and moves it to the next rank. ``out_block=True`` writes
  the independent column block ``g @ held^T`` of the backward's ``dx``
  instead.
- :func:`matmul_reduce_scatter`: ``reduce_scatter(x @ w, rows)``, each hop
  computing the outgoing row block's partial (``rprev + x[block] @ w``) and
  sending it; rank ``i`` gets row block ``i``.

A sharded value is a rank list on a ``comm.RankGroup``, as in the rest of
``collectives``. Every hop of a rank is one launch of a hand-written kernel
of ``csrc/fused_gemm.cu`` on the rank's stream, ``n - 1`` a rank and op:
:func:`ag_hop` (row 14, replaces ``_ag_hop_kernel``, ``fused_gemm.py:198``)
and :func:`rs_hop` (row 15, replaces ``_rs_hop_kernel``, ``:257``). Each
computes its product in its own body (fp32 tiles through shared memory) and
moves the wire in the same launch: the exact fp32 shard or partial, or its
int8 / e4m3 codes with an fp32 scale per ``qb`` elements, where ``qb =
gcd(B, block_size)`` and ``B`` is one of the TPU kernel's chunks (``Ks / C``
or ``Mb / C`` rows, ``C = _chunks_of(rows)``); the blocks are contiguous runs
of the row-major shard, so the codes and scales are JAX's.

The wire stays in the sender's memory and the receiver pulls it; no kernel
waits on another launch. A wire written in a rank's launch ``k`` is read in
its downstream's launch ``k + 1``, after the host has recorded an event on
the sender's stream; every rank's wire slots and receive buffers alternate by
hop parity, and a rank waits for its downstream's previous launch before it
overwrites a slot. So the schedule is JAX's shifted by one launch:

- the gather's launch ``k`` contracts the held shard (the own shard at
  ``k = 0``, else the one decoded in launch ``k - 1``) and receives the next:
  it decodes the upstream's wire ``k`` into its receive buffer and, before
  the last hop, encodes that decoded shard as its own wire ``k + 1``, as the
  TPU kernel re-encodes the shard it holds. A lossy wire's hop-0 codes (the
  own shard) are encoded before the hops by ``pallas_backend.fused_hop``
  (row 13) with no upstream, one launch a rank;
- the reduce-scatter's launch ``k`` adds the upstream's decoded wire ``k -
  1`` (nothing at ``k = 0``) to its product and writes or encodes the sum as
  its own wire ``k``. The last wire is received outside the kernel, where
  the own block's product is added (as in JAX, ``:518-520``): a lossy wire
  decoded and added by ``fused_hop`` (row 13), an exact one pulled by
  ``permute_leaves`` (row 12).

The final shard's and the own block's products are ``torch.matmul`` (TF32
stays PyTorch's default, off). ``configure(enabled=...)`` is the process
knob (JAX sets it from ``CollectivesConfig.fused_gemm_collectives`` with the
selector, which is not ported): off, or with ``fused=False``, every op runs
its unfused composition, a gather then one product or one product then a
reduce-scatter. Hops are recorded in the comms logger as ``remote_dma`` with
JAX's wire bytes.

Each kernel has its plain PyTorch version beside it (``ag_hop_plain``,
``rs_hop_plain``: the TPU kernel's chunks, the same wire math). A wrapper
runs the plain version only for CPU tensors; for CUDA tensors it launches
its kernel or raises. Launches count in ``ag_hop.launches`` and
``rs_hop.launches``, and by form in ``launches_by_form``.

Each kernel has two forms of its product (``FUSED_FORMS``), which
:func:`fused_form` picks from shapes, strides and pointer alignment alone:

- ``"wgmma"`` (form T): fp32 to fp32's accuracy on the tensor cores, three
  TF32 passes (big*big + big*small + small*big of each operand's split) on
  tiles that TMA brings into a ring; taken wherever TMA can describe both
  operands (row strides multiples of 4 floats, 16-byte aligned bases, K >
  0);
- ``"simt"`` (form S): fp32 FMAs on the CUDA cores, for the rest.

``tf32x3_matmul`` is the plain model of form T's arithmetic (TF32 rounding
by bits, the three passes summed in fp32); the CPU tests hold it to JAX's
hops, and nothing on the main path calls it. A form named on a CPU tensor
raises: a form is a kernel.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.collectives import pallas_backend
from deepspeed_tpu_torch.collectives.algorithms import _each
from deepspeed_tpu_torch.collectives.codecs import Codec, get_codec
from deepspeed_tpu_torch.comm.comm import comms_logger
from deepspeed_tpu_torch.comm.group import RankGroup
from deepspeed_tpu_torch.ops import op_builder

# --------------------------------------------------------------- config knob
_lock = threading.Lock()
_enabled = False


def configure(enabled: bool = False) -> None:
    """Process-global gate of every fused-GEMM caller (JAX sets it from
    ``CollectivesConfig.fused_gemm_collectives``)."""
    global _enabled
    with _lock:
        _enabled = bool(enabled)


def enabled() -> bool:
    with _lock:
        return _enabled


def supported(group) -> bool:
    """Whether the hop kernels can express ``group``: a single-axis rank group
    (its ranks on the CPU run the kernels' plain versions)."""
    return isinstance(group, RankGroup)


def _group_of(axis, what: str) -> RankGroup:
    """``axis`` if :func:`supported`, the one gate of the fused ops; the
    unfused compositions need a rank group too, so anything else raises."""
    if supported(axis):
        return axis
    if isinstance(axis, (tuple, list)):
        raise NotImplementedError(
            f"{what} over the axis tuple {tuple(axis)}: multi-axis groups "
            "(collectives/algorithms.py:_hier_all_reduce_axes) are not ported")
    raise TypeError(f"{what}: the axis is a RankGroup, got {type(axis).__name__}")


def _resolve_codec(codec, block_size: Optional[int]) -> Optional[Codec]:
    if codec is None or codec == "none":
        return None
    c = codec if isinstance(codec, Codec) else get_codec(codec, block_size or 64)
    if c.name not in ("int8", "fp8"):
        raise ValueError(f"no fused GEMM wire for codec {c.name!r}")
    return c


def _chunks_of(rows: int) -> int:
    """The TPU kernel's grid chunks a hop: exact divisors of the rows only."""
    for d in (4, 3, 2):
        if rows % d == 0:
            return d
    return 1


def _wire_math(codec: Optional[Codec], B: int) -> Tuple[torch.dtype, int]:
    """(wire value dtype, qb) for chunks of ``B`` elements: an exact wire is
    the raw fp32 chunk (qb spans it), a block wire has a scale every
    ``gcd(B, block_size)`` elements."""
    if codec is None:
        return torch.float32, B
    return pallas_backend.WIRE_DTYPES[codec.name], math.gcd(B, max(int(codec.block_size), 1))


def _wire_nbytes(rows: int, cols: int, codec: Optional[Codec]) -> int:
    if codec is None:
        return rows * cols * 4
    return rows * cols + 4 * max(rows * cols // max(int(codec.block_size), 1), 1)


def _record_hop(group: RankGroup, nbytes: int) -> None:
    comms_logger.record("remote_dma", group.axis, max(int(nbytes), 1), group.n)


# ---------------------------------------------------------------- the wires
_WIRE_CODES = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
# form name -> the C entries' form code (csrc/fused_gemm.cu)
FUSED_FORMS = {"simt": 0, "wgmma": 1}
# the rows and columns of an output tile, both forms' (csrc/fused_gemm.cu:
# kBM = kBN, and a static_assert holds form T's TM x TN to them): row 15's
# encode counts its groups of tiles
_TILE = 128


def fused_form(M: int, K: int, ldx: int, ldw: int, tma_ptrs: Sequence[int],
               pair_ptrs: Sequence[int] = (), pair_ld: int = 0) -> str:
    """The form of a hop's product from shapes, strides and addresses alone
    (never a device read). Form T (``"wgmma"``) where TMA can describe both
    operands and the epilogue's float2 pairs line up: ``M`` output rows and
    ``K`` > 0, the activation's and the weight's row strides ``ldx`` and
    ``ldw`` (floats) multiples of 4, every pointer of ``tma_ptrs`` 16-byte
    aligned, every pointer of ``pair_ptrs`` 8-byte aligned and ``pair_ld``
    even. Else form S (``"simt"``). The gather's column offset need not be
    aligned: form T describes x whole."""
    if M <= 0 or K <= 0 or ldx % 4 or ldw % 4 or pair_ld % 2:
        return "simt"
    if any(p % 16 for p in tma_ptrs) or any(p % 8 for p in pair_ptrs):
        return "simt"
    return "wgmma"


def _ag_form(x: torch.Tensor, held: torch.Tensor, out: torch.Tensor, out_block: bool) -> str:
    Ks, N = held.shape
    return fused_form(x.shape[0], N if out_block else Ks, x.stride(0), N,
                      (x.data_ptr(), held.data_ptr()),
                      () if out_block else (out.data_ptr(),), 0 if out_block else out.stride(0))


def _rs_form(x: torch.Tensor, w: torch.Tensor, up: Sequence[torch.Tensor], part: torch.Tensor,
             code: int) -> str:
    exact_up = (up[0].data_ptr(),) if up and code == 0 else ()
    return fused_form(part.shape[0], x.shape[1], x.shape[1], w.shape[1],
                      (x.data_ptr(), w.data_ptr()), (part.data_ptr(), *exact_up), w.shape[1])


def _named_form(what: str, form: Optional[str], picked: str) -> str:
    """``picked`` for ``form=None``; else the named form, if it takes the hop
    (form S takes every hop, form T those ``fused_form`` picks it for)."""
    if form is None:
        return picked
    if form not in FUSED_FORMS:
        raise ValueError(f"{what}: unknown form {form!r}; forms are {sorted(FUSED_FORMS)}")
    if form == "wgmma" and picked != "wgmma":
        raise ValueError(f"{what}: form 'wgmma' needs K > 0, row strides of multiples of 4 "
                         "floats and 16-byte aligned operands (8-byte aligned outputs)")
    return form


# ------------------------------------------------------- form T's arithmetic
def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 fraction bits) by bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``; inf and NaN pass through."""
    bits = a.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = bits & 0x7FFFFFFF
    rounded = (bits & 0x80000000) | ((mag + 0x1000) & 0x7FFFE000)
    out = torch.where(mag < 0x7F800000, rounded, bits)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32).view(torch.float32)


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small): ``big`` = a in TF32, ``small`` = (a - big) in TF32;
    where a is not finite, ``small`` carries it (inf or NaN) and ``big`` is
    +-1 with a's sign, as the kernel's ``split_tf32``: in the three passes
    the non-finite value then meets the other operand's big, so an inf
    gives +-inf and inf * 0 NaN, as fp32's product does."""
    a = a.float()
    big = torch.where(torch.isfinite(a), tf32_round(a), torch.copysign(torch.ones_like(a), a))
    return big, tf32_round(a - big)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The plain model of form T's product (``csrc/fused_gemm.cu``): both
    operands split by :func:`tf32_split`, the passes small*big + big*small,
    then big*big, summed in fp32 (``passes=1``: one TF32 pass of the
    operands rounded to TF32). The products of TF32 values are exact in
    fp32, so the model differs from the kernel only in its order of
    summation. Used by the tests, never on the main path."""
    if passes not in (1, 3):
        raise ValueError(f"tf32x3_matmul: 1 or 3 passes, got {passes}")
    if passes == 1:
        return torch.matmul(tf32_round(a), tf32_round(b))
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)) + torch.matmul(a_big, b_big)



def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _receive_plain(up: Sequence[torch.Tensor], recv: torch.Tensor, own, qb: int) -> None:
    """``recv`` = the upstream wire (decoded); then ``own`` = its codes."""
    if len(up) == 1:
        recv.copy_(up[0].reshape(recv.shape))
        return
    own_q, own_s = own if own is not None else (None, None)
    pallas_backend.fused_hop_plain(up[0], up[1], recv.view(-1),
                                   None if own is None else recv.view(-1), own_q, own_s,
                                   qb=qb, accumulate=False)


def _check_wire(what: str, up: Sequence[torch.Tensor], own, numel: int, qb: int) -> int:
    """The wire code (0 fp32, 1 int8, 2 e4m3) after checking the slots."""
    code = _WIRE_CODES.get(up[0].dtype) if up else None
    if up and (code is None or len(up) != (1 if code == 0 else 2)):
        raise TypeError(f"{what}: the upstream wire is one fp32 tensor or int8/e4m3 codes and "
                        f"fp32 scales, got {[t.dtype for t in up]}")
    if own is not None:
        oc = _WIRE_CODES.get(own[0].dtype)
        if oc in (None, 0) or (up and oc != code):
            raise TypeError(f"{what}: the own wire is int8/e4m3 codes of the upstream's kind")
        code = oc
    for q, s in ([up] if up and code else []) + ([own] if own is not None else []):
        if (q.numel() != numel or s.dtype != torch.float32 or s.numel() != numel // qb
                or not (q.is_contiguous() and s.is_contiguous())):
            raise ValueError(f"{what}: a wire slot is codes [{numel}] and fp32 scales "
                             f"[{numel} / qb]")
    if up and code == 0 and (up[0].numel() != numel or not up[0].is_contiguous()):
        raise ValueError(f"{what}: the exact wire is a contiguous fp32 [{numel}]")
    if code and (qb <= 0 or numel % qb):
        raise ValueError(f"{what}: {numel} elements are not a whole number of blocks of {qb}")
    return code or 0


def _fp32_contiguous(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{what}: {name} must be a contiguous 2-D fp32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _devices(what: str, tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds != {"cuda"}:
        raise ValueError(f"{what}: all CUDA or all CPU tensors expected, got "
                         f"{[str(t.device) for t in tensors]}")
    return "cuda"


# ---------------------------------------------------------------- row 14
def ag_hop_plain(x: torch.Tensor, held: torch.Tensor, out: torch.Tensor, col: int,
                 up: Sequence[torch.Tensor], recv: torch.Tensor, own=None, *, qb: int,
                 out_block: bool = False, matmul=torch.matmul) -> None:
    """The plain version of one all-gather+matmul launch, in place: the held
    shard ``[Ks, N]`` chunk by chunk as the TPU kernel's grid takes it,
    ``out[:, :] += x[:, col + chunk] @ held[chunk]`` (or, ``out_block``,
    ``out[:, col + chunk] = x @ held[chunk]^T``); then the upstream's wire
    into ``recv`` (decoded) and, with ``own``, ``recv``'s codes into it.
    ``matmul`` is the product (the tests pass ``tf32x3_matmul``)."""
    Ks = held.shape[0]
    C = _chunks_of(Ks)
    Bk = Ks // C
    for j in range(C):
        h = held[j * Bk:(j + 1) * Bk]
        c0 = col + j * Bk
        if out_block:
            out[:, c0:c0 + Bk] = matmul(x, h.t())
        else:
            out += matmul(x[:, c0:c0 + Bk], h)
    _receive_plain(up, recv, own, qb)


def ag_hop(x: torch.Tensor, held: torch.Tensor, out: torch.Tensor, col: int,
           up: Sequence[torch.Tensor], recv: torch.Tensor, own=None, *, qb: int,
           out_block: bool = False, form: Optional[str] = None) -> None:
    """One all-gather+matmul launch of ``ds_ag_hop`` on the current stream
    (see :func:`ag_hop_plain`). ``up`` is the upstream rank's wire: its fp32
    shard, or its codes and scales; it may lie on another card of the group.
    ``form`` names a form of ``FUSED_FORMS`` (None: :func:`fused_form`'s);
    a named form raises where it cannot take the hop, and on CPU tensors."""
    own = tuple(own) if own is not None else None
    given = [x, held, out, *up, recv, *(own or ())]
    if _devices("ag_hop", given) == "cpu":
        if form is not None:
            raise ValueError(f"ag_hop: form {form!r} is a kernel; CPU tensors take the plain "
                             "version (form=None)")
        return ag_hop_plain(x, held, out, col, up, recv, own, qb=qb, out_block=out_block)
    _fp32_contiguous("ag_hop", x=x, held=held, out=out, recv=recv)
    Ks, N = held.shape
    M = x.shape[0]
    if recv.shape != held.shape:
        raise ValueError(f"ag_hop: recv {tuple(recv.shape)} != held {tuple(held.shape)}")
    if out_block:
        if x.shape[1] != N or out.shape[0] != M or not 0 <= col <= out.shape[1] - Ks:
            raise ValueError(f"ag_hop: g {tuple(x.shape)}, held {tuple(held.shape)} and the "
                             f"block at column {col} of out {tuple(out.shape)} do not fit")
    elif out.shape != (M, N) or not 0 <= col <= x.shape[1] - Ks:
        raise ValueError(f"ag_hop: x {tuple(x.shape)} columns {col}:{col + Ks} against held "
                         f"{tuple(held.shape)} into out {tuple(out.shape)} do not fit")
    if not up:
        raise ValueError("ag_hop: every hop receives a wire")
    code = _check_wire("ag_hop", list(up), own, Ks * N, qb)
    if max(M, N, Ks) >= 2 ** 31:
        raise ValueError("ag_hop: dimensions must fit in int32")
    picked = _ag_form(x, held, out, out_block)
    form = _named_form("ag_hop", form, picked)
    dev = out.device
    own_q, own_s = own if own is not None else (None, None)
    op_builder.launch("fused_gemm", "ds_ag_hop", x.data_ptr(), x.stride(0), col, held.data_ptr(),
                      out.data_ptr(), out.stride(0), M, N, Ks, int(out_block),
                      up[0].data_ptr(), _ptr(up[1]) if code else None, recv.data_ptr(),
                      _ptr(own_q), _ptr(own_s), qb, code, FUSED_FORMS[form],
                      torch.cuda.current_stream(dev).cuda_stream)
    ag_hop.launches += 1
    ag_hop.launches_by_form[form] += 1


ag_hop.launches = 0
ag_hop.launches_by_form = dict.fromkeys(FUSED_FORMS, 0)


# ---------------------------------------------------------------- row 15
def rs_hop_plain(x: torch.Tensor, w: torch.Tensor, row0: int, up: Sequence[torch.Tensor],
                 part: torch.Tensor, own=None, *, qb: int, matmul=torch.matmul) -> None:
    """The plain version of one matmul+reduce-scatter launch, in place: the
    outgoing row block's partial ``part [Mb, N] = rprev + x[row0 + chunk] @
    w`` chunk by chunk as the TPU kernel's grid takes it, ``rprev`` the
    upstream's decoded wire (zeros without one); then, with ``own``,
    ``part``'s codes into it. ``matmul`` is the product."""
    Mb = part.shape[0]
    C = _chunks_of(Mb)
    Bm = Mb // C
    if not up:
        rprev = torch.zeros_like(part)
    elif len(up) == 1:
        rprev = up[0].reshape(part.shape)
    else:
        rprev = torch.empty_like(part)
        pallas_backend.fused_hop_plain(up[0], up[1], rprev.view(-1), None, None, None, qb=qb,
                                       accumulate=False)
    for j in range(C):
        r0 = j * Bm
        part[r0:r0 + Bm] = rprev[r0:r0 + Bm] + matmul(x[row0 + r0:row0 + r0 + Bm], w)
    if own is not None:
        pallas_backend.fused_hop_plain(None, None, None, part.view(-1), own[0], own[1], qb=qb)


def rs_hop(x: torch.Tensor, w: torch.Tensor, row0: int, up: Sequence[torch.Tensor],
           part: torch.Tensor, own=None, *, qb: int, form: Optional[str] = None) -> None:
    """One matmul+reduce-scatter launch of ``ds_rs_hop`` on the current
    stream (see :func:`rs_hop_plain`). ``up`` (empty at the first hop) is the
    upstream rank's wire: its fp32 partial, or its codes and scales; it may
    lie on another card of the group. ``form`` as for :func:`ag_hop`."""
    up = list(up or ())
    own = tuple(own) if own is not None else None
    given = [x, w, *up, part, *(own or ())]
    if _devices("rs_hop", given) == "cpu":
        if form is not None:
            raise ValueError(f"rs_hop: form {form!r} is a kernel; CPU tensors take the plain "
                             "version (form=None)")
        return rs_hop_plain(x, w, row0, up, part, own, qb=qb)
    _fp32_contiguous("rs_hop", x=x, w=w, part=part)
    Mb, N = part.shape
    K = x.shape[1]
    if w.shape != (K, N) or not 0 <= row0 <= x.shape[0] - Mb:
        raise ValueError(f"rs_hop: rows {row0}:{row0 + Mb} of x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} into part {tuple(part.shape)} do not fit")
    code = _check_wire("rs_hop", up, own, Mb * N, qb)
    if max(Mb, N, K) >= 2 ** 31:
        raise ValueError("rs_hop: dimensions must fit in int32")
    picked = _rs_form(x, w, up, part, code)
    form = _named_form("rs_hop", form, picked)
    dev = part.device
    # the encode's arrival counters, one a group of tiles (at most one a
    # tile; csrc/fused_gemm.cu)
    counters = None if own is None else torch.zeros(
        -(-Mb // _TILE) * -(-N // _TILE), dtype=torch.int32, device=dev)
    own_q, own_s = own if own is not None else (None, None)
    op_builder.launch("fused_gemm", "ds_rs_hop", x.data_ptr(), row0, w.data_ptr(), Mb, K, N,
                      _ptr(up[0]) if up else None, _ptr(up[1]) if code and up else None,
                      part.data_ptr(), _ptr(own_q), _ptr(own_s), _ptr(counters), qb, code,
                      FUSED_FORMS[form], torch.cuda.current_stream(dev).cuda_stream)
    rs_hop.launches += 1
    rs_hop.launches_by_form[form] += 1


rs_hop.launches = 0
rs_hop.launches_by_form = dict.fromkeys(FUSED_FORMS, 0)


# ------------------------------------------------------------ public fused ops
def _product(x: torch.Tensor, w: torch.Tensor, out_block: bool = False) -> torch.Tensor:
    x32, w32 = x.float(), w.float()
    return torch.matmul(x32, w32.t() if out_block else w32)


def all_gather_matmul(x: Sequence[torch.Tensor], w_shard: Sequence[torch.Tensor], axis, *,
                      codec=None, block_size: Optional[int] = None, out_block: bool = False,
                      fused: Optional[bool] = None) -> List[torch.Tensor]:
    """``x [M, n*Ks] @ all_gather(w_shard [Ks, N], rows) -> [M, N]`` on every
    rank, the gather fused into the product (``out_block=True``: ``x [M, N]``
    against each shard's transpose -> ``[M, n*Ks]``, the backward's ``dx``).

    ``fused=None`` follows the module knob, ``False`` forces the unfused
    composition, ``True`` the hop kernels. fp32 out."""
    c = _resolve_codec(codec, block_size)
    use = enabled() if fused is None else fused
    group = _group_of(axis, "all_gather_matmul")
    n = group.n
    if n <= 1:
        return _each(group, lambda r: _product(x[r], w_shard[r], out_block))
    if not use:
        return _unfused_all_gather_matmul(x, w_shard, group, out_block=out_block)
    Ks, N = w_shard[0].shape
    M = x[0].shape[0]
    C = _chunks_of(Ks)
    wdtype, qb = _wire_math(c, (Ks // C) * N)
    nbytes = _wire_nbytes(Ks, N, c)
    devs = group.devices
    with group.joined():
        x32 = _each(group, lambda r: x[r].float().contiguous())
        held = _each(group, lambda r: w_shard[r].float().contiguous())
        y = _each(group, lambda r: torch.zeros(M, n * Ks if out_block else N, device=devs[r]))
        recv = _each(group, lambda r: torch.empty(2, Ks, N, device=devs[r]))
        if c is not None:
            wq = _each(group, lambda r: torch.empty(2, Ks * N, dtype=wdtype, device=devs[r]))
            ws = _each(group, lambda r: torch.empty(2, Ks * N // qb, device=devs[r]))
            for r in range(n):  # hop 0's wire: the own shard's codes
                with group.on(r):
                    pallas_backend.fused_hop(None, None, None, held[r].view(-1), wq[r][0],
                                             ws[r][0], qb=qb)
        events = [group.record(r) for r in range(n)]
        for k in range(n - 1):
            _record_hop(group, nbytes)
            last = k == n - 2
            for r in range(n):
                u, d = (r - 1) % n, (r + 1) % n
                with group.on(r):
                    group.wait(r, events[u])  # its wire k
                    group.wait(r, events[d])  # done reading what this launch overwrites
                    up = (held[u],) if c is None else (wq[u][k % 2], ws[u][k % 2])
                    group.crossed(up, r)
                    own = None if c is None or last else (wq[r][(k + 1) % 2], ws[r][(k + 1) % 2])
                    ag_hop(x32[r], held[r], y[r], ((r - k) % n) * Ks, up, recv[r][(k + 1) % 2],
                           own, qb=qb, out_block=out_block)
            events = [group.record(r) for r in range(n)]
            held = [recv[r][(k + 1) % 2] for r in range(n)]

        def final(r):
            # the last received shard crosses no other wire: one plain product
            s0 = ((r + 1) % n) * Ks
            if out_block:
                y[r][:, s0:s0 + Ks] = torch.matmul(x32[r], held[r].t())
                return y[r]
            return y[r] + torch.matmul(x32[r][:, s0:s0 + Ks], held[r])

        return _each(group, final)


def matmul_reduce_scatter(x: Sequence[torch.Tensor], w: Sequence[torch.Tensor], axis, *,
                          codec=None, block_size: Optional[int] = None,
                          fused: Optional[bool] = None) -> List[torch.Tensor]:
    """``reduce_scatter(x [M, K] @ w [K, N], rows) -> [M/n, N]`` (the sum over
    the group; rank ``i`` gets row block ``i``), each hop's partial product
    fused into its own wire. fp32 out. The unfused composition runs when the
    knob is off or ``M`` does not split over the group (which it refuses)."""
    c = _resolve_codec(codec, block_size)
    use = enabled() if fused is None else fused
    group = _group_of(axis, "matmul_reduce_scatter")
    n = group.n
    M = x[0].shape[0]
    if n <= 1:
        return _each(group, lambda r: _product(x[r], w[r]))
    if not use or M % n != 0:
        return _unfused_matmul_reduce_scatter(x, w, group)
    Mb, N = M // n, w[0].shape[1]
    C = _chunks_of(Mb)
    wdtype, qb = _wire_math(c, (Mb // C) * N)
    nbytes = _wire_nbytes(Mb, N, c)
    devs = group.devices
    with group.joined():
        x32 = _each(group, lambda r: x[r].float().contiguous())
        w32 = _each(group, lambda r: w[r].float().contiguous())
        if c is None:  # the exact wire is the partial itself
            slots = _each(group, lambda r: torch.empty(2, Mb, N, device=devs[r]))
        else:
            stage = _each(group, lambda r: torch.empty(Mb, N, device=devs[r]))
            wq = _each(group, lambda r: torch.empty(2, Mb * N, dtype=wdtype, device=devs[r]))
            ws = _each(group, lambda r: torch.empty(2, Mb * N // qb, device=devs[r]))

        def wire(r, k):
            return (slots[r][k % 2],) if c is None else (wq[r][k % 2], ws[r][k % 2])

        events = [group.record(r) for r in range(n)]
        for k in range(n - 1):
            _record_hop(group, nbytes)
            for r in range(n):
                u, d = (r - 1) % n, (r + 1) % n
                with group.on(r):
                    group.wait(r, events[u])
                    group.wait(r, events[d])
                    up = wire(u, k - 1) if k else ()
                    group.crossed(up, r)
                    part = slots[r][k % 2] if c is None else stage[r]
                    rs_hop(x32[r], w32[r], ((r - 1 - k) % n) * Mb, up, part,
                           None if c is None else wire(r, k), qb=qb)
            events = [group.record(r) for r in range(n)]

        def final(r):
            # own row block: the last upstream partial plus the local product
            u = (r - 1) % n
            group.wait(r, events[u])
            up = wire(u, n - 2)
            group.crossed(up, r)
            own = torch.matmul(x32[r][r * Mb:(r + 1) * Mb], w32[r])
            if c is None:
                return pallas_backend.permute_leaves(list(up), devs[r])[0] + own
            pallas_backend.fused_hop(up[0], up[1], own.view(-1), None, None, None, qb=qb)
            return own

        return _each(group, final)


# -------------------------------------------------------- unfused compositions
def _unfused_all_gather_matmul(x, w_shard, group: RankGroup, *, out_block: bool = False):
    """The knob-off program: one all-gather of the fp32 shards, one product."""
    with group.joined():
        return _each(group, lambda r: _product(
            x[r], torch.cat([w.to(group.devices[r], torch.float32) for w in w_shard]), out_block))


def _unfused_matmul_reduce_scatter(x, w, group: RankGroup):
    """The knob-off program: one product, then a sum-scatter over the rows."""
    n = group.n
    M = x[0].shape[0]
    if M % n:
        raise ValueError(f"tiled reduce_scatter operand scatter dimension size {M} must be "
                         f"divisible by shard_count {n}")
    Mb = M // n
    with group.joined():
        p = _each(group, lambda r: _product(x[r], w[r]))
        events = [group.record(r) for r in range(n)]

        def scatter(r):
            for e in events:
                group.wait(r, e)
            group.crossed(p, r)
            return torch.stack([q[r * Mb:(r + 1) * Mb].to(group.devices[r]) for q in p]).sum(0)

        return _each(group, scatter)
