"""Wire codecs: what a collective hop puts on the link (counterpart of
``deepspeed_tpu/collectives/codecs.py``).

A ``Codec`` is an encode/decode pair over **blocked rows**: a ``[R, L]``
tensor whose rows are wire units (a ring chunk, a destination row, a gather
payload); blocks never straddle rows. ``encode_rows`` pads ``L`` with zeros
to a whole number of blocks of ``min(block_size, L)`` elements and
``decode_rows`` strips the padding. The wire is a :class:`Wire` of two
tensors, the values and the per-block scales; passthrough codecs put the
(possibly cast) payload in ``q`` and an empty tensor in ``s``.

``Int8BlockCodec`` quantises through the public ``ops.quant.quantize_int8``
/ ``dequantize_int8``, the row 7/8 kernels on the card, as JAX's goes
through its op registry; ``Fp8Codec`` uses ``ops.quant``'s e4m3 block math.
Error feedback (LoCo): ``encode_rows_ef`` compensates the input with a
carried residual and returns the refreshed one (``v = x + err; wire = Q(v);
new_err = v - deQ(Q(v))``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import quant

DEFAULT_BLOCK = 2048


class Wire(NamedTuple):
    """One hop's payload: values and per-block fp32 scales."""

    q: torch.Tensor
    s: torch.Tensor


def _pad_rows(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Pad the row length up to a whole number of blocks."""
    L = x.shape[1]
    Lp = -(-L // block) * block
    if Lp != L:
        x = torch.nn.functional.pad(x, (0, Lp - L))
    return x, Lp


def _no_scales(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.float32, device=like.device)


class Codec:
    """A named, stateless encode/decode pair. ``wire_bytes(L, itemsize)`` is
    the on-wire byte count of a row; ``lossy`` gates error feedback."""

    name: str = "none"
    lossy: bool = False

    def __init__(self, block_size: int = DEFAULT_BLOCK):
        self.block_size = int(block_size)

    def wire_bytes(self, length: int, itemsize: int) -> int:
        return length * itemsize

    def encode_rows(self, x: torch.Tensor) -> Wire:
        """``[R, L] -> Wire``. Rows are independent wire units."""
        raise NotImplementedError

    def decode_rows(self, wire: Wire, length: int, dtype: torch.dtype) -> torch.Tensor:
        """``Wire -> [R, length]`` in ``dtype`` (padding stripped)."""
        raise NotImplementedError

    def encode_rows_ef(self, x: torch.Tensor, err: torch.Tensor) -> Tuple[Wire, torch.Tensor]:
        """LoCo-style compensated encode: ``(wire, refreshed residual)``. Every
        codec re-captures what its wire dropped, so ``transmitted + new_err ==
        x + err`` holds for exact ones too."""
        v = x.float() + err.float()
        wire = self.encode_rows(v if self.lossy else v.to(x.dtype))
        new_err = v - self.decode_rows(wire, x.shape[1], torch.float32)
        return wire, new_err.to(err.dtype)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(name={self.name!r}, block={self.block_size})"


class PassthroughCodec(Codec):
    """Identity wire, optionally cast to a wire dtype (bf16 / fp32)."""

    def __init__(self, name: str = "none", wire_dtype: Optional[torch.dtype] = None,
                 block_size: int = DEFAULT_BLOCK):
        super().__init__(block_size)
        self.name = name
        self.wire_dtype = wire_dtype
        # lossy iff the wire can downcast the payload (bf16 on fp32 data)
        self.lossy = wire_dtype is not None and wire_dtype.itemsize < 4

    def wire_bytes(self, length: int, itemsize: int) -> int:
        return length * (self.wire_dtype.itemsize if self.wire_dtype else itemsize)

    def encode_rows(self, x: torch.Tensor) -> Wire:
        q = x.to(self.wire_dtype) if self.wire_dtype else x
        return Wire(q=q, s=_no_scales(x))

    def decode_rows(self, wire: Wire, length: int, dtype: torch.dtype) -> torch.Tensor:
        return wire.q[:, :length].to(dtype)


class _BlockQuantCodec(Codec):
    """1-byte values + one fp32 scale per block (int8 and fp8)."""

    lossy = True

    def wire_bytes(self, length: int, itemsize: int) -> int:
        return length + 4 * -(-length // self.block_size)


class Int8BlockCodec(_BlockQuantCodec):
    """Blockwise-symmetric int8 (the qwZ/qgZ wire), through the int8 quantiser."""

    name = "int8"

    def encode_rows(self, x: torch.Tensor) -> Wire:
        R = x.shape[0]
        block = min(self.block_size, x.shape[1])
        xp, Lp = _pad_rows(x.float(), block)
        q, scale = quant.quantize_int8(xp, block_size=block)  # Lp % block == 0: row-aligned
        return Wire(q=q.reshape(R, Lp), s=scale.reshape(R, Lp // block))

    def decode_rows(self, wire: Wire, length: int, dtype: torch.dtype) -> torch.Tensor:
        R, Lp = wire.q.shape
        block = Lp // wire.s.shape[1]
        out = quant.dequantize_int8(wire.q.reshape(-1), wire.s.reshape(-1), (R, Lp),
                                    dtype=dtype, block_size=block)
        return out[:, :length]


class Fp8Codec(_BlockQuantCodec):
    """e4m3 values + one fp32 absmax scale per block."""

    name = "fp8"

    def encode_rows(self, x: torch.Tensor) -> Wire:
        R = x.shape[0]
        block = min(self.block_size, x.shape[1])
        xp, Lp = _pad_rows(x.float(), block)
        q, scale = quant.fp8_block_math(xp.reshape(R * (Lp // block), block))
        return Wire(q=q.reshape(R, Lp), s=scale.reshape(R, Lp // block))

    def decode_rows(self, wire: Wire, length: int, dtype: torch.dtype) -> torch.Tensor:
        R, Lp = wire.q.shape
        block = Lp // wire.s.shape[1]
        out = quant.fp8_block_dequant(wire.q.reshape(-1, block), wire.s.reshape(-1, 1))
        return out.reshape(R, Lp)[:, :length].to(dtype)


CODECS: Dict[str, object] = {
    "none": lambda block_size=DEFAULT_BLOCK: PassthroughCodec("none", None, block_size),
    "fp32": lambda block_size=DEFAULT_BLOCK: PassthroughCodec("fp32", torch.float32, block_size),
    "bf16": lambda block_size=DEFAULT_BLOCK: PassthroughCodec("bf16", torch.bfloat16, block_size),
    "int8": Int8BlockCodec,
    "fp8": Fp8Codec,
}


def get_codec(codec, block_size: Optional[int] = None) -> Codec:
    """Resolve a codec name (or pass a ``Codec`` instance through)."""
    if isinstance(codec, Codec):
        return codec
    if codec is None:
        codec = "none"
    try:
        factory = CODECS[codec]
    except KeyError:
        raise ValueError(f"unknown codec {codec!r} (one of {sorted(CODECS)})") from None
    return factory(block_size=block_size) if block_size else factory()
