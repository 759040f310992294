"""Block int8 quantise / dequantise (counterpart of ``deepspeed_tpu/ops/quant.py``
and the Pallas ``ops/pallas/quantizer.py``).

The shared block math is plain PyTorch on ``[nb, block]`` fp32 tiles, as the
JAX package writes it once for every user (the WOQ weights here, the
quantised KV pool in ``inference/paged.py``):

- ``int8_block_math``: symmetric absmax per block, ``scale = 1`` for an
  all-zero block else ``absmax / 127``, ``q = clip(round_half_even(x /
  scale), -127, 127)``;
- ``fp8_block_math``: ``scale = absmax / 448``, then a cast to e4m3.

Three kernel wrappers, each with its plain version (``*_reference``) beside
it. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches its hand-written kernel (``csrc/quantizer.cu``) or raises:

- ``pallas_quantize_int8(x, block_size, stochastic=False, seed=0)``
  replaces ``_quant_kernel``; with ``stochastic=True`` it calls
  ``quantize_int8_stochastic``, which replaces ``_quant_kernel_stochastic``;
- ``pallas_dequantize_int8(values, scales, shape, dtype, block_size)``
  replaces ``_dequant_kernel``.

The two are the "pallas" impls of the registry's ``quantize_int8`` and
``dequantize_int8``, the plain versions their "xla" impls (nearest rounding
only, as JAX's jnp fallback). The public ``quantize_int8`` and
``dequantize_int8`` pick one by ``impl`` ("auto": the wrapper); WOQ calls
the wrappers directly. Launches count in ``quantize_int8.launches``,
``quantize_int8_stochastic.launches`` and ``dequantize_int8.launches``.

The flat input is padded with zeros to whole blocks of ``min(block_size,
n)`` elements and the outputs are cut back to ``n``, as in
``quantizer.py:65-133``; the kernels read the padded tail as zeros without
padding anything in memory.

Stochastic rounding draws one uniform per element from a counter-based hash
of (seed, flat element index) (``_uniform_bits``: a murmur3 finaliser),
written out here in int64 ops masked to 32 bits and in ``quantizer.cu`` in
uint32 arithmetic, so kernel and plain version agree bit for bit. The JAX
kernel draws from the TPU's own PRNG (``pltpu.prng_random_bits``) and off the
TPU falls back to nearest rounding (``quantizer.py:76``), so no bitwise parity
with JAX exists for this form: it is held to the same rule
``q = clip(floor(x / scale + u), -127, 127)`` with ``u = (bits >> 8) *
2**-24``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.registry import dispatch, register

DEFAULT_BLOCK = 2048
FP8_MAX = 448.0  # float8_e4m3fn max normal
_MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------ block math
def block_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``1`` for an all-zero block, else ``absmax / qmax`` by IEEE division.
    The divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by the scalar's reciprocal, which can land one ulp away."""
    return torch.where(absmax == 0, torch.ones_like(absmax),
                       absmax / torch.full_like(absmax, qmax))


def int8_block_math(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[nb, block] fp32 -> (int8 values [nb, block], fp32 scales [nb, 1])``."""
    scale = block_scale(x2.abs().amax(dim=-1, keepdim=True), 127.0)
    q = torch.round(x2 / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def int8_block_dequant(q2: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`int8_block_math` (fp32 out; the caller casts)."""
    return q2.float() * scale


def fp8_block_math(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[nb, block] fp32 -> (e4m3 values, fp32 scales [nb, 1])``."""
    scale = block_scale(x2.abs().amax(dim=-1, keepdim=True), FP8_MAX)
    return (x2 / scale).to(torch.float8_e4m3fn), scale


def fp8_block_dequant(q2: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q2.float() * scale


# ------------------------------------------------------------ the hash
def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 ``a`` in [0, 2**32): two 16-bit halves of
    ``b`` keep every product below 2**48."""
    lo = (a * (b & 0xFFFF)) & _MASK32
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser (a bijection on uint32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _seed_key(seed: int) -> int:
    """The per-call key: fmix32 of the seed's low 32 bits (host side)."""
    return int(_fmix32(torch.tensor([int(seed) & _MASK32], dtype=torch.int64))[0])


def _uniform_bits(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """32 random bits per flat element index ``idx`` (int64):
    ``fmix32(fmix32(lo32(idx) ^ key) ^ hi32(idx))`` with ``key =
    fmix32(seed)``. ``csrc/quantizer.cu:uniform_bits`` computes the same."""
    h = _fmix32((idx & _MASK32) ^ _seed_key(seed))
    return _fmix32(h ^ ((idx >> 32) & _MASK32))


# ------------------------------------------------------------ plain versions
def _blocked(x: torch.Tensor, block_size: int):
    flat = x.reshape(-1).float()
    n = flat.numel()
    block = min(block_size, n)
    nb = -(-n // block)
    if nb * block != n:
        flat = torch.nn.functional.pad(flat, (0, nb * block - n))
    return flat.reshape(nb, block), n, block


def _padded(flat: torch.Tensor, scales: torch.Tensor, block_size: int):
    """Flat values -> ``[nb, block]`` (zero-padded; ``nb`` = the number of
    scales) and ``n``."""
    n = flat.numel()
    block = min(block_size, n)
    nb = scales.numel()
    if nb * block != n:
        flat = torch.nn.functional.pad(flat, (0, nb * block - n))
    return flat.reshape(nb, block), n


def quantize_int8_reference(x: torch.Tensor, block_size: int = DEFAULT_BLOCK):
    x2, n, _ = _blocked(x, block_size)
    q, scale = int8_block_math(x2)
    return q.reshape(-1)[:n], scale.reshape(-1)


def quantize_int8_stochastic_reference(x: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                                       seed: int = 0):
    x2, n, _ = _blocked(x, block_size)
    scale = block_scale(x2.abs().amax(dim=-1, keepdim=True), 127.0)
    idx = torch.arange(x2.numel(), dtype=torch.int64, device=x2.device).reshape(x2.shape)
    u = (_uniform_bits(idx, seed) >> 8).float() * (1.0 / (1 << 24))
    q = torch.floor(x2 / scale + u).clamp_(-127, 127).to(torch.int8)
    return q.reshape(-1)[:n], scale.reshape(-1)


@register("quantize_int8", "xla")
def _xla_quantize_int8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK, stochastic: bool = False,
                       seed: int = 0):
    del stochastic, seed  # nearest rounding only, as JAX's jnp fallback
    return quantize_int8_reference(x, block_size)


@register("dequantize_int8", "xla")
def dequantize_int8_reference(values: torch.Tensor, scales: torch.Tensor, shape: Sequence[int],
                              dtype: torch.dtype = torch.bfloat16,
                              block_size: int = DEFAULT_BLOCK) -> torch.Tensor:
    v2, n = _padded(values.reshape(-1).float(), scales, block_size)
    return int8_block_dequant(v2, scales.reshape(-1, 1).float()).reshape(-1)[:n].reshape(
        tuple(shape)).to(dtype)


# ------------------------------------------------------------ kernel wrappers
def _check_block(block_size: int, n: int, what: str) -> int:
    if block_size <= 0:
        raise ValueError(f"{what}: block_size must be positive, got {block_size}")
    if n == 0:
        raise ValueError(f"{what}: empty input")
    block = min(block_size, n)
    if block >= 2 ** 31:
        raise ValueError(f"{what}: block {block} exceeds the kernel's int range")
    return block


def _launch_quant(x: torch.Tensor, block_size: int, stochastic: bool, seed: int):
    what = "quantize_int8_stochastic" if stochastic else "quantize_int8"
    if x.dtype not in op_builder.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} unsupported (fp32 | bf16)")
    flat = x.reshape(-1).contiguous()
    n = flat.numel()
    block = _check_block(block_size, n, what)
    nb = -(-n // block)
    vals = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    lib = op_builder.load("quantizer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = op_builder.DTYPE_CODES[x.dtype]
    if stochastic:
        err = lib.ds_quantize_int8_stochastic(flat.data_ptr(), n, block, code, vals.data_ptr(),
                                              scales.data_ptr(), _seed_key(seed), stream)
    else:
        err = lib.ds_quantize_int8(flat.data_ptr(), n, block, code, vals.data_ptr(),
                                   scales.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return vals, scales


def quantize_int8_stochastic(x: torch.Tensor, block_size: int = DEFAULT_BLOCK, seed: int = 0):
    """Flat symmetric int8 block quantisation with stochastic rounding from
    ``seed``: ``(values int8 [n], scales fp32 [nb])``."""
    if x.device.type == "cpu":
        return quantize_int8_stochastic_reference(x, block_size, seed)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_stochastic: unsupported device {x.device}")
    out = _launch_quant(x, block_size, True, seed)
    quantize_int8_stochastic.launches += 1
    return out


@register("quantize_int8", "pallas")
def pallas_quantize_int8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                         stochastic: bool = False, seed: int = 0):
    """Flat symmetric int8 block quantisation: ``(values int8 [n], scales fp32
    [nb])``, nearest rounding (half to even) unless ``stochastic``."""
    if stochastic:
        return quantize_int8_stochastic(x, block_size, seed)
    if x.device.type == "cpu":
        return quantize_int8_reference(x, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: unsupported device {x.device}")
    out = _launch_quant(x, block_size, False, seed)
    quantize_int8.launches += 1
    return out


@register("dequantize_int8", "pallas")
def pallas_dequantize_int8(values: torch.Tensor, scales: torch.Tensor, shape: Sequence[int],
                           dtype: torch.dtype = torch.bfloat16,
                           block_size: int = DEFAULT_BLOCK) -> torch.Tensor:
    """int8 codes times their block's scale, rounded once to ``dtype``, in
    ``shape``."""
    if values.device.type == "cpu":
        return dequantize_int8_reference(values, scales, shape, dtype, block_size)
    if values.device.type != "cuda":
        raise ValueError(f"dequantize_int8: unsupported device {values.device}")
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_int8: values must be int8 and scales fp32, got "
                        f"{values.dtype}, {scales.dtype}")
    if dtype not in op_builder.DTYPE_CODES:
        raise TypeError(f"dequantize_int8: output dtype {dtype} unsupported (fp32 | bf16)")
    if scales.device != values.device:
        raise ValueError(f"dequantize_int8: scales on {scales.device}, values on {values.device}")
    n = values.numel()
    block = _check_block(block_size, n, "dequantize_int8")
    if scales.numel() != -(-n // block):
        raise ValueError(f"dequantize_int8: {scales.numel()} scales for {n} values in blocks "
                         f"of {block}")
    shape = tuple(shape)
    if torch.Size(shape).numel() != n:
        raise ValueError(f"dequantize_int8: shape {shape} does not hold {n} values")
    vals = values.reshape(-1).contiguous()
    sc = scales.reshape(-1).contiguous()
    out = torch.empty(shape, dtype=dtype, device=values.device)
    lib = op_builder.load("quantizer")
    err = lib.ds_dequantize_int8(vals.data_ptr(), sc.data_ptr(), n, block,
                                 op_builder.DTYPE_CODES[dtype], out.data_ptr(),
                                 torch.cuda.current_stream(values.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequantize_int8 kernel launch failed: cudaError {err}")
    dequantize_int8.launches += 1
    return out


def quantize_int8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK, stochastic: bool = False,
                  seed: int = 0, impl: str = "auto"):
    """The registry's ``quantize_int8``: "pallas" (``auto``) or "xla"."""
    return dispatch("quantize_int8", impl)(x, block_size, stochastic, seed)


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, shape: Sequence[int],
                    dtype: torch.dtype = torch.bfloat16, block_size: int = DEFAULT_BLOCK,
                    impl: str = "auto") -> torch.Tensor:
    """The registry's ``dequantize_int8``: "pallas" (``auto``) or "xla"."""
    return dispatch("dequantize_int8", impl)(values, scales, shape, dtype, block_size)


quantize_int8.launches = 0
quantize_int8_stochastic.launches = 0
dequantize_int8.launches = 0
