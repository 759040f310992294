"""Weight-only quantisation for inference (counterpart of
``deepspeed_tpu/inference/woq.py``, without its ZeRO-Inference offload).

A quantised weight is a ``WOQTensor``: int8, int4 or e4m3 codes plus fp32
scales over flat 2048-element blocks. Its ``.to(dtype)`` dequantises, as the
JAX wrapper's ``astype`` does, so every weight read of the serving forward
(``kernel.to(cfg.dtype)`` in ``models/transformer.py:_proj`` and
``inference/model.py:_attn_out``) takes a quantised leaf with no change:
the codes are what lives in device memory, and each dequantised matrix lives
only for its matmul. int8 dequantises through
``ops.quant.pallas_dequantize_int8`` (the hand-written kernel on the card);
int4 and fp8 through ``ops.fp_quant``'s "xla" impls, plain PyTorch as the
JAX package's jnp. Each is called directly, not through the op registry.

A leaf of the stacked ``'layers'`` subtree (``[L, ...]``) is quantised per
layer slice, so blocks never cross a layer and ``layer_slice`` (``[i]``)
yields that layer's own ``WOQTensor``: one quantiser call per layer slice.

ZeRO-Inference offload (``offload_params``, ``OffloadedTensor``, a
``WOQTensor`` with ``dev_sharding``) is not ported and raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops.fp_quant import (
    xla_dequantize_fp8,
    xla_dequantize_int4,
    xla_quantize_fp8,
    xla_quantize_int4,
)
from deepspeed_tpu_torch.ops.quant import pallas_dequantize_int8, pallas_quantize_int8

_BLOCK = 2048
_OFFLOAD = "ZeRO-Inference offload of the serving weights is not ported to PyTorch"
_FMT_BYTES = {"int8": 1.0, "fp8": 1.0, "int4": 0.5}

# Per-tensor-class selection (``QuantConfig.tensor_classes``), matched on
# quoted path tokens so that e.g. 'wo' never matches inside another name.
TENSOR_CLASSES = {
    "attn": ("'wq'", "'wk'", "'wv'", "'wo'"),
    "mlp": ("'w_up'", "'w_gate'", "'w_down'"),
    "experts": ("'experts'",),
    "lm_head": ("'lm_head'",),
}


class WOQTensor:
    """Quantised weight leaf. ``fmt``: 'int8' | 'int4' | 'fp8'; ``shape`` the
    dense shape; ``stacked``: quantised per leading slice (``q`` and ``scale``
    carry the layer dim first)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, fmt: str, shape: Sequence[int],
                 dev_sharding=None, stacked: bool = False):
        if dev_sharding is not None:
            raise NotImplementedError(_OFFLOAD)
        if fmt not in _FMT_BYTES:
            raise ValueError(f"unknown WOQ format {fmt!r}")
        self.q = q
        self.scale = scale
        self.fmt = fmt
        self._shape = tuple(shape)
        self.stacked = stacked

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def size(self) -> int:
        return torch.Size(self._shape).numel()

    def __getitem__(self, i: int) -> "WOQTensor":
        """Layer ``i`` of a stacked leaf (what ``layer_slice`` takes)."""
        if not self.stacked:
            raise TypeError("only a stacked WOQTensor can be indexed by layer")
        return WOQTensor(self.q[i], self.scale[i], self.fmt, self._shape[1:])

    def placed(self, device: torch.device) -> "WOQTensor":
        """The same codes and scales on ``device``, never cast."""
        return WOQTensor(self.q.to(device), self.scale.to(device), self.fmt, self._shape,
                         stacked=self.stacked)

    def _dequant(self, q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
        if self.fmt == "int8":
            return pallas_dequantize_int8(q, scale, shape, dtype=dtype, block_size=_BLOCK)
        if self.fmt == "int4":
            return xla_dequantize_int4(q, scale, dtype=dtype, block_size=_BLOCK).reshape(shape)
        return xla_dequantize_fp8(q, scale, dtype=dtype, block_size=_BLOCK)

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """The dense weight in ``dtype`` (the JAX wrapper's ``astype``)."""
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"WOQTensor.to takes a dtype (it dequantises), got {dtype!r}")
        if not self.stacked:
            return self._dequant(self.q, self.scale, self._shape, dtype)
        return torch.stack([self._dequant(q, s, self._shape[1:], dtype)
                            for q, s in zip(self.q, self.scale)])

    def __repr__(self) -> str:
        return f"WOQTensor({self.fmt}, shape={self._shape}, stacked={self.stacked})"


class OffloadedTensor:
    """ZeRO-Inference's host-resident dense weight: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_OFFLOAD)


def offload_params(params: Any, min_size: int = 1 << 16) -> Any:
    raise NotImplementedError(_OFFLOAD)


def _quantize_flat(x: torch.Tensor, fmt: str):
    if fmt == "int8":
        return pallas_quantize_int8(x, block_size=_BLOCK)
    if fmt == "int4":
        return xla_quantize_int4(x, block_size=_BLOCK)
    if fmt == "fp8":
        return xla_quantize_fp8(x, block_size=_BLOCK)
    raise ValueError(f"unknown WOQ format {fmt!r} (int8/int4/fp8)")


def _quantize_leaf(x: torch.Tensor, fmt: str, stacked: bool = False) -> WOQTensor:
    if not stacked:
        q, s = _quantize_flat(x, fmt)
        return WOQTensor(q, s, fmt, x.shape)
    parts = [_quantize_flat(x[i], fmt) for i in range(x.shape[0])]
    return WOQTensor(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
                     fmt, x.shape, stacked=True)


def woq_format(quant_cfg) -> str:
    """QuantConfig -> format: qtype 'fp' -> 'fp8'; else bits 8 -> 'int8',
    4 -> 'int4'."""
    if getattr(quant_cfg, "qtype", "int") == "fp" or getattr(quant_cfg, "fp8", False):
        return "fp8"
    if quant_cfg.bits == 8:
        return "int8"
    if quant_cfg.bits == 4:
        return "int4"
    raise ValueError(f"unsupported WOQ bits={quant_cfg.bits} (8 or 4)")


def _class_selected(key: str, classes) -> bool:
    if classes is None:
        return True
    for c in classes:
        if c not in TENSOR_CLASSES:
            raise ValueError(
                f"unknown WOQ tensor class {c!r} (choose from {sorted(TENSOR_CLASSES)})")
        if any(tok in key for tok in TENSOR_CLASSES[c]):
            return True
    return False


def _eligible(key: str, shape, size: int, fmt: str, min_size: int, classes) -> bool:
    """THE quantisation predicate, shared by :func:`quantize_params` and
    :func:`quantized_bytes_estimate`. ``key`` is the leaf's path in the JAX
    ``keystr`` form (``"['layers']['attn']['wq']['kernel']"``)."""
    if "embed" in key:
        return False
    if len(shape) < 2 or size < min_size:
        return False
    if shape[-1] % 2 and fmt == "int4":
        return False  # odd trailing dim: leave dense
    if "'layers'" in key and len(shape) < 3:
        return False  # a [L, n] stack quantises per row poorly; leave dense
    return _class_selected(key, classes)


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    """(keystr path, leaf) of a nested dict of parameters."""
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _map(tree: Dict[str, Any], fn, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        out[k] = _map(v, fn, path) if isinstance(v, dict) else fn(path, v)
    return out


def quantize_params(params: Dict[str, Any], fmt: str, min_size: int = 1 << 16,
                    classes: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Quantise every floating kernel of 2+ dims with ``min_size`` elements
    or more (embeddings, norm scales, biases and ``[L, n]`` stacks stay
    dense), restricted to ``classes`` of :data:`TENSOR_CLASSES` when given.
    Runs where the leaves lie: on the card through the int8 kernel."""

    def leaf(key, x):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        if not _eligible(key, x.shape, x.numel(), fmt, min_size, classes):
            return x
        return _quantize_leaf(x, fmt, stacked="'layers'" in key)

    return _map(params, leaf)


def quantized_bytes_estimate(params: Dict[str, Any], fmt: str, min_size: int = 1 << 16,
                             classes: Optional[Sequence[str]] = None, dense_itemsize: int = 2,
                             block: int = _BLOCK) -> int:
    """Device bytes the tree will occupy after :func:`quantize_params`,
    quantising nothing: a quantised leaf costs ``size * fmt_bytes +
    blocks * 4``, a dense floating leaf ``size * dense_itemsize``, any other
    leaf its own bytes."""
    total = 0
    for key, x in _leaves(params):
        size = x.numel()
        if not x.is_floating_point():
            total += size * x.element_size()
        elif _eligible(key, x.shape, size, fmt, min_size, classes):
            if "'layers'" in key and x.dim() >= 3:
                per_layer = size // x.shape[0]
                nb = x.shape[0] * -(-per_layer // min(block, max(per_layer, 1)))
            else:
                nb = -(-size // min(block, max(size, 1)))
            total += int(size * _FMT_BYTES[fmt]) + nb * 4
        else:
            total += size * dense_itemsize
    return total


def dequantize_params(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Dense copy of a quantised tree, every ``WOQTensor`` read in ``dtype``."""
    return _map(params, lambda _, x: x.to(dtype) if isinstance(x, WOQTensor) else x)


def woq_bytes(params: Dict[str, Any]) -> int:
    """Device bytes of the (quantised) tree: codes and scales of each
    ``WOQTensor``, every other leaf as it is."""
    total = 0
    for _, x in _leaves(params):
        parts = (x.q, x.scale) if isinstance(x, WOQTensor) else (x,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total
