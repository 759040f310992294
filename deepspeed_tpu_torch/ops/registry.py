"""Op registry (counterpart of ``deepspeed_tpu/ops/registry.py``).

An op is a name with one or more implementations, kept under the JAX
package's impl names so callers' spellings carry over:

- ``"pallas"``: the port's kernel-backed wrapper. On a CUDA tensor it
  launches the hand-written kernel (``csrc/``), on a CPU tensor it runs its
  plain version, as every wrapper of the port does;
- ``"xla"``: the plain PyTorch function, the JAX package's jnp version.

``dispatch(op, "auto")`` resolves to ``"pallas"`` wherever one is registered
and to ``"xla"`` otherwise; ``"flash"`` is the model config's alias of
``"pallas"``. Unlike the JAX registry, which warns and falls back to xla, an
impl that is not registered raises ``NotImplementedError`` naming the op and
the impls it has: the port does no quiet fallback.

The op modules register themselves when imported; importing
``deepspeed_tpu_torch.ops`` imports all of them.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(op_name: str, impl: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op_name, {})[impl] = fn
        return fn

    return deco


def available_impls(op_name: str) -> Dict[str, Callable]:
    return dict(_REGISTRY.get(op_name, {}))


def dispatch(op_name: str, impl: str = "auto") -> Callable:
    """The implementation of ``op_name`` that ``impl`` names."""
    impls = _REGISTRY.get(op_name)
    if not impls:
        raise KeyError(f"No implementations registered for op {op_name!r}")
    if impl in ("auto", "flash"):
        impl = "pallas" if "pallas" in impls else "xla"
    fn = impls.get(impl)
    if fn is None:
        raise NotImplementedError(
            f"op {op_name!r} has no impl {impl!r}; registered: {sorted(impls)}")
    return fn


def op_report() -> Dict[str, List[str]]:
    """``ds_report``'s op matrix: the impls registered for each op."""
    return {name: sorted(impls) for name, impls in sorted(_REGISTRY.items())}
