"""Causal GQA flash attention (counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py``).

The kernels, each wrapper with its plain PyTorch version beside it:

- ``flash_fwd(qs, k, v, keep, slopes) -> (out, lse)`` replaces ``_fwd_kernel``;
- ``flash_bwd(...) -> (dq, dk, dv)`` replaces ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel`` together (the backward the autograd function runs);
- ``flash_bwd_dq(...) -> dq`` and ``flash_bwd_dkv(...) -> (dk, dv)``, the
  pair of kernels that replaced them one for one, now the backward's "mma"
  (bf16) and "simt" (fp32) forms;

each with and without ALiBi (``_alibi_add``, which ``_sub_score`` of the
three Pallas kernels calls).

Each wrapper runs its plain version (``*_reference``) on a CPU tensor and on
a CUDA tensor launches its hand-written kernel
(``csrc/flash_attention_fwd.cu``, ``flash_attention_bwd.cu``,
``flash_attention_bwd_dq.cu``, ``flash_attention_bwd_dkv.cu``) or raises. The
forward and the backward have three forms each (``FWD_FORMS``,
``BWD_FORMS``), picked by ``flash_fwd_form`` / ``flash_bwd_form`` from the
dtype: form W (``"wgmma"``: wgmma fed by TMA, warp-specialised, every bf16
input; the backward's computes dq, dk and dv in one kernel) and ``"simt"``
(fp32, a check path); the first bf16 forms (``"mma"``, mma.sync; the
backward's is the dq and dkv pair) are reached only through
``_flash_fwd_form`` / ``_flash_bwd_form``, which run one form by name (the
card's tests and timing). Each forward and backward launch counts in
``flash_fwd.launches_by_form`` / ``flash_bwd.launches_by_form`` too.
``flash_causal_attention`` ties
them together in a ``torch.autograd.Function`` with the bookkeeping of the JAX package's
``_flash_core`` and ``_flash_vjp_bwd``:

- q is pre-scaled **in q's dtype** by ``hd**-0.5 * log2(e)``; the softmax
  runs in base 2 on the pre-scaled scores and ``lse`` is base 2;
- ``delta = rowsum(dO * O)`` is computed in fp32 here, outside the kernels;
- the backward multiplies dq's fp32 sum by ``hd**-0.5`` (the exact scale,
  no ``log2e * ln2`` rounding) and dk's by ``ln 2``, both before the cast to
  the input dtype; form W adds dq's partial sums from its key tiles in an
  order that varies from run to run (dk and dv stay deterministic);
- dk and dv are summed over the G query heads of a kv head (``h // G``);
- ALiBi: ``slopes`` (fp32 ``[H]``) arrive times ``log2(e)``, as the JAX
  wrapper folds them, and are constants (no gradient, as JAX's
  ``stop_gradient``). Query head h's score of key j for query i gets
  ``slope[h] * (j - i)`` (fp32 product, then the sum) before the mask. JAX
  adds ``slope[h] * j``: the same softmax, since ``slope[h] * i`` is one
  constant per row, but the absolute form reaches ~2,000 at S 2048, where an
  fp32 ulp is 2.4e-4. ``lse`` is then JAX's less ``slope[h] * i``; the
  backward pieces take that lse and the same bias, so gradients are JAX's.
  An ALiBi launch counts in ``<wrapper>.alibi_launches``, any other in
  ``<wrapper>.launches``.

Layouts are the JAX package's ``[B, S, H, hd]`` (q) and ``[B, S, kvH, hd]``
(k, v); ``keep`` is an optional ``[B, S]`` key keep-mask (1 = keep), applied
to keys only; causality is column <= row. A row with no visible key gets
output 0, ``lse = finfo(float32).min`` and zero gradients. ``lse`` and
``delta`` are fp32 ``[B, H, S]`` (the TPU layout's 8-lane padding is dropped).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import op_builder

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
NEG_INF = float(torch.finfo(torch.float32).min)
SUPPORTED_HEAD_DIMS = (64, 128)
# Pallas scheduling knobs of the JAX kernel; the same math either way, so the
# port accepts and ignores them (as the JAX XLA path does)
_SCHEDULING_KWARGS = ("block_q", "block_k", "k_splits")
# forward form name -> the C entry's form code (csrc/flash_attention_fwd.cu, enum Form)
FWD_FORMS = {"simt": 0, "mma": 1, "wgmma": 2}
# backward forms, coded as the forward's: form W is csrc/flash_attention_bwd.cu (its
# own C entry), the others the dq and dkv pair's entries
BWD_FORMS = {"simt": 0, "mma": 1, "wgmma": 2}
# form W's fp32 dq accumulator has S rounded up to this many rows a (batch,
# head) (csrc/flash_attention_bwd.cu kPadRows)
_BWD_PAD_ROWS = 128
# the dtype each form takes (forward and backward alike)
_FORM_DTYPE = {"simt": torch.float32, "mma": torch.bfloat16, "wgmma": torch.bfloat16}


# ------------------------------------------------------------ plain versions
def _grouped(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, S, H, d] -> fp32 [B, S, kvH, G, d] (query head h = kvh * G + g)."""
    B, S, H, d = x.shape
    return x.float().reshape(B, S, kv_heads, H // kv_heads, d)


def _scores(qs: torch.Tensor, k: torch.Tensor, keep: Optional[torch.Tensor],
            slopes: Optional[torch.Tensor] = None):
    """Masked base-2 scores, fp32 ``[B, kvH, G, S, S]`` (NEG_INF where a key
    is not visible), and the visibility mask. With ``slopes`` (fp32 ``[H]``,
    times log2(e)) each score first gets ``slope[h] * (j - i)``."""
    S, kvH = qs.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(qs, kvH), k.float())
    if slopes is not None:
        pos = torch.arange(S, device=qs.device)
        rel = (pos[None, :] - pos[:, None]).float()  # [query i, key j]: j - i
        s = s + slopes.float().reshape(kvH, -1)[None, :, :, None, None] * rel
    ok = torch.ones(S, S, dtype=torch.bool, device=qs.device).tril()[None, None, None]
    if keep is not None:
        ok = ok & (keep[:, None, None, None, :] > 0)
    return torch.where(ok, s, torch.full((), NEG_INF, device=qs.device)), ok


def _probs(s: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """p = exp2(s - lse) with lse's sentinel read as 0 (masked p are 0)."""
    B, H, S = lse.shape
    kvH = s.shape[1]
    lse = lse.reshape(B, kvH, H // kvH, S, 1)
    return torch.exp2(s - torch.where(lse == NEG_INF, torch.zeros_like(lse), lse))


def flash_fwd_reference(qs, k, v, keep=None, slopes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: scores materialised in fp32.
    Returns ``(out [B, S, H, hd] in qs.dtype, lse [B, H, S] fp32)``."""
    B, S, H, hd = qs.shape
    s, _ = _scores(qs, k, keep, slopes)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - torch.where(m == NEG_INF, torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 3, 1, 2, 4)
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log2(l_safe))
    return out.reshape(B, S, H, hd).to(qs.dtype), lse.reshape(B, H, S)


def flash_bwd_dq_reference(qs, k, v, keep, do, lse, delta, slopes=None) -> torch.Tensor:
    """Plain version of the dq kernel: ``dq = (ds @ k) * hd**-0.5`` with
    ``ds = p * (dO V^T - delta)`` cast to k's dtype before the product."""
    B, S, H, hd = qs.shape
    kvH = k.shape[2]
    s, _ = _scores(qs, k, keep, slopes)
    p = _probs(s, lse)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(do, kvH), v.float())
    ds = p * (dp - delta.reshape(B, kvH, H // kvH, S, 1))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    return (dq.reshape(B, S, H, hd) * hd ** -0.5).to(qs.dtype)


def flash_bwd_dkv_reference(qs, k, v, keep, do, lse, delta,
                            slopes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dkv kernel: per query head ``dv = p^T dO`` and
    ``dk = ds^T qs`` (p and ds cast to dO's and q's dtype), summed over the
    G heads of a kv head; dk times ln 2 in fp32."""
    B, S, H, hd = qs.shape
    kvH = k.shape[2]
    s, _ = _scores(qs, k, keep, slopes)
    p = _probs(s, lse)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), _grouped(do, kvH))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(do, kvH), v.float())
    ds = p * (dp - delta.reshape(B, kvH, H // kvH, S, 1))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(qs.dtype).float(), _grouped(qs, kvH))
    return (dk * _LN2).to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(qs, k, v, keep, do, lse, delta,
                        slopes=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: ``(dq, dk, dv)`` from the dq and dkv
    plain versions."""
    dq = flash_bwd_dq_reference(qs, k, v, keep, do, lse, delta, slopes)
    return (dq, *flash_bwd_dkv_reference(qs, k, v, keep, do, lse, delta, slopes))


# ------------------------------------------------------------ kernel wrappers
def _check_slopes(qs, slopes) -> None:
    """ALiBi slopes, where given, are fp32 ``[H]``, contiguous, on q's device
    (checked on every device: the plain version would broadcast bad ones)."""
    if slopes is None:
        return
    H = qs.shape[2]
    if slopes.dtype != torch.float32 or tuple(slopes.shape) != (H,):
        raise ValueError(f"flash attention: slopes must be fp32 [{H}], got "
                         f"{slopes.dtype} {list(slopes.shape)}")
    if slopes.device != qs.device:
        raise ValueError(f"flash attention: slopes on {slopes.device}, q on {qs.device}")
    if not slopes.is_contiguous():
        raise ValueError("flash attention: slopes must be contiguous")


def _check(qs, k, v, keep, *more):
    if qs.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {qs.device}")
    if qs.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention: q [B, S, H, hd], k and v [B, S, kvH, hd] expected, got "
            f"{tuple(qs.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = qs.shape
    kvH = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"flash attention: k {tuple(k.shape)} does not match q {tuple(qs.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {hd} unsupported (one of {SUPPORTED_HEAD_DIMS})")
    if H % kvH:
        raise ValueError(f"flash attention: {H} query heads not divisible by {kvH} kv heads")
    if B > 65535 or H > 65535 or kvH > 65535 or S >= 2 ** 31 // 64:
        raise ValueError(f"flash attention: B={B}, H={H}, S={S} exceed the kernel's grid")
    if qs.dtype not in op_builder.DTYPE_CODES:
        raise TypeError(f"flash attention: dtype {qs.dtype} unsupported (fp32 | bf16)")
    tensors = [("q", qs), ("k", k), ("v", v)] + [(n, t) for n, t in more]
    for name, t in tensors:
        want = torch.float32 if name in ("lse", "delta") else qs.dtype
        if t.dtype != want:
            raise TypeError(f"flash attention: {name} dtype {t.dtype}, expected {want}")
    if keep is not None:
        if keep.shape != (B, S) or keep.dtype != torch.int32:
            raise ValueError(f"flash attention: keep must be int32 [{B}, {S}], got "
                             f"{keep.dtype} {tuple(keep.shape)}")
        tensors.append(("keep", keep))
    for name, t in tensors:
        if t.device != qs.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on {qs.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count(wrapper, slopes) -> None:
    """One launch of ``wrapper``'s kernel: an ALiBi launch counts in
    ``wrapper.alibi_launches``, any other in ``wrapper.launches``."""
    if slopes is not None:
        wrapper.alibi_launches += 1
    else:
        wrapper.launches += 1


def flash_fwd_form(dtype: torch.dtype, hd: int) -> str:
    """The forward form ``flash_fwd`` runs: form W (``"wgmma"``) for bf16,
    ``"simt"`` for fp32."""
    return _form_of(dtype, hd)


def flash_bwd_form(dtype: torch.dtype, hd: int) -> str:
    """The backward form ``flash_bwd`` runs: form W (``"wgmma"``, one kernel
    for dq, dk and dv) for bf16, ``"simt"`` (the dq and dkv pair) for fp32."""
    return _form_of(dtype, hd)


def _form_of(dtype: torch.dtype, hd: int) -> str:
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {hd} unsupported (one of {SUPPORTED_HEAD_DIMS})")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"flash attention: dtype {dtype} unsupported (fp32 | bf16)")


def _fwd_launch(qs, k, v, keep, slopes, form: str):
    """Allocate the outputs and launch forward ``form``; count the launch."""
    B, S, H, hd = qs.shape
    out = torch.empty_like(qs)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=qs.device)
    op_builder.launch("flash_attention_fwd", "ds_flash_fwd", qs.data_ptr(), k.data_ptr(),
                      v.data_ptr(), _ptr(keep), _ptr(slopes), out.data_ptr(), lse.data_ptr(),
                      B, S, H, k.shape[2], hd, op_builder.DTYPE_CODES[qs.dtype], FWD_FORMS[form],
                      torch.cuda.current_stream(qs.device).cuda_stream)
    _count(flash_fwd, slopes)
    flash_fwd.launches_by_form[form] += 1
    return out, lse


def flash_fwd(qs, k, v, keep=None, slopes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on pre-scaled ``qs``: ``(out [B, S, H, hd], lse [B, H, S] fp32)``."""
    _check_slopes(qs, slopes)
    if qs.device.type == "cpu":
        return flash_fwd_reference(qs, k, v, keep, slopes)
    _check(qs, k, v, keep)
    return _fwd_launch(qs, k, v, keep, slopes, flash_fwd_form(qs.dtype, qs.shape[3]))


def _check_form(qs, form: str, forms, slopes, k, v, keep, *more) -> None:
    """A form is named and is a kernel (so a CUDA tensor); the inputs pass
    ``_check``; q's dtype is the form's."""
    if form not in forms:
        raise ValueError(f"flash attention: unknown form {form!r}; forms are {sorted(forms)}")
    if qs.device.type != "cuda":
        raise ValueError(f"flash attention: form {form!r} is a kernel; {qs.device} tensor given")
    _check_slopes(qs, slopes)
    _check(qs, k, v, keep, *more)
    if qs.dtype != _FORM_DTYPE[form]:
        raise ValueError(f"flash attention: form {form!r} does not take {qs.dtype}")


def _flash_fwd_form(qs, k, v, keep, slopes, form: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_fwd`` through the named form, whatever ``flash_fwd_form`` would
    choose; raises ``ValueError`` for a form or dtype that does not fit and
    for a CPU tensor (a form is a kernel)."""
    _check_form(qs, form, FWD_FORMS, slopes, k, v, keep)
    return _fwd_launch(qs, k, v, keep, slopes, form)


def _dq_launch(qs, k, v, keep, do, lse, delta, slopes) -> torch.Tensor:
    """Allocate dq and launch the dq kernel of the pair (uncounted)."""
    B, S, H, hd = qs.shape
    dq = torch.empty_like(qs)
    op_builder.launch("flash_attention_bwd_dq", "ds_flash_bwd_dq", qs.data_ptr(), k.data_ptr(),
                      v.data_ptr(), _ptr(keep), _ptr(slopes), do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq.data_ptr(), B, S, H, k.shape[2], hd,
                      ctypes.c_float(hd ** -0.5), op_builder.DTYPE_CODES[qs.dtype],
                      torch.cuda.current_stream(qs.device).cuda_stream)
    return dq


def _dkv_launch(qs, k, v, keep, do, lse, delta, slopes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate dk, dv and launch the dkv kernel of the pair (uncounted)."""
    B, S, H, hd = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    op_builder.launch("flash_attention_bwd_dkv", "ds_flash_bwd_dkv", qs.data_ptr(),
                      k.data_ptr(), v.data_ptr(), _ptr(keep), _ptr(slopes), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H,
                      k.shape[2], hd, ctypes.c_float(_LN2), op_builder.DTYPE_CODES[qs.dtype],
                      torch.cuda.current_stream(qs.device).cuda_stream)
    return dk, dv


def flash_bwd_dq(qs, k, v, keep, do, lse, delta, slopes=None) -> torch.Tensor:
    """dq (already times ``hd**-0.5``, in q's dtype) by the pair's dq kernel."""
    _check_slopes(qs, slopes)
    if qs.device.type == "cpu":
        return flash_bwd_dq_reference(qs, k, v, keep, do, lse, delta, slopes)
    _check(qs, k, v, keep, ("do", do), ("lse", lse), ("delta", delta))
    dq = _dq_launch(qs, k, v, keep, do, lse, delta, slopes)
    _count(flash_bwd_dq, slopes)
    return dq


def flash_bwd_dkv(qs, k, v, keep, do, lse, delta, slopes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk times ln 2, dv), summed over each kv head's G query heads, by the
    pair's dkv kernel."""
    _check_slopes(qs, slopes)
    if qs.device.type == "cpu":
        return flash_bwd_dkv_reference(qs, k, v, keep, do, lse, delta, slopes)
    _check(qs, k, v, keep, ("do", do), ("lse", lse), ("delta", delta))
    dk, dv = _dkv_launch(qs, k, v, keep, do, lse, delta, slopes)
    _count(flash_bwd_dkv, slopes)
    return dk, dv


def _bwd_launch(qs, k, v, keep, do, lse, delta, slopes, form: str):
    """Allocate dq, dk, dv and run backward ``form``: form W's one C entry
    (its fp32 dq accumulator zeroed there, then the kernel and dq's
    conversion), or the pair's two kernels; count the launch."""
    if form == "wgmma":
        B, S, H, hd = qs.shape
        dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
        rows = -(-S // _BWD_PAD_ROWS) * _BWD_PAD_ROWS
        dq_acc = torch.empty((B, H, rows, hd), dtype=torch.float32, device=qs.device)
        op_builder.launch("flash_attention_bwd", "ds_flash_bwd", qs.data_ptr(), k.data_ptr(),
                          v.data_ptr(), _ptr(keep), _ptr(slopes), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), B, S, H, k.shape[2], hd, ctypes.c_float(hd ** -0.5),
                          ctypes.c_float(_LN2), op_builder.DTYPE_CODES[qs.dtype],
                          torch.cuda.current_stream(qs.device).cuda_stream)
    else:
        dq = _dq_launch(qs, k, v, keep, do, lse, delta, slopes)
        dk, dv = _dkv_launch(qs, k, v, keep, do, lse, delta, slopes)
    _count(flash_bwd, slopes)
    flash_bwd.launches_by_form[form] += 1
    return dq, dk, dv


def flash_bwd(qs, k, v, keep, do, lse, delta,
              slopes=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on pre-scaled ``qs``: ``(dq times hd**-0.5, dk times ln 2,
    dv)``, dk and dv summed over each kv head's G query heads."""
    _check_slopes(qs, slopes)
    if qs.device.type == "cpu":
        return flash_bwd_reference(qs, k, v, keep, do, lse, delta, slopes)
    _check(qs, k, v, keep, ("do", do), ("lse", lse), ("delta", delta))
    return _bwd_launch(qs, k, v, keep, do, lse, delta, slopes, flash_bwd_form(qs.dtype, qs.shape[3]))


def _flash_bwd_form(qs, k, v, keep, do, lse, delta, slopes, form: str):
    """``flash_bwd`` through the named form, whatever ``flash_bwd_form`` would
    choose; raises ``ValueError`` for a form or dtype that does not fit and
    for a CPU tensor (a form is a kernel)."""
    _check_form(qs, form, BWD_FORMS, slopes, k, v, keep, ("do", do), ("lse", lse),
                ("delta", delta))
    return _bwd_launch(qs, k, v, keep, do, lse, delta, slopes, form)


for _wrapper in (flash_fwd, flash_bwd, flash_bwd_dq, flash_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.alibi_launches = 0
flash_fwd.launches_by_form = dict.fromkeys(FWD_FORMS, 0)
flash_bwd.launches_by_form = dict.fromkeys(BWD_FORMS, 0)


# ------------------------------------------------------------ autograd
def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """q times ``hd**-0.5 * log2(e)``, the scale rounded to q's dtype and the
    product taken in q's dtype, as ``_flash_core`` does."""
    scale = torch.tensor(q.shape[-1] ** -0.5 * _LOG2E, dtype=q.dtype, device=q.device)
    return q * scale


# id(slopes) -> (slopes, its version, the kernels' form of it)
_SLOPES_LOG2: Dict[int, Tuple[torch.Tensor, int, torch.Tensor]] = {}


def alibi_log2(alibi_slopes: torch.Tensor) -> torch.Tensor:
    """ALiBi slopes as the kernels take them: detached (constants, as JAX's
    ``stop_gradient``), times ``log2(e)`` in fp32, contiguous. Kept per
    slopes tensor until it is changed in place: the model passes one cached
    tensor per head count and device, so a layer call launches nothing here."""
    version = -1 if alibi_slopes.is_inference() else alibi_slopes._version  # inference tensors have none
    hit = _SLOPES_LOG2.get(id(alibi_slopes))
    if hit is None or hit[1] != version or version < 0:
        if len(_SLOPES_LOG2) >= 16:
            _SLOPES_LOG2.clear()
        # the entry holds the tensor itself, so its id is not reused while kept
        hit = (alibi_slopes, version, (alibi_slopes.detach().float() * _LOG2E).contiguous())
        _SLOPES_LOG2[id(alibi_slopes)] = hit
    return hit[2]


def flash_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in fp32, ``[B, S, H, hd] -> [B, H, S]``."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, keep, slopes):
        qs = prescale_q(q).contiguous()
        k, v = k.contiguous(), v.contiguous()
        out, lse = flash_fwd(qs, k, v, keep, slopes)
        ctx.save_for_backward(qs, k, v, keep, slopes, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, keep, slopes, out, lse = ctx.saved_tensors
        do = g.to(qs.dtype).contiguous()
        delta = flash_delta(do, out)
        dq, dk, dv = flash_bwd(qs, k, v, keep, do, lse, delta, slopes)
        return dq, dk, dv, None, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           alibi_slopes: Optional[torch.Tensor] = None,
                           **kernel_kwargs) -> torch.Tensor:
    """Causal GQA attention of q ``[B, S, H, hd]`` over k, v ``[B, S, kvH, hd]``
    with an optional key keep-mask ``[B, S]`` (1 = keep) and optional ALiBi
    slopes ``[H]`` (Bloom's; constants, no gradient). Differentiable in q, k
    and v; returns ``[B, S, H, hd]`` in q's dtype."""
    unknown = sorted(set(kernel_kwargs) - set(_SCHEDULING_KWARGS))
    if unknown:
        raise TypeError(f"flash_causal_attention: unexpected keyword arguments {unknown}")
    keep = None if mask is None else (mask > 0).to(torch.int32).contiguous()
    slopes = None if alibi_slopes is None else alibi_log2(alibi_slopes)
    return _FlashAttention.apply(q, k, v, keep, slopes)


__all__ = [
    "BWD_FORMS", "FWD_FORMS", "NEG_INF", "alibi_log2", "flash_bwd", "flash_bwd_dkv",
    "flash_bwd_dkv_reference", "flash_bwd_dq", "flash_bwd_dq_reference", "flash_bwd_form",
    "flash_bwd_reference", "flash_causal_attention", "flash_delta", "flash_fwd",
    "flash_fwd_form", "flash_fwd_reference", "prescale_q",
]
