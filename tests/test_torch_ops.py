"""The public op entry point of the PyTorch port against the JAX package's
(``deepspeed_tpu.ops``), on the CPU, with numpy-seeded inputs.

- ``ops.layer_norm``: the forward against JAX's Pallas op (interpret mode,
  as ``tests/unit/ops/test_pallas_kernels.py`` runs it) and ``_xla_layer_norm``
  at (4, 12, 64), (8, 32), (3, 5, 4544) and channels offset by 100 (std 1),
  where a one-pass variance drifts; fp32 within 1e-5 (the order of sums
  differs), bf16 within one bf16 ulp of the output (both round once from
  fp32). The offset case is [32, 64] with values on a 1/64 grid: every
  partial sum of a row is then exact in fp32 and the divide by 64 too, so
  the mean is the same in any order and the case isolates the variance
  formula (a one-pass E[x^2] - mean^2 misses by ~2e-3 on these inputs, which
  the test asserts). With continuous values at offset 100 the fp32 mean
  alone moves by 1-4 ulps with the order of the sum: JAX's and the port's
  outputs are each 2-3e-5 from a float64 reference at [64, 768], so no two
  correct fp32 versions meet 1e-5 there. The backward: ``jax.grad`` of
  sum(sin(.)) through the Pallas op against ``torch.autograd`` through the
  port, dx, dscale and dbias within 1e-5; ``layer_norm_bwd`` against
  ``_ln_p_bwd`` itself in bf16 and with a mixed scale/bias pair (one bf16
  ulp, 1e-5 in fp32).
- The registry: every op and impl name of JAX's ``op_report()`` (with every
  JAX module that registers one imported) is the port's, so a new JAX op
  fails here until it is ported or sorted; "auto" and "flash" resolve to the
  kernel-backed wrapper wherever one is registered; an unregistered impl
  raises ``NotImplementedError``.
- Attention's "xla" impl and ``evoformer_attention`` against JAX's, with
  ALiBi, a pair bias ([H, S, S] and [B, H, S, S], with its gradient), a
  keep-mask with a fully masked batch row (which averages V over every key,
  as JAX's -1e9 fill does) and ``causal=False``: outputs and every gradient
  within 1e-5.
- ``rope`` (half-split and ``interleaved``) against JAX's, fp32 within 1e-6
  and bf16 within one ulp.
- Dispatch of the quantisers and paged attention gives what the direct
  calls give, bit for bit.
- ``env_report.report()`` runs here and lists every registered op.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.ops as jops
from deepspeed_tpu.ops.attention import causal_attention as jax_causal_attention
from deepspeed_tpu.ops.attention import evoformer_attention as jax_evoformer_attention
from deepspeed_tpu.ops.norms import _xla_layer_norm
from deepspeed_tpu.ops.pallas.norms import _ln_p_bwd
from deepspeed_tpu.ops.rope import _xla_rope, _xla_rope_interleaved
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.env_report import report
from deepspeed_tpu_torch.ops import fp_quant, norms, quant
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.transformer import flatten
from deepspeed_tpu_torch.ops import registry
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
    pallas_paged_attention,
)

from .test_torch_engine_v2 import make_model

TOL = 1e-5
JAX_PKG = Path(deepspeed_tpu.__file__).resolve().parent


def _import_jax_registrants():
    """Import every module of the JAX package that registers an op, so its
    ``op_report()`` is complete whatever else this process imported."""
    for path in sorted(JAX_PKG.rglob("*.py")):
        if re.search(r"^@register\(|^\s*register\(\"", path.read_text(), re.M):
            rel = path.relative_to(JAX_PKG.parent).with_suffix("")
            importlib.import_module(".".join(rel.parts))
    return jops.op_report()


def _bf16_ulp_close(got: np.ndarray, want: np.ndarray):
    """|got - want| <= one bf16 ulp of the larger of the two."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{int(bad.sum())} entries differ by more than one bf16 ulp"


# ------------------------------------------------------------------ layer_norm
LN_SHAPES = {"4x12x64": ((4, 12, 64), 0.0), "8x32": ((8, 32), 0.0),
             "3x5x4544": ((3, 5, 4544), 0.0), "offset 32x64": ((32, 64), 100.0)}


def _ln_inputs(shape, offset, seed=0):
    rng = np.random.default_rng(seed)
    if offset:  # std 1 on a 1/64 grid: exact row sums (see the module docstring)
        x = (offset + np.round(64 * rng.standard_normal(shape)) / 64).astype(np.float32)
    else:
        x = (3 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(LN_SHAPES))
def test_layer_norm_matches_jax(case, dtype, impl):
    shape, offset = LN_SHAPES[case]
    x, scale, bias = _ln_inputs(shape, offset)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    j = [jnp.asarray(a, jdt) for a in (x, scale, bias)]
    wants = [np.asarray(jops.dispatch("layer_norm", impl)(*j).astype(jnp.float32)),
             np.asarray(_xla_layer_norm(*j).astype(jnp.float32))]
    got = ops.layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, scale, bias)), impl=impl)
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    if offset and dtype == "fp32":  # the case tells a one-pass variance apart
        xt = torch.from_numpy(x)
        mean = xt.mean(-1, keepdim=True)
        one_pass = (xt - mean) * torch.rsqrt(xt.square().mean(-1, keepdim=True) - mean ** 2 + 1e-5)
        assert np.abs((one_pass * torch.from_numpy(scale) + torch.from_numpy(bias)).numpy()
                      - wants[0]).max() > 1e-4
    for want in wants:
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        else:
            _bf16_ulp_close(got, want)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("case", list(LN_SHAPES))
def test_layer_norm_grad_matches_jax_pallas(case, impl):
    shape, offset = LN_SHAPES[case]
    x, scale, bias = _ln_inputs(shape, offset, seed=1)

    def jax_loss(a, s, b):
        return jnp.sum(jnp.sin(jops.dispatch("layer_norm", "pallas")(a, s, b)))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, bias)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    ops.layer_norm(*t, impl=impl).sin().sum().backward()
    for got, w in zip(t, want):
        assert got.grad.dtype == torch.float32 and got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtypes", ["bf16 x, bf16 params", "bf16 x, fp32 scale, bf16 bias"])
def test_layer_norm_bwd_matches_ln_p_bwd(dtypes):
    """dscale and dbias come back in the scale's dtype, as ``_ln_p_bwd``
    casts them (``ops/pallas/norms.py:140``); autograd then casts dbias to
    the bias's dtype, with the same values."""
    x, scale, bias = _ln_inputs((6, 40, 96), 0.0, seed=2)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    sdt = ((jnp.bfloat16, torch.bfloat16) if dtypes == "bf16 x, bf16 params"
           else (jnp.float32, torch.float32))
    x2 = x.reshape(-1, x.shape[-1])
    want = _ln_p_bwd(1e-5, (jnp.asarray(x2, jnp.bfloat16), jnp.asarray(scale, sdt[0])),
                     jnp.asarray(g.reshape(x2.shape), jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    st = torch.from_numpy(scale).to(sdt[1]).requires_grad_(True)
    bt = torch.from_numpy(bias).to(torch.bfloat16).requires_grad_(True)
    direct = norms.layer_norm_bwd(xt.detach(), st.detach(), torch.from_numpy(g).to(torch.bfloat16),
                                  1e-5)
    ops.layer_norm(xt, st, bt).backward(torch.from_numpy(g).to(torch.bfloat16))
    assert (direct[1].dtype, direct[2].dtype) == (sdt[1], sdt[1])
    assert (xt.grad.dtype, st.grad.dtype, bt.grad.dtype) == (torch.bfloat16, sdt[1], torch.bfloat16)
    for got, via_autograd, w in zip(direct, (xt.grad, st.grad, bt.grad), want):
        w = np.asarray(w.astype(jnp.float32)).reshape(got.shape)
        check = (_bf16_ulp_close if got.dtype == torch.bfloat16
                 else lambda a, b: np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL))
        check(got.float().numpy(), w)
        assert torch.equal(via_autograd.float(), got.to(via_autograd.dtype).float())


# ------------------------------------------------------------------ registry
def test_registry_has_every_jax_op_and_impl():
    jax_report = _import_jax_registrants()
    port_report = ops.op_report()
    missing = sorted(set(jax_report) - set(port_report))
    assert not missing, f"JAX ops the port does not register: {missing}"
    for name, impls in jax_report.items():
        assert port_report[name] == impls, (name, port_report[name], impls)


def test_auto_resolves_to_the_kernel_wrapper_and_unknown_impls_raise():
    kernel_backed = {"causal_attention": ops.flash_causal_attention,
                     "layer_norm": norms.pallas_layer_norm,
                     "rms_norm": norms.pallas_rms_norm,
                     "paged_attention": pallas_paged_attention,
                     "quantize_int8": quant.pallas_quantize_int8,
                     "dequantize_int8": quant.pallas_dequantize_int8}
    for name, impls in ops.op_report().items():
        pallas = ops.available_impls(name).get("pallas")
        auto = ops.dispatch(name, "auto")
        assert ops.dispatch(name, "flash") is auto
        if "pallas" in impls:
            assert auto is pallas
        else:
            assert impls == ["xla"] and auto is ops.available_impls(name)["xla"]
        if name in kernel_backed:
            assert auto is kernel_backed[name]
        with pytest.raises(NotImplementedError, match=name):
            ops.dispatch(name, "triton")
    assert ops.dispatch("layer_norm", "xla") is ops.layer_norm_reference
    assert ops.dispatch("rms_norm", "xla") is ops.rms_norm_reference
    with pytest.raises(KeyError):
        ops.dispatch("no_such_op")
    x = torch.ones(2, 8)
    for call in (lambda: ops.layer_norm(x, x[0], x[0], impl="cuda"),
                 lambda: ops.rms_norm(x, x[0], impl="cuda"),
                 lambda: quant.quantize_int8(x, impl="cuda"),
                 lambda: fp_quant.quantize_fp8(x, impl="pallas"),
                 lambda: ops.rope(x[None, :, None], x[:, :4], x[:, :4],
                                  torch.zeros(1, 2, dtype=torch.int64), impl="pallas"),
                 lambda: ops.causal_attention(x[None, :, None], x[None, :, None],
                                              x[None, :, None], impl="cuda")):
        with pytest.raises(NotImplementedError):
            call()


def test_ops_exports_the_jax_entry_point():
    names = [n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n))]
    for name in names:
        assert callable(getattr(ops, name, None)), name
    assert ops.resolves_to_flash("auto") and ops.resolves_to_flash("flash")
    assert not ops.resolves_to_flash("xla") and not ops.resolves_to_flash("sparse")


def test_env_report_lists_every_op():
    text = report()
    for name, impls in ops.op_report().items():
        assert re.search(rf"op:{name}\s+{','.join(impls)}$", text, re.M), name
    assert "layer_norm.cu" in text and "torch" in text and "devices:" in text


# ------------------------------------------------------------------ attention
ATTN_CASES = {
    "alibi": dict(alibi=True),
    "pair bias [H,S,S]": dict(bias=3),
    "pair bias [B,H,S,S], alibi, masked row": dict(bias=4, alibi=True, mask=True),
    "keep-mask, fully masked row": dict(mask=True),
    "non-causal, alibi, keep-mask": dict(alibi=True, mask=True, causal=False),
}


def _attn_inputs(alibi=False, bias=None, mask=False, causal=True, B=2, S=12, H=4, kvH=2, D=8,
                 seed=0):
    rng = np.random.default_rng(seed)
    arrs = {"q": rng.standard_normal((B, S, H, D)), "k": rng.standard_normal((B, S, kvH, D)),
            "v": rng.standard_normal((B, S, kvH, D))}
    if alibi:
        arrs["alibi_slopes"] = 0.5 ** (1 + np.arange(H))
    if bias:
        arrs["bias"] = rng.standard_normal((H, S, S) if bias == 3 else (B, H, S, S))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    keep = None
    if mask:  # row 0 keeps its first 9 keys, row 1 none
        keep = np.ones((B, S), np.int32)
        keep[0, 9:] = 0
        keep[1] = 0
    return arrs, keep, causal


def _attn_grads(fn_jax, fn_port, arrs, keep):
    """Output and every input's gradient of sum(sin(out)) through both."""
    names = list(arrs)
    jkeep = None if keep is None else jnp.asarray(keep)

    def jloss(*a):
        return jnp.sum(jnp.sin(fn_jax(dict(zip(names, a)), jkeep)))

    jvals = [jnp.asarray(arrs[n]) for n in names]
    jout = fn_jax(dict(zip(names, jvals)), jkeep)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(*jvals)
    t = {n: torch.from_numpy(arrs[n]).requires_grad_(True) for n in names}
    out = fn_port(t, None if keep is None else torch.from_numpy(keep))
    out.sin().sum().backward()
    return ([out.detach().numpy()] + [t[n].grad.numpy() for n in names],
            [np.asarray(jout)] + [np.asarray(g) for g in jgrads])


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_xla_matches_jax(case):
    arrs, keep, causal = _attn_inputs(**ATTN_CASES[case])
    extra = {k: arrs[k] for k in ("alibi_slopes", "bias") if k in arrs}
    if causal:
        def fj(a, m):
            return jax_causal_attention(a["q"], a["k"], a["v"], mask=m, impl="xla",
                                        **{k: a[k] for k in extra})

        def fp(a, m):
            return ops.causal_attention(a["q"], a["k"], a["v"], mask=m, impl="xla",
                                        **{k: a[k] for k in extra})
    else:
        def fj(a, m):
            return jops.dispatch("causal_attention", "xla")(
                a["q"], a["k"], a["v"], mask=m, causal=False, **{k: a[k] for k in extra})

        def fp(a, m):
            return ops.dispatch("causal_attention", "xla")(
                a["q"], a["k"], a["v"], mask=m, causal=False, **{k: a[k] for k in extra})
    got, want = _attn_grads(fj, fp, arrs, keep)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    if keep is not None and causal:  # the fully masked row averages V over every key
        v_mean = arrs["v"][1].mean(axis=0).repeat(2, axis=0)  # [H, D], kv head h // G
        np.testing.assert_allclose(got[0][1], np.broadcast_to(v_mean, got[0][1].shape),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bias_rank", [3, 4])
def test_evoformer_attention_matches_jax(bias_rank):
    arrs, keep, _ = _attn_inputs(bias=bias_rank, mask=True, kvH=4, seed=1)
    got, want = _attn_grads(
        lambda a, m: jax_evoformer_attention(a["q"], a["k"], a["v"], pair_bias=a["bias"], mask=m),
        lambda a, m: ops.evoformer_attention(a["q"], a["k"], a["v"], pair_bias=a["bias"], mask=m),
        arrs, keep)
    for g, w in zip(got, want):  # out, dq, dk, dv, d(pair_bias)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_bias_takes_the_xla_path_from_any_impl():
    arrs, keep, _ = _attn_inputs(bias=3, mask=True)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    want = ops.xla_causal_attention(**t, mask=torch.from_numpy(keep))
    for impl in ("auto", "flash", "pallas", "xla"):
        torch.testing.assert_close(ops.causal_attention(**t, mask=torch.from_numpy(keep),
                                                        impl=impl, block_q=8), want)


# ------------------------------------------------------------------ rope
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rope_matches_jax(interleaved, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    ang = np.outer(np.arange(32), 1e4 ** (-np.arange(8) / 8)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    pos = rng.integers(0, 32, (2, 5)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jfn = _xla_rope_interleaved if interleaved else _xla_rope
    want = np.asarray(jfn(jnp.asarray(x, jdt), jnp.asarray(cos), jnp.asarray(sin),
                          jnp.asarray(pos)).astype(jnp.float32))
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(cos), torch.from_numpy(sin),
            torch.from_numpy(pos))
    outs = [ops.rope(*args, interleaved=interleaved), ops.rope(*args, impl="xla",
                                                               interleaved=interleaved)]
    if interleaved:
        outs.append(ops.rope_interleaved(*args))
    for got in outs:
        assert got.dtype == tdt
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        else:
            _bf16_ulp_close(got.float().numpy(), want)


# ------------------------------------------------------------------ quantisers, paged attention
def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
        return True
    assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1 else a,
                                              b.view(torch.uint8) if b.dtype.itemsize == 1 else b)
    return True


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_quantiser_dispatch_equals_direct_calls(impl):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 700)).astype(np.float32))
    q, s = quant.quantize_int8_reference(x, 512)
    _equal(quant.quantize_int8(x, 512, impl=impl), (q, s))
    _equal(ops.quantize_int8(x, 512, impl=impl), (q, s))
    for dtype in (torch.bfloat16, torch.float32):
        _equal(quant.dequantize_int8(q, s, x.shape, dtype, 512, impl=impl),
               quant.dequantize_int8_reference(q, s, x.shape, dtype, 512))
    if impl == "pallas":  # fp8 and int4 have only "xla", as in JAX
        with pytest.raises(NotImplementedError):
            fp_quant.quantize_fp8(x, 512, impl=impl)
        return
    f8, f8s = fp_quant.xla_quantize_fp8(x, 512)
    _equal(fp_quant.quantize_fp8(x, 512, impl=impl), (f8, f8s))
    _equal(fp_quant.dequantize_fp8(f8, f8s, torch.bfloat16, 512, impl=impl),
           fp_quant.xla_dequantize_fp8(f8, f8s, torch.bfloat16, 512))
    i4, i4s = fp_quant.xla_quantize_int4(x, 512)
    _equal(fp_quant.quantize_int4(x, 512, impl=impl), (i4, i4s))
    _equal(fp_quant.dequantize_int4(i4, i4s, torch.float32, 512, impl=impl),
           fp_quant.xla_dequantize_int4(i4, i4s, torch.float32, 512))


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_paged_attention_dispatch_equals_direct_calls(impl):
    rng = np.random.default_rng(6)
    N, C, H, kvH, hd, bs, P = 2, 3, 4, 2, 16, 4, 3
    q = torch.from_numpy(rng.standard_normal((N, C, H, hd)).astype(np.float32))
    pk, pv = (torch.from_numpy(rng.standard_normal((8 * bs, kvH, hd)).astype(np.float32))
              for _ in range(2))
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    pos = torch.tensor([[5, 6, 7], [0, 1, 2]], dtype=torch.int32)
    lens = torch.tensor([3, 3], dtype=torch.int32)
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    for extra in ({}, {"alibi_slopes": slopes}):
        want = paged_attention_reference(q, pk, pv, bt, pos, bs, lens, **extra)
        got = paged_attention(q, pk, pv, bt, pos, bs, lens, impl=impl, **extra)
        assert torch.equal(got, want)


# ------------------------------------------------------------------ model paths
@pytest.mark.parametrize("serving", [
    {}, {"kv_cache_dtype": "int8", "quant": {"enabled": True, "bits": 8, "min_leaf_size": 0}},
    {"quant": {"enabled": True, "bits": 4, "min_leaf_size": 0}}])
def test_model_paths_do_not_go_through_the_registry(monkeypatch, serving):
    """Training and serving call their kernel-backed functions (and plain
    impls) directly: with the registry emptied, a training step and a
    generation still run, with the same results as with it."""
    _, _, cfg, params = make_model()
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 97, (2, 8)))
    prompts = [ids[0, :5].numpy(), ids[1, :3].numpy()]
    conf = {"dtype": "fp32", "kv_block_size": 4, "num_kv_blocks": 64, "chunk_bucket": 8,
            **serving}

    def leaf_grads(tree):
        return {k: leaf_grads(v) if isinstance(v, dict) else v.detach().requires_grad_(True)
                for k, v in tree.items()}

    def run():
        p = leaf_grads(params)
        loss, _ = CausalLM(cfg)(p, {"input_ids": ids, "labels": ids}, train=True)
        grads = torch.autograd.grad(loss, list(flatten(p).values()))
        out = InferenceEngineV2(cfg, params, dict(conf), device="cpu").generate(
            prompts, max_new_tokens=3)
        return loss.detach(), grads, out

    want = run()
    monkeypatch.setattr(registry, "_REGISTRY", {})
    with pytest.raises(KeyError):
        ops.dispatch("rms_norm")
    got = run()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
