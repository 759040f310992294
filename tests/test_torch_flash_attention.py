"""Flash attention of the PyTorch port against the JAX package, on the CPU.

On the CPU the port's ``flash_causal_attention`` runs its three plain
versions (forward, dq, dkv) inside its ``autograd.Function``. Its output and
its q/k/v gradients for one numpy-seeded cotangent are held to the JAX
package's flash path (the Pallas kernels in interpret mode, as
``tests/unit/ops/test_pallas_kernels.py`` runs them) and to its XLA path,
and each plain piece to the JAX kernels' own values: ``lse`` of
``_flash_fwd``, and dq, dk, dv of ``_flash_bwd`` with the wrapper's
``hd**-0.5`` and ``ln 2`` applied. Cases: S 64 and 100 (not a multiple of
the 32-row blocks), MHA and G = 4, hd 16 and 32, with and without a
right-padding keep-mask. fp32, tolerance 1e-5 (the order of sums differs).

ALiBi (Bloom's slopes for 4 heads): the same comparisons with
``alibi_slopes``, against JAX's kernels run with ``alibi=True`` and its XLA
path, at S 64 and 100, kv heads 4 and 1, with and without the keep-mask, and
left-padded. The port adds ``slope * log2(e) * (j - i)`` where JAX adds
``slope * log2(e) * j``: the same softmax, so outputs and gradients agree,
and the port's lse plus ``slope * log2(e) * i`` is JAX's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops as jops
from deepspeed_tpu.ops.attention import _xla_causal_attention
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import register_all
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import causal_attention

register_all()

TOL = 1e-5
BLOCK = 32


def _inputs(S, kvH, hd, masked, B=2, H=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kvH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kvH, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    mask = None
    if masked:  # right padding: row 1 keeps its first 3/4 of the keys
        mask = np.ones((B, S), np.int32)
        mask[1, (3 * S) // 4:] = 0
    return q, k, v, do, mask


def _slopes(alibi, H=4):
    """Bloom's ALiBi slopes for H heads (numpy fp32), or None."""
    return np.array(jax_alibi_slopes(H)) if alibi else None


def _port(q, k, v, do, mask, slopes=None):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = causal_attention(qt, kt, vt, mask=None if mask is None else torch.from_numpy(mask),
                           alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
                           block_q=BLOCK, block_k=BLOCK)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


def _jax(fn, q, k, v, do, mask):
    m = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, m), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _jax_flash(q, k, v, do, mask, slopes=None):
    """JAX's flash path (Pallas kernels in interpret mode), with ALiBi slopes
    where given."""
    pallas = jops.dispatch("causal_attention", "pallas")
    extra = {} if slopes is None else {"alibi_slopes": jnp.asarray(slopes)}
    return _jax(lambda a, b, c, m: pallas(a, b, c, mask=m, block_q=BLOCK, block_k=BLOCK, **extra),
                q, k, v, do, mask)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


CASES = [(S, kvH, hd, masked) for S in (64, 100) for kvH in (4, 1) for hd in (16, 32)
         for masked in (False, True)]
ALIBI_CASES = [(S, kvH, 16, masked) for S in (64, 100) for kvH in (4, 1)
               for masked in (False, True)]


@pytest.mark.parametrize("S,kvH,hd,masked,alibi", [
    pytest.param(*c, False, id="-".join(map(str, c))) for c in CASES] + [
    pytest.param(*c, True, id="alibi-" + "-".join(map(str, c))) for c in ALIBI_CASES])
def test_flash_matches_jax_flash_and_xla(S, kvH, hd, masked, alibi):
    q, k, v, do, mask = _inputs(S, kvH, hd, masked)
    slopes = _slopes(alibi)
    got = _port(q, k, v, do, mask, slopes)
    want_flash = _jax_flash(q, k, v, do, mask, slopes)
    extra = {} if slopes is None else {"alibi_slopes": jnp.asarray(slopes)}
    want_xla = _jax(lambda a, b, c, m: _xla_causal_attention(a, b, c, mask=m, **extra),
                    q, k, v, do, mask)
    for g, wf, wx in zip(got, want_flash, want_xla):
        _close(g, wf)
        _close(g, wx)


@pytest.mark.parametrize("S,kvH,masked,alibi", [
    pytest.param(64, 1, True, False, id="64-1-True"),
    pytest.param(100, 4, False, False, id="100-4-False"),
    pytest.param(64, 1, True, True, id="alibi-64-1-True"),
    pytest.param(100, 4, False, True, id="alibi-100-4-False"),
    pytest.param(100, 1, True, True, id="alibi-100-1-True")])
def test_plain_pieces_match_jax_kernels(S, kvH, masked, alibi):
    """lse, dq, dk and dv of the port's plain versions against the JAX
    kernels' own outputs (interpret mode) on the same pre-scaled q. With
    ALiBi both take the slopes times log2(e); the port's lse plus
    ``slope * log2(e) * i`` is compared with JAX's."""
    hd = 16
    q, k, v, do, mask = _inputs(S, kvH, hd, masked)
    keep = np.ones((q.shape[0], S), np.int32) if mask is None else mask
    qs = fa.prescale_q(torch.from_numpy(q))
    kt, vt, dot = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do)
    keep_t = None if mask is None else torch.from_numpy(mask)
    slopes = None if not alibi else fa.alibi_log2(torch.from_numpy(_slopes(alibi, q.shape[2])))
    out, lse = fa.flash_fwd(qs, kt, vt, keep_t, slopes)
    delta = fa.flash_delta(dot, out)
    dq = fa.flash_bwd_dq(qs, kt, vt, keep_t, dot, lse, delta, slopes)
    dk, dv = fa.flash_bwd_dkv(qs, kt, vt, keep_t, dot, lse, delta, slopes)

    # the JAX kernels on [B, H, S, hd], S padded to the block as its wrapper pads
    Sp = -(-S // BLOCK) * BLOCK
    pad = lambda a: np.pad(a, ((0, 0), (0, Sp - S), (0, 0), (0, 0))).transpose(0, 2, 1, 3)  # noqa: E731
    jq, jk, jv, jdo = (jnp.asarray(pad(a)) for a in (qs.numpy(), k, v, do))
    jkeep = jnp.asarray(np.pad(keep, ((0, 0), (0, Sp - S))))[:, None, :]
    H = q.shape[2]
    jslopes = (jnp.zeros((H, 8), jnp.float32) if slopes is None
               else jnp.broadcast_to(jnp.asarray(slopes.numpy())[:, None], (H, 8)))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, jkeep, jslopes, BLOCK, BLOCK, True, masked, alibi)
    jdq, jdk, jdv = jfa._flash_bwd(jq, jk, jv, jkeep, jslopes, jout, jlse, jdo, BLOCK, BLOCK,
                                   True, masked, alibi)
    unpad = lambda a: np.asarray(a)[:, :, :S].transpose(0, 2, 1, 3)  # noqa: E731
    _close(out.numpy(), unpad(jout))
    lse = lse.numpy()
    if alibi:  # back to JAX's absolute form on the rows that see a key
        lse = np.where(lse == fa.NEG_INF, lse,
                       lse + slopes.numpy()[None, :, None] * np.arange(S, dtype=np.float32))
    _close(lse, np.asarray(jlse)[:, :, :S, 0])
    _close(dq.numpy(), unpad(jdq) * hd ** -0.5)
    _close(dk.numpy(), unpad(jdk) * jfa._LN2)
    _close(dv.numpy(), unpad(jdv))


def test_scheduling_kwargs_accepted_alibi_and_bias_refused():
    """Scheduling knobs change nothing; ALiBi slopes are accepted (and
    change the output). A dense pair bias and ``impl="xla"`` once raised:
    they now run the op's plain "xla" impl (held to JAX's XLA path in
    ``test_torch_ops.py``), which agrees with the flash path where no row is
    fully masked. An unregistered impl and an unknown keyword raise."""
    q, k, v, _, _ = _inputs(16, 2, 16, False)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    base = causal_attention(qt, kt, vt)
    torch.testing.assert_close(causal_attention(qt, kt, vt, block_q=8, block_k=8, k_splits=2), base)
    slopes = torch.from_numpy(_slopes(True))
    alibi = causal_attention(qt, kt, vt, alibi_slopes=slopes)
    torch.testing.assert_close(causal_attention(qt, kt, vt, alibi_slopes=slopes, block_q=8), alibi)
    assert alibi.shape == base.shape and not torch.allclose(alibi, base)
    torch.testing.assert_close(causal_attention(qt, kt, vt, impl="xla", block_q=8), base,
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(causal_attention(qt, kt, vt, impl="xla", alibi_slopes=slopes),
                               alibi, rtol=TOL, atol=TOL)
    torch.testing.assert_close(causal_attention(qt, kt, vt, bias=torch.zeros(4, 16, 16)), base,
                               rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError):
        causal_attention(qt, kt, vt, impl="triton")
    with pytest.raises(TypeError):
        causal_attention(qt, kt, vt, block_m=8)


@pytest.mark.parametrize("S,kvH,alibi", [
    pytest.param(64, 4, False, id="64-4"), pytest.param(100, 1, False, id="100-1"),
    pytest.param(100, 4, True, id="alibi-100-4")])
def test_left_padded_rows_match_jax_flash(S, kvH, alibi):
    """Left padding: row 1 drops its first S/4 keys, so its first S/4 queries
    see no key at all. The port gives them output 0 and zero gradients, as
    JAX's flash kernels (interpret mode) do; every other value within 1e-5;
    with ALiBi too."""
    q, k, v, do, _ = _inputs(S, kvH, 16, False)
    mask = np.ones((q.shape[0], S), np.int32)
    mask[1, : S // 4] = 0
    slopes = _slopes(alibi)
    got = _port(q, k, v, do, mask, slopes)
    want = _jax_flash(q, k, v, do, mask, slopes)
    for g, w in zip(got, want):
        _close(g, w)
    out, dq = got[0], got[1]
    assert np.all(out[1, : S // 4] == 0) and np.all(dq[1, : S // 4] == 0)
    assert np.all(want[0][1, : S // 4] == 0)


def test_alibi_log2_is_kept_per_slopes_tensor():
    """The kernels' form of the slopes is made once per slopes tensor (the
    model's come cached per head count and device), and made anew after the
    tensor is changed in place."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    natural = alibi_slopes(4)
    scaled = fa.alibi_log2(natural)
    assert fa.alibi_log2(natural) is scaled
    np.testing.assert_array_equal(scaled.numpy(), (natural * np.log2(np.e)).numpy())
    other = natural.clone()
    assert fa.alibi_log2(other) is not scaled
    other.mul_(2.0)
    np.testing.assert_allclose(fa.alibi_log2(other).numpy(), 2 * scaled.numpy(), rtol=1e-7)


def test_flash_fwd_form_choices():
    """The forward's form follows the dtype alone: form W ("wgmma") for
    bf16 at both head dims, the SIMT form for fp32; the mma.sync form is
    never picked. Other head dims and dtypes raise."""
    for hd in fa.SUPPORTED_HEAD_DIMS:
        assert fa.flash_fwd_form(torch.bfloat16, hd) == "wgmma"
        assert fa.flash_fwd_form(torch.float32, hd) == "simt"
    with pytest.raises(ValueError):
        fa.flash_fwd_form(torch.bfloat16, 96)
    with pytest.raises(TypeError):
        fa.flash_fwd_form(torch.float16, 64)
    assert set(fa.FWD_FORMS) == {"simt", "mma", "wgmma"}
    assert set(fa.flash_fwd.launches_by_form) == set(fa.FWD_FORMS)


def test_flash_fwd_launches_by_form_sum_to_launches(monkeypatch):
    """Each forward launch counts once in its form and once in ``launches``
    or ``alibi_launches``, and passes its form's code to the C entry. The
    launcher is stubbed: there is no card here."""
    calls = []
    monkeypatch.setattr(fa.op_builder, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(fa.flash_fwd, "launches", 3)
    monkeypatch.setattr(fa.flash_fwd, "alibi_launches", 2)
    monkeypatch.setattr(fa.flash_fwd, "launches_by_form", {"simt": 4, "mma": 0, "wgmma": 1})
    qs = torch.zeros(1, 5, 4, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 5, 2, 64, dtype=torch.bfloat16)
    slopes = torch.ones(4)
    order = [("wgmma", None), ("wgmma", slopes), ("mma", None), ("simt", slopes), ("wgmma", None)]
    for form, sl in order:
        out, lse = fa._fwd_launch(qs, k, v, None, sl, form)
        assert out.shape == qs.shape and out.dtype == qs.dtype
        assert lse.shape == (1, 4, 5) and lse.dtype == torch.float32
    assert [(a[-3], a[-2]) for a in calls] == [
        (fa.op_builder.DTYPE_CODES[torch.bfloat16], fa.FWD_FORMS[f]) for f, _ in order]
    assert fa.flash_fwd.launches_by_form == {"simt": 5, "mma": 1, "wgmma": 4}
    assert (fa.flash_fwd.launches, fa.flash_fwd.alibi_launches) == (6, 4)
    assert sum(fa.flash_fwd.launches_by_form.values()) == (fa.flash_fwd.launches
                                                           + fa.flash_fwd.alibi_launches)


# ---- form W's turn order (csrc/flash_attention_fwd.cu): a model on the CPU.
# The consumer warpgroups take turns at the tensor cores through named
# barriers: warpgroup w waits (bar.sync) on barrier 1 + w and another
# warpgroup hands it the turn (bar.arrive); each barrier counts 256 threads,
# one warpgroup's sync and one other's arrival. A miscount hangs the launch
# (bar.sync does not trap), so the order is checked here first, over every
# interleaving of the warpgroups, for every first query row q0 of a block.
_FWD_SOURCE = Path(fa.__file__).resolve().parent.parent / "csrc" / "flash_attention_fwd.cu"
# the kernel's lines that the model mirrors, whitespace aside
_TURN_ORDER_SOURCE = """
  if (kPP && wg == kWG - 1) bar_arrive(1, 256);  // warpgroup 0 takes the first turn
  const auto tiles_of = [&](int w) {
    const int last = q0 + 64 * w + 63;
    return last < 0 ? 1 : last / kBN + 1;
  };
  const int my_tiles = tiles_of(wg);
  const auto take_turn = [&](int r) {
    if (kPP && !(wg == kWG - 1 && r >= 1 && tiles_of(kWG - 2) < r)) bar_sync(1 + wg, 256);
  };
  const auto hand_over = [&](int r) {
    if (!kPP) return;
    if (wg < kWG - 1) {
      bar_arrive(2 + wg, 256);
    } else if (r < my_tiles) {
      int next = 0;
      while (tiles_of(next) <= r) ++next;
      if (next != wg) bar_arrive(1 + next, 256);
    }
  };
"""
_KBN = 128  # keys a step


def _tiles_of(q0, w):
    last = q0 + 64 * w + 63
    return 1 if last < 0 else last // _KBN + 1


def _hand_over_ok(q0, wg, n_wg, r):
    """The kernel's ``hand_over(r)``: the barrier warpgroup ``wg`` arrives at, or None."""
    if wg < n_wg - 1:
        return 2 + wg
    if r < _tiles_of(q0, wg):
        nxt = 0
        while _tiles_of(q0, nxt) <= r:
            nxt += 1
        if nxt != wg:
            return 1 + nxt
    return None


def _hand_over_always_next(q0, wg, n_wg, r):
    """A wrong order: the last warpgroup hands warpgroup 0 the turn every
    round, even after warpgroup 0's last tile."""
    return 2 + wg if wg < n_wg - 1 else (1 if r < _tiles_of(q0, wg) else None)


def _turn_program(q0, wg, n_wg, hand_over):
    """Warpgroup ``wg``'s barrier operations in order: ("sync" | "arrive", id)."""
    ops = [("arrive", 1)] if wg == n_wg - 1 else []  # warpgroup 0 takes the first turn
    # turn r = 0 .. my_tiles: tile 0's Q K^T, tile r's Q K^T with tile r - 1's
    # P V, the last tile's P V; each a take_turn(r), the products, a hand_over(r)
    for r in range(_tiles_of(q0, wg) + 1):
        if not (wg == n_wg - 1 and r >= 1 and _tiles_of(q0, n_wg - 2) < r):
            ops.append(("sync", 1 + wg))
        to = hand_over(q0, wg, n_wg, r)
        if to is not None:
            ops.append(("arrive", to))
    return ops


def _turn_order_fault(q0, n_wg, hand_over=_hand_over_ok):
    """Every interleaving of the warpgroups' barrier operations: None if each
    ``bar.sync`` meets exactly one arrival from another warpgroup, no barrier
    ever holds two arrivals with no warpgroup waiting, and every warpgroup
    ends; else what went wrong."""
    progs = [_turn_program(q0, wg, n_wg, hand_over) for wg in range(n_wg)]
    # state: each warpgroup's next operation and whether it waits at a
    # bar.sync; each barrier's arrivals not yet met by a sync
    start = (tuple(0 for _ in progs), tuple(False for _ in progs), tuple(0 for _ in range(n_wg + 1)))
    seen, todo = {start}, [start]
    while todo:
        pcs, waiting, pending = todo.pop()
        moves = []
        for wg, prog in enumerate(progs):
            if waiting[wg] or pcs[wg] == len(prog):
                continue
            kind, bar = prog[pcs[wg]]
            pc, wt, pd = list(pcs), list(waiting), list(pending)
            if kind == "sync":
                if bar != 1 + wg:
                    return f"warpgroup {wg} waits on barrier {bar}, not its own"
                if pd[bar]:  # the arrival came first: the barrier completes
                    pd[bar], pc[wg] = 0, pc[wg] + 1
                else:
                    wt[wg] = True
            else:
                if bar == 1 + wg:
                    return f"warpgroup {wg} arrives at its own barrier {bar}"
                pc[wg] += 1
                owner = bar - 1
                if owner < n_wg and wt[owner]:  # the owner waits: the barrier completes
                    wt[owner], pc[owner] = False, pc[owner] + 1
                else:
                    pd[bar] += 1
                    if pd[bar] > 1:
                        return f"barrier {bar} holds two arrivals with no warpgroup waiting"
            moves.append((tuple(pc), tuple(wt), tuple(pd)))
        if not moves and not all(pc == len(p) for pc, p in zip(pcs, progs)):
            return f"deadlock at operations {pcs} (waiting {waiting})"
        if not moves and any(pending):
            return f"arrivals left unmet at the end: {pending}"
        for state in moves:
            if state not in seen:
                seen.add(state)
                todo.append(state)
    return None


def test_form_w_turn_order_source_is_the_modelled_one():
    """The model below mirrors these lines of form W; a change to them must
    change the model too (and pass it) before the kernel runs on a card."""
    text = _FWD_SOURCE.read_text()
    for line in _TURN_ORDER_SOURCE.strip().splitlines():
        assert " ".join(line.split()) in " ".join(text.split()), line


@pytest.mark.parametrize("n_wg", [2, 3])
def test_form_w_turn_order_never_hangs(n_wg):
    """Two consumer warpgroups (hd 128) and three (hd 64): over every first
    row q0 of a block (a partial first tile, q0 < 0, and two 128-row periods
    of the tile counts), every barrier balances in every interleaving."""
    faults = {q0: _turn_order_fault(q0, n_wg) for q0 in range(1 - 64 * n_wg, 2 * _KBN)}
    assert {q0: f for q0, f in faults.items() if f} == {}


def test_form_w_turn_order_model_finds_a_wrong_order():
    """The model is not vacuous: handing warpgroup 0 a turn after its last
    tile leaves an arrival unmet or two pending where the tile counts differ."""
    faults = [_turn_order_fault(q0, 3, _hand_over_always_next) for q0 in range(-191, 256)]
    assert any(faults)
    assert _turn_order_fault(0, 3, _hand_over_always_next) is not None


def test_cpu_flash_fwd_takes_the_plain_version(monkeypatch):
    """A CPU tensor takes ``flash_fwd_reference`` with no launch of any
    form, every counter unchanged, with and without ALiBi; a form by name
    refuses a CPU tensor (a form is a kernel), as it refuses an unknown form."""
    plain_calls = []
    real_plain = fa.flash_fwd_reference
    monkeypatch.setattr(fa, "flash_fwd_reference",
                        lambda *a: plain_calls.append(1) or real_plain(*a))
    q, k, v, _, mask = _inputs(40, 2, 16, True)
    qs, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    keep = torch.from_numpy(mask)
    slopes = fa.alibi_log2(torch.from_numpy(_slopes(True)))
    before = (fa.flash_fwd.launches, fa.flash_fwd.alibi_launches,
              dict(fa.flash_fwd.launches_by_form))
    for sl in (None, slopes):
        out, lse = fa.flash_fwd(qs, kt, vt, keep, sl)
        want, want_lse = real_plain(qs, kt, vt, keep, sl)
        assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert plain_calls == [1, 1]
    assert (fa.flash_fwd.launches, fa.flash_fwd.alibi_launches,
            dict(fa.flash_fwd.launches_by_form)) == before
    for form in list(fa.FWD_FORMS) + ["wmma"]:
        with pytest.raises(ValueError):
            fa._flash_fwd_form(qs, kt, vt, keep, None, form)
