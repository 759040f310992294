"""The port's fused GEMM collectives (``deepspeed_tpu_torch.collectives.fused_gemm``,
``parallel.zeropp.sharded_matmul``, ``parallel.tp``) against the JAX package's.

JAX runs each op inside a full-manual ``shard_map`` over a 4-device ``tp``
mesh with its Pallas hop kernels in interpret mode, as
``tests/unit/comm/test_fused_gemm.py`` does, at its sizes (``M, Ks, N = 6,
8, 16``, 8 rows for the reduce-scatter). The port runs on ``RankGroup("tp",
4, device="cpu")``, where the hop kernels' plain versions run the TPU
kernels' chunks and wire math. Both take the same numpy arrays. Tolerances:

- exact wires on integer-valued payloads: the port, JAX and the exact
  product equal bit for bit (every summation order is exact there), for both
  ``all_gather_matmul`` forms and ``matmul_reduce_scatter``, fused and not;
  ``sharded_matmul``'s gradients likewise, the knob on and off;
- int8 and e4m3 wires on normal payloads: each element within 3 fp32 ulps a
  quantisation (``n - 1`` of them on a hop chain) of the largest |exact
  result| from JAX's output. The ulps are taken at the output: the gather's
  wire carries the weights, whose decoded errors the product sums, and the
  products themselves reassociate (XLA's dot against torch's): the exact
  wire on normal payloads already sits up to 3 ulps from JAX's (measured).
  Measured with the lossy wires: at most 4 ulps. Against the exact product:
  int8 within JAX's 2e-2 relative bound; e4m3 within 6e-2, JAX's own e4m3
  test bound for a block wire (``tests/unit/comm/test_collectives.py``),
  because JAX's e4m3 output itself lies 1.6-2.5e-2 from the exact product
  here (3 mantissa bits);
- the ZeRO-3 SGD trajectory: 6 steps, losses and weights within 1e-4
  relative, fused against unfused and against JAX's.

The shapes cover every chunk count the TPU kernels take (``C`` = 4, 3, 2, 1)
with quantisation blocks smaller than the codec's (``qb = gcd(B, 64) <
64``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu.comm.comm as jdist
from deepspeed_tpu.collectives import fused_gemm as jfg
from deepspeed_tpu.parallel import tp as jtp
from deepspeed_tpu.parallel import zeropp as jzeropp
from deepspeed_tpu.utils.compat import shard_map

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.collectives import fused_gemm as fg
from deepspeed_tpu_torch.collectives import pallas_backend
from deepspeed_tpu_torch.comm import RankGroup, shards_from_numpy, shards_to_numpy
from deepspeed_tpu_torch.parallel import tp, zeropp

N_DEV = 4
M, KS, N = 6, 8, 16
K = N_DEV * KS
BLOCK = 64
# (Ks, N, reduce-scatter rows): chunks C = 4, 3, 2, 1 for both hops; qb
# 32, 32, 16, 8 (gather) and 16, 16, 16, 8 (reduce-scatter)
LOSSY_SHAPES = {"C4": (8, 16, 16), "C3": (6, 16, 12), "C2": (2, 16, 8), "C1": (5, 24, 20)}
FORMS = ("accumulate", "out_block", "reduce_scatter")


@pytest.fixture(autouse=True)
def _knobs_off():
    jfg.configure(enabled=False)
    fg.configure(enabled=False)
    yield
    jfg.configure(enabled=False)
    fg.configure(enabled=False)


@pytest.fixture(scope="module")
def group():
    return RankGroup("tp", N_DEV, device="cpu")


@functools.lru_cache(None)
def _mesh():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("tp",))


def _run(f, *args, in_specs, out_specs):
    fn = jax.jit(shard_map(f, mesh=_mesh(), in_specs=in_specs, out_specs=out_specs,
                           check_vma=False))
    out = fn(*(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.asarray, out)


def _ints(rng, shape):
    return rng.integers(-4, 4, size=shape).astype(np.float32)


def _replicated(a, group):
    return [torch.from_numpy(a.copy()) for _ in range(group.n)]


def _row_shards(w, group):
    """``P("tp")`` on the rows: rank r's ``w[r*Ks:(r+1)*Ks]``."""
    return shards_from_numpy(w.reshape(group.n, -1, w.shape[1]), group)


def _col_shards(a, group):
    """``P(None, "tp")``: rank r's columns ``a[:, r*Ks:(r+1)*Ks]``."""
    return shards_from_numpy(a.reshape(a.shape[0], group.n, -1).transpose(1, 0, 2), group)


def _port_forms(x, g, a, w, group, **kw):
    """The three forms through the port: every rank's gather results and the
    reduce-scatter's row blocks stacked back into ``[M, N]``."""
    ws = _row_shards(w, group)
    ag = fg.all_gather_matmul(_replicated(x, group), ws, group, **kw)
    ob = fg.all_gather_matmul(_replicated(g, group), ws, group, out_block=True, **kw)
    rs = fg.matmul_reduce_scatter(_col_shards(a, group), ws, group, **kw)
    return {"accumulate": shards_to_numpy(ag), "out_block": shards_to_numpy(ob),
            "reduce_scatter": shards_to_numpy(rs).reshape(a.shape[0], -1)}


def _jax_forms(x, g, a, w, **kw):
    """The three forms through JAX's fused kernels, in one program: every
    rank's gather results stacked on a leading axis (a lossy wire gives each
    rank its own), the reduce-scatter's row blocks stacked back into ``[M, N]``."""
    def f(xv, gv, av, wv):
        return (jfg.all_gather_matmul(xv, wv, "tp", **kw)[None],
                jfg.all_gather_matmul(gv, wv, "tp", out_block=True, **kw)[None],
                jfg.matmul_reduce_scatter(av, wv, "tp", **kw))

    out = _run(f, x, g, a, w, in_specs=(P(), P(), P(None, "tp"), P("tp")),
               out_specs=(P("tp"), P("tp"), P("tp")))
    return dict(zip(FORMS, out))


# ------------------------------------------------------------ exact wires
@functools.lru_cache(None)
def _exact_case():
    rng = np.random.default_rng(0)
    x, w, g, a = _ints(rng, (M, K)), _ints(rng, (K, N)), _ints(rng, (M, N)), _ints(rng, (8, K))
    return (x, g, a, w), _jax_forms(x, g, a, w, fused=True)


@pytest.mark.parametrize("form", FORMS)
def test_exact_wires_bit_identical(group, form):
    """Integer-valued payloads: the fused port, the unfused port, JAX's fused
    kernels and the exact product equal bit for bit, on every rank."""
    (x, g, a, w), want = _exact_case()
    exact = {"accumulate": x @ w, "out_block": g @ w.T, "reduce_scatter": a @ w}[form]
    for fused in (True, False):
        got = _port_forms(x, g, a, w, group, fused=fused)[form]
        if form == "reduce_scatter":
            np.testing.assert_array_equal(want[form], exact)
            np.testing.assert_array_equal(got, exact)
        else:
            for r in range(N_DEV):
                np.testing.assert_array_equal(want[form][r], exact)
                np.testing.assert_array_equal(got[r], exact)


# ------------------------------------------------------------ lossy wires
@functools.lru_cache(None)
def _lossy_case(shape, codec):
    ks, n_cols, rows = LOSSY_SHAPES[shape]
    rng = np.random.default_rng(3 + ks)
    x = rng.normal(size=(M, N_DEV * ks)).astype(np.float32)
    w = rng.normal(size=(N_DEV * ks, n_cols)).astype(np.float32)
    g = rng.normal(size=(M, n_cols)).astype(np.float32)
    a = rng.normal(size=(rows, N_DEV * ks)).astype(np.float32)
    return (x, g, a, w), _jax_forms(x, g, a, w, codec=codec, block_size=BLOCK, fused=True)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("codec", ("int8", "fp8"))
@pytest.mark.parametrize("shape", sorted(LOSSY_SHAPES))
def test_lossy_wires_match_jax(group, shape, codec, form):
    (x, g, a, w), want = _lossy_case(shape, codec)
    got = _port_forms(x, g, a, w, group, codec=codec, block_size=BLOCK, fused=True)[form]
    exact = {"accumulate": x @ w, "out_block": g @ w.T, "reduce_scatter": a @ w}[form]
    mag = np.float32(np.abs(exact).max())
    tol = (N_DEV - 1) * 3 * np.spacing(mag)
    bound = 2e-2 if codec == "int8" else 6e-2
    pairs = [(got, want[form])] if form == "reduce_scatter" else list(zip(got, want[form]))
    for r, (mine, theirs) in enumerate(pairs):  # every rank against JAX's same rank
        assert np.abs(mine - theirs).max() <= tol, (r, np.abs(mine - theirs).max(), tol)
        assert np.abs(mine - exact).max() / mag < bound


def test_chunk_geometry_and_wire_math_match_jax():
    for rows in range(1, 40):
        assert fg._chunks_of(rows) == jfg._chunks_of(rows)
    for B in (1, 8, 32, 48, 80, 120, 4096, 2 ** 20 + 3):
        for block in (1, 32, 64, 2048):
            c = fg._resolve_codec("int8", block)
            jc = jfg._resolve_codec("int8", block)
            assert fg._wire_math(c, B)[1] == jfg._wire_math(jc, B)[3]
            assert fg._wire_nbytes(3, B, c) == jfg._wire_nbytes(3, B, jc)
        assert fg._wire_math(None, B) == (torch.float32, B)
    assert fg._resolve_codec("fp8", None).block_size == jfg._resolve_codec("fp8", None).block_size
    assert fg._resolve_codec("none", 64) is None and fg._resolve_codec(None, 64) is None
    for bad in ("bf16", "fp32"):
        with pytest.raises(ValueError, match="no fused GEMM wire"):
            fg._resolve_codec(bad, 64)
        with pytest.raises(ValueError, match="no fused GEMM wire"):
            jfg._resolve_codec(bad, 64)


# ------------------------------------------------------------ routing
@pytest.fixture
def spies(monkeypatch):
    """Counting wrappers around the plain hops (the CPU ranks' kernels)."""
    calls = {"ag": 0, "rs": 0}

    def spy(key, fn):
        def counted(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return counted

    monkeypatch.setattr(fg, "ag_hop_plain", spy("ag", fg.ag_hop_plain))
    monkeypatch.setattr(fg, "rs_hop_plain", spy("rs", fg.rs_hop_plain))
    return calls


def _routes(group, **kw):
    (x, g, a, w), _ = _exact_case()
    return _port_forms(x, g, a, w, group, **kw)


def test_routing_follows_fused_and_the_knob(group, spies):
    """``fused=False`` and the knob off run no hop; the knob on (or
    ``fused=True``) runs ``n - 1`` hops a rank and op, each one plain-hop
    call on the CPU, and the comms logger sees only the hops' remote DMAs
    with JAX's wire bytes (no native collective)."""
    want = _routes(group, fused=False)
    assert spies == {"ag": 0, "rs": 0}
    for kw in ({}, {"codec": "int8", "block_size": BLOCK}):
        got = _routes(group, **kw)  # knob off
        assert spies == {"ag": 0, "rs": 0}
        if not kw:
            assert all(np.array_equal(got[f], want[f]) for f in FORMS)
    fg.configure(enabled=True)
    comm.comms_logger.reset()
    comm.configure(enabled=True)
    try:
        got = _routes(group)
        rows = comm.comms_logger.summary()
    finally:
        comm.configure(enabled=False)
        comm.comms_logger.reset()
    hops = N_DEV * (N_DEV - 1)
    assert spies == {"ag": 2 * hops, "rs": hops}
    assert all(np.array_equal(got[f], want[f]) for f in FORMS)
    # JAX's logger records the same per-hop bytes: Ks x N fp32 (gather), Mb x N (scatter)
    gather_b, scatter_b = jfg._wire_nbytes(KS, N, None), jfg._wire_nbytes(8 // N_DEV, N, None)
    assert rows == [{"op": "remote_dma", "axis": "tp", "count": 3 * (N_DEV - 1),
                     "total_bytes": (N_DEV - 1) * (2 * gather_b + scatter_b),
                     "bus_bytes": int((N_DEV - 1) / N_DEV * (N_DEV - 1)
                                      * (2 * gather_b + scatter_b))}]


def test_jax_knob_records_the_same_hop_census(group):
    """JAX's trace-time logger over its fused all_gather_matmul: n - 1
    ``remote_dma`` records of the bytes the port records."""
    (x, g, a, w), _ = _exact_case()
    jdist.comms_logger.reset()
    jdist.configure(enabled=True)
    try:
        jax.make_jaxpr(shard_map(lambda xv, wv: jfg.all_gather_matmul(
            xv, wv, "tp", codec="int8", block_size=BLOCK, fused=True), mesh=_mesh(),
            in_specs=(P(), P("tp")), out_specs=P(), check_vma=False))(x, w)
        jrows = [r for r in jdist.comms_logger.summary() if r["op"] == "remote_dma"]
    finally:
        jdist.configure(enabled=False)
        jdist.comms_logger.reset()
    comm.comms_logger.reset()
    comm.configure(enabled=True)
    try:
        fg.all_gather_matmul(_replicated(x, group), _row_shards(w, group), group, codec="int8",
                             block_size=BLOCK, fused=True)
        rows = comm.comms_logger.summary()
    finally:
        comm.configure(enabled=False)
        comm.comms_logger.reset()
    assert [(r["count"], r["total_bytes"]) for r in rows] == \
        [(r["count"], r["total_bytes"]) for r in jrows]


def test_one_rank_and_ragged_rows_take_the_plain_routes(spies):
    """``n = 1`` is one plain product; ``M % n != 0`` is the unfused
    reduce-scatter, which refuses the rows as ``lax.psum_scatter`` does."""
    rng = np.random.default_rng(5)
    one = RankGroup("tp", 1, device="cpu")
    x, w = _ints(rng, (M, KS)), _ints(rng, (KS, N))
    for form_kw in ({}, {"out_block": True}):
        xin = x if not form_kw else _ints(rng, (M, N))
        got = fg.all_gather_matmul([torch.from_numpy(xin)], [torch.from_numpy(w)], one,
                                   fused=True, **form_kw)
        np.testing.assert_array_equal(got[0].numpy(), xin @ (w.T if form_kw else w))
    got = fg.matmul_reduce_scatter([torch.from_numpy(x)], [torch.from_numpy(w)], one, fused=True)
    np.testing.assert_array_equal(got[0].numpy(), x @ w)
    group = RankGroup("tp", N_DEV, device="cpu")
    a = _ints(rng, (6, K))
    with pytest.raises(ValueError, match="divisible by shard_count"):
        fg.matmul_reduce_scatter(_col_shards(a, group), _row_shards(_ints(rng, (K, N)), group),
                                 group, fused=True)
    with pytest.raises(ValueError, match="divisible by shard_count 4"):
        _run(lambda av, wv: jfg.matmul_reduce_scatter(av, wv, "tp", fused=True), a,
             _ints(rng, (K, N)), in_specs=(P(None, "tp"), P("tp")), out_specs=P("tp"))
    assert spies == {"ag": 0, "rs": 0}
    with pytest.raises(NotImplementedError, match="_hier_all_reduce_axes"):
        fg.all_gather_matmul([torch.from_numpy(x)], [torch.from_numpy(w)], (group, group))
    with pytest.raises(TypeError, match="RankGroup"):
        fg.matmul_reduce_scatter([torch.from_numpy(x)], [torch.from_numpy(w)], "tp")
    assert not fg.supported("tp") and not fg.supported((group,))


def test_knob_routes_the_default_path(group, spies):
    """``fused=None`` consults ``configure()`` in both packages."""
    (x, g, a, w), _ = _exact_case()

    def jaxpr():
        return str(jax.make_jaxpr(shard_map(lambda xv, wv: jfg.all_gather_matmul(
            xv, wv, "tp"), mesh=_mesh(), in_specs=(P(), P("tp")), out_specs=P(),
            check_vma=False))(x, w))

    assert "pallas_call" not in jaxpr()
    fg.all_gather_matmul(_replicated(x, group), _row_shards(w, group), group)
    assert spies["ag"] == 0 and not fg.enabled()
    jfg.configure(enabled=True)
    fg.configure(enabled=True)
    assert jaxpr().count("pallas_call") == N_DEV - 1
    fg.all_gather_matmul(_replicated(x, group), _row_shards(w, group), group)
    assert spies["ag"] == N_DEV * (N_DEV - 1) and fg.enabled() and fg.supported(group)


# ------------------------------------------------------------ sharded_matmul
@functools.lru_cache(None)
def _jax_grads(fused):
    rng = np.random.default_rng(6)
    x, w, t = _ints(rng, (M, K)), _ints(rng, (K, N)), _ints(rng, (M, N))

    def loss(xv, wv):
        y = jzeropp.sharded_matmul(xv, wv, "tp", False, 64)
        return jnp.sum((y - t) * (y - t))

    jfg.configure(enabled=fused)
    try:
        grads = _run(jax.grad(loss, argnums=(0, 1)), x, w, in_specs=(P(), P("tp")),
                     out_specs=(P(), P("tp")))
    finally:
        jfg.configure(enabled=False)
    return (x, w, t), grads


def _port_grads(group, x, w, t, fused, quantize=False):
    fg.configure(enabled=fused)
    xs = [v.requires_grad_() for v in _replicated(x, group)]
    ws = [v.requires_grad_() for v in _row_shards(w, group)]
    ys = zeropp.sharded_matmul(xs, ws, group, quantize, 64)
    tt = torch.from_numpy(t)
    sum(((y - tt) * (y - tt)).sum() for y in ys).backward()
    return (shards_to_numpy([v.grad for v in xs]),
            shards_to_numpy([v.grad for v in ws]).reshape(K, N))


@pytest.mark.parametrize("fused", (False, True))
def test_sharded_matmul_grads_bit_identical(group, fused):
    """Integer payloads: the gradients with the knob on and off equal each
    other and JAX's (both ways) bit for bit; every rank's dx is its own."""
    (x, w, t), (jdx, jdw) = _jax_grads(fused)
    np.testing.assert_array_equal(jdx, _jax_grads(not fused)[1][0])
    np.testing.assert_array_equal(jdw, _jax_grads(not fused)[1][1])
    dx, dw = _port_grads(group, x, w, t, fused)
    for r in range(N_DEV):
        np.testing.assert_array_equal(dx[r], jdx)
    np.testing.assert_array_equal(dw, jdw)


def test_sharded_matmul_casts_and_quantised_wire(group):
    """dx in x's dtype and dw in w's (bf16 here); the int8 wire (qwZ/qgZ) on
    the fused hops stays within JAX's 2e-2 of the exact gradients."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    fg.configure(enabled=True)
    xs = [v.to(torch.bfloat16).requires_grad_() for v in _replicated(x, group)]
    ws = [v.to(torch.bfloat16).requires_grad_() for v in _row_shards(w, group)]
    sum(y.sum() for y in zeropp.sharded_matmul(xs, ws, group)).backward()
    assert xs[0].grad.dtype == torch.bfloat16 and ws[0].grad.dtype == torch.bfloat16
    t = rng.normal(size=(M, N)).astype(np.float32)
    exact_dx = 2 * (x @ w - t) @ w.T
    dx, dw = _port_grads(group, x, w, t, True, quantize=True)
    assert np.abs(dx[0] - exact_dx).max() / np.abs(exact_dx).max() < 2e-2
    exact_dw = N_DEV * x.T @ (2 * (x @ w - t))
    assert np.abs(dw - exact_dw).max() / np.abs(exact_dw).max() < 2e-2


STEPS, LR, MB = 6, 1e-3, 4


@functools.lru_cache(None)
def _trajectory_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N_DEV * MB, K)).astype(np.float32)
    w0 = rng.normal(size=(K, N)).astype(np.float32) * 0.1
    t = rng.normal(size=(N_DEV * MB, N)).astype(np.float32)
    return x, w0, t


@functools.lru_cache(None)
def _jax_trajectory(fused):
    x, w0, t = _trajectory_inputs()

    def sgd_step(xv, wv, tv):
        def loss(a, b):
            y = jzeropp.sharded_matmul(a, b, "tp", False, 64)
            return jnp.sum((y - tv) * (y - tv))

        lval, dw = jax.value_and_grad(loss, argnums=1)(xv, wv)
        return wv - LR * dw, jnp.reshape(lval, (1,))

    jfg.configure(enabled=fused)
    try:
        f = jax.jit(shard_map(sgd_step, mesh=_mesh(), in_specs=(P("tp"), P("tp"), P("tp")),
                              out_specs=(P("tp"), P("tp")), check_vma=False))
        w, losses = jnp.asarray(w0), []
        for _ in range(STEPS):
            w, lv = f(jnp.asarray(x), w, jnp.asarray(t))
            losses.append(float(np.asarray(lv).sum()))
    finally:
        jfg.configure(enabled=False)
    return np.asarray(losses), np.asarray(w)


def _port_trajectory(group, fused):
    x, w0, t = _trajectory_inputs()
    fg.configure(enabled=fused)
    xs = shards_from_numpy(x.reshape(N_DEV, MB, K), group)  # batch-sharded
    ts = shards_from_numpy(t.reshape(N_DEV, MB, N), group)
    ws = _row_shards(w0, group)
    losses = []
    for _ in range(STEPS):
        ws = [v.detach().requires_grad_() for v in ws]
        ys = zeropp.sharded_matmul(xs, ws, group, False, 64)
        per_rank = [((y - tt) * (y - tt)).sum() for y, tt in zip(ys, ts)]
        sum(per_rank).backward()
        losses.append(sum(float(lv.detach()) for lv in per_rank))
        ws = [v.detach() - LR * v.grad for v in ws]
    return np.asarray(losses), shards_to_numpy(ws).reshape(K, N)


def _rel(a, b):
    return np.abs(a - b) / (np.abs(b) + 1e-12)


def test_zero3_sgd_trajectory_tracks_unfused_and_jax(group):
    """Batch-sharded x, row-sharded w: 6 SGD steps fused and unfused within
    1e-4 of each other and of JAX's trajectories (JAX's own bound)."""
    l_off, w_off = _port_trajectory(group, False)
    l_on, w_on = _port_trajectory(group, True)
    assert l_off[-1] < l_off[0]
    assert _rel(l_on, l_off).max() < 1e-4
    assert np.abs(w_on - w_off).max() / np.abs(w_off).max() < 1e-4
    for fused, (lp, wp) in ((False, (l_off, w_off)), (True, (l_on, w_on))):
        lj, wj = _jax_trajectory(fused)
        assert _rel(lp, lj).max() < 1e-4
        assert np.abs(wp - wj).max() / np.abs(wj).max() < 1e-4


# ------------------------------------------------------------ tp.py
@functools.lru_cache(None)
def _tp_case():
    rng = np.random.default_rng(9)
    xs, wr = _ints(rng, (8, K)), _ints(rng, (K, N))
    xc, wc = _ints(rng, (M, N)), _ints(rng, (N, K))

    def f(xv, wv, cx, cw):
        return (jtp.row_parallel_linear(xv, wv, "tp"),
                jtp.row_parallel_linear(xv, wv, "tp", scatter_output=False),
                jtp.column_parallel_linear(cx, cw))

    jfg.configure(enabled=True)
    try:
        out = _run(f, xs, wr, xc, wc, in_specs=(P(None, "tp"), P("tp"), P(), P(None, "tp")),
                   out_specs=(P("tp"), P(), P(None, "tp")))
    finally:
        jfg.configure(enabled=False)
    return (xs, wr, xc, wc), out


@pytest.mark.parametrize("fused", (True, False))
def test_tp_linears_match_jax(group, fused, spies):
    """``row_parallel_linear`` (scatter and replicated) and
    ``column_parallel_linear`` against JAX's, bit for bit on integer
    payloads; only the scatter form runs hops (with the knob on)."""
    (xs, wr, xc, wc), (j_rs, j_ar, j_col) = _tp_case()
    fg.configure(enabled=fused)
    x_shards, w_shards = _col_shards(xs, group), _row_shards(wr, group)
    rs = tp.row_parallel_linear(x_shards, w_shards, group)
    np.testing.assert_array_equal(shards_to_numpy(rs).reshape(8, N), j_rs)
    assert spies["rs"] == (N_DEV * (N_DEV - 1) if fused else 0)
    ar = tp.row_parallel_linear(x_shards, w_shards, group, scatter_output=False)
    for r in range(N_DEV):
        np.testing.assert_array_equal(ar[r].numpy(), j_ar)
    col = tp.column_parallel_linear(_replicated(xc, group), _col_shards(wc, group))
    np.testing.assert_array_equal(np.concatenate(shards_to_numpy(col), axis=1), j_col)
    assert spies["ag"] == 0 and spies["rs"] == (N_DEV * (N_DEV - 1) if fused else 0)
    q = tp.row_parallel_linear(x_shards, w_shards, group, quantize=True, block=32)
    exact = xs @ wr
    err = np.abs(shards_to_numpy(q).reshape(8, N) - exact).max() / np.abs(exact).max()
    assert err < 2e-2


# ------------------------------------------------------------ the plain hops
@pytest.mark.parametrize("codec", ("int8", "fp8"))
def test_plain_hops_carry_the_codec_block_math(codec):
    """One hop of each plain version: the decoded upstream shard and the
    re-encoded own wire are the codec's block math at the chunk's qb (the
    same codes and scales as JAX's codec on the same values)."""
    from deepspeed_tpu.collectives import codecs as jcodecs

    rng = np.random.default_rng(11)
    ks, n_cols, qb = 6, 16, 32
    c = fg._resolve_codec(codec, BLOCK)
    held_up = torch.from_numpy(rng.normal(size=(ks, n_cols)).astype(np.float32))
    wire = c.encode_rows(held_up.reshape(-1, qb))  # blocks of qb along the flat shard
    up = (wire.q.reshape(-1), wire.s.reshape(-1))
    x = torch.from_numpy(rng.normal(size=(M, N_DEV * ks)).astype(np.float32))
    held = torch.from_numpy(rng.normal(size=(ks, n_cols)).astype(np.float32))
    y = torch.zeros(M, n_cols)
    recv = torch.empty(ks, n_cols)
    own = (torch.empty(ks * n_cols, dtype=wire.q.dtype), torch.empty(ks * n_cols // qb))
    fg.ag_hop(x, held, y, 2 * ks, up, recv, own, qb=qb)
    decoded = c.decode_rows(wire, qb, torch.float32).reshape(ks, n_cols)
    assert torch.equal(recv, decoded)
    jw = jcodecs.get_codec(codec, qb).encode_rows(jnp.asarray(decoded.reshape(-1, qb).numpy()))
    np.testing.assert_array_equal(own[0].view(torch.uint8).numpy(),
                                  np.asarray(jw.q).reshape(-1).view(np.uint8))
    np.testing.assert_array_equal(own[1].numpy(), np.asarray(jw.s).reshape(-1))
    ref = torch.zeros(M, n_cols)
    for j in range(fg._chunks_of(ks)):  # 3 chunks of 2 rows
        ref = ref + x[:, 2 * ks + 2 * j:2 * ks + 2 * j + 2] @ held[2 * j:2 * j + 2]
    assert torch.equal(y, ref)
    # the reduce-scatter hop: rprev + x[block] @ w, then its codes
    w = torch.from_numpy(rng.normal(size=(N_DEV * ks, n_cols)).astype(np.float32))
    part = torch.empty(ks, n_cols)
    own2 = (torch.empty_like(own[0]), torch.empty_like(own[1]))
    fg.rs_hop(torch.cat([x, x]), w, 3, up, part, own2, qb=qb)
    rows = torch.cat([x, x])[3:3 + ks]
    want = torch.cat([decoded[2 * j:2 * j + 2] + rows[2 * j:2 * j + 2] @ w for j in range(3)])
    assert torch.equal(part, want)
    w2 = c.encode_rows(part.reshape(-1, qb))
    assert torch.equal(own2[0].view(torch.uint8), w2.q.reshape(-1).view(torch.uint8))
    assert torch.equal(own2[1], w2.s.reshape(-1))


def test_wrappers_refuse_mixed_devices_and_bad_wires():
    x, held = torch.zeros(4, 8), torch.zeros(2, 8)
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        fg.ag_hop(x, held, torch.zeros(4, 8), 0, (meta,), torch.zeros(2, 8), None, qb=16,
                  out_block=True)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        fg.rs_hop(x, meta, 0, (), torch.zeros(2, 8), None, qb=16)
    before = (fg.ag_hop.launches, fg.rs_hop.launches, pallas_backend.fused_hop.launches)
    group = RankGroup("tp", N_DEV, device="cpu")
    (xx, g, a, w), _ = _exact_case()
    _port_forms(xx, g, a, w, group, codec="int8", block_size=BLOCK, fused=True)
    assert (fg.ag_hop.launches, fg.rs_hop.launches, pallas_backend.fused_hop.launches) == before


# ------------------------------------------------------------ form choice
# (M, K, ldx, ldw, tma_ptrs, pair_ptrs, pair_ld) -> the form
FORM_CASES = {
    "aligned": ((4096, 512, 2048, 8192, (0, 1024), (2048,), 8192), "wgmma"),
    "gather_col_off_4": ((4096, 5, 2048, 8192, (0, 1024), (2048,), 8192), "wgmma"),
    "one_row": ((1, 8, 16, 16, (0, 16), (32,), 16), "wgmma"),
    "odd_k": ((6, 5, 24, 24, (0, 16), (8,), 24), "wgmma"),
    "x_stride_off_4": ((6, 8, 26, 24, (0, 16), (8,), 24), "simt"),
    "odd_n": ((37, 7, 131, 131, (0, 16), (8,), 131), "simt"),
    "x_base_off_16": ((6, 8, 24, 24, (8, 16), (8,), 24), "simt"),
    "w_base_off_16": ((6, 8, 24, 24, (16, 20), (8,), 24), "simt"),
    "out_off_8": ((6, 8, 24, 24, (0, 16), (4,), 24), "simt"),
    "out_stride_odd": ((6, 8, 24, 24, (0, 16), (8,), 23), "simt"),
    "out_block_any_out": ((6, 24, 24, 24, (0, 16), (), 0), "wgmma"),
    "k_zero": ((6, 0, 24, 24, (0, 16), (8,), 24), "simt"),
    "no_rows": ((0, 8, 24, 24, (0, 16), (8,), 24), "simt"),
}


@pytest.mark.parametrize("case", sorted(FORM_CASES))
def test_fused_form_boundaries(case):
    """``fused_form`` from shapes, strides and addresses alone: form T where
    TMA can describe both operands (row strides multiples of 4 floats,
    16-byte bases, K > 0) and the float2 epilogue lines up; form S else."""
    args, want = FORM_CASES[case]
    assert fg.fused_form(*args) == want


@pytest.mark.parametrize("out_block", [False, True], ids=["accumulate", "out_block"])
def test_fused_form_of_the_gather_hops(out_block):
    """The wrappers' view of a gather hop (the column offset is not an
    input: form T describes x whole): contiguous operands of row strides
    that are multiples of 4 take form T, at M = 1 and at odd Ks; a row
    stride off 4 floats, odd N and a base off 16 bytes take form S."""
    Ks, N = 5, 24
    for M in (1, 6):
        x = torch.zeros(M, N if out_block else 3 * Ks + 9)
        held, out = torch.zeros(Ks, N), torch.zeros(M, 3 * Ks if out_block else N)
        assert fg._ag_form(x, held, out, out_block) == "wgmma", M
    wide = torch.zeros(6, 26)
    x = wide[:, :N] if out_block else wide[:, :3 * Ks + 8]
    assert fg._ag_form(x, torch.zeros(Ks, N), torch.zeros(6, 3 * Ks if out_block else N),
                       out_block) == "simt"
    assert fg._ag_form(torch.zeros(6, 131 if out_block else 3 * Ks), torch.zeros(Ks, 131),
                       torch.zeros(6, 3 * Ks if out_block else 131), out_block) == "simt"
    buf = torch.zeros(1 + 6 * 24)
    assert fg._ag_form(buf[1:].view(6, 24) if out_block else torch.zeros(6, 24),
                       buf[1:1 + Ks * N].view(Ks, N) if not out_block else torch.zeros(Ks, N),
                       torch.zeros(6, 3 * Ks if out_block else N), out_block) == "simt"


def test_fused_form_of_the_reduce_scatter_hops():
    """Row 15: x [*, K] and w [K, N] with K and N multiples of 4 take form
    T, odd K or N form S; an exact upstream partial off 8 bytes form S."""
    x, w, part = torch.zeros(20, 8), torch.zeros(8, 24), torch.zeros(6, 24)
    assert fg._rs_form(x, w, (), part, 0) == "wgmma"
    assert fg._rs_form(x, w, (torch.zeros(6, 24),), part, 0) == "wgmma"
    assert fg._rs_form(torch.zeros(20, 7), torch.zeros(7, 24), (), part, 0) == "simt"
    assert fg._rs_form(x, torch.zeros(8, 131), (), torch.zeros(6, 131), 0) == "simt"
    off = torch.zeros(1 + 6 * 24)[1:].view(6, 24)
    assert fg._rs_form(x, w, (off,), part, 0) == "simt"
    codes = torch.zeros(1 + 6 * 24, dtype=torch.int8)[1:]
    assert fg._rs_form(x, w, (codes, torch.zeros(3)), part, 1) == "wgmma"


def test_named_forms_raise_on_cpu_tensors(spies):
    """A form is a kernel: naming one on CPU tensors raises and runs no plain
    version; ``form=None`` takes the plain version."""
    x, held, y = torch.zeros(4, 24), torch.zeros(2, 8), torch.zeros(4, 8)
    for form in fg.FUSED_FORMS:
        with pytest.raises(ValueError, match="is a kernel"):
            fg.ag_hop(x, held, y, 0, (held,), torch.zeros(2, 8), qb=16, form=form)
        with pytest.raises(ValueError, match="is a kernel"):
            fg.rs_hop(torch.zeros(4, 8), torch.zeros(8, 8), 0, (), torch.zeros(2, 8), qb=16,
                      form=form)
    assert spies == {"ag": 0, "rs": 0}
    fg.ag_hop(x, held, y, 0, (held,), torch.zeros(2, 8), qb=16)
    assert spies == {"ag": 1, "rs": 0}


# ------------------------------------------------------------ form T's arithmetic
def test_tf32_round_by_bits():
    """Round to nearest, ties away from zero, at TF32's 10 fraction bits;
    inf, NaN, zeros and subnormals' bit patterns handled as the hardware's
    ``cvt.rna.tf32.f32``."""
    one = 1.0
    ulp = 2.0 ** -10
    vals = [one, one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4, -(one + ulp / 2), 3.0e38,
            float("inf"), -float("inf"), 0.0, -0.0, 2.0 ** -136, 2.0 ** -140, 3 * 2.0 ** -137]
    # subnormals round at the same bit: 2^-136 is TF32's least, 2^-140 under its half
    want = [one, one + ulp, one, one + ulp, -(one + ulp), None, float("inf"), -float("inf"),
            0.0, -0.0, 2.0 ** -136, 0.0, 2.0 ** -135]
    got = fg.tf32_round(torch.tensor(vals, dtype=torch.float32))
    for g_, w_, v in zip(got.tolist(), want, vals):
        if w_ is not None:
            assert g_ == w_ and np.signbit(g_) == np.signbit(w_), (v, g_, w_)
    bits = got.view(torch.int32).numpy().astype(np.int64) & 0x1FFF
    assert (bits[np.isfinite(got.numpy())] == 0).all()
    assert torch.isnan(fg.tf32_round(torch.tensor([float("nan")]))).all()
    big, small = fg.tf32_split(torch.tensor([float("inf"), -float("inf"), 1.0 + 2.0 ** -20]))
    # a non-finite value rides in small, big keeping its sign (the kernel's split_tf32)
    assert big[:2].tolist() == [1.0, -1.0] and small[:2].tolist() == [float("inf"), -float("inf")]
    assert big[2] + small[2] == 1.0 + 2.0 ** -20


def _model_payload(kind, rng, shape):
    if kind == "ints":
        return _ints(rng, shape)
    a = rng.normal(size=shape).astype(np.float32)
    if kind == "wide":  # exponents from 2^-20 to 2^20
        a = (a * np.exp2(rng.integers(-20, 21, size=shape))).astype(np.float32)
    return a


MODEL_M, MODEL_KS, MODEL_N, MODEL_ROWS = 16, 64, 48, 16


@functools.lru_cache(None)
def _model_case(kind):
    rng = np.random.default_rng({"normal": 21, "wide": 22, "ints": 23, "nonfinite": 24}[kind])
    K_ = N_DEV * MODEL_KS
    x = _model_payload(kind, rng, (MODEL_M, K_))
    w = _model_payload(kind, rng, (K_, MODEL_N))
    g = _model_payload(kind, rng, (MODEL_M, MODEL_N))
    a = _model_payload(kind, rng, (MODEL_ROWS, K_))
    if kind == "nonfinite":  # +-inf meeting -inf and 0 at one k, -inf, NaN, in every operand
        x[3, 10], w[10, 5], w[10, 7], x[7, 150], w[200, 11], x[12, 40] = \
            np.inf, -np.inf, 0.0, -np.inf, np.inf, np.nan
        g[3, 5], g[4, 7], g[12, 40] = np.inf, np.inf, np.nan
        a[3, 10], a[7, 150], a[12, 40] = -np.inf, np.inf, np.nan
    return (x, g, a, w), _jax_forms(x, g, a, w, fused=True)


def _with_model(monkeypatch, passes):
    """The CPU ranks' hops through the plain model of form T's product."""
    mm = functools.partial(fg.tf32x3_matmul, passes=passes)
    monkeypatch.setattr(fg, "ag_hop_plain", functools.partial(fg.ag_hop_plain, matmul=mm))
    monkeypatch.setattr(fg, "rs_hop_plain", functools.partial(fg.rs_hop_plain, matmul=mm))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["normal", "wide", "ints", "nonfinite"])
def test_tf32x3_model_matches_jax_hops(group, monkeypatch, kind, form):
    """The three ops with every hop's product through ``tf32x3_matmul`` (the
    plain model of form T) against JAX's fused hop kernels in interpret mode:
    within the unchanged ``fused_gemm_close`` on normal payloads and on
    payloads whose exponents span 2^-20 to 2^20, bit for bit on integer
    payloads (small parts 0, sums exact); with +-inf and NaN operands, JAX's
    NaNs and signed infs where fp32 has them and the rest within the check."""
    from deepspeed_tpu_torch.utils.checks import fused_gemm_close, fused_gemm_match

    (x, g, a, w), want = _model_case(kind)
    _with_model(monkeypatch, 3)
    got = _port_forms(x, g, a, w, group, fused=True)[form]
    K_ = MODEL_N if form == "out_block" else N_DEV * MODEL_KS
    pairs = [(got, want[form])] if form == "reduce_scatter" else list(zip(got, want[form]))
    for mine, theirs in pairs:
        if kind == "ints":
            np.testing.assert_array_equal(mine, theirs)
        else:
            check = fused_gemm_match if kind == "nonfinite" else fused_gemm_close
            err, ok = check(torch.from_numpy(np.asarray(mine)),
                            torch.from_numpy(np.asarray(theirs)), K_)
            assert ok, err


def test_one_tf32_pass_fails_the_check_and_three_pass():
    """The check tells TF32 from fp32: on a phase-6c-like product (normal
    payloads, K = 512) one TF32 pass exceeds ``fused_gemm_close`` against
    the plain fp32 product, and the three-pass model stays within it."""
    from deepspeed_tpu_torch.utils.checks import fused_gemm_close

    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(size=(256, 512)).astype(np.float32))
    held = torch.from_numpy(rng.normal(size=(512, 1024)).astype(np.float32))
    want = torch.matmul(x, held)
    one_err, one_ok = fused_gemm_close(fg.tf32x3_matmul(x, held, passes=1), want, 512)
    three_err, three_ok = fused_gemm_close(fg.tf32x3_matmul(x, held), want, 512)
    assert not one_ok and three_ok
    assert one_err > 100 * three_err
