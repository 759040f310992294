"""The port's collectives (``deepspeed_tpu_torch.comm`` / ``.collectives``)
against the JAX package's on the 8-device CPU mesh.

JAX runs each collective inside a full-manual ``shard_map`` exactly as
``tests/unit/comm/test_collectives.py:_run`` does (its Pallas hop kernels in
interpret mode); the port runs it on ``RankGroup("dp", 8, device="cpu")``,
where the hop kernels' plain versions run. Both take the same numpy arrays
(``[8, ...]``: row r is rank r's shard). Tolerances:

- exact wires ("none", "fp32", "bf16") on integer-valued fp32 payloads, for
  every op x algorithm: bit-identical to JAX's output and to the exact
  result (every summation order is exact on such payloads);
- int8 and fp8 wires: the same codes as JAX's at every quantisation, so
  within 3 fp32 ulps a quantisation (``_ulp_tol``) of the largest absmax a
  block can hold. That allows for XLA's CPU rewrite of ``absmax / 127``
  into a multiply, a scale one ulp off, which moves a decoded element by at
  most 2.5 ulps of its block's absmax; no code may flip, since one flipped
  code moves an element by a whole block scale, thousands of times the
  tolerance. The codec's own wire (codes and scales) equals JAX's exactly.
  Also within JAX's own bounds against the exact result (all_reduce 0.15;
  all_to_all 0.02 int8 / 0.06 fp8), the fused hop bit-identical to the
  unfused wire (JAX's bound there: 0.05), and every rank byte-identical
  after an all-reduce.

Sizes are the JAX tests': 103 and 37 columns (chunk padding), block 32 (codec
padding), 96 rows for the all-to-all.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu.comm as jdist
from deepspeed_tpu import collectives as jcoll
from deepspeed_tpu.collectives import codecs as jcodecs
from deepspeed_tpu.collectives import pallas_backend as jpb
from deepspeed_tpu.utils.compat import shard_map

from deepspeed_tpu_torch import collectives as coll
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.collectives import codecs, pallas_backend
from deepspeed_tpu_torch.comm import RankGroup, shards_from_numpy, shards_to_numpy

N = 8
BLOCK = 32
ALGS = ("ring", "bidir", "rhd", "ring2d")
PALLAS = ("pallas_ring", "pallas_ring2d")
BASE = {"pallas_ring": "ring", "pallas_ring2d": "ring2d"}
EXACT = ("none", "fp32", "bf16")
LOSSY = ("int8", "fp8")
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


@pytest.fixture(scope="module")
def group():
    return RankGroup("dp", N, device="cpu")


@functools.lru_cache(None)
def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("dp",))


def _int_payload(shape, seed):
    return np.random.default_rng(seed).integers(-8, 9, shape).astype(np.float32)


def _normal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)


def _inputs(op, lossy):
    shape = {"all_reduce": (N, 103), "all_gather": (N, 37), "reduce_scatter": (N, 96),
             "all_to_all": (N, 96, 37)}[op]
    seed = {"all_reduce": 21, "all_gather": 22, "reduce_scatter": 23, "all_to_all": 31}[op]
    return _normal(shape, seed + 100) if lossy else _int_payload(shape, seed)


def _jax_op(op, v, alg, codec):
    kw = dict(algorithm=alg, codec=codec, block_size=BLOCK)
    if op == "all_to_all":
        return jcoll.all_to_all(v, "dp", split_axis=0, concat_axis=0, **kw)
    return getattr(jcoll, op)(v, "dp", **kw)


def _port_op(op, xs, group, alg, codec):
    kw = dict(algorithm=alg, codec=codec, block_size=BLOCK)
    if op == "all_to_all":
        return coll.all_to_all(xs, group, split_axis=0, concat_axis=0, **kw)
    return getattr(coll, op)(xs, group, **kw)


def _run(f, *xs, n_out=1):
    out_specs = P("dp") if n_out == 1 else tuple(P("dp") for _ in range(n_out))
    fn = jax.jit(shard_map(f, mesh=_mesh(), in_specs=tuple(P("dp") for _ in xs),
                           out_specs=out_specs, check_vma=False))
    out = fn(*(jnp.asarray(x) for x in xs))
    return np.asarray(out) if n_out == 1 else [np.asarray(o) for o in out]


@functools.lru_cache(None)
def _jax_outputs(op, codec, algs, lossy):
    """JAX's outputs of ``op`` for every algorithm of ``algs``, from one
    compiled program."""
    x = _inputs(op, lossy)
    outs = _run(lambda v: tuple(_jax_op(op, v[0], a, codec)[None] for a in algs), x,
                n_out=len(algs))
    return dict(zip(algs, outs))


def _exact(op, x):
    if op == "all_reduce":
        return np.tile(x.sum(0, keepdims=True), (N, 1))
    if op == "all_gather":
        return np.tile(x.reshape(1, -1), (N, 1))
    if op == "reduce_scatter":
        return x.sum(0).reshape(N, -1)
    blocks = x.reshape(N, N, -1, *x.shape[2:])  # [src, dst, m, ...]
    return blocks.transpose(1, 0, *range(2, blocks.ndim)).reshape(x.shape)


def _jax_algs(op):
    return tuple(a for a in ALGS if not (op == "all_to_all" and a == "rhd"))


def _quantisations(op, alg):
    """How many times a wire element is quantised on its way (n = 8 = 2 x 4)."""
    base = BASE.get(alg, alg)
    if op == "all_to_all":
        return 1
    if op == "reduce_scatter":
        return N - 1
    return 6 if base == "ring2d" else N


def _ulp_tol(op, alg, x):
    """3 fp32 ulps a quantisation of the largest absmax a block can hold (a
    row of ``x`` for the all-to-all, else a sum of |x| over ranks)."""
    mag = np.abs(x).max() if op == "all_to_all" else np.abs(x).sum(0).max()
    return _quantisations(op, alg) * 3 * np.spacing(np.float32(mag))


# ------------------------------------------------------------ exact wires
@pytest.mark.parametrize("alg", ALGS + PALLAS)
@pytest.mark.parametrize("codec", EXACT)
@pytest.mark.parametrize("op", OPS)
def test_exact_wires_bit_identical_to_jax(group, op, codec, alg):
    x = _inputs(op, lossy=False)
    if op == "all_to_all" and alg == "rhd":
        with pytest.raises(ValueError, match="recursive-halving"):
            _port_op(op, shards_from_numpy(x, group), group, alg, codec)
        return
    got = shards_to_numpy(_port_op(op, shards_from_numpy(x, group), group, alg, codec))
    want = _jax_outputs(op, codec, _jax_algs(op), False)[BASE.get(alg, alg)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _exact(op, x))


# ------------------------------------------------------------ lossy wires
@pytest.mark.parametrize("alg", ("ring", "ring2d") + PALLAS)
@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("op", ("all_reduce", "reduce_scatter", "all_to_all"))
def test_lossy_wires_match_jax(group, op, codec, alg):
    x = _inputs(op, lossy=True)
    got = shards_to_numpy(_port_op(op, shards_from_numpy(x, group), group, alg, codec))
    jax_out = _jax_outputs(op, codec, ("ring", "ring2d"), True)
    want = jax_out[BASE.get(alg, alg)]
    tol = _ulp_tol(op, alg, x)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    exact = _exact(op, x)
    scale = np.abs(exact).max() + 1e-9
    if op == "all_to_all":
        bound = 0.02 if codec == "int8" else 0.06
        assert np.abs(got - exact).max() / scale < bound
        own = x.reshape(N, N, -1)
        for r in range(N):  # the own block never crosses a link: raw
            np.testing.assert_array_equal(got.reshape(N, N, -1)[r, r], own[r, r])
    else:
        assert np.abs(got - exact).max() / scale < 0.15
    if op == "all_reduce":
        for r in range(1, N):
            np.testing.assert_array_equal(got[r], got[0])
    if alg in PALLAS:  # the fused hop quantises as the unfused wire does
        unfused = shards_to_numpy(_port_op(op, shards_from_numpy(x, group), group, BASE[alg],
                                           codec))
        np.testing.assert_array_equal(got, unfused)


@pytest.mark.parametrize("alg", PALLAS)
@pytest.mark.parametrize("codec", ("none",) + LOSSY)
def test_pallas_all_reduce_against_jax_interpret(group, alg, codec):
    """The cases JAX's own tests run through its Pallas hop kernels (interpret
    mode): exact wires bit for bit, int8/fp8 within ``_ulp_tol``."""
    x = _int_payload((N, 103), 24) if codec == "none" else _normal((N, 103), 24)
    want = _run(lambda v: jcoll.all_reduce(v[0], "dp", algorithm=alg, codec=codec,
                                           block_size=BLOCK)[None], x)
    got = shards_to_numpy(coll.all_reduce(shards_from_numpy(x, group), group, algorithm=alg,
                                          codec=codec, block_size=BLOCK))
    if codec == "none":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= _ulp_tol("all_reduce", alg, x)
    for r in range(1, N):
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("alg,codec", [("pallas_ring", "int8"), ("pallas_ring", "fp8"),
                                       ("pallas_ring2d", "int8"), ("pallas_ring", "none")])
def test_pallas_all_to_all_against_jax_interpret(group, alg, codec):
    x = _normal((N, 96), 33)
    want = _run(lambda v: jcoll.all_to_all(v[0], "dp", split_axis=0, concat_axis=0,
                                           algorithm=alg, codec=codec, block_size=BLOCK)[None], x)
    got = shards_to_numpy(coll.all_to_all(shards_from_numpy(x, group), group, split_axis=0,
                                          concat_axis=0, algorithm=alg, codec=codec,
                                          block_size=BLOCK))
    if codec == "none":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= _ulp_tol("all_to_all", alg, x)


@pytest.mark.parametrize("alg", ALGS + PALLAS)
def test_bf16_payload_accumulates_fp32(group, alg):
    """A bf16 payload accumulates in fp32 through the chain and rounds once at
    the reduce-scatter -> all-gather boundary, as JAX's does."""
    x = (np.random.default_rng(9).standard_normal((N, 1024)) * 3).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact values
    want = _run(lambda v: jcoll.all_reduce(v[0].astype(jnp.bfloat16), "dp",
                                           algorithm=BASE.get(alg, alg))[None].astype(jnp.float32),
                xb)
    got = shards_to_numpy(coll.all_reduce(shards_from_numpy(xb, group, torch.bfloat16), group,
                                          algorithm=alg))
    np.testing.assert_array_equal(got, want)


def test_split_and_concat_axes_match_jax(group):
    """Tiled semantics on distinct axes (the MoE dispatch shape), all_gather
    and reduce_scatter along axis 1."""
    x = _int_payload((N, 16, 8), 32)
    for split, concat in ((0, 1), (1, 0)):
        want = _run(lambda v: jax.lax.all_to_all(v[0], "dp", split_axis=split,
                                                 concat_axis=concat, tiled=True)[None], x)
        for alg in ("ring", "bidir", "ring2d", "pallas_ring"):
            got = coll.all_to_all(shards_from_numpy(x, group), group, split_axis=split,
                                  concat_axis=concat, algorithm=alg)
            np.testing.assert_array_equal(shards_to_numpy(got), want)
    want = _run(lambda v: jax.lax.all_gather(v[0], "dp", axis=1, tiled=True)[None], x)
    got = coll.all_gather(shards_from_numpy(x, group), group, algorithm="pallas_ring",
                          concat_axis=1)
    np.testing.assert_array_equal(shards_to_numpy(got), want)
    xs = _int_payload((N, 4, 16), 34)
    want = _run(lambda v: jax.lax.psum_scatter(v[0], "dp", scatter_dimension=1,
                                               tiled=True)[None], xs)
    got = coll.reduce_scatter(shards_from_numpy(xs, group), group, algorithm="ring",
                              scatter_axis=1)
    np.testing.assert_array_equal(shards_to_numpy(got), want)


def test_error_feedback_matches_jax(group):
    """reduce_scatter(err=...) on the int8 ring: the output and the refreshed
    residual, two rounds with the residual carried, against JAX's."""
    L = 64
    x = _normal((N, N * L), 0)
    err = np.zeros((N, N, L), np.float32)
    jerr, perr = err, [torch.from_numpy(e.copy()) for e in err]
    for _ in range(2):
        def f(v, e):
            out, new = jcoll.reduce_scatter(v[0], "dp", algorithm="ring", codec="int8",
                                            block_size=BLOCK, err=e[0])
            return out[None], new[None]

        jout, jerr = _run(f, x, jerr, n_out=2)
        pout, perr = coll.reduce_scatter(shards_from_numpy(x, group), group, algorithm="ring",
                                         codec="int8", block_size=BLOCK, err=perr)
        tol = _ulp_tol("reduce_scatter", "ring", np.abs(x) + np.abs(jerr).max())
        assert np.abs(shards_to_numpy(pout) - jout).max() <= tol
        assert np.abs(shards_to_numpy(perr) - jerr).max() <= tol
    with pytest.raises(ValueError, match="algorithm='ring' only"):
        coll.reduce_scatter(shards_from_numpy(x, group), group, algorithm="bidir", err=perr)


# ------------------------------------------------------------ codecs
@pytest.mark.parametrize("name", EXACT + LOSSY)
def test_codec_wire_matches_jax(name):
    """encode_rows / decode_rows: the wire (values and scales) and the decoded
    rows against JAX's codec, with block padding (45 columns, block 16): equal
    bit for bit."""
    x = _normal((3, 45), 5)
    jc, pc = jcodecs.get_codec(name, 16), codecs.get_codec(name, 16)
    jw = jc.encode_rows(jnp.asarray(x))
    pw = pc.encode_rows(torch.from_numpy(x))
    assert tuple(pw.q.shape) == jw.q.shape and tuple(pw.s.shape) == jw.s.shape
    back = pc.decode_rows(pw, 45, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jc.decode_rows(jw, 45, jnp.float32)))
    assert pc.wire_bytes(45, 4) == jc.wire_bytes(45, 4) and pc.lossy == jc.lossy
    if name in LOSSY:
        np.testing.assert_array_equal(pw.q.view(torch.uint8).numpy(),
                                      np.asarray(jw.q).view(np.uint8))
        np.testing.assert_array_equal(pw.s.numpy(), np.asarray(jw.s))
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.get_codec("int3")


def test_chunk_geometry_matches_jax():
    for L in (1, 12, 103, 2047, 2048, 65536 + 37, 16384 * 3 + 1):
        for block in (1, 32, 2048, 10 ** 6):
            assert pallas_backend._chunk_geometry(L, block) == jpb._chunk_geometry(L, block)


# ------------------------------------------------------------ the facade
def test_facade_pallas_int8_mean_through_the_logger(group):
    """comm.all_reduce(..., algorithm="pallas_ring", codec="int8", op="mean")
    against JAX's facade, recorded by the comms logger."""
    x = _normal((N, 103), 40)
    want = _run(lambda v: jdist.all_reduce(v[0], "dp", op="mean", algorithm="pallas_ring",
                                           codec="int8", block_size=BLOCK)[None], x)
    comm.comms_logger.reset()
    comm.configure(enabled=True)
    try:
        got = shards_to_numpy(comm.all_reduce(shards_from_numpy(x, group), group, op="mean",
                                              algorithm="pallas_ring", codec="int8",
                                              block_size=BLOCK))
        rows = comm.comms_logger.summary()
        assert comm.log_summary() == rows
    finally:
        comm.configure(enabled=False)
        comm.comms_logger.reset()
    assert np.abs(got - want).max() <= _ulp_tol("all_reduce", "pallas_ring", x) / N
    assert rows == [{"op": "all_reduce_mean", "axis": "dp", "count": 1, "total_bytes": 103 * 4,
                     "bus_bytes": int(2 * 7 / 8 * 103 * 4)}]


@pytest.mark.parametrize("op", ("sum", "mean", "max", "min"))
def test_facade_native_all_reduce_matches_lax(group, op):
    x = _int_payload((N, 37), 41)
    lax_fn = {"sum": jax.lax.psum, "mean": jax.lax.pmean, "max": jax.lax.pmax,
              "min": jax.lax.pmin}[op]
    want = _run(lambda v: lax_fn(v[0], "dp")[None], x)
    got = shards_to_numpy(comm.all_reduce(shards_from_numpy(x, group), group, op=op))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ("int32", "float32", "bfloat16"))
def test_facade_native_mean_matches_pmean_dtype(group, dtype):
    """The native mean returns what ``lax.pmean`` returns: float32 means of an
    int32 payload (not the sum cast back to int32), a float payload's mean in
    its own dtype. Sums of the integer payload over 8 ranks are exact in
    every dtype here, and so are their eighths."""
    x = _int_payload((N, 37), 48)
    want = _run(lambda v: jax.lax.pmean(v[0].astype(dtype), "dp")[None], x)
    tdtype = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = comm.all_reduce(shards_from_numpy(x, group, tdtype), group, op="mean")
    assert str(got[0].dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(shards_to_numpy(got), want.astype(np.float32))


EMPTY_AXIS_OPS = {
    "all_reduce_sum": (lambda v: jdist.all_reduce(v, (), op="sum"),
                       lambda xs: comm.all_reduce(xs, (), op="sum")),
    "all_reduce_mean": (lambda v: jdist.all_reduce(v, (), op="mean"),
                        lambda xs: comm.all_reduce(xs, (), op="mean")),
    "all_reduce_max": (lambda v: jdist.all_reduce(v, (), op="max"),
                       lambda xs: comm.all_reduce(xs, (), op="max")),
    "all_reduce_ring_int8": (lambda v: jdist.all_reduce(v, (), algorithm="ring", codec="int8"),
                             lambda xs: comm.all_reduce(xs, (), algorithm="ring", codec="int8")),
    "all_gather": (lambda v: jdist.all_gather(v, ()), lambda xs: comm.all_gather(xs, ())),
    "all_gather_untiled": (lambda v: jdist.all_gather(v, (), tiled=False),
                           lambda xs: comm.all_gather(xs, (), tiled=False)),
    "reduce_scatter": (lambda v: jdist.reduce_scatter(v, ()),
                       lambda xs: comm.reduce_scatter(xs, ())),
    "all_to_all": (lambda v: jdist.all_to_all(v, (), split_axis=0, concat_axis=1),
                   lambda xs: comm.all_to_all(xs, (), split_axis=0, concat_axis=1)),
    "ppermute": (lambda v: jdist.ppermute(v, (), [(0, 0)]),
                 lambda xs: comm.ppermute(xs, (), [(0, 0)])),
}


@pytest.mark.parametrize("op", sorted(EMPTY_AXIS_OPS))
def test_facade_empty_axis_is_the_native_noop(group, op):
    """``axis=()`` reduces nothing: every facade op JAX runs as a no-op there
    returns each rank's value as ``lax.psum(x, ())`` (``lax.pmean(x, ())``
    for the mean: float32 for this int32 payload) does, and JAX's facade
    agrees; the algorithmic route quantises nothing."""
    x = _int_payload((N, 8, 5), 52).astype(np.int32)
    ref = jax.lax.pmean if op == "all_reduce_mean" else jax.lax.psum
    want = _run(lambda v: ref(v[0], ())[None], x)
    jfn, pfn = EMPTY_AXIS_OPS[op]
    np.testing.assert_array_equal(_run(lambda v: jfn(v[0])[None], x), want)
    xs = shards_from_numpy(x, group)
    got = pfn(xs)
    assert str(got[0].dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(shards_to_numpy(got), want)
    assert all(g.data_ptr() != t.data_ptr() for g, t in zip(got, xs))


def test_facade_empty_axis_refusals(group):
    """Where JAX's facade is no no-op over ``()``: the untiled all-to-all
    (its split dim must be the axis size, 1) and the broadcast (it indexes
    the payload's first dim) raise."""
    xs = shards_from_numpy(_int_payload((N, 8, 5), 53), group)
    with pytest.raises(ValueError, match="empty axis tuple"):
        comm.all_to_all(xs, (), split_axis=0, concat_axis=1, tiled=False)
    with pytest.raises(NotImplementedError, match="empty axis tuple"):
        comm.broadcast(xs, ())


@pytest.mark.parametrize("tiled", (True, False))
def test_facade_native_gather_scatter_a2a_match_lax(group, tiled):
    xg = _int_payload((N, 3, 5), 42)
    want = _run(lambda v: jax.lax.all_gather(v[0], "dp", axis=1, tiled=tiled)[None], xg)
    got = comm.all_gather(shards_from_numpy(xg, group), group, concat_axis=1, tiled=tiled)
    np.testing.assert_array_equal(shards_to_numpy(got), want)
    xs = _int_payload((N, N * (1 if not tiled else 2), 3), 43)
    want = _run(lambda v: jax.lax.psum_scatter(v[0], "dp", scatter_dimension=0,
                                               tiled=tiled)[None], xs)
    got = comm.reduce_scatter(shards_from_numpy(xs, group), group, tiled=tiled)
    np.testing.assert_array_equal(shards_to_numpy(got), want)
    xa = _int_payload((N, 4, N * (1 if not tiled else 2)), 44)
    want = _run(lambda v: jax.lax.all_to_all(v[0], "dp", split_axis=1, concat_axis=0,
                                             tiled=tiled)[None], xa)
    got = comm.all_to_all(shards_from_numpy(xa, group), group, split_axis=1, concat_axis=0,
                          tiled=tiled)
    np.testing.assert_array_equal(shards_to_numpy(got), want)


def test_facade_ppermute_and_broadcast_match_jax(group):
    x = _int_payload((N, 11), 45)
    perm = [(s, (s + 3) % N) for s in range(N - 2)]  # ranks 3 and 4 receive nothing
    want = _run(lambda v: jax.lax.ppermute(v[0], "dp", perm)[None], x)
    got = comm.ppermute(shards_from_numpy(x, group), group, perm)
    np.testing.assert_array_equal(shards_to_numpy(got), want)
    want = _run(lambda v: jdist.broadcast(v[0], "dp", root=5)[None], x)
    got = comm.broadcast(shards_from_numpy(x, group), group, root=5)
    np.testing.assert_array_equal(shards_to_numpy(got), want)


# ------------------------------------------------------------ refusals
def test_out_of_slice_settings_raise(group):
    xs = shards_from_numpy(_int_payload((N, 16), 46), group)
    with pytest.raises(NotImplementedError, match="selector"):
        comm.all_reduce(xs, group, algorithm="auto")
    with pytest.raises(NotImplementedError, match="selector"):
        comm.all_gather(xs, group, codec="int8")
    for fn in (coll.all_reduce, coll.all_gather, coll.reduce_scatter):
        with pytest.raises(NotImplementedError, match="schedule"):
            fn(xs, group, algorithm="compiled")
    with pytest.raises(NotImplementedError, match="_hier_all_reduce_axes"):
        RankGroup(("dp", "tp"), N, device="cpu")
    with pytest.raises(NotImplementedError, match="_hier_all_reduce_axes"):
        comm.all_reduce(xs, (group, group), algorithm="ring")
    with pytest.raises(NotImplementedError, match="_hier_all_reduce_axes"):
        coll.all_reduce(xs, (group, group), algorithm="pallas_ring")
    with pytest.raises(ValueError, match="tiled=True only"):
        comm.all_to_all(xs, group, split_axis=1, concat_axis=0, tiled=False, algorithm="ring")
    with pytest.raises(ValueError, match="power-of-two"):
        coll.all_reduce(shards_from_numpy(_int_payload((6, 12), 47), RankGroup("dp", 6, "cpu")),
                        RankGroup("dp", 6, "cpu"), algorithm="rhd")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RankGroup("dp", N)


def test_plain_fused_hop_is_the_codec_block_math():
    """The fused hop's plain version (what a CPU rank runs) adds the decoded
    upstream wire into the row and re-encodes the sum exactly as the int8 and
    fp8 codecs' block math does, and as JAX's codec does: the same codes and
    scales bit for bit."""
    rng = np.random.default_rng(49)
    for kind, qb in (("int8", 32), ("fp8", 103)):
        L = 7 * qb
        c = codecs.get_codec(kind, qb)
        up = c.encode_rows(torch.from_numpy(_normal((1, L), 50)))
        tgt = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
        want = tgt + c.decode_rows(up, L, torch.float32)[0]
        own_q = torch.empty(L, dtype=pallas_backend.WIRE_DTYPES[kind])
        own_s = torch.empty(L // qb, dtype=torch.float32)
        pallas_backend.fused_hop(up.q[0], up.s[0], tgt, tgt, own_q, own_s, qb=qb)
        torch.testing.assert_close(tgt, want, rtol=0, atol=0)
        w = c.encode_rows(want[None])
        assert torch.equal(own_q.view(torch.int8), w.q[0].view(torch.int8))
        assert torch.equal(own_s, w.s[0])
        jw = jcodecs.get_codec(kind, qb).encode_rows(jnp.asarray(want[None].numpy()))
        np.testing.assert_array_equal(own_q.view(torch.uint8).numpy(),
                                      np.asarray(jw.q[0]).view(np.uint8))
        np.testing.assert_array_equal(own_s.numpy(), np.asarray(jw.s[0]))


def test_shards_round_trip(group):
    x = _normal((N, 3, 4), 51)
    xs = shards_from_numpy(x, group, torch.bfloat16)
    assert len(xs) == N and xs[0].dtype == torch.bfloat16 and xs[3].shape == (3, 4)
    np.testing.assert_array_equal(shards_to_numpy(shards_from_numpy(x, group)), x)
    with pytest.raises(ValueError, match="group size"):
        shards_from_numpy(x[:4], group)
