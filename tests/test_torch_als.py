"""ALS in the port against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``pio_tpu.models.als`` (on
``JAX_PLATFORMS=cpu``) and ``pio_tpu_torch.models.als`` on ``device="cpu"``.
Tolerances, stated per check:

- the host packers, the wire encoders, ``device_pack`` and the decoders
  are integer or copy work: bitwise;
- the normal equations are the same float32 products summed in another
  order (the reference's einsum and segment sum against ``bmm`` and
  ``segment_reduce``): sums of at most a few hundred O(1) terms, so
  ``rtol = atol = 1e-5`` leaves an order of magnitude over f32 rounding;
- the solves of well-conditioned systems (``reg = 0.1``) by the same
  method: ``rtol = atol = 1e-4``; CG runs K+8 iterations in both;
- the trainer from one initial state (the reference's ``jax.random``
  init, fed to the port's ``_run_iterations``): 3 iterations of rounding
  differences through ``reg = 0.1`` solves, ``atol = 1e-4`` on factors of
  O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.models import als as R
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu_torch.models import als as T
from pio_tpu_torch.parallel.context import ComputeContext

CPU = torch.device("cpu")
CFG = dict(rank=8, iterations=12, reg=0.01, blocks_per_chunk=64)


@pytest.fixture(scope="module")
def synthetic():
    # the fixture of tests/test_als.py
    rng = np.random.default_rng(0)
    U, I, K = 60, 40, 4
    P = rng.normal(size=(U, K))
    Q = rng.normal(size=(I, K))
    R_ = P @ Q.T
    mask = rng.random((U, I)) < 0.6
    u_idx, i_idx = np.nonzero(mask)
    return dict(U=U, I=I, R=R_, mask=mask, u=u_idx, i=i_idx,
                r=R_[u_idx, i_idx])


def _ctx():
    return ComputeContext.local(device="cpu")


def _train(u, i, r, U, I, **cfg):
    return T.train_als(_ctx(), u, i, r, U, I, T.ALSConfig(**cfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _edges(rng, E, N, n_other):
    ent = rng.integers(0, N, E).astype(np.int32)
    oth = rng.integers(0, n_other, E).astype(np.int32)
    rat = rng.random(E).astype(np.float32)
    return ent, oth, rat


# --------------------------------------------------------- host side: bitwise
@pytest.mark.parametrize("n_edges,n_entities", [
    (1, 1), (100, 100), (25_000_000, 162_541), (25_000_000, 59_047),
    (100_000, 943), (100_000, 1682), (10, 0),
])
def test_auto_width_matches_reference(n_edges, n_entities):
    assert T._auto_width(n_edges, n_entities) == R._auto_width(
        n_edges, n_entities)


@pytest.mark.parametrize("E,N,W,pad", [
    (5000, 80, 16, 8), (1, 4, 8, 8), (64, 4, 8, 8), (97, 200, 8, 64),
])
def test_pack_blocks_bitwise(E, N, W, pad):
    ent, oth, rat = _edges(np.random.default_rng(E), E, N, 999)
    got = T._pack_blocks(ent, oth, rat, N, W, pad)
    want = R._pack_blocks(ent, oth, rat, N, W, pad)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_sort_edges_by_user_bitwise():
    rng = np.random.default_rng(8)
    E, U, I = 3000, 50, 40  # many duplicate (user, item) pairs
    u = rng.integers(0, U, E).astype(np.int32)
    i = rng.integers(0, I, E).astype(np.int32)
    r = rng.random(E).astype(np.float32)
    counts = np.bincount(u, minlength=U).astype(np.int64)
    got = T._sort_edges_by_user(u, i, r)
    want = R._sort_edges_by_user(u, i, r, E, U, counts)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _segmented_ids(rng, counts, hi=60_000):
    return np.concatenate(
        [np.sort(rng.integers(0, hi, c)) for c in counts]
    ).astype(np.int32)


@pytest.mark.parametrize("codes", [
    [1, 10, 7, 15, 0, 3, 9], [4, 2], [15],
])
def test_nibble_pack_bitwise(codes):
    c = np.array(codes, np.uint8)
    assert np.array_equal(T._nibble_pack(c), R._nibble_pack(c))


@pytest.mark.parametrize("n_pad", [1000, 70_000, 1 << 24])
def test_planes_bitwise(n_pad):
    idx = np.random.default_rng(3).integers(0, n_pad, 500).astype(np.int32)
    for g, w in zip(T._planes(idx, n_pad), R._planes(idx, n_pad)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_delta_encoders_bitwise(monkeypatch):
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 40, 300).astype(np.int64)
    counts[:3] = 0  # empty leading users
    ids = _segmented_ids(rng, counts)
    assert np.array_equal(T._np_deltas(ids, counts), R._np_deltas(ids, counts))
    assert T._delta_wire_size(ids, counts) == R._delta_wire_size(ids, counts)
    got = T._encode_items_delta(ids, counts)
    want = R._encode_items_delta(ids, counts)
    assert len(got[2]) > 0, "fixture must exercise the overflow list"
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # not segment-sorted → the delta wire does not apply, in both
    rev = ids[::-1].copy()
    assert T._delta_wire_size(rev, counts) is None
    assert R._delta_wire_size(rev, counts) is None
    assert T._encode_items_delta(ids[:0], counts[:0])[4] == 0


@pytest.mark.parametrize("kind,ratings", [
    ("u4", [0.5, 5.0, 3.0, 1.5, 2.5]),
    ("u8", [8.5, 0.5, 100.0]),
    ("f16", [0.125, 1.0, 3.25]),
    ("f32", [0.123, 3.7]),
])
def test_encode_ratings_bitwise(kind, ratings, monkeypatch):
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    r = np.array(ratings, np.float32)
    got, got_kind = T._encode_ratings(r)
    want, want_kind = R._encode_ratings(r)
    assert got_kind == want_kind == kind
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("env", ["auto", "planes", "delta12"])
def test_choose_item_wire_matches_reference(env, monkeypatch):
    """The port's item_wire argument against the reference's
    PIO_TPU_ALS_ITEM_WIRE of the same value."""
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    monkeypatch.setenv("PIO_TPU_ALS_ITEM_WIRE", env)
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 30, 50).astype(np.int64)
    ids = _segmented_ids(rng, counts, hi=300)
    E = len(ids)
    got = T._choose_item_wire(ids, counts, 300, E, item_wire=env)
    want = R._choose_item_wire(ids, counts, 300, E)
    assert got == want


# -------------------------------------------------------- device side: bitwise
@pytest.mark.parametrize("E,N,W", [(5000, 80, 16), (1, 4, 8), (64, 4, 8),
                                   (97, 200, 8)])
def test_device_pack_bitwise(E, N, W):
    """The cases of tests/test_als.py's device_pack test, against the
    host packer and the reference's device_pack."""
    ent, oth, rat = _edges(np.random.default_rng(21 + E), E, N, 999)
    ref = R._pack_blocks(ent, oth, rat, N, W, 8)
    S = ref[0].shape[0]
    jgot = jax.jit(R.device_pack, static_argnums=(3, 4, 5))(
        jnp.asarray(ent), jnp.asarray(oth), jnp.asarray(rat), N, W, S)
    got = T.device_pack(_t(ent), _t(oth), _t(rat), N, W, S)
    for g, h, j in zip(got, ref, jgot):
        assert g.numpy().dtype == h.dtype
        assert np.array_equal(g.numpy(), h)
        assert np.array_equal(g.numpy(), np.asarray(j))


def test_device_pack_sorted_with_counts_bitwise():
    """The by-user layout of the trainer: ids rebuilt from counts, sorted
    by construction, and a redirected padding entity."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 20, 30).astype(np.int32)
    E = int(counts.sum())
    ent = np.repeat(np.arange(30, dtype=np.int32), counts)
    oth = rng.integers(0, 50, E).astype(np.int32)
    rat = rng.random(E).astype(np.float32)
    S = 64
    for pad_entity in (None, 27):
        got = T.device_pack(None, _t(oth), _t(rat), 30, 8, S,
                            assume_sorted=True, counts=_t(counts),
                            pad_entity=pad_entity)
        want = R.device_pack(None, jnp.asarray(oth), jnp.asarray(rat), 30, 8,
                             S, assume_sorted=True,
                             counts=jnp.asarray(counts),
                             pad_entity=pad_entity)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def _ref_math(item_wire="planes", rating_wire="f32", implicit=False,
              solver="cholesky", reg=0.1, alpha=40.0, mm="float32"):
    return R._make_math(reg, implicit, alpha, mm, solver, rating_wire,
                        item_wire)


@pytest.mark.parametrize("n_pad", [1000, 70_000, 1 << 24])
def test_decode_items_planes_bitwise(n_pad):
    ids = np.random.default_rng(2).integers(0, n_pad, 700).astype(np.int32)
    lo, hi = T._planes(ids, n_pad)
    got = T.decode_items(T._wire_tensor(lo, CPU), T._wire_tensor(hi, CPU))
    want = _ref_math().decode_items(jnp.asarray(lo), jnp.asarray(hi))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), ids)


def test_decode_items_delta12_bitwise():
    """Gaps > 4095 ride the overflow list; empty users and duplicates."""
    rng = np.random.default_rng(3)
    counts = np.array([0, 5, 0, 3, 1, 7, 0, 40, 2], np.int64)
    ids = _segmented_ids(rng, counts)
    d_lo, d_hi, ovf_idx, ovf_val, _ = T._encode_items_delta(ids, counts)
    assert len(ovf_idx) > 0
    c32 = counts.astype(np.int32)
    got = T.decode_items(
        *(T._wire_tensor(a, CPU) for a in (d_lo, d_hi, ovf_idx, ovf_val, c32)),
        item_wire="delta12")
    want = _ref_math(item_wire="delta12").decode_items(
        *(jnp.asarray(a) for a in (d_lo, d_hi, ovf_idx, ovf_val, c32)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), ids)


@pytest.mark.parametrize("kind,ratings", [
    ("u4", [0.5, 5.0, 3.0, 1.5, 2.5]),  # odd count: half a byte unused
    ("u4", [1.0, 2.0]),
    ("u8", [8.5, 0.5, 100.0]),
    ("f16", [0.125, 1.0, 3.25]),
    ("f32", [0.123, 3.7]),
])
def test_decode_ratings_bitwise(kind, ratings):
    r = np.array(ratings, np.float32)
    wire, got_kind = T._encode_ratings(r)
    assert got_kind == kind
    got = T.decode_ratings(T._wire_tensor(wire, CPU), len(r), kind)
    want = _ref_math(rating_wire=kind).decode_ratings(jnp.asarray(wire), len(r))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), r)


# ----------------------------------------------- device side: within tolerance
def _blocks(seed=0, E=900, N=40, n_other=30, W=8, chunk=16):
    rng = np.random.default_rng(seed)
    ent, oth, _ = _edges(rng, E, N, n_other)
    rat = (rng.integers(1, 11, E) * 0.5).astype(np.float32)
    blocks = T._pack_blocks(ent, oth, rat, N, W, chunk)
    factors = np.abs(rng.normal(size=(n_other, 6))).astype(np.float32)
    return blocks, factors


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("chunk", [16, 4096])  # entities span chunks / not
def test_partial_normal_eq_matches_reference(implicit, chunk):
    blocks, factors = _blocks(chunk=16)
    N = 40
    A, b = T.partial_normal_eq(*(_t(x) for x in blocks), _t(factors), N,
                               min(chunk, blocks[0].shape[0]),
                               implicit=implicit, alpha=2.0)
    rA, rb = _ref_math(implicit=implicit, alpha=2.0).partial_normal_eq(
        *(jnp.asarray(x) for x in blocks), jnp.asarray(factors), N, 16)
    np.testing.assert_allclose(A.numpy(), np.asarray(rA), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=1e-5, atol=1e-5)


def test_partial_normal_eq_bfloat16_matches_reference():
    """Explicit bfloat16: both gather bf16 rows and round the weighted rows
    to bf16; products of bf16 values are exact in f32, so the same
    tolerance as float32."""
    blocks, factors = _blocks(seed=1)
    A, b = T.partial_normal_eq(*(_t(x) for x in blocks), _t(factors), 40, 16,
                               implicit=True, alpha=3.0,
                               matmul_dtype=torch.bfloat16)
    rA, rb = _ref_math(implicit=True, alpha=3.0,
                       mm="bfloat16").partial_normal_eq(
        *(jnp.asarray(x) for x in blocks), jnp.asarray(factors), 40, 16)
    np.testing.assert_allclose(A.numpy(), np.asarray(rA), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=1e-5, atol=1e-5)


def _heavy_blocks(W=8, chunk=4):
    """One entity with 25 blocks (it spans seven chunks of 4), entities
    with no edge between the others, and padding blocks at the end."""
    rng = np.random.default_rng(7)
    ent = np.concatenate([np.full(200, 3), rng.choice([0, 1, 4, 9, 11], 120)])
    ent = ent.astype(np.int32)
    oth = rng.integers(0, 30, len(ent)).astype(np.int32)
    rat = (rng.integers(1, 11, len(ent)) * 0.5).astype(np.float32)
    blocks = T._pack_blocks(ent, oth, rat, 12, W, chunk)
    factors = np.abs(rng.normal(size=(30, 6))).astype(np.float32)
    return blocks, factors


@pytest.mark.parametrize("implicit", [False, True])
def test_partial_normal_eq_carries_across_chunks(implicit):
    """An entity whose blocks span several chunks is carried from chunk to
    chunk; empty entities stay zero (reference tolerance as above)."""
    blocks, factors = _heavy_blocks()
    A, b = T.partial_normal_eq(*(_t(x) for x in blocks), _t(factors), 12, 4,
                               implicit=implicit, alpha=2.0)
    rA, rb = _ref_math(implicit=implicit, alpha=2.0).partial_normal_eq(
        *(jnp.asarray(x) for x in blocks), jnp.asarray(factors), 12, 4)
    np.testing.assert_allclose(A.numpy(), np.asarray(rA), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=1e-5, atol=1e-5)
    assert not A[[2, 5, 6, 7, 8, 10]].any() and not b[[2, 5, 6, 7, 8, 10]].any()


def test_segment_plan_covers_each_chunk():
    blocks, _ = _heavy_blocks()
    ent = _t(blocks[0])
    plan = T.segment_plan(ent, 4)
    assert [lo for lo, _, _ in plan] == list(range(0, len(ent), 4))
    for lo, e0, offsets in plan:
        seg = ent[lo:lo + 4]
        lengths = offsets.diff()
        assert int(offsets[0]) == 0 and int(offsets[-1]) == len(seg)
        assert e0 == int(seg[0]) and e0 + len(lengths) - 1 == int(seg[-1])
        assert torch.equal(torch.repeat_interleave(
            torch.arange(e0, e0 + len(lengths)), lengths), seg.long())


def test_partial_normal_eq_same_bits_at_any_plan():
    """A plan made once and passed in gives the bits of one made inside."""
    blocks, factors = _heavy_blocks()
    tb = tuple(_t(x) for x in blocks)
    plan = T.segment_plan(tb[0], 4)
    A1, b1 = T.partial_normal_eq(*tb, _t(factors), 12, 4, plan=plan)
    A2, b2 = T.partial_normal_eq(*tb, _t(factors), 12, 4)
    assert torch.equal(A1, A2) and torch.equal(b1, b2)


@pytest.mark.parametrize("solver", ["cholesky", "cg", "lu"])
@pytest.mark.parametrize("implicit", [False, True])
def test_solve_block_matches_reference(solver, implicit):
    blocks, factors = _blocks(seed=2)
    A, b = T.partial_normal_eq(*(_t(x) for x in blocks), _t(factors), 40, 16)
    gram = T.gram_of(_t(factors), implicit)
    got = T.solve_block(A, b, gram, 0.1, implicit, solver)
    m = _ref_math(implicit=implicit, solver=solver, reg=0.1)
    rgram = m.gram_of(jnp.asarray(factors))
    np.testing.assert_allclose(gram.numpy(), np.asarray(rgram), rtol=1e-5,
                               atol=1e-5)
    want = m.solve_block(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()), rgram)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_solve_block_unknown_solver_raises():
    A = torch.eye(2)[None].repeat(3, 1, 1)
    with pytest.raises(ValueError, match="unknown ALS solver"):
        T.solve_block(A, torch.ones(3, 2), torch.zeros(2, 2), 0.1,
                      solver="choleski")


def _reference_init(seed, U, I, rank):
    """The reference's init (pio_tpu/models/als.py:480-483), as numpy."""
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    scale = jnp.float32(rank) ** -0.5
    return (
        np.asarray(jnp.abs(jax.random.normal(ku, (U, rank), jnp.float32))
                   * scale),
        np.asarray(jnp.abs(jax.random.normal(ki, (I, rank), jnp.float32))
                   * scale),
    )


@pytest.mark.parametrize("implicit", [False, True])
def test_local_trainer_from_reference_init(synthetic, implicit):
    """3 iterations of the port's trainer and of the reference's half-steps
    from the reference's init give the same factors (module docstring)."""
    s = synthetic
    rank, W, chunk = 4, 8, 16
    r = np.abs(s["r"]).astype(np.float32) if implicit \
        else s["r"].astype(np.float32)
    cfg = T.ALSConfig(rank=rank, iterations=3, reg=0.1, implicit=implicit,
                      alpha=2.0)
    u = s["u"].astype(np.int32)
    i = s["i"].astype(np.int32)
    by_user = T._pack_blocks(u, i, r, s["U"], W, chunk)
    by_item = T._pack_blocks(i, u, r, s["I"], W, chunk)
    P0, Q0 = _reference_init(1, s["U"], s["I"], rank)
    P, Q = T._run_iterations(tuple(_t(x) for x in by_user),
                             tuple(_t(x) for x in by_item), _t(P0), _t(Q0),
                             cfg, chunk, chunk)
    m = _ref_math(implicit=implicit, alpha=2.0, reg=0.1, solver="cholesky")
    jb_u = tuple(jnp.asarray(x) for x in by_user)
    jb_i = tuple(jnp.asarray(x) for x in by_item)
    rP, rQ = jnp.asarray(P0), jnp.asarray(Q0)
    for _ in range(3):
        rP = m.half_local(jb_u, rQ, s["U"], chunk)
        rQ = m.half_local(jb_i, rP, s["I"], chunk)
    np.testing.assert_allclose(P.numpy(), np.asarray(rP), atol=1e-4)
    np.testing.assert_allclose(Q.numpy(), np.asarray(rQ), atol=1e-4)


def test_train_als_runs_the_reference_pipeline(synthetic, monkeypatch):
    """Through the wire: the port's train_als with the init swapped for the
    reference's trains the reference train_als's factors (grid ratings,
    so the u4 wire is exact)."""
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    s = synthetic
    rng = np.random.default_rng(9)
    r = (rng.integers(1, 11, len(s["u"])) * 0.5).astype(np.float32)
    cfg = dict(rank=4, iterations=3, reg=0.1, blocks_per_chunk=16, seed=5)
    want = R.train_als(JaxContext.local(), s["u"], s["i"], r, s["U"], s["I"],
                       R.ALSConfig(**cfg))
    P0, Q0 = _reference_init(5, s["U"], s["I"], 4)
    inits = iter([_t(P0), _t(Q0)])
    monkeypatch.setattr(T, "_init_factors", lambda *a: next(inits))
    stats = {}
    got = T.train_als(_ctx(), s["u"], s["i"], r, s["U"], s["I"],
                      T.ALSConfig(**cfg), stats=stats)
    assert stats["encoding"].startswith("u4")
    np.testing.assert_allclose(got.user_factors, want.user_factors, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, want.item_factors, atol=1e-4)


# ------------------------------------- mirrors of tests/test_als.py, local
def test_reconstructs_observed_local(synthetic):
    s = synthetic
    f = _train(s["u"], s["i"], s["r"], s["U"], s["I"], **CFG)
    pred = f.user_factors @ f.item_factors.T
    rmse = np.sqrt(np.mean((pred[s["u"], s["i"]] - s["r"]) ** 2))
    assert rmse < 0.05
    assert f.user_factors.shape == (s["U"], 8)
    assert f.item_factors.shape == (s["I"], 8)
    assert f.user_factors.dtype == np.float32


def test_two_runs_same_bits(synthetic):
    s = synthetic
    a = _train(s["u"], s["i"], s["r"], s["U"], s["I"], **CFG)
    b = _train(s["u"], s["i"], s["r"], s["U"], s["I"], **CFG)
    assert np.array_equal(a.user_factors, b.user_factors)
    assert np.array_equal(a.item_factors, b.item_factors)


def test_implicit_separates_observed(synthetic):
    s = synthetic
    f = _train(s["u"], s["i"], np.abs(s["r"]), s["U"], s["I"], rank=8,
               iterations=8, reg=0.1, implicit=True, alpha=10,
               blocks_per_chunk=64)
    pred = f.user_factors @ f.item_factors.T
    hu, hi = np.nonzero(~s["mask"])
    assert pred[s["u"], s["i"]].mean() > pred[hu, hi].mean() + 0.1


def test_cg_solver_matches_cholesky(synthetic):
    s = synthetic
    preds = {}
    for solver in ("cholesky", "cg", "lu"):
        f = _train(s["u"], s["i"], s["r"], s["U"], s["I"], rank=4,
                   iterations=10, reg=0.1, blocks_per_chunk=64, solver=solver)
        preds[solver] = (f.user_factors @ f.item_factors.T)[s["u"], s["i"]]
    assert np.abs(preds["cg"] - preds["cholesky"]).max() < 0.05
    assert np.abs(preds["lu"] - preds["cholesky"]).max() < 0.05


def test_unknown_solver_raises(synthetic):
    s = synthetic
    with pytest.raises(ValueError, match="unknown ALS solver"):
        _train(s["u"], s["i"], s["r"], s["U"], s["I"], solver="choleski")


def test_empty_ratings_raises():
    with pytest.raises(ValueError, match="at least one rating"):
        T.train_als(_ctx(), np.array([], np.int32), np.array([], np.int32),
                    np.array([], np.float32), 5, 5)


def test_non_grid_ratings_train():
    rng = np.random.default_rng(3)
    E = 400
    u = rng.integers(0, 30, E).astype(np.int32)
    i = rng.integers(0, 20, E).astype(np.int32)
    r = (rng.random(E) * 3.7 + 0.123).astype(np.float32)  # not fp16-exact
    stats = {}
    f = T.train_als(_ctx(), u, i, r, 30, 20,
                    T.ALSConfig(rank=4, iterations=3, reg=0.05), stats=stats)
    assert stats["encoding"].startswith("f32")
    assert np.isfinite(f.user_factors).all()
    pred = (f.user_factors[u] * f.item_factors[i]).sum(1)
    assert np.sqrt(np.mean((pred - r) ** 2)) < 1.0


def test_single_rating():
    f = _train(np.array([0], np.int32), np.array([0], np.int32),
               np.array([5.0], np.float32), 1, 1, rank=2, iterations=3,
               reg=0.01)
    assert abs(float(f.user_factors[0] @ f.item_factors[0]) - 5.0) < 0.5


def test_item_wire_formats_agree_bitwise(synthetic):
    """delta12 decode is integer-exact: planes and delta12 train the same
    bits (train_als's host side with each wire asked for, then its device
    side from one init)."""
    s = synthetic
    cfg = T.ALSConfig(**CFG)
    u, i = s["u"].astype(np.int32), s["i"].astype(np.int32)
    r = s["r"].astype(np.float32)
    outs = {}
    for wire in ("planes", "delta12"):
        host_wire, shapes, rating_wire, got_wire, _ = T._encode_wire(
            u, i, r, s["U"], s["I"], cfg, item_wire=wire)
        assert got_wire == wire
        gen = torch.Generator().manual_seed(0)
        P0 = T._init_factors(s["U"], cfg.rank, gen)
        Q0 = T._init_factors(s["I"], cfg.rank, gen)
        by_user, by_item = T._decode_pack(
            tuple(T._wire_tensor(a, CPU) for a in host_wire), shapes,
            s["U"], s["I"], rating_wire, wire)
        outs[wire] = T._run_iterations(by_user, by_item, P0, Q0, cfg,
                                       shapes[0], shapes[3])
    assert torch.equal(outs["planes"][0], outs["delta12"][0])
    assert torch.equal(outs["planes"][1], outs["delta12"][1])


def test_stats_phases(synthetic):
    s = synthetic
    st = {}
    T.train_als(_ctx(), s["u"], s["i"], s["r"], s["U"], s["I"],
                T.ALSConfig(**CFG), stats=st)
    for k in ("packer", "pack_s", "wire_bytes", "h2d_s", "device_s",
              "n_stream", "encoding"):
        assert k in st, (k, st)
    assert st["wire_bytes"] > 0 and st["device_s"] > 0
    assert st["n_stream"] == 1  # the port always ships one piece


def test_entity_counts_with_empty_rows():
    # 7 users, 3 items; user and item ids with no ratings keep finite rows
    u = np.array([0, 1, 2, 3, 4, 5, 6, 0, 1], np.int32)
    i = np.array([0, 1, 2, 0, 1, 2, 0, 2, 0], np.int32)
    r = np.ones(9, np.float32) * 2.0
    f = _train(u, i, r, 9, 4, rank=2, iterations=4, reg=0.01)
    assert f.user_factors.shape == (9, 2)
    assert f.item_factors.shape == (4, 2)
    assert np.isfinite(f.user_factors).all()


def test_wide_id_space_plane_encoding():
    """Item ids ≥ 2^16 ship as uint16 + uint8 planes."""
    rng = np.random.default_rng(5)
    u = rng.integers(0, 8, 120).astype(np.int32)
    hi_items = np.array([65_536, 70_000, 99_999], np.int32)
    i = hi_items[rng.integers(0, 3, 120)]
    Rm = rng.normal(size=(8, 3)).astype(np.float32)
    r = Rm[u, np.searchsorted(hi_items, i)]
    st = {}
    f = T.train_als(_ctx(), u, i, r, 8, 100_000,
                    T.ALSConfig(rank=4, iterations=10, reg=0.05), stats=st)
    assert st["encoding"].endswith("planes")
    pred = (f.user_factors[u] * f.item_factors[i]).sum(1)
    assert float(np.sqrt(np.mean((pred - r) ** 2))) < 0.1


@pytest.mark.parametrize("scores,n,exclude,want", [
    ([0.1, 5.0, 3.0, 4.0], 2, None, [1, 3]),
    ([0.1, 5.0, 3.0, 4.0], 2, [1], [3, 2]),
    ([1.0, 2.0], 10, None, [1, 0]),
])
def test_host_top_n_matches_reference(scores, n, exclude, want):
    s = np.array(scores)
    ex = None if exclude is None else np.array(exclude)
    idx, vals = T.top_n(s, n, ex)
    ridx, rvals = R.top_n(s, n, ex)
    assert idx.tolist() == ridx.tolist() == want
    assert np.array_equal(vals, rvals)
    uf = np.arange(6, dtype=np.float32).reshape(3, 2)
    itf = np.ones((4, 2), np.float32)
    assert np.array_equal(T.predict_scores(uf, itf, 1),
                          R.predict_scores(uf, itf, 1))


# ------------------------------------------------------------------- the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(synthetic, cuda_device):
    """train_als on the card against the CPU, same seed and init: the
    same math in another summation order, limit 1e-4 on the factors."""
    s = synthetic
    cfg = T.ALSConfig(rank=4, iterations=3, reg=0.1, blocks_per_chunk=16)
    cpu = T.train_als(_ctx(), s["u"], s["i"], s["r"], s["U"], s["I"], cfg)
    gpu = T.train_als(ComputeContext.local(device=cuda_device), s["u"],
                      s["i"], s["r"], s["U"], s["I"], cfg)
    np.testing.assert_allclose(gpu.user_factors, cpu.user_factors, atol=1e-4)
    np.testing.assert_allclose(gpu.item_factors, cpu.item_factors, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True])
def test_card_bfloat16_products_match_cpu(cuda_device, implicit):
    """Explicit bfloat16: the card's bf16 products (cuBLAS, f32
    accumulation) against the CPU's upcast operands — the same bf16
    values and exact products, summed in another order (1e-5). With
    implicit feedback the card rounds each weighted row to bf16 (the
    CPU keeps it f32): relative 2^-8 over sums of positive terms."""
    blocks, factors = _heavy_blocks()
    args = dict(implicit=implicit, alpha=2.0, matmul_dtype=torch.bfloat16)
    A, b = T.partial_normal_eq(*(_t(x) for x in blocks), _t(factors), 12, 4,
                               **args)
    Ag, bg = T.partial_normal_eq(*(_t(x).to(cuda_device) for x in blocks),
                                 _t(factors).to(cuda_device), 12, 4, **args)
    tol = 2.0 ** -8 if implicit else 1e-5
    np.testing.assert_allclose(Ag.cpu().numpy(), A.numpy(), rtol=tol,
                               atol=1e-5)
    np.testing.assert_allclose(bg.cpu().numpy(), b.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("knob", ["planes", "delta12", "auto"])
def test_item_wire_knob_is_read_like_reference(knob, monkeypatch):
    """``PIO_TPU_ALS_ITEM_WIRE`` picks the item wire in both packages: at
    MovieLens-100K's shape (100,000 seeded ratings over 943 x 1,682) the
    port's ``encoding`` and ``wire_bytes`` equal the reference's exactly,
    and the trainer from the reference's init gives its factors (the
    tolerance of ``test_train_als_runs_the_reference_pipeline``)."""
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    monkeypatch.setenv("PIO_TPU_ALS_ITEM_WIRE", knob)
    rng = np.random.default_rng(100)
    U, I, E = 943, 1682, 100_000
    u = rng.integers(0, U, E).astype(np.int32)
    i = rng.integers(0, I, E).astype(np.int32)
    r = (rng.integers(1, 11, E) * 0.5).astype(np.float32)
    cfg = dict(rank=4, iterations=2, reg=0.1, seed=3)
    want_stats = {}
    want = R.train_als(JaxContext.local(), u, i, r, U, I, R.ALSConfig(**cfg),
                       stats=want_stats)
    P0, Q0 = _reference_init(3, U, I, 4)
    inits = iter([_t(P0), _t(Q0)])
    monkeypatch.setattr(T, "_init_factors", lambda *a: next(inits))
    stats = {}
    got = T.train_als(_ctx(), u, i, r, U, I, T.ALSConfig(**cfg), stats=stats)
    assert stats["encoding"] == want_stats["encoding"]
    assert stats["encoding"].endswith(
        {"planes": "+planes", "delta12": "+delta12", "auto": ""}[knob])
    assert stats["wire_bytes"] == want_stats["wire_bytes"]
    np.testing.assert_allclose(got.user_factors, want.user_factors, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, want.item_factors, atol=1e-4)
