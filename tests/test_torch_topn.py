"""The port's DeviceTopNScorer against the JAX package's, on the CPU.

Mirrors the non-mesh cases of ``tests/test_topn_scorer.py``.
The port's device path runs its torch programs on ``device="cpu"``; the
reference's runs its jitted programs on the JAX CPU backend. Both score
in float32 from the same factors, so indices must match where the scores
have no ties, and scores within ``rtol = 1e-5`` (a rank-8 dot of O(1)
values in another summation order). On deliberate ties both must give
the reference's order: larger score first, then lower index. The native
host scorer is held bitwise to the numpy host path on inputs whose dot
products are exact (every summation order gives the same bits), and to
the reference's native scorer, the same C++ loop, on any input.
"""

import pickle

import numpy as np
import pytest
import torch

from pio_tpu.ops.topn import DeviceTopNScorer as JaxScorer
from pio_tpu.ops.topn import _bucket as jax_bucket
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import ALSFactors
from pio_tpu_torch.ops import topn
from pio_tpu_torch.ops.topn import DeviceTopNScorer, _bucket
from pio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSModel,
    Query,
    recommendation_engine,
)


def _factors(n_rows=37, n_cols=53, k=8, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(n_rows, k)).astype(np.float32),
        rng.normal(size=(n_cols, k)).astype(np.float32),
    )


def _scorer(rows, cols, **kw):
    return DeviceTopNScorer(rows, cols, device="cpu", **kw)


def _model(rows, cols):
    return ALSModel.from_factors(
        ALSFactors(rows, cols),
        BiMap.string_int([f"u{i}" for i in range(len(rows))]),
        BiMap.string_int([f"i{i}" for i in range(len(cols))]),
        device="cpu",
    )


@pytest.mark.parametrize("n,cap", [(1, 512), (3, 512), (16, 512),
                                   (700, 512), (5, 4)])
def test_bucket(n, cap):
    assert _bucket(n, cap) == jax_bucket(n, cap)
    assert topn._MAX_BATCH_BUCKET == 512


@pytest.mark.parametrize("device", [False, True])
def test_topn_matches_naive_and_reference(device):
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=device)
    ref = JaxScorer(rows, cols, prefer_device=device)
    codes = np.array([0, 3, 36, 7], np.int32)
    idx, vals = s.top_n_batch(codes, 5)
    ridx, rvals = ref.top_n_batch(codes, 5)
    assert idx.shape == (4, 5) and vals.shape == (4, 5)
    assert idx.dtype == np.int64 and vals.dtype == np.float32
    full = rows[codes] @ cols.T
    for b in range(4):
        want = np.argsort(-full[b])[:5]
        np.testing.assert_array_equal(idx[b], want)
        np.testing.assert_allclose(vals[b], full[b][want], rtol=1e-5)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(vals, rvals, rtol=1e-5)


@pytest.mark.parametrize("device", [False, True])
def test_topn_exclusion(device):
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=device)
    ref = JaxScorer(rows, cols, prefer_device=device)
    codes = np.array([1, 2], np.int32)
    full = rows[codes] @ cols.T
    top1 = np.argsort(-full, axis=1)[:, 0]
    excl = np.stack([
        [top1[0], int(np.argsort(-full[0])[1])],
        [top1[1], s.n_cols],  # sentinel slot
    ]).astype(np.int32)
    idx, vals = s.top_n_batch(codes, 3, exclude=excl)
    assert top1[0] not in idx[0]
    assert int(np.argsort(-full[0])[1]) not in idx[0]
    assert top1[1] not in idx[1]
    assert int(np.argsort(-full[1])[1]) == idx[1][0]
    ridx, rvals = ref.top_n_batch(codes, 3, exclude=excl)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(vals, rvals, rtol=1e-5)


@pytest.mark.parametrize("device", [False, True])
def test_ties_take_the_reference_order(device):
    """Duplicate columns give exactly equal scores: the lower index comes
    first, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(6, 4)).astype(np.float32)
    base = rng.normal(size=(5, 4)).astype(np.float32)
    cols = base[[0, 1, 0, 2, 1, 3, 0, 4, 2, 3, 4, 1]]  # each row thrice
    s = _scorer(rows, cols, prefer_device=device)
    ref = JaxScorer(rows, cols, prefer_device=True)
    codes = np.arange(6, dtype=np.int32)
    for n in (1, 4, 7, 12):
        idx, vals = s.top_n_batch(codes, n)
        ridx, rvals = ref.top_n_batch(codes, n)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_allclose(vals, rvals, rtol=1e-5)
    # all-equal scores (zero rows): ranked by index
    z = _scorer(np.zeros((2, 4), np.float32), cols, prefer_device=device)
    idx, _ = z.top_n_batch(np.array([0, 1], np.int32), 5)
    np.testing.assert_array_equal(idx, [[0, 1, 2, 3, 4]] * 2)


def test_device_and_host_paths_agree_with_nan_and_masked_rows():
    """NaN scores rank as -inf on both paths; a row whose exclusions leave
    fewer than n items surfaces -inf slots (dropped by the template), and
    the device path pins their index to 0."""
    rng = np.random.default_rng(10)
    rows = np.ones((3, 4), np.float32)
    cols = rng.normal(size=(20, 4)).astype(np.float32)
    cols[::3] = np.nan
    dev = _scorer(rows, cols, prefer_device=True)
    host = _scorer(rows, cols, prefer_device=False)
    codes = np.array([0, 1], np.int32)
    i_d, v_d = dev.top_n_batch(codes, 5)
    i_h, v_h = host.top_n_batch(codes, 5)
    assert np.isfinite(v_d).all()
    assert not set(i_d.flat) & set(range(0, 20, 3))
    np.testing.assert_array_equal(i_d, i_h)
    np.testing.assert_allclose(v_d, v_h, rtol=1e-5)
    excl = np.arange(18, dtype=np.int32)[None, :]
    i_d, v_d = dev.top_n_batch(codes[:1], 4, exclude=excl)
    assert np.isfinite(v_d).sum() == 1 and i_d[0, 0] == 19
    assert (i_d[0, 1:] == 0).all() and np.isneginf(v_d[0, 1:]).all()


@pytest.mark.parametrize("device", [False, True])
def test_large_batch_chunks_and_n_clamp(device):
    rows, cols = _factors(n_rows=600, n_cols=17)
    s = _scorer(rows, cols, prefer_device=device)
    codes = np.arange(600, dtype=np.int32) % 600
    idx, vals = s.top_n_batch(codes, 99)
    assert idx.shape == (600, 17)
    full = rows[codes] @ cols.T
    np.testing.assert_array_equal(idx[123], np.argsort(-full[123]))
    np.testing.assert_array_equal(idx[599], np.argsort(-full[599]))


@pytest.mark.parametrize("device", [False, True])
def test_pairs_and_scores(device):
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=device)
    ref = JaxScorer(rows, cols, prefer_device=device)
    rc = np.array([0, 5], np.int32)
    cc = np.array([7, 9], np.int32)
    np.testing.assert_allclose(
        s.score_pairs(rc, cc), np.einsum("bk,bk->b", rows[rc], cols[cc]),
        rtol=1e-5)
    np.testing.assert_allclose(s.score_pairs(rc, cc), ref.score_pairs(rc, cc),
                               rtol=1e-5)
    np.testing.assert_allclose(s.scores_batch(rc), rows[rc] @ cols.T,
                               rtol=1e-5)
    np.testing.assert_allclose(s.scores_batch(rc), ref.scores_batch(rc),
                               rtol=1e-5)


def test_adaptive_routing_by_link_speed():
    rows, cols = _factors()
    slow = _scorer(rows, cols, link_rtt_s=10.0)
    assert slow.on_device
    assert slow.min_device_batch > 1_000  # B=1 stays on host
    assert not slow._route_to_device(1)
    fast = _scorer(rows, cols, link_rtt_s=0.0)
    assert fast.min_device_batch == 1
    assert fast._route_to_device(1)
    codes = np.array([4, 9], np.int32)
    i1, v1 = slow.top_n_batch(codes, 3)
    i2, v2 = fast.top_n_batch(codes, 3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)


def test_probed_link_routes_a_local_device():
    """The probe measures a real round trip; to the CPU it is a copy."""
    rows, cols = _factors()
    s = _scorer(rows, cols)
    assert s.on_device and s.min_device_batch >= 1
    assert topn._probe_link_rtt_s("cpu") >= 0.0


def test_env_override_forces_host(monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "0")
    rows, cols = _factors()
    s = _scorer(rows, cols)
    assert not s.on_device
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "1")
    s = _scorer(rows, cols)
    assert s.on_device and s.min_device_batch == 1
    assert s.sharding_info() is None


def test_env_auto_routes_by_batch_size(monkeypatch):
    """PIO_TPU_SERVE_DEVICE=auto asks for the adaptive routing."""
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "auto")
    rows, cols = _factors()
    s = _scorer(rows, cols, link_rtt_s=10.0)
    assert s.on_device and s.min_device_batch > 1_000
    assert topn._env_mode(torch.device("cuda")) == "auto"


def test_unset_env_scores_on_the_card(monkeypatch):
    """Unset, a scorer on CUDA takes the device path at every batch size;
    one on the CPU routes by batch size."""
    monkeypatch.delenv("PIO_TPU_SERVE_DEVICE", raising=False)
    assert topn._env_mode(torch.device("cuda")) == "device"
    assert topn._env_mode(torch.device("cuda", 0)) == "device"
    assert topn._env_mode(torch.device("cpu")) == "auto"


def test_pair_routing_stays_on_host_for_small_batches():
    rows, cols = _factors()
    s = _scorer(rows, cols, link_rtt_s=1e-3)
    assert s.min_pair_batch >= s.min_device_batch
    np.testing.assert_allclose(
        s.score_pairs([1], [2]), [float(rows[1] @ cols[2])], rtol=1e-5)


def test_predict_num_zero_returns_empty():
    rows, cols = _factors()
    m = _model(rows, cols)
    algo = ALSAlgorithm(None)
    assert algo.predict(m, Query(user="u1", num=0)).item_scores == ()
    assert dict(algo.batch_predict(
        m, [(0, Query(user="u1", num=0))]
    ))[0].item_scores == ()


def test_pairs_chunked(monkeypatch):
    """score_pairs chunks past its per-dispatch cap (the cap lowered here
    from 2^20 to keep the test small)."""
    monkeypatch.setattr(topn, "_PAIRS_CHUNK", 64)
    rows, cols = _factors(n_rows=50, n_cols=60)
    s = _scorer(rows, cols, prefer_device=True)
    rng = np.random.default_rng(1)
    B = 64 * 3 + 5
    rc = rng.integers(0, 50, B).astype(np.int32)
    cc = rng.integers(0, 60, B).astype(np.int32)
    got = s.score_pairs(rc, cc)
    assert got.shape == (B,)
    np.testing.assert_allclose(
        got, np.einsum("bk,bk->b", rows[rc], cols[cc]), rtol=1e-5)


def test_exclusion_widths():
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=True)
    codes = np.array([3], np.int32)
    top = np.argsort(-(rows[3] @ cols.T))
    for E in (1, 2, 3, 5, 9):
        idx, _ = s.top_n_batch(codes, 3, exclude=np.array([top[:E]], np.int32))
        np.testing.assert_array_equal(idx[0], top[E:E + 3])


def test_out_of_range_codes_raise_on_the_host():
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=True)
    with pytest.raises(IndexError):
        s.top_n_batch(np.array([37], np.int32), 3)
    with pytest.raises(IndexError):
        s.score_pairs(np.array([0], np.int32), np.array([-1], np.int32))


def test_batch_negative_num_matches_online():
    rows, cols = _factors()
    m = _model(rows, cols)
    algo = ALSAlgorithm(None)
    q = Query(user="u2", num=-1)
    assert algo.predict(m, q).item_scores == ()
    got = dict(algo.batch_predict(m, [(0, Query(user="u1", num=5)), (1, q)]))
    assert got[1].item_scores == ()
    assert len(got[0].item_scores) == 5


def test_empty_batch():
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=True)
    idx, vals = s.top_n_batch(np.empty(0, np.int32), 5)
    assert idx.shape == (0, 5)


def test_rank_mismatch_rejected():
    rows, cols = _factors()
    with pytest.raises(ValueError):
        _scorer(rows, cols[:, :4])


def test_empty_factor_tables():
    rows, cols = _factors()
    for r, c in [
        (np.empty((0, rows.shape[1]), np.float32), cols),
        (rows, np.empty((0, rows.shape[1]), np.float32)),
    ]:
        s = _scorer(r, c)
        assert not s.on_device
        if s.n_cols == 0:
            idx, vals = s.top_n_batch(np.empty(0, np.int32), 5)
            assert idx.shape == (0, 0) and vals.shape == (0, 0)
        assert s.score_pairs(
            np.empty(0, np.int32), np.empty(0, np.int32)
        ).shape == (0,)


def test_model_pickle_drops_scorer():
    rows, cols = _factors()
    m = _model(rows, cols)
    m.scorer(warmup=False)
    assert "_scorer" in m.__dict__
    m2 = pickle.loads(pickle.dumps(m))
    assert "_scorer" not in m2.__dict__ and "_scorer_lock" not in m2.__dict__
    idx, vals = m2.scorer().top_n_batch(np.array([0], np.int32), 3)
    assert idx.shape == (1, 3)


def test_scorer_lives_on_the_models_device():
    """The scorer follows the factors' device, and the device table is the
    model's own tensor, not a copy."""
    rows, cols = _factors()
    m = _model(rows, cols)
    s = m.scorer()
    assert s.device == torch.device("cpu")
    assert s._rows_dev.data_ptr() == m.factors.user_factors.data_ptr()


def test_prepare_for_serving_attaches_scorer():
    rows, cols = _factors()
    model = _model(rows, cols)
    ep = EngineParams(algorithm_params_list=(("als", None),))
    pairs = recommendation_engine().algorithms_with_models(ep, [model])
    assert "_scorer" in pairs[0][1].__dict__


# ------------------------------------------------------------------- the card
# ------------------------------------------------ the native host scorer
def _exact_factors(n_rows, n_cols, k, seed):
    """Multiples of 1/4 in [-2, 2]: every product and partial sum of a
    rank-k dot is exact in float32, so any summation order gives the same
    bits, and equal scores (ties) are frequent."""
    rng = np.random.default_rng(seed)
    return (
        (rng.integers(-8, 9, (n_rows, k)) / 4).astype(np.float32),
        (rng.integers(-8, 9, (n_cols, k)) / 4).astype(np.float32),
    )


@pytest.mark.parametrize("n_cols,k,n", [(53, 8, 1), (53, 8, 10),
                                        (53, 8, 53), (9000, 4, 25)])
def test_native_host_is_numpy_host_bitwise(n_cols, k, n):
    """The fused native scan-and-select against the numpy host path on
    exact inputs: the same indices and the same score bits, ties broken
    by lower index; 9000 columns span three of its 4096-column blocks."""
    rows, cols = _exact_factors(12, n_cols, k, n_cols + n)
    rows[3] = 0.0  # every score ties at zero
    s = _scorer(rows, cols, prefer_device=False)
    codes = np.arange(12, dtype=np.int32)
    i_n, v_n = s._top_n_host_native(codes, n)
    i_p, v_p = s._top_n_host_chunk(codes, n, None)
    np.testing.assert_array_equal(i_n, i_p)
    assert np.array_equal(v_n.view(np.uint32), v_p.view(np.uint32))
    # the all-tied row: zeros, by index
    np.testing.assert_array_equal(i_n[3], np.arange(n))
    assert (v_n[3] == 0).all()


def test_native_host_nan_and_negative_zero():
    """NaN scores rank last as -inf on both paths, and a score of -0.0
    comes back as +0.0 from both: the reference's C++ scorer returns the
    -0.0 of a sum of negative zeros (shown by building its source here),
    so the port's copy adds 0.0 to each score."""
    rows = np.array([[0.0, 0.0], [np.nan, 1.0], [1.0, 2.0]], np.float32)
    cols = np.array([[-1.0, -1.0], [2.0, 0.0], [-3.0, -2.0], [1.0, 1.0]],
                    np.float32)
    s = _scorer(rows, cols, prefer_device=False)
    codes = np.arange(3, dtype=np.int32)
    i_n, v_n = s._top_n_host_native(codes, 4)
    i_p, v_p = s._top_n_host_chunk(codes, 4, None)
    np.testing.assert_array_equal(i_n, i_p)
    assert np.array_equal(v_n.view(np.uint32), v_p.view(np.uint32))
    assert not np.signbit(v_n[0]).any() and np.isneginf(v_n[1]).all()


def test_reference_cpp_returns_negative_zero(tmp_path):
    """The difference the port's copy of topn_host.cpp fixes, on the
    reference's own source built by the port's builder."""
    import ctypes
    import pathlib

    from pio_tpu_torch import native

    ref_src = pathlib.Path(__file__).resolve().parents[1] / "pio_tpu" / \
        "native"
    lib = ctypes.CDLL(str(native.build_library(
        "topn_host", src_dir=ref_src, build_dir=tmp_path)))
    native._declare_topn_host(lib)
    rows = np.zeros((1, 2), np.float32)
    cols_t = np.ascontiguousarray(np.array([[-1.0, 2.0], [-1.0, 0.0]],
                                           np.float32))
    idx = np.empty((1, 2), np.int64)
    val = np.empty((1, 2), np.float32)
    lib.topn_host_f32(
        rows.ctypes.data_as(topn._F32P), cols_t.ctypes.data_as(topn._F32P),
        1, 2, 2, np.zeros(1, np.int32).ctypes.data_as(topn._I32P), 1, 2,
        idx.ctypes.data_as(topn._I64P), val.ctypes.data_as(topn._F32P))
    assert idx.tolist() == [[0, 1]] and np.signbit(val[0, 0])
    s = _scorer(rows, np.ascontiguousarray(cols_t.T), prefer_device=False)
    _, v = s._top_n_host_native(np.zeros(1, np.int32), 2)
    assert not np.signbit(v).any()


def test_native_host_matches_reference_native(tmp_home):
    """The same C++ loop as the reference's on random factors (no score
    is a negative zero): the same indices and bits."""
    rows, cols = _factors(n_rows=40, n_cols=5000, k=16, seed=4)
    s = _scorer(rows, cols, prefer_device=False)
    ref = JaxScorer(rows, cols, prefer_device=False)
    codes = np.array([0, 7, 39, 7, 12], np.int32)
    for n in (1, 10, 100):
        got = s._top_n_host_native(codes, n)
        want = ref._top_n_host_native(codes, n)
        assert want is not None, "the reference's native scorer must build"
        np.testing.assert_array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_host_routing_takes_native_without_exclusions(monkeypatch):
    """The native scorer for a host batch without exclusions, at any size
    (the reference stops at 8 rows); numpy for a batch with exclusions,
    and always under PIO_TPU_NO_NATIVE."""
    rows, cols = _factors()
    s = _scorer(rows, cols, prefer_device=False)
    assert s._cols_t is None  # the transposed mirror comes on first use
    calls = []
    real = s._top_n_host_native
    monkeypatch.setattr(s, "_top_n_host_native",
                        lambda c, n: calls.append(len(c)) or real(c, n))
    codes = np.arange(40, dtype=np.int32) % 37
    s.top_n_batch(codes[:8], 5)
    assert calls == [8] and s._cols_t.shape == (8, 53)
    s.top_n_batch(codes, 5)
    assert calls == [8, 40]
    s.top_n_batch(codes[:2], 5, exclude=np.array([[1], [2]], np.int32))
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    s.top_n_batch(codes[:1], 5)
    assert calls == [8, 40]
    monkeypatch.delenv("PIO_TPU_NO_NATIVE")
    with pytest.raises(IndexError):
        s.top_n_batch(np.array([37], np.int32), 3)


def test_batch_scores_single_item_queries_together(monkeypatch):
    """batch_predict sends the single-item queries of known users and
    items to the scorer in one score_pairs call (an evaluation fold's
    queries); the per-query predict gives the same scores."""
    rows, cols = _factors()
    m = _model(rows, cols)
    algo = ALSAlgorithm(None)
    qs = [(k, Query(user=f"u{k % 37}", item=f"i{(5 * k) % 53}"))
          for k in range(40)]
    qs += [(40, Query(user="u1", item="nope")),
           (41, Query(user="ghost", item="i1")),
           (42, Query(user="u2", num=3))]
    calls = []
    scorer = m.scorer()
    real = scorer.score_pairs
    monkeypatch.setattr(scorer, "score_pairs",
                        lambda r, c: calls.append(len(r)) or real(r, c))
    got = dict(algo.batch_predict(m, qs))
    assert calls == [40]
    for k, q in qs:
        want = algo.predict(m, q).item_scores
        assert [x.item for x in got[k].item_scores] == [x.item for x in want]
        np.testing.assert_allclose([x.score for x in got[k].item_scores],
                                   [x.score for x in want], rtol=1e-6)
    assert got[40].item_scores == () and got[41].item_scores == ()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_host(cuda_device):
    rows, cols = _factors(n_rows=300, n_cols=500)
    card = DeviceTopNScorer(rows, cols, prefer_device=True, device=cuda_device)
    host = DeviceTopNScorer(rows, cols, prefer_device=False,
                            device=cuda_device)
    codes = np.arange(300, dtype=np.int32)
    i_c, v_c = card.top_n_batch(codes, 10)
    i_h, v_h = host.top_n_batch(codes, 10)
    np.testing.assert_array_equal(i_c, i_h)
    np.testing.assert_allclose(v_c, v_h, rtol=1e-5)


@pytest.mark.cuda
def test_card_scorer_takes_the_card_for_one_query(cuda_device, monkeypatch):
    monkeypatch.delenv("PIO_TPU_SERVE_DEVICE", raising=False)
    rows, cols = _factors(n_rows=300, n_cols=500)
    s = DeviceTopNScorer(rows, cols, device=cuda_device)
    assert s.min_device_batch == 1 and s._route_to_device(1)
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "auto")
    s = DeviceTopNScorer(rows, cols, link_rtt_s=10.0, device=cuda_device)
    assert s.min_device_batch > 1_000
