"""The port's native ALS packer against its numpy routes and the reference's.

The same seeded numpy inputs go through ``pio_tpu_torch.models.als`` twice
— on the native route (``pio_tpu_torch/native/als_pack.cpp``, built with
``g++``) and with ``PIO_TPU_NO_NATIVE`` set, the numpy route — and through
``pio_tpu.models.als`` on its numpy route. Every check is bitwise: counts,
sorts and encoders are integer or copy work. Sizes of 2^20 edges and more
reach the packer's multi-threaded paths.
"""

import shutil

import numpy as np
import pytest

from pio_tpu.models import als as R
from pio_tpu_torch import native
from pio_tpu_torch.models import als as T
from pio_tpu_torch.parallel.context import ComputeContext

BIG = (1 << 20) + 4097  # above the packer's one-thread limit


def _routes(monkeypatch, fn):
    """``fn()`` on the native route, then on the numpy route (the
    reference's numpy route too: the variable is the same)."""
    monkeypatch.delenv("PIO_TPU_NO_NATIVE", raising=False)
    got = fn()
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    want = fn()
    monkeypatch.delenv("PIO_TPU_NO_NATIVE")
    return got, want


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b


def _edges(seed, E, U, I):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, E).astype(np.int32)
    i = (rng.random(E) ** 2 * I).astype(np.int32)  # popularity skew
    # distinct ratings, so a sort that is not stable shows
    r = rng.permutation(E).astype(np.float32)
    return u, i, r


@pytest.mark.parametrize("E,N,W", [(1, 1, 16), (5000, 80, 16), (BIG, 997, 64)])
def test_counts_layout_native_is_numpy(monkeypatch, E, N, W):
    ent = _edges(E, E, N, 10)[0]
    got, want = _routes(monkeypatch,
                        lambda: T._counts_layout(ent, W, N + 3, 4096))
    _same(got, want)
    assert got[0].dtype == np.int64
    assert np.array_equal(got[0], np.bincount(ent, minlength=N + 3))


def test_counts_out_of_range_raise_on_both_routes(monkeypatch):
    for bad in ([0, 5], [-1, 0]):
        ent = np.array(bad, np.int32)
        for env in (None, "1"):
            if env:
                monkeypatch.setenv("PIO_TPU_NO_NATIVE", env)
            with pytest.raises(ValueError):
                T._counts_layout(ent, 16, 3, 64)
        monkeypatch.delenv("PIO_TPU_NO_NATIVE")


@pytest.mark.parametrize("E,U,I", [(3000, 50, 40), (BIG, 4099, 3001)])
def test_sort_edges_native_is_lexsort(monkeypatch, E, U, I):
    """The two-pass native sort (counting sort by user, then a stable
    radix or insertion sort of each user's items) gives numpy's stable
    lexsort order, duplicate (user, item) pairs included."""
    u, i, r = _edges(E + 1, E, U, I)
    counts = np.bincount(u, minlength=U).astype(np.int64)
    got, want = _routes(monkeypatch,
                        lambda: T._sort_edges_by_user(u, i, r, counts))
    _same(got, want)
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    _same(got, R._sort_edges_by_user(u, i, r, E, U, counts))
    # without the counts the native route counts itself
    monkeypatch.delenv("PIO_TPU_NO_NATIVE")
    _same(T._sort_edges_by_user(u, i, r), got)


def _segmented(rng, counts, hi):
    return np.concatenate(
        [np.sort(rng.integers(0, hi, c)) for c in counts]).astype(np.int32)


@pytest.mark.parametrize("hi", [300, 60_000])
def test_delta_encoders_native_is_numpy(monkeypatch, hi):
    """Random sorted users (empty ones too) and the gaps at the 12-bit
    edge: those of 4096 and more go to the overflow list."""
    rng = np.random.default_rng(hi)
    counts = rng.integers(0, 40, 300).astype(np.int64)
    counts[:3] = 0
    counts[-2:] = 0
    # one user with gaps 4095, 4096, 4097 and 0, one whose only item is
    # 65535 (a first gap from 0)
    edge = [0, 4095, 8191, 12288, 12288], [65535]
    if hi < 4096:
        edge = [0, 7, 7, hi - 1], [hi - 1]
    ids = np.concatenate([_segmented(rng, counts, hi), *edge]).astype(np.int32)
    counts = np.concatenate([counts, [len(e) for e in edge]])
    got_size, want_size = _routes(monkeypatch,
                                  lambda: T._delta_wire_size(ids, counts))
    got, want = _routes(monkeypatch,
                        lambda: T._encode_items_delta(ids, counts))
    _same(got_size, want_size)
    _same(got, want)
    if hi > 4096:
        assert len(got[2]) >= 3, "the input must reach the overflow list"
    # the count pass saved by the caller gives the same wire
    _same(T._encode_items_delta(ids, counts, n_ovf=got_size[1]), got)
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    _same(want_size, R._delta_wire_size(ids, counts))
    _same(want, tuple(R._encode_items_delta(ids, counts)))


def test_delta_wire_does_not_apply_on_both_routes(monkeypatch):
    counts = np.array([3, 2], np.int64)
    unsorted = np.array([5, 3, 9, 1, 2], np.int32)
    wide = np.array([0, 65536, 65537, 1, 2], np.int32)  # a gap of 2^16
    for ids in (unsorted, wide):
        got, want = _routes(monkeypatch,
                            lambda: T._delta_wire_size(ids, counts))
        assert got is None and want is None
    got, want = _routes(monkeypatch, lambda: T._delta_wire_size(
        np.array([0, 65535], np.int32), np.array([2], np.int64)))
    assert got == want == (2 + 1 + 5, 1)  # d_lo, d_hi, one overflow


@pytest.mark.parametrize("kind,ratings", [
    ("u4", [0.5, 5.0, 3.0, 1.5, 2.5]),
    ("u4", [1.0, -0.0, 7.5]),
    ("u8", [8.5, 0.5, 100.0, 127.5]),
    ("f16", [0.125, 1.0, 3.25, 200.0]),
    ("f16", [np.inf, 1.0]),
    ("f32", [0.123, 3.7]),
    ("f32", [np.nan, 1.0]),
    ("f16", []),
])
def test_encode_ratings_native_is_numpy(monkeypatch, kind, ratings):
    r = np.array(ratings, np.float32)
    got, want = _routes(monkeypatch, lambda: T._encode_ratings(r))
    assert got[1] == want[1] == kind
    assert got[0].dtype == want[0].dtype
    assert np.array_equal(got[0].view(np.uint8), want[0].view(np.uint8))
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    ref, ref_kind = R._encode_ratings(r)
    assert ref_kind == kind
    assert np.array_equal(ref.view(np.uint8), want[0].view(np.uint8))


def test_encode_ratings_native_at_size(monkeypatch):
    rng = np.random.default_rng(3)
    r = (rng.integers(1, 11, BIG) * 0.5).astype(np.float32)
    got, want = _routes(monkeypatch, lambda: T._encode_ratings(r))
    _same(got, want)
    assert got[1] == "u4"


@pytest.mark.parametrize("E,N,W,pad", [
    (5000, 80, 16, 8), (1, 4, 8, 8), (64, 4, 8, 8), (97, 200, 8, 64),
    (BIG, 3001, 32, 4096),
])
def test_pack_fill_is_pack_blocks(monkeypatch, E, N, W, pad):
    """``als_pack_fill`` (the native route of ``_pack_blocks``) against the
    numpy packer and the reference's."""
    ent, oth, rat = _edges(E + 2, E, N, 999)
    got, want = _routes(monkeypatch,
                        lambda: T._pack_blocks(ent, oth, rat, N, W, pad))
    _same(got, want)
    _same(tuple(R._pack_blocks(ent, oth, rat, N, W, pad)), want)


def test_train_als_native_and_numpy_same_bits(monkeypatch):
    """The two routes ship the same wire, so the factors are the same
    bits; ``stats["packer"]`` names the route that ran."""
    u, i, _ = _edges(7, 4000, 60, 50)
    r = (np.random.default_rng(7).integers(1, 11, 4000) * 0.5).astype(
        np.float32)
    cfg = T.ALSConfig(rank=4, iterations=3, blocks_per_chunk=16)
    ctx = ComputeContext.local(device="cpu")
    runs = {}

    def run():
        st = {}
        f = T.train_als(ctx, u, i, r, 60, 50, cfg, stats=st)
        runs[st["packer"]] = st
        return f.user_factors, f.item_factors

    got, want = _routes(monkeypatch, run)
    _same(got, want)
    assert set(runs) == {"native", "numpy"}
    assert runs["native"]["encoding"] == runs["numpy"]["encoding"] == \
        "u4+delta12"
    assert runs["native"]["wire_bytes"] == runs["numpy"]["wire_bytes"]


def test_no_native_never_builds(monkeypatch):
    """With ``PIO_TPU_NO_NATIVE`` the numpy routes run and the library is
    neither built nor loaded."""

    def refuse():
        raise AssertionError("the native library was asked for")

    monkeypatch.setattr(native, "als_pack_lib", refuse)
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    u, i, r = _edges(1, 500, 20, 30)
    st = {}
    T.train_als(ComputeContext.local(device="cpu"), u, i, r, 20, 30,
                T.ALSConfig(rank=2, iterations=1), stats=st)
    assert st["packer"] == "numpy"
    monkeypatch.delenv("PIO_TPU_NO_NATIVE")
    with pytest.raises(AssertionError, match="asked for"):
        T._counts_layout(u, 16, 20, 64)


def _broken_source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(native.SRC_DIR / "als_pack.cpp", src / "als_pack.cpp")
    with open(src / "als_pack.cpp", "a") as f:
        f.write("\nint broken_on_purpose( {\n")
    return src


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = _broken_source(tmp_path)
    with pytest.raises(native.NativeBuildError, match="broken_on_purpose"):
        native.build_library("als_pack", src_dir=src,
                             build_dir=tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))
    assert not list((tmp_path / "out").glob("*.tmp"))


def test_failed_build_fails_train_als(tmp_path, monkeypatch):
    """No quiet fallback: a packer that does not build fails the run."""
    src = _broken_source(tmp_path)
    monkeypatch.setattr(native, "als_pack_lib", lambda: native.build_library(
        "als_pack", src_dir=src, build_dir=tmp_path / "out"))
    monkeypatch.delenv("PIO_TPU_NO_NATIVE", raising=False)
    u, i, r = _edges(2, 100, 5, 5)
    with pytest.raises(native.NativeBuildError):
        T.train_als(ComputeContext.local(device="cpu"), u, i, r, 5, 5,
                    T.ALSConfig(rank=2, iterations=1))


def test_build_is_cached_by_source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(native.SRC_DIR / "topn_host.cpp", src / "topn_host.cpp")
    out = tmp_path / "out"
    first = native.build_library("topn_host", src_dir=src, build_dir=out)
    stamp = first.stat().st_mtime_ns
    assert native.build_library("topn_host", src_dir=src,
                                build_dir=out) == first
    assert first.stat().st_mtime_ns == stamp
    with open(src / "topn_host.cpp", "a") as f:
        f.write("\n// an edit\n")
    assert native.build_library("topn_host", src_dir=src,
                                build_dir=out) != first
    assert len(list(out.glob("topn_host-*.so"))) == 2
