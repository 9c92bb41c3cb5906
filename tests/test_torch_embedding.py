"""Parity of the port's embedding bag (pio_tpu_torch.ops.embedding) with
the JAX package's, on the CPU.

The same seeded numpy inputs go through ``_embedding_bag_xla`` (the JAX
reference arithmetic), the Pallas kernel in interpret mode (as
``tests/test_ops.py`` runs it) and the port's ``embedding_bag`` on
``device="cpu"`` (its plain version). The CUDA kernel itself runs only on
the card: its test is marked ``cuda`` and skips here.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops.embedding import (
    _embedding_bag_pallas,
    _embedding_bag_xla,
    pack_bags as jax_pack_bags,
)
from pio_tpu_torch.ops import embedding as temb

V, D, B, L = 64, 128, 5, 11


@pytest.fixture()
def bag_case():
    rng = np.random.default_rng(7)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids, w = jax_pack_bags(
        [rng.integers(0, V, size=rng.integers(1, L)) for _ in range(B)],
        [rng.random(L) for _ in range(B)],
    )
    return table, ids, w


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _port(table, ids, w, dtype=torch.float32):
    return temb.embedding_bag(
        torch.from_numpy(table).to(dtype),
        torch.from_numpy(ids),
        torch.from_numpy(w),
    ).numpy()


def test_cpu_matches_xla(bag_case):
    # same f32 arithmetic, summed in another order
    table, ids, w = bag_case
    ref = np.asarray(_embedding_bag_xla(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w)
    ))
    out = _port(table, ids, w)
    assert out.dtype == np.float32 and out.shape == (ids.shape[0], D)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_cpu_matches_pallas_interpret(bag_case):
    # the interpreter accumulates row by row; 1e-4 as test_ops.py allows
    table, ids, w = bag_case
    ref = np.asarray(_embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w), interpret=True
    ))
    np.testing.assert_allclose(_port(table, ids, w), ref, atol=1e-4)


def test_duplicate_ids_accumulate():
    table = np.eye(8, 128, dtype=np.float32)
    ids = np.asarray([[2, 2, 2, 0, 0, 0, 0, 0]], np.int32)
    w = np.asarray([[1.0, 2.0, 3.0, 0, 0, 0, 0, 0]], np.float32)
    out = _port(table, ids, w)
    assert out[0, 2] == pytest.approx(6.0)
    assert np.count_nonzero(out) == 1


def test_bf16_table_matches_jax_bf16(bag_case):
    # both widen the same bf16 values to f32 exactly, then sum in f32
    table, ids, w = bag_case
    ref = np.asarray(_embedding_bag_xla(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids), jnp.asarray(w)
    ))
    out = _port(table, ids, w, dtype=torch.bfloat16)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize(
    "bags, max_len",
    [
        (([[3, 4], [5]], [[1.0, 2.0], [0.5]]), None),
        (([[1, 2, 3, 4, 5, 6, 7, 8, 9]], [[0.1] * 9]), None),
        (([[1, 2, 3, 4, 5]], [[1.0] * 5]), 3),
        (([], []), None),
        (([[], [7]], [[], [2.0]]), 16),
    ],
    ids=["ragged", "over-8", "truncated", "empty", "empty-bag"],
)
def test_pack_bags_equals_jax(bags, max_len):
    want = jax_pack_bags(*bags, max_len=max_len)
    got = temb.pack_bags(*bags, max_len=max_len)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


def test_cpu_path_launches_no_kernel(bag_case, monkeypatch):
    monkeypatch.setattr(temb, "KERNEL_LAUNCHES", 0)
    _port(*bag_case)
    assert temb.KERNEL_LAUNCHES == 0


@pytest.mark.parametrize(
    "change, err",
    [
        (lambda t, i, w: (t.double(), i, w), TypeError),
        (lambda t, i, w: (t, i.long(), w), TypeError),
        (lambda t, i, w: (t, i, w.double()), TypeError),
        (lambda t, i, w: (t[0], i, w), ValueError),
        (lambda t, i, w: (t, i, w[:, :1]), ValueError),
    ],
    ids=["table-f64", "ids-i64", "weights-f64", "table-1d", "shape-mismatch"],
)
def test_wrapper_rejects_bad_inputs(bag_case, change, err):
    table, ids, w = (torch.from_numpy(a) for a in bag_case)
    with pytest.raises(err):
        temb.embedding_bag(*change(table, ids, w))


def test_build_targets_hopper_and_keys_on_source():
    from pio_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    path = _build.library_path("embedding_bag")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert (_build.CSRC / _build.SOURCES["embedding_bag"]).is_file()


# (B, L, D, table is a row view one row in): the served shapes and the
# shapes the launch plan treats apart
SHAPES = [
    pytest.param(1, 256, 128, False, id="query"),
    pytest.param(1024, 256, 128, False, id="serving"),
    pytest.param(4096, 64, 256, False, id="wide"),
    pytest.param(1, 1, 128, False, id="one-slot"),
    pytest.param(3, 7, 130, True, id="unaligned-view"),
    pytest.param(0, 8, 128, False, id="no-bags"),
    pytest.param(37, 300, 192, False, id="ragged-d"),
]
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


def _bags(rng, B, L, V):
    """Seeded bags with L2-normalised weights (|out| ~ 1, as TF-IDF bags
    give); bag 1, where there is one, has only weight-0 slots."""
    ids = rng.integers(0, V, size=(B, L), dtype=np.int32)
    w = rng.random((B, L), dtype=np.float32) + 0.01
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    if B > 1:
        w[1] = 0.0
    return ids, w.astype(np.float32)


def _table(rng, V, D, view):
    """[V, D] f32 table; with ``view`` a contiguous slice one row in, so
    its pointer is off by D*elem bytes."""
    full = rng.standard_normal((V + 1, D), dtype=np.float32)
    return full[1:] if view else full[:V]


@pytest.mark.parametrize("B, L, D, view", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_covers_every_slot_and_column_once(B, L, D, view, dtype):
    elem = torch.tensor([], dtype=dtype).element_size()
    # a fresh allocation is 16-byte aligned; one row in is D*elem bytes on
    align = min(16, (D * elem) & -(D * elem)) if view else 16
    plan = temb._plan(B, L, D, elem, align)
    per_lane = plan.vec_bytes // elem
    G = plan.group_lanes
    assert plan.vec_bytes >= elem
    assert (D * elem) % plan.vec_bytes == 0 and align % plan.vec_bytes == 0
    assert plan.col_slice == G * per_lane and 32 % G == 0
    assert plan.threads <= 1024
    assert plan.smem_bytes <= 48 * 1024  # no opt-in to more shared memory
    gx, gy = plan.grid
    assert gx * plan.bags_per_block >= B > (gx - 1) * plan.bags_per_block
    # columns: slices x lanes x elements per lane, each column of D once
    cols = (np.arange(gy)[:, None, None] * plan.col_slice
            + np.arange(G)[None, :, None] * per_lane
            + np.arange(per_lane)[None, None, :]).ravel()
    assert np.array_equal(np.sort(cols[cols < D]), np.arange(D))
    assert (gy - 1) * plan.col_slice < D  # no slice without a column
    # threads of one column slice, as the kernel indexes them:
    # (bag, group, lane within group) once each for every live bag
    t = np.arange(gx * plan.threads)
    bx, warp, lane = t // plan.threads, t % plan.threads // 32, t % 32
    bag = bx * plan.bags_per_block + warp // plan.warps_per_bag
    group = (warp % plan.warps_per_bag) * (32 // G) + lane // G
    key = (bag * plan.groups_per_bag + group) * G + lane % G
    live = key[bag < B]
    assert len(np.unique(live)) == len(live) == B * plan.groups_per_bag * G
    # slots: group g takes l = g, g + groups_per_bag, ...: each slot once
    slots = np.concatenate(
        [np.arange(g, L, plan.groups_per_bag) for g in range(plan.groups_per_bag)]
    )
    assert np.array_equal(np.sort(slots), np.arange(L))
    per_group = -(-L // plan.groups_per_bag)
    assert plan.warps_per_bag * (32 // G) * per_group >= L


@pytest.mark.parametrize(
    "B, L, D, elem, align, vec",
    [
        (1, 256, 128, 4, 16, 16),  # a 512 B row: one float4 a lane
        (1024, 256, 128, 2, 16, 16),  # 8 bf16 a lane, half a warp a row
        (3, 7, 130, 4, 8, 8),  # 520 B rows, pointer one row in
        (3, 7, 130, 2, 4, 4),  # 260 B rows
        (2, 3, 129, 2, 16, 2),  # 258 B rows: one bf16 a lane
    ],
)
def test_plan_takes_the_widest_lane_the_rows_allow(B, L, D, elem, align, vec):
    assert temb._plan(B, L, D, elem, align).vec_bytes == vec


def test_plan_splits_one_bag_across_warps():
    # a served query: one block of 16 warps, each group 16 slots, so the
    # 256 row loads go out in two steps of 8 a thread
    query = temb._plan(1, 256, 128, 4)
    assert query.grid == (1, 1) and query.warps_per_bag == 16
    assert query.groups_per_bag * 16 == 256
    # a batch chunk fills the card with fewer warps a bag: as many as the
    # 132 SMs hold at 32 warps each, and not one warp a bag more
    batch = temb._plan(1024, 256, 128, 4)
    assert batch.warps_per_bag < query.warps_per_bag
    warps = batch.grid[0] * batch.threads // 32
    assert warps <= 132 * 32 < warps + 1024


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("warps_per_sm", [16, 32, 64])
def test_plan_fills_the_card_it_is_given(sms, warps_per_sm):
    # the batch chunk's warps a bag follow the card's SM count and residency
    plan = temb._plan(1024, 256, 128, 4, 16, sms, warps_per_sm)
    assert plan.warps_per_bag == max(1, sms * warps_per_sm // 1024)
    assert plan.grid == (-(-1024 // plan.bags_per_block), 1)


def test_plan_for_reads_the_cards_sm_count(monkeypatch):
    monkeypatch.setattr(temb, "_sm_count", lambda device: 66)
    table = torch.zeros(10, 128)
    assert temb._plan_for(table, 1024, 256) == temb._plan(1024, 256, 128, 4,
                                                          16, 66)


@pytest.mark.parametrize("err", [0, 700])
def test_launch_passes_the_plan_as_the_c_entry_takes_it(monkeypatch, err):
    # the C entry launches the grid, block size and shared memory it is
    # given: 4 pointers, B, L, D, the plan's 8 ints in this order, stream
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    monkeypatch.setattr(temb, "_kernel", lambda suffix: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(temb, "KERNEL_LAUNCHES", 0)
    table = torch.zeros(10, 130)
    ids = torch.zeros(3, 5, dtype=torch.int32)
    plan = temb._plan(3, 5, 130, 4, 8)
    if err:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            temb._launch(table, ids, torch.zeros(3, 5), plan)
    else:
        assert temb._launch(table, ids, torch.zeros(3, 5), plan).shape == (3, 130)
    (args,) = calls
    assert len(args) == 16 and args[4:7] == (3, 5, 130) and args[15] == 7
    assert args[7:15] == (plan.vec_bytes, plan.warps_per_bag,
                          plan.bags_per_block, plan.group_lanes, *plan.grid,
                          plan.threads, plan.smem_bytes)
    assert temb.KERNEL_LAUNCHES == (0 if err else 1)


@pytest.mark.parametrize("B, L, D, view", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_matches_xla_at_plan_shapes(B, L, D, view, dtype):
    # bf16 tables widen to f32 exactly in both; the same f32 products,
    # summed in another order: 1e-5 at |out| ~ 1
    rng = np.random.default_rng(11)
    table = _table(rng, 50, D, view)
    ids, w = _bags(rng, B, L, 50)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(_embedding_bag_xla(
        jnp.asarray(table, jdt), jnp.asarray(ids), jnp.asarray(w)
    ))
    out = _port(table, ids, w, dtype=dtype)
    assert out.shape == (B, D) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)
    if B > 1:
        assert not out[1].any()  # the bag of weight-0 slots


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, D, view", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_card(cuda_device, B, L, D, view, dtype):
    rng = np.random.default_rng(3)
    full = torch.from_numpy(
        rng.standard_normal((1001, D), dtype=np.float32)
    ).to(cuda_device, dtype)
    table = full[1:] if view else full[:1000]
    assert table.is_contiguous()
    ids, w = (torch.from_numpy(a).to(cuda_device) for a in _bags(rng, B, L, 1000))
    before = temb.KERNEL_LAUNCHES
    out = temb.embedding_bag(table, ids, w)
    again = temb.embedding_bag(table, ids, w)
    torch.cuda.synchronize()
    assert temb.KERNEL_LAUNCHES == before + (2 if B else 0)
    assert torch.equal(out, again)  # fixed summation order
    ref = temb.embedding_bag_plain(table, ids, w)
    # same f32 products, another summation order (|out| ~ 1)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    if B > 1:
        assert not out[1].any()
