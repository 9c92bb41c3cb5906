"""The embedding bag's backward in the port against the JAX package's.

The same seeded numpy inputs go through ``jax.vjp`` of
``pio_tpu.ops.embedding.embedding_bag`` (its ``custom_vjp``: a segment sum
for ``d_table``, a gathered dot for ``d_weights``) and through torch
autograd of ``pio_tpu_torch.ops.embedding.embedding_bag`` on the CPU,
where the backward runs its plain versions. The two CUDA kernels of the
backward (bag scatter, bag dot) run only on the card: their tests are
marked ``cuda`` and skip here.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops.embedding import embedding_bag as jax_embedding_bag
from pio_tpu_torch.ops import embedding as temb

V, D, B, L = 40, 24, 6, 9


def _case(seed=5, V=V, D=D, B=B, L=L):
    """Seeded table, bags with repeated ids and weight-0 slots (bag 1 all
    weight 0, the last two slots of every bag padding), and a cotangent."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = rng.integers(0, V, size=(B, L), dtype=np.int32)
    ids[:, 0] = ids[:, 1]  # a row twice in one bag
    w = (rng.random((B, L), dtype=np.float32) + 0.01)
    w[:, -2:] = 0.0
    if B > 1:
        w[1] = 0.0
    g = rng.standard_normal((B, D), dtype=np.float32)
    return table, ids, w, g


def _jax_grads(table, ids, w, g, dtype=jnp.float32):
    _, vjp = jax.vjp(
        lambda t, ww: jax_embedding_bag(t, jnp.asarray(ids), ww),
        jnp.asarray(table, dtype), jnp.asarray(w),
    )
    d_table, d_w = vjp(jnp.asarray(g))
    return (np.asarray(jnp.asarray(d_table, jnp.float32)), np.asarray(d_w))


def _port_grads(table, ids, w, g, dtype=torch.float32):
    t = torch.from_numpy(table).to(dtype).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = temb.embedding_bag(t, torch.from_numpy(ids), ww)
    d_table, d_w = torch.autograd.grad(out, [t, ww], torch.from_numpy(g))
    assert d_table.dtype == dtype and d_w.dtype == torch.float32
    return d_table.float().numpy(), d_w.numpy()


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_grads_match_jax_f32(seed):
    # the same f32 products, summed in another order: 1e-5 at |grad| ~ 1-10
    want = _jax_grads(*_case(seed))
    got = _port_grads(*_case(seed))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_, w_, atol=1e-5, rtol=1e-6)


def test_grads_match_jax_bf16_table():
    # d_table is summed in f32 and cast to bf16 in both: equal up to one
    # bf16 rounding step (2^-8 relative) where the f32 sums differ in the
    # last bit; d_w widens the same bf16 rows to f32 exactly
    case = _case(8)
    want_t, want_w = _jax_grads(*case, dtype=jnp.bfloat16)
    got_t, got_w = _port_grads(*case, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_t, want_t, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got_w, want_w, atol=1e-5, rtol=1e-6)


def test_zero_weight_slot_gets_a_weight_gradient():
    # d out / d w[b, l] = table[ids[b, l]] whatever w[b, l] is
    table, ids, w, g = _case(9)
    assert w[1].max() == 0.0
    _, d_w = _port_grads(table, ids, w, g)
    want = np.einsum("ld,d->l", table[ids[1]], g[1])
    assert np.abs(want).min() > 0
    np.testing.assert_allclose(d_w[1], want, rtol=1e-5)
    np.testing.assert_allclose(d_w[:, -1], np.einsum("bd,bd->b", table[ids[:, -1]], g),
                               rtol=1e-5)


def test_rows_only_weight_zero_slots_touch_get_zero():
    table, ids, w, g = _case(10)
    d_table, _ = _port_grads(table, ids, w, g)
    live = set(ids[w != 0].tolist())
    dead = [v for v in range(V) if v not in live]
    assert dead and not d_table[dead].any()
    assert all(d_table[v].any() for v in live)


def test_no_gradient_for_ids_and_none_without_requires_grad():
    table, ids, w, g = _case()
    t = torch.from_numpy(table).requires_grad_(True)
    out = temb.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(w))
    (d_table,) = torch.autograd.grad(out, [t], torch.from_numpy(g))
    assert d_table.shape == (V, D)
    with torch.no_grad():
        assert not temb.embedding_bag(
            t, torch.from_numpy(ids), torch.from_numpy(w)).requires_grad


def test_backward_passes_the_plan_and_skips_d_w_unless_asked(monkeypatch):
    table, ids, w, g = _case()
    ids_t, w_t = torch.from_numpy(ids), torch.from_numpy(w)
    plan = temb.bag_plan(ids_t, w_t, V)
    seen, real = [], temb.embedding_bag_backward_table
    monkeypatch.setattr(temb, "embedding_bag_backward_table",
                        lambda *a, plan=None: seen.append(plan) or real(*a))
    monkeypatch.setattr(temb, "embedding_bag_backward_weights",
                        lambda *a: pytest.fail("d_w was not asked for"))
    t = torch.from_numpy(table).requires_grad_(True)
    out = temb.embedding_bag(t, ids_t, w_t, plan)
    torch.autograd.grad(out, [t], torch.from_numpy(g))
    assert seen == [plan]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_table_plain_is_the_segment_sum(dtype):
    table, ids, w, g = _case(11)
    want = np.zeros((V, D), np.float64)
    np.add.at(want, ids.reshape(-1),
              (g[:, None, :] * w[:, :, None]).reshape(-1, D).astype(np.float64))
    got = temb.embedding_bag_backward_table(
        torch.from_numpy(g), torch.from_numpy(ids), torch.from_numpy(w), V, dtype
    )
    assert got.dtype == dtype and got.shape == (V, D)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-6)


def test_plain_backward_of_no_bags_is_zero():
    g, ids, w = torch.zeros(0, D), torch.zeros((0, L), dtype=torch.int32), torch.zeros(0, L)
    d_table = temb.embedding_bag_backward_table(g, ids, w, V)
    assert d_table.shape == (V, D) and not d_table.any()
    assert temb.embedding_bag_backward_weights(g, torch.ones(V, D), ids).shape == (0, L)


def test_nb_keys_and_unit_gradient_give_feature_sums():
    # kernel A's second caller: key y*V + id, one column, g = 1
    _, ids, w, _ = _case(12)
    y = np.arange(B) % 3
    keys = (y[:, None] * V + ids).astype(np.int32)
    got = temb.embedding_bag_backward_table(
        torch.ones(B, 1), torch.from_numpy(keys), torch.from_numpy(w), 3 * V
    ).reshape(3, V).numpy()
    want = np.zeros((3, V), np.float64)
    np.add.at(want, (np.repeat(y, L), ids.reshape(-1)), w.reshape(-1))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bag_plan_lists_non_zero_slots_by_row_in_slot_order(seed):
    _, ids, w, _ = _case(seed)
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), V)
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    assert plan.order.dtype == plan.offsets.dtype == torch.int32
    assert plan.n_rows == V and plan.shape == (B, L)
    assert offsets[0] == 0 and offsets[-1] == len(order) == np.count_nonzero(w)
    flat_ids, flat_w = ids.reshape(-1), w.reshape(-1)
    for v in range(V):
        want = np.flatnonzero((flat_ids == v) & (flat_w != 0))
        np.testing.assert_array_equal(order[offsets[v]:offsets[v + 1]], want)
    assert plan.bags.dtype == torch.int32
    np.testing.assert_array_equal(plan.bags.numpy(), order // L)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bag_plan_bags_ascend_within_each_row(seed):
    # kernel A's cursors walk a row's bags chunk by chunk: never backwards
    _, ids, w, _ = _case(seed, V=7, B=30, L=12)  # rows hit many times
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), 7)
    bags, offsets = plan.bags.numpy(), plan.offsets.numpy()
    for v in range(7):
        row = bags[offsets[v]:offsets[v + 1]]
        assert len(row) > 1 and np.all(np.diff(row) >= 0)
        assert row.min() >= 0 and row.max() < 30


@pytest.mark.parametrize("seed", [0, 1])
def test_bag_plan_rows_by_slot_count_most_first(seed):
    _, ids, w, _ = _case(seed)
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), V)
    rows, counts = plan.rows.numpy(), np.diff(plan.offsets.numpy())
    assert plan.rows.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(rows), np.arange(V))
    np.testing.assert_array_equal(rows, np.argsort(-counts, kind="stable"))


def test_bag_plan_of_no_bags_has_empty_rows():
    plan = temb.bag_plan(torch.zeros((0, 8), dtype=torch.int32),
                         torch.zeros((0, 8)), 5)
    assert plan.order.numel() == 0
    assert plan.offsets.tolist() == [0] * 6


@pytest.mark.parametrize("bad", [-1, V])
def test_bag_plan_rejects_ids_out_of_range(bad):
    _, ids, w, _ = _case()
    ids[0, 0] = bad
    with pytest.raises(ValueError, match="must lie in"):
        temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), V)


def test_out_of_range_id_of_a_zero_weight_slot_is_not_planned():
    _, ids, w, _ = _case()
    ids[1, 0] = V + 5  # bag 1 is all weight 0
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), V)
    assert int(plan.offsets[-1]) == np.count_nonzero(w)


def test_given_plan_must_fit_the_bags():
    _, ids, w, g = _case()
    ids_t, w_t = torch.from_numpy(ids), torch.from_numpy(w)
    plan = temb.bag_plan(ids_t, w_t, V)
    with pytest.raises(ValueError, match="does not fit"):
        temb._backward_table_cuda(torch.from_numpy(g), ids_t, w_t, V + 1,
                                  torch.float32, plan)
    with pytest.raises(ValueError, match="does not fit"):
        temb._backward_table_cuda(torch.from_numpy(g[:2]), ids_t[:2], w_t[:2],
                                  V, torch.float32, plan)


# -------------------------------------------------------------- geometry
@pytest.mark.parametrize(
    "D, aligns, epl",
    [
        (128, [(16, 4)], 4),
        (130, [(16, 4)], 2),  # 520-byte rows
        (128, [(8, 4)], 2),  # g one odd row in
        (1, [(16, 4)], 1),  # NB: one column
        (128, [(16, 4), (8, 2)], 4),  # bf16 table, 8 bytes a lane
        (128, [(16, 4), (4, 2)], 2),
        (129, [(16, 4), (16, 2)], 1),
    ],
)
def test_lane_elems_takes_the_widest_the_rows_allow(D, aligns, epl):
    assert temb._lane_elems(D, *aligns) == epl


GEOMETRIES = [
    pytest.param(65537, 128, 4, id="mlp-d-table"),
    pytest.param(20 * 65537, 1, 1, id="nb-feature-sums"),
    pytest.param(7, 130, 2, id="unaligned"),
    pytest.param(3, 20, 4, id="narrow"),
    pytest.param(1, 512, 4, id="wide"),
]


#: bags of the training shape: kernel A stages all of g's slice at once
N_BAGS = 11314


@pytest.mark.parametrize("n_rows, D, epl", GEOMETRIES)
def test_scatter_geometry_covers_every_row_and_column_once(n_rows, D, epl):
    geo = temb._scatter_geo(n_rows, N_BAGS, D, epl)
    assert D % geo.dt == 0 and geo.dt % epl == 0 and geo.grid_y * geo.dt == D
    assert geo.threads % 32 == 0
    # slices of 32 rows, of lengths as a plan sorts them, to all the warps
    # of a column slice: each slice (so each row) once
    n_slices = -(-n_rows // 32)
    widths = np.sort(np.random.default_rng(n_rows).zipf(1.5, n_slices))[::-1]
    slices, starts = temb._lpt(widths, geo.grid_x * geo.threads // 32)
    assert starts[0] == 0 and starts[-1] == n_slices and np.all(np.diff(starts) >= 0)
    assert np.array_equal(np.sort(slices), np.arange(n_slices))


@pytest.mark.parametrize("n_rows, D, epl", GEOMETRIES)
def test_scatter_geometry_fits_the_budget_the_c_side_checks(n_rows, D, epl):
    geo = temb._scatter_geo(n_rows, N_BAGS, D, epl)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= temb._SCATTER_THREADS
    assert geo.smem_bytes <= temb._SCATTER_SMEM_BYTES
    assert temb._smem_stride(geo.dt) % min(4, geo.dt) == 0  # aligned reads
    assert geo.grid_y <= 65535 and geo.grid_x >= 1
    # all of g's slice fits: one pass, and no wider slice would
    assert geo.chunk_bags == N_BAGS and geo.passes(N_BAGS) == 1
    wider = [t for t in (16, 8, 4, 2) if t > geo.dt and D % t == 0 and t % epl == 0]
    assert all(N_BAGS * temb._smem_stride(t) * 4 > temb._SCATTER_SMEM_BYTES
               for t in wider)


def test_scatter_geometry_at_the_training_and_nb_shapes():
    # g [11314, 128] f32: 4 columns a block (181 KB), 32 slices; one block
    # an SM, 4 blocks a slice on 132 SMs
    assert temb._scatter_geo(65537, N_BAGS, 128, 4) == temb.ScatterGeometry(
        4, 4, 1024, N_BAGS, 4, 32)
    nb = temb._scatter_geo(20 * 65537, N_BAGS, 1, 1, blocks_per_sm=2)
    assert (nb.dt, nb.grid_x, nb.grid_y, nb.smem_bytes) == (1, 264, 1, 4 * N_BAGS)


def test_scatter_geometry_constants_match_the_c_side():
    import re

    from pio_tpu_torch.ops import _build

    src = (_build.CSRC / _build.SOURCES["embedding_bag_bwd"]).read_text()
    threads = re.search(r"kScatterThreads = (\d+);", src).group(1)
    smem = re.search(r"kScatterSmemBytes = (\d+) \* 1024;", src).group(1)
    assert int(threads) == temb._SCATTER_THREADS
    assert int(smem) * 1024 == temb._SCATTER_SMEM_BYTES
    above, pad = map(int, re.search(
        r"return dt > (\d+) \? dt \+ (\d+) : dt;", src).groups())
    for dt in (16, 8, 4, 2, 1):
        assert temb._smem_stride(dt) == (dt + pad if dt > above else dt)


def test_scatter_geometry_takes_fewer_threads_and_blocks_for_few_rows():
    geo = temb._scatter_geo(1000, 64, 128, 4)
    assert (geo.dt, geo.threads, geo.grid_x, geo.grid_y) == (16, 1024, 1, 8)
    geo = temb._scatter_geo(40, 64, 128, 4)
    assert (geo.threads, geo.grid_x) == (64, 1)


def test_scatter_geometry_takes_passes_when_g_does_not_fit():
    geo = temb._scatter_geo(65537, 100_000, 128, 4)
    # the narrowest slice the copy width allows, chunks of g that fill the
    # shared memory
    assert geo.dt == 4 and geo.chunk_bags == temb._SCATTER_SMEM_BYTES // 16
    assert geo.passes(100_000) == 7 and geo.smem_bytes <= temb._SCATTER_SMEM_BYTES


@pytest.mark.parametrize("args", [(0, 8, 16, 4), (5, 8, 16, 3), (5, 8, 6, 4), (5, -1, 16, 4)])
def test_scatter_geometry_rejects_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError, match="no scatter geometry"):
        temb._scatter_geo(*args)


def _walk(plan, g, w, geo):
    """numpy model of kernel A as the geometry launches it: the records
    gathered by ``cell_src``; a pass a chunk of bags; in each, every warp walks
    its scheduled slices, lane i the row at position 32 s + i, through that
    row's cells of the pass. Returns d_table (f32) and how often each flat
    slot was added in each column slice."""
    rows, lens, so, rec_slot = (t.numpy() for t in (
        plan.rows, plan.lens, plan.slice_offsets, plan.cell_src))
    n_rows, (B, D), L = plan.n_rows, g.shape, plan.shape[1]
    flat_w = w.reshape(-1)
    passes = geo.passes(B)
    starts = (temb._pass_starts(plan, B, geo.chunk_bags).numpy()
              if passes > 1 else np.zeros((0, n_rows), np.int32))
    bounds = [np.zeros(n_rows, np.int64), *starts, lens]
    warps = geo.grid_x * geo.threads // 32
    slices, warp_starts = temb._lpt(lens[::32], warps)
    acc = np.zeros((n_rows, D), np.float32)
    visits = np.zeros((B * L, geo.grid_y), np.int64)
    for p in range(passes):
        b_lo = p * geo.chunk_bags
        b_hi = min(B, b_lo + geo.chunk_bags)
        written = np.zeros((n_rows, D), np.int64)
        for y in range(geo.grid_y):
            cols = slice(y * geo.dt, (y + 1) * geo.dt)
            for wp in range(warps):
                for s in slices[warp_starts[wp]:warp_starts[wp + 1]]:
                    for pos in range(32 * s, min(n_rows, 32 * s + 32)):
                        row = rows[pos]
                        for j in range(bounds[p][pos], bounds[p + 1][pos]):
                            slot = rec_slot[so[s] + 32 * j + pos % 32]
                            bag = slot // L
                            assert b_lo <= bag < b_hi  # staged this pass
                            acc[row, cols] += flat_w[slot] * g[bag, cols]
                            visits[slot, y] += 1
                        written[row, cols] += 1
        assert (written == 1).all()
    return acc, visits


def _walk_case(pattern):
    """(g, ids, w, n_rows, vec, chunk_bags or None, most threads a block)"""
    if pattern == "nb":
        _, ids, w, _ = _case(12)
        keys = ((np.arange(B) % 3)[:, None] * V + ids).astype(np.int32)
        return np.ones((B, 1), np.float32), keys, w, 3 * V, 1, None, 1024
    sizes = {"bags": dict(), "passes": dict(B=30), "narrow": dict(D=20),
             "unaligned": dict(D=130), "blocks": dict(V=300, B=40, L=16, D=16),
             "heavy-row": dict(V=30, B=40, L=16, D=16)}[pattern]
    _, ids, w, g = _case(15, **sizes)
    if pattern == "heavy-row":
        ids[:, ::2] = 7  # 320 slots on row 7, a few on the others
    vec = {"unaligned": 2}.get(pattern, 4)
    chunk = {"passes": 7, "heavy-row": 9}.get(pattern)
    threads = 64 if pattern == "blocks" else 1024
    return g, ids, w, sizes.get("V", V), vec, chunk, threads


@pytest.mark.parametrize("pattern", ["bags", "passes", "narrow", "unaligned",
                                     "blocks", "heavy-row", "nb"])
def test_scatter_walk_adds_every_slot_once_a_slice_and_equals_plain(pattern):
    g, ids, w, n_rows, vec, chunk, threads = _walk_case(pattern)
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), n_rows)
    geo = temb._scatter_geo(n_rows, g.shape[0], g.shape[1], vec, threads=threads)
    if chunk:
        geo = geo._replace(chunk_bags=chunk)
        assert geo.passes(g.shape[0]) > 1
    if pattern == "blocks":
        assert geo.grid_x > 1
    out, visits = _walk(plan, g, w, geo)
    assert (visits[w.reshape(-1) != 0] == 1).all() and not visits[w.reshape(-1) == 0].any()
    want = temb.embedding_bag_backward_table_plain(
        torch.from_numpy(g), torch.from_numpy(ids), torch.from_numpy(w), n_rows)
    # the same f32 products, summed in the plan's (b, l) order
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-5, atol=1e-5)


def test_pass_starts_split_each_row_at_the_chunk_bounds():
    _, ids, w, _ = _case(16, V=9, B=40, L=12)
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), 9)
    starts = temb._pass_starts(plan, 40, 15).numpy()  # passes 0-14, 15-29, 30-39
    assert starts.shape == (2, 9) and starts.dtype == np.int32
    bags, offsets = plan.bags.numpy(), plan.offsets.numpy()
    for pos, row in enumerate(plan.rows.numpy()):
        mine = bags[offsets[row]:offsets[row + 1]]
        for p, bound in enumerate((15, 30)):
            assert starts[p, pos] == np.count_nonzero(mine < bound)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bag_plan_cells_hold_each_rows_slots_in_order(seed):
    _, ids, w, _ = _case(seed, V=70, B=30, L=12)  # three slices, the last short
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), 70)
    order, offsets, rows, lens, so, src = (t.numpy() for t in (
        plan.order, plan.offsets, plan.rows, plan.lens, plan.slice_offsets,
        plan.cell_src))
    assert all(t.dtype == torch.int32 for t in plan[:7])
    assert len(so) == 4 and so[0] == 0 and so[-1] == plan.n_cells == len(src)
    np.testing.assert_array_equal(lens, np.diff(offsets)[rows])
    filled = np.zeros(len(src), bool)
    for pos, row in enumerate(rows):
        s, i = divmod(pos, 32)
        assert so[s + 1] - so[s] == 32 * lens[32 * s]  # as wide as its first row
        q = so[s] + 32 * np.arange(lens[pos]) + i
        # the row's slots in (b, l) order
        np.testing.assert_array_equal(src[q], order[offsets[row]:offsets[row + 1]])
        filled[q] = True
    assert (src[~filled] == -1).all()


def test_lpt_schedule_balances_skewed_slices():
    # a few slices as wide as a warp's share, many narrow ones (the main
    # path's bags: rows of up to 576 slots, 36 on average)
    widths = np.sort(np.concatenate([np.arange(576, 300, -9), np.full(2000, 30)]))[::-1]
    slices, starts = temb._lpt(widths, 128)
    work = np.array([widths[slices[a:b]].sum() + temb._SLICE_OVERHEAD * (b - a)
                     for a, b in zip(starts[:-1], starts[1:])])
    assert np.array_equal(np.sort(slices), np.arange(len(widths)))
    assert work.max() <= work.mean() + widths.max() + temb._SLICE_OVERHEAD
    assert work.max() <= 1.1 * max(work.mean(), widths.max() + temb._SLICE_OVERHEAD)


def test_schedule_is_built_once_for_each_count_of_warps():
    _, ids, w, _ = _case(3)
    plan = temb.bag_plan(torch.from_numpy(ids), torch.from_numpy(w), V)
    first = temb._schedule(plan, 4)
    assert temb._schedule(plan, 4) is first and set(plan.schedules) == {4}
    assert temb._schedule(plan, 8)[1].numel() == 9


@pytest.mark.parametrize(
    "D, elem, table_align, g_align, epl",
    [
        (128, 4, 16, 16, 4),
        (128, 2, 16, 16, 8),  # bf16: 16 bytes a lane
        (128, 2, 8, 16, 4),
        (128, 2, 16, 8, 2),  # g one odd row in: 8-byte g loads
        (130, 4, 16, 16, 2),
        (130, 2, 16, 16, 2),
        (1, 4, 16, 16, 1),
    ],
)
def test_dot_lane_elems_takes_the_widest_the_rows_allow(D, elem, table_align,
                                                         g_align, epl):
    assert temb._dot_lane_elems(D, elem, table_align, g_align) == epl


@pytest.mark.parametrize("n_bags, D, epl", GEOMETRIES)
@pytest.mark.parametrize("L", [1, 13, 256])
def test_dot_geometry_gives_each_span_of_a_bag_one_warp(n_bags, D, epl, L):
    geo = temb._dot_geo(n_bags, L, D, epl)
    group = min(32, 1 << max(0, -(-D // epl) - 1).bit_length())
    assert (geo.epl, geo.group_lanes) == (epl, group)
    # a warp walks whole rounds of 32 ids; no span longer than the bags
    assert geo.span % 32 == 0 and geo.span == min(temb._DOT_SPAN, -(-L // 32) * 32)
    warps = n_bags * -(-L // geo.span)
    assert geo.warps(n_bags, L) == warps
    per_block = geo.threads // 32
    assert geo.threads % 32 == 0 and 1 <= per_block <= temb._DOT_THREADS // 32
    assert geo.grid_x * per_block >= warps > (geo.grid_x - 1) * per_block


@pytest.mark.parametrize("args", [(0, 8, 16, 4), (5, 0, 16, 4), (5, 8, 0, 4),
                                  (5, 8, 6, 4), (5, 8, 16, 3), (5, 8, 16, 4, 48)])
def test_dot_geometry_rejects_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError, match="no dot geometry"):
        temb._dot_geo(*args)


def test_dot_constants_match_the_c_side():
    import re

    from pio_tpu_torch.ops import _build

    src = (_build.CSRC / _build.SOURCES["embedding_bag_bwd"]).read_text()
    assert int(re.search(r"kDotThreads = (\d+);", src).group(1)) == temb._DOT_THREADS
    assert int(re.search(r"kDotPartials = (\d+);", src).group(1)) == temb._DOT_PARTIALS


def _transpose_reduce(p, cols, G):
    """The lanes' partials (and the columns in each) after kernel B's
    transpose-reduce across groups of G lanes: halving steps while a lane
    holds more than one, then butterfly steps."""
    lanes = np.arange(32)
    step = 0
    while (1 << step) < G:
        o, m = G >> (step + 1), p.shape[1]
        partner = lanes ^ o
        if m > 1:
            upper = (lanes % G & o) != 0
            keep = np.where(upper[:, None], np.arange(m // 2, m), np.arange(m // 2))
            p = p[lanes[:, None], keep] + p[partner[:, None], keep]
            cols = cols[lanes[:, None], keep] + cols[partner[:, None], keep]
        else:
            p, cols = p + p[partner], cols + cols[partner]
        step += 1
    return p[:, 0], cols[:, 0]


def _dot_walk(g, table, ids, geo):
    """numpy model of kernel B as the geometry launches it: warp w walks
    slots (w % spans a bag) * span onwards of bag w // spans a bag, 32 ids
    at a time, in rounds of S = (32 / G) * NP slots; lane j of group q sums
    columns j * EPL, + G * EPL, ... of slot r0 + q * NP + k into partial k;
    the transpose-reduce, and the store of the first lane that holds a
    slot. Returns d_w (f32), how often each slot was stored, and for each
    slot how often each column reached its stored sum."""
    B, L = ids.shape
    D = table.shape[1]
    G, epl, span = geo.group_lanes, geo.epl, geo.span
    NP = min(G, temb._DOT_PARTIALS)
    S, copies = 32 // G * NP, G // NP
    per_bag = -(-L // span)
    out = np.zeros((B, L), np.float32)
    stores = np.zeros((B, L), np.int64)
    reached = np.zeros((B, L, D), np.int64)
    for w in range(min(B * per_bag, geo.grid_x * geo.threads // 32)):
        bag, begin = w // per_bag, w % per_bag * span
        end = min(L, begin + span)
        for c0 in range(begin, end, 32):
            n = min(32, end - c0)
            for r0 in range(0, n, S):
                p = np.zeros((32, NP), np.float32)
                cols = np.zeros((32, NP, D), np.int64)
                for lane in range(32):
                    j, s0 = lane % G, lane // G * NP
                    for c in range(j * epl, D, G * epl):
                        for k in range(NP):
                            if r0 + s0 + k < n:
                                row = table[ids[bag, c0 + r0 + s0 + k]]
                                for e in range(epl):
                                    p[lane, k] += g[bag, c + e] * row[c + e]
                                cols[lane, k, c:c + epl] += 1
                sums, cols = _transpose_reduce(p, cols, G)
                for lane in range(32):
                    j, s0 = lane % G, lane // G * NP
                    s = r0 + s0 + j // copies
                    if j % copies == 0 and s < n:
                        out[bag, c0 + s] = sums[lane]
                        stores[bag, c0 + s] += 1
                        reached[bag, c0 + s] += cols[lane]
    assert stores.sum() == B * L  # no warp beyond the bags stores
    return out, stores, reached


def _dot_inputs(seed, V, D, B, L, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    # bf16 widens to f32 exactly: the model reads the widened table
    table = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32)).to(dtype)
    ids = rng.integers(0, V, size=(B, L), dtype=np.int32)
    g = rng.standard_normal((B, D), dtype=np.float32)
    return table.float().numpy(), ids, g


@pytest.mark.parametrize("D, epl", [(1, 1), (2, 2), (130, 2)], ids=["d1", "d2", "d130"])
@pytest.mark.parametrize("L", [1, 13, 256])
def test_dot_walk_sums_every_slot_over_every_column_once_and_equals_plain(L, D, epl):
    table, ids, g = _dot_inputs(17, 50, D, 3, L)
    geo = temb._dot_geo(3, L, D, epl)
    out, stores, reached = _dot_walk(g, table, ids, geo)
    # every slot, weight 0 or not, stored once with one sum over all D columns
    assert (stores == 1).all() and (reached == 1).all()
    want = temb.embedding_bag_backward_weights_plain(
        torch.from_numpy(g), torch.from_numpy(table), torch.from_numpy(ids))
    # the same f32 products, summed lane by lane and then across lanes
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-5, atol=1e-5 * D ** 0.5)


@pytest.mark.parametrize(
    "dtype, epl, span",
    [(torch.float32, 4, 64), (torch.bfloat16, 8, 64), (torch.float32, 4, 32),
     (torch.float32, 4, 256)],
    ids=["f32", "bf16-16-byte-lanes", "span-32", "span-whole-bag"],
)
def test_dot_walk_at_the_training_width_equals_plain(dtype, epl, span):
    table, ids, g = _dot_inputs(18, 300, 128, 2, 45, dtype)
    geo = temb._dot_geo(2, 45, 128, epl, span)
    assert geo.group_lanes == 128 // epl
    out, stores, reached = _dot_walk(g, table, ids, geo)
    assert (stores == 1).all() and (reached == 1).all()
    want = temb.embedding_bag_backward_weights_plain(
        torch.from_numpy(g), torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-5, atol=1e-4)


def test_dot_of_no_bags_launches_nothing(monkeypatch):
    monkeypatch.setattr(temb, "_launch_dot", lambda *a: pytest.fail("launched"))
    d_w = temb._backward_weights_cuda(torch.zeros(0, D), torch.ones(V, D),
                                      torch.zeros((0, L), dtype=torch.int32))
    assert d_w.shape == (0, L) and d_w.dtype == torch.float32


def _fake_cuda(monkeypatch, err, calls):
    def entry(*args):
        calls.append(args)
        return err

    monkeypatch.setattr(temb, "_bwd_kernel", lambda kind, suffix: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(temb, "BACKWARD_TABLE_LAUNCHES", 0)
    monkeypatch.setattr(temb, "BACKWARD_WEIGHTS_LAUNCHES", 0)


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("chunk", [None, 2], ids=["one-pass", "passes"])
def test_scatter_launch_passes_plan_and_geometry(monkeypatch, err, chunk):
    # g, weights, cell_src, rows, lens, slice_offsets, warp_slices,
    # warp_starts, j_starts, rec, partial, out; n_rows, B, L, D, n_cells; the
    # geometry's 6 ints; the stream — the order the C entry reads them
    calls = []
    _fake_cuda(monkeypatch, err, calls)
    _, ids, w, g = _case()
    ids_t, w_t = torch.from_numpy(ids), torch.from_numpy(w)
    plan = temb.bag_plan(ids_t, w_t, V)
    geo = temb._scatter_geo(V, B, D, 4)
    if chunk:
        geo = geo._replace(chunk_bags=chunk)
    g_t = torch.from_numpy(g)
    if err:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            temb._launch_scatter(g_t, w_t, plan, torch.bfloat16, geo)
    else:
        out = temb._launch_scatter(g_t, w_t, plan, torch.bfloat16, geo)
        assert out.shape == (V, D) and out.dtype == torch.bfloat16
    (args,) = calls
    assert len(args) == 24
    slices, warp_starts = plan.schedules[geo.grid_x * geo.threads // 32]
    assert args[:8] == (g_t.data_ptr(), w_t.data_ptr(), plan.cell_src.data_ptr(),
                        plan.rows.data_ptr(), plan.lens.data_ptr(),
                        plan.slice_offsets.data_ptr(), slices.data_ptr(),
                        warp_starts.data_ptr())
    # j_starts and partial only for more than one pass; rec scratch, out
    assert (args[8] != 0) == (args[10] != 0) == bool(chunk)
    assert args[9] not in args[:9] and args[11] not in args[:11]
    assert args[12:17] == (V, B, L, D, plan.n_cells)
    assert args[17:23] == tuple(geo) and args[23] == 7
    assert temb.BACKWARD_TABLE_LAUNCHES == (0 if err else 1)
    assert temb.BACKWARD_WEIGHTS_LAUNCHES == 0


@pytest.mark.parametrize("err", [0, 700])
def test_dot_launch_passes_geometry(monkeypatch, err):
    # table, ids, g, out; B, L, D; the geometry's 5 ints; the stream
    calls = []
    _fake_cuda(monkeypatch, err, calls)
    table, ids, _, g = _case()
    t, ids_t, g_t = (torch.from_numpy(a) for a in (table, ids, g))
    geo = temb._dot_geo(B, L, D, 4)
    if err:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            temb._launch_dot(g_t, t, ids_t, geo)
    else:
        assert temb._launch_dot(g_t, t, ids_t, geo).shape == (B, L)
    (args,) = calls
    assert len(args) == 13
    assert args[:3] == (t.data_ptr(), ids_t.data_ptr(), g_t.data_ptr())
    assert args[4:7] == (B, L, D) and args[7:12] == tuple(geo) and args[12] == 7
    assert temb.BACKWARD_WEIGHTS_LAUNCHES == (0 if err else 1)


def test_cpu_backward_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(temb, "BACKWARD_TABLE_LAUNCHES", 0)
    monkeypatch.setattr(temb, "BACKWARD_WEIGHTS_LAUNCHES", 0)
    _port_grads(*_case())
    assert temb.BACKWARD_TABLE_LAUNCHES == temb.BACKWARD_WEIGHTS_LAUNCHES == 0


@pytest.mark.parametrize(
    "call, err",
    [
        (lambda g, t, i, w: temb.embedding_bag_backward_table(g.double(), i, w, V), TypeError),
        (lambda g, t, i, w: temb.embedding_bag_backward_table(g, i.long(), w, V), TypeError),
        (lambda g, t, i, w: temb.embedding_bag_backward_table(g[:2], i, w, V), ValueError),
        (lambda g, t, i, w: temb.embedding_bag_backward_table(
            g, i, w, V, torch.float16), TypeError),
        (lambda g, t, i, w: temb.embedding_bag_backward_weights(g, t.double(), i), TypeError),
        (lambda g, t, i, w: temb.embedding_bag_backward_weights(g[:, :3], t, i), ValueError),
        (lambda g, t, i, w: temb.embedding_bag_backward_weights(g, t, i.long()), TypeError),
    ],
    ids=["g-f64", "ids-i64", "g-rows", "dtype-f16", "table-f64", "g-cols", "dot-ids-i64"],
)
def test_backward_wrappers_reject_bad_inputs(call, err):
    table, ids, w, g = (torch.from_numpy(a) for a in _case())
    with pytest.raises(err):
        call(g, table, ids, w)


def test_build_lists_the_backward_source():
    from pio_tpu_torch.ops import _build

    assert (_build.CSRC / _build.SOURCES["embedding_bag_bwd"]).is_file()
    # both libraries key on the shared header as well as their source
    a, b = (_build.library_path(n) for n in ("embedding_bag", "embedding_bag_bwd"))
    assert a != b and a.parent == b.parent == _build.BUILD_DIR


# ------------------------------------------------------------ on the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (B, L, V, D, table is a row view one row in, pattern): the shapes the
# kernels treat apart
CARD_SHAPES = [
    pytest.param(64, 32, 1000, 128, False, "", id="bags"),
    pytest.param(1, 1, 1000, 128, False, "", id="one-slot"),
    pytest.param(0, 8, 1000, 128, False, "", id="no-bags"),
    pytest.param(4, 16, 1000, 128, False, "zero-bag", id="zero-weight-bag"),
    pytest.param(16, 64, 1000, 128, False, "one-row", id="every-slot-one-row"),
    pytest.param(3, 7, 1000, 130, True, "", id="unaligned-view"),
    pytest.param(32, 16, 3000, 1, False, "", id="one-column"),
    # one row of 375 slots among light rows, over three chunks of g (the
    # main path's bags: 35.6 slots a row, at most 576)
    pytest.param(1500, 32, 1000, 128, False, "heavy-row", id="heavy-row-among-light"),
    # L not a multiple of kernel B's tile of 32 slots: a short last tile
    pytest.param(40, 45, 1000, 128, False, "", id="l-not-a-tile"),
]


def _card_case(dev, B, Lc, Vc, Dc, view, pattern, dtype):
    rng = np.random.default_rng(13)
    full = torch.from_numpy(
        rng.standard_normal((Vc + 1, Dc), dtype=np.float32)).to(dev, dtype)
    table = full[1:] if view else full[:Vc]
    ids = rng.integers(0, Vc, size=(B, Lc), dtype=np.int32)
    w = rng.random((B, Lc), dtype=np.float32) + 0.01
    w /= np.linalg.norm(w, axis=1, keepdims=True) if Lc else 1
    if pattern == "zero-bag":
        w[1] = 0.0
    if pattern == "one-row":
        ids[:] = 7
    if pattern == "heavy-row":
        ids[::4, 0] = 7
    gfull = torch.from_numpy(rng.standard_normal((B + 1, Dc), dtype=np.float32)).to(dev)
    g = gfull[1:] if view else gfull[:B]
    return table, torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev), g


@pytest.mark.cuda
@pytest.mark.parametrize("B, Lc, Vc, Dc, view, pattern", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bag_scatter_matches_plain_on_card(cuda_device, B, Lc, Vc, Dc, view,
                                           pattern, dtype):
    table, ids, w, g = _card_case(cuda_device, B, Lc, Vc, Dc, view, pattern, dtype)
    before = temb.BACKWARD_TABLE_LAUNCHES
    out = temb.embedding_bag_backward_table(g, ids, w, Vc, dtype)
    again = temb.embedding_bag_backward_table(g, ids, w, Vc, dtype)
    torch.cuda.synchronize()
    assert temb.BACKWARD_TABLE_LAUNCHES == before + 2
    assert torch.equal(out, again)  # no atomics: the same bits
    # the reference sums in a fixed order: the plain version on the CPU
    # (index_add_ there adds in slot order) from the same inputs. On the
    # card its index_add_ adds with atomics in an order that changes from
    # run to run: up to 7.6e-5 apart over 20 runs at every-slot-one-row,
    # and 1.3e-4 from the kernel, where this reference is 1.1e-5 from it
    # (scripts/torch_bag_scatter_spread.py)
    ref = temb.embedding_bag_backward_table_plain(
        g.cpu(), ids.cpu(), w.cpu(), Vc, dtype)
    # the same f32 products in another order; bf16 one rounding step apart
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else dict(atol=1e-4, rtol=2 ** -7)
    torch.testing.assert_close(out.float().cpu(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B, Lc, Vc, Dc, view, pattern", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bag_dot_matches_plain_on_card(cuda_device, B, Lc, Vc, Dc, view,
                                       pattern, dtype):
    table, ids, w, g = _card_case(cuda_device, B, Lc, Vc, Dc, view, pattern, dtype)
    before = temb.BACKWARD_WEIGHTS_LAUNCHES
    out = temb.embedding_bag_backward_weights(g, table, ids)
    again = temb.embedding_bag_backward_weights(g, table, ids)
    torch.cuda.synchronize()
    assert temb.BACKWARD_WEIGHTS_LAUNCHES == before + (2 if B else 0)
    assert torch.equal(out, again)
    ref = temb.embedding_bag_backward_weights_plain(g, table, ids)
    # |d_w| ~ sqrt(D): f32 dot products summed in another order
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1, Dc) ** 0.5, rtol=0)
    if pattern == "zero-bag":
        assert out[1].abs().min() > 0  # weight 0, gradient not 0


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu(cuda_device):
    table, ids, w, g = _case(14, V=500, D=128, B=32, L=40)
    want = _port_grads(table, ids, w, g)
    t = torch.from_numpy(table).to(cuda_device).requires_grad_(True)
    ww = torch.from_numpy(w).to(cuda_device).requires_grad_(True)
    out = temb.embedding_bag(t, torch.from_numpy(ids).to(cuda_device), ww)
    got = torch.autograd.grad(out, [t, ww], torch.from_numpy(g).to(cuda_device))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b, atol=1e-4)
