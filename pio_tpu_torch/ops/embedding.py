"""Weighted embedding-bag lookup (sparse × dense matmul) on a CUDA kernel.

Counterpart of ``pio_tpu/ops/embedding.py``. The sparse hot loop of the
text-classification template is

    out[b] = Σ_l weights[b, l] · table[ids[b, l]]        # f32 [B, D]

i.e. a TF-IDF document bag times an embedding table. The TPU package runs
it as a Pallas kernel (``_embedding_bag_pallas``); here it is a CUDA C++
kernel written for Hopper (``csrc/embedding_bag.cu``), built with ``nvcc``
on first use and called through ``ctypes``.

:func:`embedding_bag` is differentiable in ``table`` and ``weights``, as
the reference's ``custom_vjp`` is. Its backward has two kernels of its own
(``csrc/embedding_bag_bwd.cu``): the bag scatter for ``d_table``
(:func:`embedding_bag_backward_table`, launched from a :class:`BagPlan` of
the slots sorted by row) and the bag dot for ``d_weights``
(:func:`embedding_bag_backward_weights`). Neither uses atomics: two calls
give the same bits.

Dispatch is by the tensors' device and nothing else: CUDA tensors always
launch the kernels, CPU tensors take the plain versions
(:func:`embedding_bag_plain`, :func:`embedding_bag_backward_table_plain`,
:func:`embedding_bag_backward_weights_plain`). The TPU package's size
cutoff between its kernel and an XLA gather is not carried over — it was a
TPU measurement, and a gather fallback on the card would hide the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pio_tpu_torch.utils.numutil import round_up as _round_up

#: launches of each CUDA kernel in this process (tests and chip_smoke.py
#: reset them to 0 and read them back to show a path went through the
#: kernel): the forward, the bag scatter (d_table) and the bag dot (d_w)
KERNEL_LAUNCHES = 0
BACKWARD_TABLE_LAUNCHES = 0
BACKWARD_WEIGHTS_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def launch_counts() -> dict:
    """This process's launches of each CUDA kernel so far, by kernel."""
    return {"embedding_bag": KERNEL_LAUNCHES,
            "embedding_bag_backward_table": BACKWARD_TABLE_LAUNCHES,
            "embedding_bag_backward_weights": BACKWARD_WEIGHTS_LAUNCHES}

_TABLE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_KERNELS = {}  # table dtype suffix → bound ctypes function
_BWD_KERNELS = {}  # (kind, table dtype suffix) → bound ctypes function
#: the plan's int32 slot indices and offsets, and the kernels' int indexing
_MAX_SLOTS = 2 ** 31 - 1


def embedding_bag_plain(
    table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Gather + f32 weighted sum — the same arithmetic as the TPU package's
    ``_embedding_bag_xla``. Materializes the ``[B, L, D]`` gather."""
    rows = table[ids.long()].float()  # [B, L, D]
    return torch.einsum("bld,bl->bd", rows, weights.float())


def _check(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor):
    _check_table(table)
    _check_bags(ids, weights)
    if not (table.device == ids.device == weights.device):
        raise ValueError(
            f"table, ids and weights on different devices: {table.device}, "
            f"{ids.device}, {weights.device}"
        )


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be [V, D], got shape {tuple(table.shape)}")
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"table dtype {table.dtype} not in float32/bfloat16")


def _kernel(suffix: str):
    fn = _KERNELS.get(suffix)
    if fn is None:
        from pio_tpu_torch.ops import _build

        fn = getattr(_build.load("embedding_bag"), f"pio_embedding_bag_{suffix}")
        # table, ids, weights, out; B, L, D and the plan's 8 ints; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KERNELS[suffix] = fn
    return fn


#: SMs of an H100 SXM; the wrapper reads the card's own count instead
_H100_SMS = 132
#: warps of this kernel an SM holds at once: ``__launch_bounds__(1024, 1)``
#: lets ptxas use up to 64 registers a thread, and 64 K registers / 64 / 32
#: lanes = 32 warps. The plan gives a bag more warps until the grid has
#: about SMs x this many.
_WARPS_PER_SM = 32
#: fewest warps a block gets when bags have few warps each (an SM holds at
#: most 32 blocks, so one-warp blocks would fill half of it)
_MIN_BLOCK_WARPS = 4
#: most warps a bag gets: on the H100 one bag of 256 slots (chip_smoke.py's
#: one-query shape) took longer on 32 warps, the kernel's widest block,
#: than on 16, though 32 put all its row loads in flight at once
_MAX_BAG_WARPS = 16
_WARP = 32
#: B, L and D index the kernel in int32, with a step of up to 8192 slots
_MAX_DIM = 1 << 30


class Plan(NamedTuple):
    """Launch geometry of the CUDA kernel (see ``csrc/embedding_bag.cu``).

    Each lane reads ``vec_bytes`` of a row; ``col_slice`` columns of D go to
    one block (grid y walks the slices), read by groups of
    ``group_lanes`` lanes; a bag has ``warps_per_bag`` warps, and a block
    ``bags_per_block`` bags. Slot ``l`` of a bag goes to group
    ``l % groups_per_bag``. The kernel is launched with exactly this grid,
    block size and shared memory; the C side only checks them.
    """

    vec_bytes: int
    warps_per_bag: int
    bags_per_block: int
    col_slice: int
    group_lanes: int
    grid: Tuple[int, int]

    @property
    def threads(self) -> int:
        return self.warps_per_bag * self.bags_per_block * _WARP

    @property
    def groups_per_bag(self) -> int:
        return self.warps_per_bag * (_WARP // self.group_lanes)

    @property
    def smem_bytes(self) -> int:
        """f32 partial rows of every warp, summed across a bag's warps."""
        if self.warps_per_bag == 1:
            return 0
        return self.warps_per_bag * self.bags_per_block * self.col_slice * 4


@functools.lru_cache(maxsize=256)
def _plan(B: int, L: int, D: int, elem_bytes: int, align: int = 16,
          sms: int = _H100_SMS, warps_per_sm: int = _WARPS_PER_SM) -> Plan:
    """Launch geometry for ``B`` bags of ``L`` slots over a ``[V, D]`` table
    of ``elem_bytes`` elements whose pointer is ``align``-byte aligned, on
    a card of ``sms`` SMs that each hold ``warps_per_sm`` of its warps.

    The widest of 16/8/4/2-byte lanes that divides the row bytes and the
    alignment; lanes across the columns, at most a warp per slice; then
    as many warps per bag (at most 16) as the bag has slots for, until the
    grid fills the card; small bags share a block.
    """
    if min(B, L) < 0 or D < 1 or elem_bytes not in (2, 4):
        raise ValueError(f"no plan for B={B} L={L} D={D} elem_bytes={elem_bytes}")
    vec = next(v for v in (16, 8, 4, 2)
               if v >= elem_bytes and (D * elem_bytes) % v == 0 and align % v == 0)
    per_lane = vec // elem_bytes
    group_lanes = min(_WARP, _pow2_at_least(-(-D // per_lane)))
    col_slice = group_lanes * per_lane
    slices = -(-D // col_slice)
    groups_per_warp = _WARP // group_lanes
    useful = max(1, -(-L // groups_per_warp))  # warps that get a slot
    wanted = max(1, sms * warps_per_sm // max(1, B * slices))
    warps = min(_MAX_BAG_WARPS, useful, wanted)
    bags = max(1, min(B, -(-_MIN_BLOCK_WARPS // warps)))
    return Plan(vec, warps, bags, col_slice, group_lanes,
                (-(-B // bags), slices))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _align(ptr: int) -> int:
    """Byte alignment of a device pointer, capped at 16 (the widest lane)."""
    return min(16, ptr & -ptr) if ptr else 16


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_for(table: torch.Tensor, B: int, L: int, **kw) -> Plan:
    """The plan for ``B`` bags of ``L`` slots over this CUDA ``table``."""
    return _plan(B, L, table.shape[1], table.element_size(),
                 _align(table.data_ptr()), _sm_count(table.device), **kw)


def _launch(table, ids, weights, plan: Plan) -> torch.Tensor:
    """Launch the kernel with ``plan`` on the current stream (B, D >= 1)."""
    global KERNEL_LAUNCHES
    B, L = ids.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    fn = _kernel(_TABLE_DTYPES[table.dtype])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), B, L, D, plan.vec_bytes, plan.warps_per_bag,
                 plan.bags_per_block, plan.group_lanes, *plan.grid,
                 plan.threads, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def _embedding_bag_cuda(table, ids, weights) -> torch.Tensor:
    if not (table.is_contiguous() and ids.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("embedding_bag's CUDA kernel needs contiguous inputs")
    B, L = ids.shape
    V, D = table.shape
    if max(B, L, D) > _MAX_DIM:
        raise ValueError(f"shape (B={B}, L={L}, D={D}) is over the kernel's "
                         f"int indexing (at most {_MAX_DIM})")
    if B == 0 or D == 0:
        return torch.empty((B, D), dtype=torch.float32, device=table.device)
    return _launch(table, ids, weights, _plan_for(table, B, L))


def _forward(table, ids, weights) -> torch.Tensor:
    if table.device.type == "cuda":
        return _embedding_bag_cuda(table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, weights)
    raise ValueError(f"embedding_bag: unsupported device {table.device}")


class _EmbeddingBag(torch.autograd.Function):
    """The reference's ``custom_vjp``: no gradient for ``ids``."""

    @staticmethod
    def forward(ctx, table, ids, weights, plan):
        ctx.save_for_backward(table, ids, weights)
        ctx.plan = plan
        return _forward(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        g = g.contiguous()
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            d_table = embedding_bag_backward_table(
                g, ids, weights, table.shape[0], table.dtype, plan=ctx.plan
            )
        if ctx.needs_input_grad[2]:
            d_w = embedding_bag_backward_weights(g, table, ids)
        return d_table, None, d_w, None


def embedding_bag(
    table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
    plan: "BagPlan | None" = None,
) -> torch.Tensor:
    """``out[b] = Σ_l weights[b,l] · table[ids[b,l]]`` → float32 ``[B, D]``.

    ``table`` float32 or bfloat16 ``[V, D]``; ``ids`` int32 ``[B, L]`` in
    ``[0, V)`` (pad with any valid row and weight 0); ``weights`` float32
    ``[B, L]``. On CUDA tensors this launches the kernel (inputs must be
    contiguous; ids are not range-checked on the card), whatever D and the
    table's alignment; on CPU tensors it runs :func:`embedding_bag_plain`.

    Differentiable in ``table`` and ``weights``: the backward runs
    :func:`embedding_bag_backward_table` (with ``plan``, built here when
    not given; a trainer that passes the same bags every step builds it
    once with :func:`bag_plan`) and, when ``weights`` needs a gradient,
    :func:`embedding_bag_backward_weights`.

    The kernel reads no row for a slot of weight 0, where the plain version
    adds ``0 · row``: the two differ only where such a row holds inf or NaN.
    It sums in a fixed order, so two calls give the same bits.
    """
    _check(table, ids, weights)
    if torch.is_grad_enabled() and (table.requires_grad or weights.requires_grad):
        return _EmbeddingBag.apply(table, ids, weights, plan)
    return _forward(table, ids, weights)


# ----------------------------------------------------------------- backward
def embedding_bag_backward_table_plain(
    g: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor, n_rows: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The reference's ``d_table`` (``_bwd``, a segment sum): the
    ``[B·L, D]`` contributions ``g[b]·w[b,l]`` summed into row ``ids[b,l]``
    in f32, then cast to ``dtype``."""
    B, L = ids.shape
    contrib = (g.float()[:, None, :] * weights.float()[:, :, None]).reshape(
        B * L, g.shape[1])
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, ids.reshape(-1).long(), contrib).to(dtype)


def embedding_bag_backward_weights_plain(
    g: torch.Tensor, table: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """The reference's ``d_weights``: ``g[b]`` dotted with each gathered
    row, f32 ``[B, L]``. Materializes the ``[B, L, D]`` gather."""
    rows = table[ids.long()].float()
    return torch.einsum("bld,bd->bl", rows, g.float())


class BagPlan(NamedTuple):
    """Launch plan of the bag scatter: the slots of non-zero weight, sorted
    by their row.

    ``order`` int32 ``[nnz]`` holds flat slot indices ``b·L + l``, stably
    sorted by ``ids[b, l]`` (so ``(b, l)`` ascending within a row);
    ``offsets`` int32 ``[n_rows + 1]``: row ``v``'s slots are
    ``order[offsets[v]:offsets[v + 1]]``; ``bags`` int32 ``[nnz]`` is each
    listed slot's bag, ``order // L``.

    The kernel reads the same slots in a sliced layout (sliced ELLPACK):
    ``rows`` int32 ``[n_rows]`` lists the rows by their count of slots,
    most first (stable), and ``lens`` holds those counts; slice ``s`` is the
    32 rows at positions ``32 s ... 32 s + 31`` of that order, and slot
    ``j`` of the row at position ``32 s + i`` is cell
    ``slice_offsets[s] + 32 j + i`` of ``n_cells``, so that a warp reads one
    slot of 32 rows as 32 neighbouring cells; ``cell_src`` int32
    ``[n_cells]`` is each cell's flat slot, -1 for padding. ``schedules``
    caches, by count of warps, which slices each warp walks.

    It belongs to the ``ids`` of ``shape`` and to the zero pattern of the
    weights it was built from, not to their values.
    """

    order: torch.Tensor
    offsets: torch.Tensor
    bags: torch.Tensor
    rows: torch.Tensor
    lens: torch.Tensor
    slice_offsets: torch.Tensor
    cell_src: torch.Tensor
    n_cells: int
    n_rows: int
    shape: Tuple[int, int]
    schedules: dict


def bag_plan(ids: torch.Tensor, weights: torch.Tensor, n_rows: int) -> BagPlan:
    """The :class:`BagPlan` of these bags over ``n_rows`` rows.

    Bookkeeping on the bags' device with stable sorts, a
    ``torch.searchsorted`` and scatters; it waits for the device twice (the
    count of non-zero slots sizes ``order``, the count of cells the sliced
    layout). Raises ``ValueError`` for an id of a non-zero slot outside
    ``[0, n_rows)``.
    """
    _check_bags(ids, weights)
    if ids.numel() > _MAX_SLOTS or n_rows >= _MAX_SLOTS:
        raise ValueError(f"{ids.numel()} slots over {n_rows} rows is over the "
                         f"plan's int32 indexing")
    dev = ids.device
    slots = torch.nonzero(weights.reshape(-1) != 0).reshape(-1)
    keys = ids.reshape(-1)[slots]
    if keys.numel() and (int(keys.min()) < 0 or int(keys.max()) >= n_rows):
        raise ValueError(f"bag ids must lie in [0, {n_rows}); got "
                         f"[{int(keys.min())}, {int(keys.max())}]")
    keys, perm = torch.sort(keys, stable=True)
    order = slots[perm]
    bags = order // max(1, ids.shape[1])
    offsets = torch.searchsorted(keys, torch.arange(n_rows + 1, dtype=keys.dtype, device=dev))
    counts = offsets.diff()
    lens, rows = torch.sort(counts, descending=True, stable=True)
    # a slice is as wide as its first (longest) row
    n_slices = -(-n_rows // _WARP)
    width = lens[::_WARP]
    slice_offsets = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    torch.cumsum(width * _WARP, 0, out=slice_offsets[1:])
    n_cells = int(slice_offsets[-1])
    if n_cells > _MAX_SLOTS:
        raise ValueError(f"{n_cells} cells of the sliced layout is over the "
                         f"plan's int32 indexing")
    pos_of_row = torch.empty_like(rows)
    pos_of_row[rows] = torch.arange(n_rows, device=dev)
    row_of = torch.repeat_interleave(torch.arange(n_rows, device=dev), counts)
    pos = pos_of_row[row_of]
    j = torch.arange(len(order), device=dev) - offsets[row_of]
    cell_src = torch.full((n_cells,), -1, dtype=torch.int32, device=dev)
    cell_src[slice_offsets[pos // _WARP] + j * _WARP + pos % _WARP] = order.to(torch.int32)
    return BagPlan(
        order=order.to(torch.int32),
        offsets=offsets.to(torch.int32),
        bags=bags.to(torch.int32),
        rows=rows.to(torch.int32),
        lens=lens.to(torch.int32),
        slice_offsets=slice_offsets.to(torch.int32),
        cell_src=cell_src,
        n_cells=n_cells,
        n_rows=n_rows,
        shape=tuple(ids.shape),
        schedules={},
    )


def _check_bags(ids: torch.Tensor, weights: torch.Tensor) -> None:
    if ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"ids and weights must both be [B, L]; got {tuple(ids.shape)} "
            f"and {tuple(weights.shape)}"
        )
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")


def _check_grad(g: torch.Tensor, ids: torch.Tensor, *others) -> None:
    if g.dim() != 2 or g.shape[0] != ids.shape[0]:
        raise ValueError(f"g must be [B, D] with B = {ids.shape[0]}, got "
                         f"{tuple(g.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if any(t.device != g.device for t in (ids, *others)):
        raise ValueError("g, ids and the other inputs on different devices")


def embedding_bag_backward_table(
    g: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor, n_rows: int,
    dtype: torch.dtype = torch.float32, plan: BagPlan | None = None,
) -> torch.Tensor:
    """``d_table[v] = Σ_{(b,l): ids[b,l]=v} weights[b,l] · g[b]`` →
    ``[n_rows, D]`` of ``dtype`` (float32 or bfloat16; summed in f32).

    On CUDA tensors this launches the bag scatter from ``plan`` (built with
    :func:`bag_plan` when not given; a given plan must be of these bags):
    every row is written once, 0 where no slot lands, slots of weight 0
    are not read, and two calls give the same bits. On CPU tensors it runs
    :func:`embedding_bag_backward_table_plain`.
    """
    _check_bags(ids, weights)
    _check_grad(g, ids, weights)
    if dtype not in _TABLE_DTYPES:
        raise TypeError(f"d_table dtype {dtype} not in float32/bfloat16")
    if g.device.type == "cuda":
        return _backward_table_cuda(g, ids, weights, n_rows, dtype, plan)
    if g.device.type == "cpu":
        return embedding_bag_backward_table_plain(g, ids, weights, n_rows, dtype)
    raise ValueError(f"embedding_bag_backward_table: unsupported device {g.device}")


def embedding_bag_backward_weights(
    g: torch.Tensor, table: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """``d_w[b, l] = Σ_d g[b, d] · table[ids[b, l], d]`` → float32 ``[B, L]``.

    Every slot is read, weight 0 or not: the derivative with respect to a
    zero weight is not zero. On CUDA tensors this launches the bag dot
    (fixed summation order, the same bits on every call); on CPU tensors it
    runs :func:`embedding_bag_backward_weights_plain`.
    """
    _check_table(table)
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32 [B, L], got {ids.dtype} {tuple(ids.shape)}")
    _check_grad(g, ids, table)
    if g.shape[1] != table.shape[1]:
        raise ValueError(f"g has {g.shape[1]} columns, the table {table.shape[1]}")
    if g.device.type == "cuda":
        return _backward_weights_cuda(g, table, ids)
    if g.device.type == "cpu":
        return embedding_bag_backward_weights_plain(g, table, ids)
    raise ValueError(f"embedding_bag_backward_weights: unsupported device {g.device}")


#: threads a block of the bag dot (its launch bounds' cap)
_DOT_THREADS = 256
#: most partial sums a lane of the bag dot holds (``kDotPartials``)
_DOT_PARTIALS = 8
#: slots one warp of the bag dot walks, at most (a multiple of 32)
_DOT_SPAN = 64


class DotGeometry(NamedTuple):
    """Launch geometry of the bag dot (``csrc/embedding_bag_bwd.cu``, kernel
    B): each lane loads ``epl`` elements of a row at once; a warp walks
    ``span`` slots of one bag (a multiple of 32), in rounds of
    ``32 // group_lanes * min(group_lanes, _DOT_PARTIALS)`` slots, a group
    of ``group_lanes`` lanes on each row. The kernel is launched with
    exactly these ``grid_x`` blocks of ``threads``; the C side only checks
    them."""

    epl: int
    group_lanes: int
    span: int
    grid_x: int
    threads: int

    def warps(self, B: int, L: int) -> int:
        return B * -(-L // self.span)


def _lane_elems(D: int, *aligned: Tuple[int, int]) -> int:
    """Most elements a lane moves at once (4, 2 or 1): ``D`` is a multiple
    of it, and every ``(pointer alignment, element bytes)`` allows it."""
    return next(e for e in (4, 2, 1)
                if D % e == 0 and all(a % (e * b) == 0 for a, b in aligned))


@functools.lru_cache(maxsize=256)
def _dot_geo(B: int, L: int, D: int, epl: int, span: int = _DOT_SPAN) -> DotGeometry:
    """Kernel B's geometry for ``B`` bags of ``L`` slots and ``D`` columns,
    ``epl`` elements a load: a group spans the row (at most a warp, then
    passes); a warp walks ``span`` slots, fewer where the bags are
    shorter; blocks of up to ``_DOT_THREADS`` threads."""
    if min(B, L, D) < 1 or epl not in (8, 4, 2, 1) or D % epl or span % _WARP:
        raise ValueError(f"no dot geometry for B={B}, L={L}, D={D}, epl={epl}, "
                         f"span={span}")
    group = min(_WARP, _pow2_at_least(-(-D // epl)))
    span = min(span, _round_up(L, _WARP))
    warps = B * -(-L // span)
    per_block = min(_DOT_THREADS // _WARP, warps)
    grid = -(-warps // per_block)
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{warps} warps of the bag dot is over a grid's size")
    return DotGeometry(epl, group, span, grid, per_block * _WARP)


def _dot_lane_elems(D: int, elem_bytes: int, table_align: int, g_align: int) -> int:
    """Most elements of a row a lane of the bag dot loads at once (8, 4, 2
    or 1; at most 16 bytes): ``D`` is a multiple of it, the table's pointer
    is aligned to its bytes and g's to its floats' (at most 16)."""
    return next(e for e in (8, 4, 2, 1)
                if e * elem_bytes <= 16 and D % e == 0
                and table_align % (e * elem_bytes) == 0 and g_align % min(16, 4 * e) == 0)


#: most threads a block of the bag scatter (its launch bounds' cap: 64
#: registers a thread, one block of 1024 an SM)
_SCATTER_THREADS = 1024
#: most shared memory a block of the bag scatter takes (H100, opt-in)
_SCATTER_SMEM_BYTES = 227 * 1024


def _smem_stride(dt: int) -> int:
    """Floats between two bags' columns in the bag scatter's g buffer: 16
    bytes of padding above 4 columns spread a quarter warp's reads over the
    banks (``smem_stride`` in the C side)."""
    return dt + 4 if dt > 4 else dt


class ScatterGeometry(NamedTuple):
    """Launch geometry of the bag scatter (``csrc/embedding_bag_bwd.cu``,
    kernel A). Each block stages ``chunk_bags`` bags of ``g``'s ``dt``
    columns in shared memory, ``vec`` floats a copy (all ``B`` bags when
    they fit: one pass; else one launch a chunk), and the warps of its
    ``threads`` walk slices of 32 rows (the plan's schedule); ``grid_x``
    blocks share the rows of each of the ``grid_y`` column slices. The
    kernel is launched with exactly this; the C side only checks it."""

    dt: int
    vec: int
    threads: int
    chunk_bags: int
    grid_x: int
    grid_y: int

    @property
    def smem_bytes(self) -> int:
        return self.chunk_bags * _smem_stride(self.dt) * 4

    def passes(self, B: int) -> int:
        return max(1, -(-B // self.chunk_bags))


def _scatter_slice(B: int, D: int, vec: int) -> Tuple[int, int]:
    """Columns a block (the widest of 16, 8, 4, 2, 1 that divides ``D``, is
    a multiple of ``vec`` and lets all ``B`` bags of g fit in shared memory;
    the narrowest such width when none fits) and bags a pass."""
    widths = [t for t in (16, 8, 4, 2, 1) if D % t == 0 and t % vec == 0]
    fits = [t for t in widths if max(1, B) * _smem_stride(t) * 4 <= _SCATTER_SMEM_BYTES]
    dt = fits[0] if fits else widths[-1]
    return dt, max(1, min(B, _SCATTER_SMEM_BYTES // (_smem_stride(dt) * 4)))


@functools.lru_cache(maxsize=256)
def _scatter_geo(n_rows: int, B: int, D: int, vec: int, sms: int = _H100_SMS,
                 blocks_per_sm: int = 1,
                 threads: int = _SCATTER_THREADS) -> ScatterGeometry:
    """Kernel A's geometry for ``n_rows`` rows of ``D`` columns from ``B``
    bags of ``g``, copied ``vec`` floats at a time (``D`` a multiple of it),
    on a card of ``sms`` SMs that each hold ``blocks_per_sm`` of its blocks.

    The widest column slice whose g fits in shared memory
    (:func:`_scatter_slice`): the slot records are read once a slice, so
    fewer slices move fewer bytes. At most ``threads`` a block, fewer for
    few rows; as many blocks a slice as fill the card once, and no more
    than the rows need. On the H100 1024 threads were fastest, against 512
    and 256 and twice the blocks (``scripts/torch_bag_scatter.py --tiles``).
    """
    if min(n_rows, D, B + 1) < 1 or vec not in (4, 2, 1) or D % vec:
        raise ValueError(f"no scatter geometry for {n_rows} rows, B={B}, D={D}, "
                         f"vec={vec}")
    dt, chunk = _scatter_slice(B, D, vec)
    threads = min(threads, _round_up(n_rows, _WARP))
    slices = D // dt
    blocks = max(1, min(sms * blocks_per_sm // slices, -(-n_rows // threads)))
    return ScatterGeometry(dt, vec, threads, chunk, blocks, slices)


def _pass_starts(plan: "BagPlan", B: int, chunk_bags: int) -> torch.Tensor:
    """int32 ``[passes - 1, n_rows]``: for each position of the plan's row
    order, the first slot ``j`` of its row whose bag is at least
    ``p · chunk_bags``, for the passes ``p = 1, 2, ...`` of a bag scatter
    whose g does not fit in shared memory at once."""
    dev = plan.offsets.device
    n = plan.n_rows
    offsets = plan.offsets.long()
    row_of = torch.repeat_interleave(torch.arange(n, device=dev), offsets.diff())
    keys = row_of * B + plan.bags.long()  # ascending: by row, then bag
    bounds = torch.arange(1, -(-B // chunk_bags), device=dev) * chunk_bags
    rows = plan.rows.long()
    first = torch.searchsorted(keys, rows[None, :] * B + bounds[:, None])
    return (first - offsets[rows][None, :]).to(torch.int32)


def _bwd_kernel(kind: str, suffix: str):
    fn = _BWD_KERNELS.get((kind, suffix))
    if fn is None:
        from pio_tpu_torch.ops import _build

        fn = getattr(_build.load("embedding_bag_bwd"), f"pio_bag_{kind}_{suffix}")
        if kind == "scatter":
            # g, weights, cell_src, rows, lens, slice_offsets, warp_slices,
            # warp_starts, j_starts, rec, partial, out; n_rows, B, L, D,
            # n_cells; the geometry's 6 ints; stream
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        elif kind == "scatter_occupancy":
            fn.argtypes = [ctypes.c_int] * 3  # dt, threads, smem bytes
        else:
            # table, ids, g, out; B, L, D; the geometry's 5 ints; stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD_KERNELS[(kind, suffix)] = fn
    return fn


def _call(fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag backward kernel launch failed: CUDA error {err}")


def _launch_scatter(g, weights, plan: BagPlan, dtype, geo: ScatterGeometry) -> torch.Tensor:
    """Launch the bag scatter with ``geo`` on the current stream; the slots'
    records (bag, weight) are gathered into the plan's cells in the same
    call."""
    global BACKWARD_TABLE_LAUNCHES
    B, D = g.shape
    dev = g.device
    out = torch.empty((plan.n_rows, D), dtype=dtype, device=dev)
    rec = torch.empty((plan.n_cells, 2), dtype=torch.int32, device=dev)
    warp_slices, warp_starts = _schedule(plan, geo.grid_x * geo.threads // _WARP)
    starts = partial = None
    if geo.passes(B) > 1:
        starts = _pass_starts(plan, B, geo.chunk_bags)
        partial = torch.empty((plan.n_rows, D), dtype=torch.float32, device=dev)
    _call(_bwd_kernel("scatter", _TABLE_DTYPES[dtype]), dev,
          g.data_ptr(), weights.data_ptr(), plan.cell_src.data_ptr(),
          plan.rows.data_ptr(), plan.lens.data_ptr(),
          plan.slice_offsets.data_ptr(), warp_slices.data_ptr(),
          warp_starts.data_ptr(), _ptr(starts), rec.data_ptr(), _ptr(partial),
          out.data_ptr(), plan.n_rows, B, plan.shape[1], D, plan.n_cells, *geo)
    with _COUNT_LOCK:
        BACKWARD_TABLE_LAUNCHES += 1
    return out


def _schedule(plan: BagPlan, warps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(warp_slices, warp_starts)`` on the plan's device: warp ``w`` walks
    slices ``warp_slices[warp_starts[w]:warp_starts[w + 1]]``. Built once
    for each count of warps and kept in the plan."""
    got = plan.schedules.get(warps)
    if got is None:
        widths = plan.lens[::_WARP].cpu().numpy()  # one wait for the device
        dev = plan.lens.device
        got = tuple(torch.from_numpy(a).to(dev) for a in _lpt(widths, warps))
        plan.schedules[warps] = got
    return got


#: slot steps a slice costs a warp besides its slots (its rows' order and
#: lengths, the writes)
_SLICE_OVERHEAD = 4


def _lpt(widths: np.ndarray, warps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Slices to warps, longest first, each to the warp with the least work
    so far (ties to the lowest warp): a warp's work is its slices' widths
    (slot steps) plus ``_SLICE_OVERHEAD`` each. Returns the slices warp by
    warp, and where each warp's begin (int32)."""
    heap = [(0, w) for w in range(warps)]
    lists = [[] for _ in range(warps)]
    for s in np.argsort(-widths, kind="stable"):
        work, w = heapq.heappop(heap)
        lists[w].append(s)
        heapq.heappush(heap, (work + int(widths[s]) + _SLICE_OVERHEAD, w))
    slices = np.array([s for one in lists for s in one], dtype=np.int32)
    starts = np.cumsum([0] + [len(one) for one in lists]).astype(np.int32)
    return slices, starts


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_dot(g, table, ids, geo: DotGeometry) -> torch.Tensor:
    """Launch the bag dot with ``geo`` on the current stream."""
    global BACKWARD_WEIGHTS_LAUNCHES
    B, L = ids.shape
    out = torch.empty((B, L), dtype=torch.float32, device=g.device)
    _call(_bwd_kernel("dot", _TABLE_DTYPES[table.dtype]), g.device,
          table.data_ptr(), ids.data_ptr(), g.data_ptr(), out.data_ptr(),
          B, L, table.shape[1], *geo)
    with _COUNT_LOCK:
        BACKWARD_WEIGHTS_LAUNCHES += 1
    return out


def _scatter_geometry(g: torch.Tensor, n_rows: int, dtype=torch.float32,
                      threads: int = _SCATTER_THREADS) -> ScatterGeometry:
    """The geometry for a ``dtype`` d_table of ``n_rows`` rows from this
    CUDA ``g``, at the card's SM count and the kernel's occupancy."""
    # the output is a fresh allocation, 16-byte aligned
    B, D = g.shape
    vec = _lane_elems(D, (_align(g.data_ptr()), 4))
    dt, chunk = _scatter_slice(B, D, vec)
    threads = min(threads, _round_up(n_rows, _WARP))
    per_sm = _scatter_occupancy(g.device, _TABLE_DTYPES[dtype], dt, threads,
                                chunk * _smem_stride(dt) * 4)
    return _scatter_geo(n_rows, B, D, vec, _sm_count(g.device), per_sm, threads)


@functools.lru_cache(maxsize=None)
def _scatter_occupancy(device, suffix: str, dt: int, threads: int, smem: int) -> int:
    """Blocks of the bag scatter an SM of ``device`` holds (the C side asks
    the CUDA runtime)."""
    with torch.cuda.device(device):
        n = _bwd_kernel("scatter_occupancy", suffix)(dt, threads, smem)
    if n < 1:
        raise RuntimeError(f"bag scatter occupancy query failed: CUDA error {-n}")
    return n


def _dot_geometry(g: torch.Tensor, table: torch.Tensor, L: int) -> DotGeometry:
    """The geometry for d_w of bags of ``L`` slots from this CUDA ``g`` and
    ``table``."""
    epl = _dot_lane_elems(table.shape[1], table.element_size(),
                          _align(table.data_ptr()), _align(g.data_ptr()))
    return _dot_geo(g.shape[0], L, table.shape[1], epl)


def _contiguous(*tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_bag's CUDA kernels need contiguous inputs")


def _backward_table_cuda(g, ids, weights, n_rows, dtype, plan) -> torch.Tensor:
    _contiguous(g, ids, weights)
    D = g.shape[1]
    if max(n_rows, D) > _MAX_DIM:
        raise ValueError(f"d_table of {n_rows} x {D} is over the kernel's int indexing")
    if n_rows == 0 or D == 0:
        return torch.zeros((n_rows, D), dtype=dtype, device=g.device)
    if plan is None:
        plan = bag_plan(ids, weights, n_rows)
    if plan.n_rows != n_rows or plan.shape != tuple(ids.shape) \
            or plan.order.device != g.device:
        raise ValueError(
            f"plan of {plan.shape} bags over {plan.n_rows} rows on "
            f"{plan.order.device} does not fit {tuple(ids.shape)} bags over "
            f"{n_rows} rows on {g.device}"
        )
    return _launch_scatter(g, weights, plan, dtype,
                           _scatter_geometry(g, n_rows, dtype))


def _backward_weights_cuda(g, table, ids) -> torch.Tensor:
    _contiguous(g, table, ids)
    B, L = ids.shape
    D = table.shape[1]
    if max(B, L, D) > _MAX_DIM:
        raise ValueError(f"shape (B={B}, L={L}, D={D}) is over the kernel's "
                         f"int indexing (at most {_MAX_DIM})")
    if B == 0 or L == 0 or D == 0:
        return torch.zeros((B, L), dtype=torch.float32, device=g.device)
    return _launch_dot(g, table, ids, _dot_geometry(g, table, L))


# --------------------------------------------------- host-side bag packing
def pack_bags(
    indices_per_bag, weights_per_bag, max_len: int | None = None
):
    """Ragged per-bag (ids, weights) lists → padded int32/float32 arrays.

    Pads with id 0 / weight 0 (contributes exactly zero). ``max_len`` is
    rounded up to a multiple of 8 so the token stream tiles evenly.
    """
    B = len(indices_per_bag)
    L = max_len or max((len(x) for x in indices_per_bag), default=1)
    L = max(1, _round_up(L, 8))
    ids = np.zeros((B, L), np.int32)
    w = np.zeros((B, L), np.float32)
    for b, (ix, wx) in enumerate(zip(indices_per_bag, weights_per_bag)):
        n = min(len(ix), L)
        ids[b, :n] = np.asarray(ix[:n], np.int32)
        w[b, :n] = np.asarray(wx[:n], np.float32)
    return ids, w
