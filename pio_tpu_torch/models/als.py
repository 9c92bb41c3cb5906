"""ALS matrix factorization — the port of ``pio_tpu/models/als.py``.

The rating list is packed per orientation (by user, by item) into
fixed-width blocks: edges sorted by entity, each entity's adjacency split
into ``[block_width]`` slices, padded slots carrying ``other = -1``. One
half-iteration (the user update, say) is::

    A_u = Σ_{i ∈ R(u)} q_i q_iᵀ + λI        b_u = Σ_i r_ui q_i
    p_u = A_u⁻¹ b_u

computed per chunk of blocks as a gather of ``[chunk, W, K]`` factor rows,
one batched product with float32 accumulation (``torch.bmm`` of ``[w·q |
rhs]ᵀ q``), and a sum of the block partials onto their entities; then one
batched solve per entity (Cholesky, Jacobi-preconditioned CG or LU). Implicit feedback
(Hu-Koren): confidence ``1 + α·r``, preference 1; the shared ``QᵀQ`` gram
term is added once, and only the ``α·r·q qᵀ`` correction rides the blocks.

What the port keeps of the reference, and how:

- The host side is the reference's: the width rule, the block packer,
  the (user, item) edge sort and the wire encoders (4-bit half-star
  ratings, 12-bit item gaps or uint16 planes), through the native C++
  packer (``pio_tpu_torch/native/als_pack.cpp``, built with ``g++`` on
  first use) with each numpy function as its plain version, held bitwise
  equal to it. A failed build raises; numpy runs only when
  ``PIO_TPU_NO_NATIVE`` asks for it. ``stats["packer"]`` names the route.
- The device side builds both blocked layouts from the sorted wire
  (:func:`device_pack`, gathers only) and runs the iterations as a Python
  loop of tensor ops where the reference compiles one ``jit`` program.
- The per-entity sum is carried from chunk to chunk, as there, into one
  ``[n_entities, K, K]`` accumulator: each chunk's block partials are
  summed over the entity runs the chunk holds (``torch.segment_reduce``)
  and added into that slice of the accumulator, so only the entity that
  straddles a chunk boundary gets a second add. The order is fixed, so
  two runs give the same bits on the CPU and on the card (an atomic
  ``index_add_`` would not), and memory stays at ``n·K²`` plus a chunk.
- The initial factors, ``|N(0,1)|/√rank``, come from a ``torch.Generator``
  seeded with ``config.seed``, drawn on the CPU and moved to the device,
  so the card and the CPU start from the same factors. ``jax.random``
  streams cannot be reproduced; :func:`_run_iterations` takes the initial
  factors for the tests that hold the port against the reference.
- :func:`train_als` ships the wire in one piece (``stats["n_stream"] ==
  1``). The reference streams it in chunks above an ~8 MiB wire
  (``_run_streamed``, ``PIO_TPU_ALS_STREAM_MB``) to hide a TPU's slow
  host link behind iteration 1's user side. On an NVIDIA H100 the whole
  wire crosses in tens of milliseconds, and streaming it was measured to
  hide nothing and to cost time and memory (PERF.md §6), so the port has
  no streamed route. Phases are timed with ``time.monotonic``.
- One path for every context: in a process group (``ComputeContext.create``
  under the env contract) entity counts are padded to world multiples and
  each rank runs its ``1/world`` of the blocks through :func:`half_step`
  (partial normal equations, ``reduce_scatter`` over entity rows, the
  local solve, ``all_gather``), on either wire of
  ``PIO_TPU_ALS_MESH_WIRE``; one process is world size 1, where the
  collectives are identities.
- ``matmul_dtype="auto"`` is float32 (the reference picks bfloat16 on any
  accelerator; here that waits for a measurement that it pays on the
  card). ``"bfloat16"`` gathers from a bf16 table and multiplies bf16
  values with float32 accumulation, as the reference does. On the card
  the products are cuBLAS bf16 products (``out_dtype=float32``), so the
  implicit weighted rows round to bf16 as on the reference's MXU; on the
  CPU, which has no such product, the bf16 values are upcast and the
  weighted rows stay float32, as the reference's do there. With explicit
  feedback (weights 0 or 1) the two give the same values.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from pio_tpu_torch.obs import trainwatch
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.utils import knobs
from pio_tpu_torch.utils.numutil import round_up as _round_up

_SOLVERS = ("auto", "cg", "cholesky", "lu")


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    rank: int = 10
    iterations: int = 10
    reg: float = 0.1
    implicit: bool = False
    alpha: float = 40.0
    #: edges per dense block; None → power of two near a quarter of the
    #: mean degree, within [16, 64]
    block_width: Optional[int] = None
    #: blocks per chunk — bounds the [chunk, width, K] gathered rows
    blocks_per_chunk: int = 4096
    #: dtype of the factor gather and the products: "auto" and "float32"
    #: are float32, "bfloat16" gathers bf16 rows and multiplies bf16
    #: operands (on the card at bf16's rate); accumulation and the solves
    #: stay float32 either way
    matmul_dtype: str = "auto"
    #: per-entity K×K solver: "auto" (Cholesky), "cholesky", "cg" or "lu".
    #: The reference's "auto" switches to CG above 32768 entities, a TPU
    #: workaround. On an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py phase
    #: 11, K = 16) Cholesky took 1.77 ms at 162541 entities and 0.67 ms at
    #: 59047, CG 7.89 and 3.69, so the port's "auto" is Cholesky at every
    #: count. On implicit systems (phase 18, alpha 40, 50064 and 20064
    #: entities) Cholesky took 0.617 and 0.266 ms, CG 8.363 and 5.920, LU
    #: 0.382 and 0.169, with normwise relative residuals of 6.6e-8 and
    #: 1.1e-7 (Cholesky), 6.6e-7 and 2.4e-7 (CG), 6.2e-8 and 1.0e-7 (LU).
    #: LU's lead is 2-4% of a half-step; "auto" stays Cholesky until the
    #: port's benchmark can show it end to end (PERF.md §7)
    solver: str = "auto"
    seed: int = 0


@dataclasses.dataclass
class ALSFactors:
    """Trained factors: host numpy out of :func:`train_als`."""

    user_factors: np.ndarray  # [n_users, rank]
    item_factors: np.ndarray  # [n_items, rank]


# ------------------------------------------------------------------ host side
def _native_packer():
    """The C++ packer (``pio_tpu_torch/native/als_pack.cpp``), built on
    first use; None when ``PIO_TPU_NO_NATIVE`` asks for the numpy routes.
    A failed build raises ``NativeBuildError``."""
    if knobs.knob_str("PIO_TPU_NO_NATIVE"):
        return None
    from pio_tpu_torch.native import als_pack_lib

    return als_pack_lib()


def _ptr(a: np.ndarray, dtype, ctype):
    """C pointer to ``a``'s buffer. Checks rather than converts: a silent
    contiguous copy would send the native writes into a discarded
    temporary (output buffers pass through here too)."""
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"native packer needs a contiguous {np.dtype(dtype)}"
                         f" array, got {a.dtype} {a.flags}")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32p(a):
    return _ptr(a, np.int32, ctypes.c_int32)


def _i64p(a):
    return _ptr(a, np.int64, ctypes.c_int64)


def _f32p(a):
    return _ptr(a, np.float32, ctypes.c_float)


def _u8p(a):
    return _ptr(a, np.uint8, ctypes.c_uint8)


def _auto_width(n_edges: int, n_entities: int) -> int:
    mean_deg = max(1.0, n_edges / max(1, n_entities))
    w = 1 << int(np.ceil(np.log2(max(8.0, mean_deg / 4))))
    return int(min(64, max(16, w)))


def _pack_blocks(
    ent_idx: np.ndarray,
    other_idx: np.ndarray,
    rating: np.ndarray,
    n_entities: int,
    width: int,
    pad_blocks_to: int,
    counts: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a COO edge list into dense [n_blocks, width] CSR-style blocks.

    Returns (block_ent [S], block_other [S,W], block_rating [S,W]);
    ``block_ent`` ascending. Padded slots carry ``other = -1``; padding
    blocks belong to the last entity, with every slot padded. The native
    route is ``als_pack_fill``, a stable parallel scatter.
    """
    native = _native_packer()
    if counts is None:
        counts = _entity_counts(ent_idx, n_entities, native)
    n_blocks = int((-(-counts // width)).sum())
    S = max(pad_blocks_to, _round_up(max(n_blocks, 1), pad_blocks_to))
    if native is not None:
        ent = np.ascontiguousarray(ent_idx, np.int32)
        block_ent = np.empty(S, np.int32)
        block_other = np.empty(S * width, np.int32)
        block_rating = np.empty(S * width, np.float32)
        native.als_pack_fill(
            _i32p(ent), _i32p(np.ascontiguousarray(other_idx, np.int32)),
            _f32p(np.ascontiguousarray(rating, np.float32)), len(ent),
            n_entities, width,
            _i64p(np.ascontiguousarray(counts, np.int64)), S,
            _i32p(block_ent), _i32p(block_other), _f32p(block_rating),
        )
        return (block_ent, block_other.reshape(S, width),
                block_rating.reshape(S, width))

    order = np.argsort(ent_idx, kind="stable")
    e = ent_idx[order]
    blocks_per_ent = -(-counts // width)  # zero for empty entities
    block_start = np.zeros(n_entities + 1, dtype=np.int64)
    np.cumsum(blocks_per_ent, out=block_start[1:])
    edge_start = np.zeros(n_entities + 1, dtype=np.int64)
    np.cumsum(counts, out=edge_start[1:])

    # position of each (sorted) edge within its entity's adjacency
    pos = np.arange(len(e), dtype=np.int64) - edge_start[e]
    flat = (block_start[e] + pos // width) * width + pos % width

    block_other = np.full(S * width, -1, dtype=np.int32)
    block_rating = np.zeros(S * width, dtype=np.float32)
    block_other[flat] = other_idx[order]
    block_rating[flat] = rating[order]

    block_ent = np.full(S, n_entities - 1, dtype=np.int32)
    reps = np.repeat(np.arange(n_entities, dtype=np.int32), blocks_per_ent)
    block_ent[: len(reps)] = reps
    return (
        block_ent,
        block_other.reshape(S, width),
        block_rating.reshape(S, width),
    )


def _entity_counts(ent: np.ndarray, n_entities: int, native) -> np.ndarray:
    """int64 degree of each entity; raises ValueError on an id outside
    ``[0, n_entities)``."""
    if native is not None:
        counts = np.zeros(n_entities, np.int64)
        if native.als_pack_count(
                _i32p(np.ascontiguousarray(ent, np.int32)), len(ent),
                n_entities, 1, _i64p(counts)) < 0:
            raise ValueError("entity index out of range")
        return counts
    counts = np.bincount(ent, minlength=n_entities)
    if len(counts) > n_entities:
        raise ValueError("entity index out of range")
    return counts


def _counts_layout(ent: np.ndarray, width: int, n_entities: int,
                   blocks_per_chunk: int, n_shards: int = 1):
    """counts + (chunk, padded block count S) for one side. Over
    ``n_shards`` ranks (the reference's mesh layout, l.1242-1261) each
    rank's ``S / n_shards`` blocks are whole chunks; at one shard this is
    the single-device layout."""
    counts = _entity_counts(ent, n_entities, _native_packer())
    n_blocks = int((-(-counts // width)).sum())
    per_shard = max(1, -(-n_blocks // n_shards))
    chunk = min(blocks_per_chunk, _round_up(per_shard, 8))
    pad_to = n_shards * chunk
    S = max(pad_to, _round_up(max(n_blocks, 1), pad_to))
    return counts, chunk, S


def _nibble_pack(codes: np.ndarray) -> np.ndarray:
    """Pack uint8 codes ≤ 15 two-per-byte: byte k = edge 2k (low nibble)
    | edge 2k+1 (high nibble). Mirrors ``decode_ratings('u4')``."""
    n = len(codes)
    if n % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    pair = codes.reshape(-1, 2)
    return (pair[:, 0] | (pair[:, 1] << 4)).astype(np.uint8)


def _planes(idx: np.ndarray, n_pad: int):
    """(low, high) item wire planes: uint16 alone below 2^16, uint16 +
    uint8 high plane below 2^24, raw int32 beyond. An empty high plane
    means "unused"."""
    none = np.zeros(0, np.uint8)
    if n_pad < 65536:
        return idx.astype(np.uint16), none
    if n_pad < (1 << 24):
        return (
            (idx & 0xFFFF).astype(np.uint16),
            (idx >> 16).astype(np.uint8),
        )
    return idx, none


def _np_deltas(ids: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-edge gap to the previous same-segment id (the first edge of
    each segment gaps from 0)."""
    E = len(ids)
    cnt = counts[counts > 0].astype(np.int64)
    starts = np.zeros(len(cnt), np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    prev = np.empty(E, np.int32)
    prev[0] = 0
    prev[1:] = ids[:-1]
    prev[starts] = 0
    return ids.astype(np.int32) - prev


def _delta_wire_size(
    ids: np.ndarray, counts: np.ndarray
) -> Optional[Tuple[int, int]]:
    """``(wire_bytes, n_ovf)`` of the delta12 encoding without building
    it, or None when it does not apply (ids not segment-sorted, or a gap
    ≥ 2^16). The native route is one count pass, ``als_delta_count``."""
    E = len(ids)
    if E == 0:
        return 0, 0
    native = _native_packer()
    if native is not None:
        cnt64 = np.ascontiguousarray(counts, np.int64)
        n_ovf = int(native.als_delta_count(
            _i32p(np.ascontiguousarray(ids, np.int32)), _i64p(cnt64),
            len(cnt64)))
        if n_ovf < 0:
            return None
    else:
        delta = _np_deltas(ids, counts)
        if int(delta.min()) < 0 or int(delta.max()) >= 65536:
            return None
        n_ovf = int((delta > 0xFFF).sum())
    return E + (E + 1) // 2 + 5 * n_ovf, n_ovf


def _encode_items_delta(ids: np.ndarray, counts: np.ndarray,
                        n_ovf: Optional[int] = None):
    """12-bit delta item wire over a (user, item)-sorted edge slice.

    ``counts`` segments ``ids`` into per-user runs (zero entries allowed;
    the nonzero entries sum to ``len(ids)``). Each edge ships the gap to
    the previous item of its user (the first edge of a run ships its
    absolute id) as a u8 low byte and a nibble-packed high 4 bits — 1.5
    B/edge — plus a sparse overflow list of ``delta >> 12`` for the gaps ≥
    4096. Exact for any id space < 2^16 (see :func:`decode_items`). The
    native route is ``als_delta_fill`` (``n_ovf``, :func:`_delta_wire_size`'s
    count, saves its count pass); the caller has checked that the
    encoding applies.
    Returns ``(d_lo, d_hi, ovf_idx i32, ovf_val u8, wire_bytes)``.
    """
    E = len(ids)
    if E == 0:
        z8 = np.zeros(0, np.uint8)
        return z8, z8, np.zeros(0, np.int32), z8, 0
    native = _native_packer()
    if native is not None:
        ids = np.ascontiguousarray(ids, np.int32)
        cnt64 = np.ascontiguousarray(counts, np.int64)
        if n_ovf is None:
            n_ovf = int(native.als_delta_count(
                _i32p(ids), _i64p(cnt64), len(cnt64)))
            if n_ovf < 0:
                raise ValueError("the delta12 item wire does not apply: ids "
                                 "not segment-sorted, or a gap >= 2^16")
        d_lo = np.empty(E, np.uint8)
        d_hi = np.empty((E + 1) // 2, np.uint8)  # zeroed by als_delta_fill
        ovf_idx = np.empty(n_ovf, np.int32)
        ovf_val = np.empty(n_ovf, np.uint8)
        native.als_delta_fill(
            _i32p(ids), _i64p(cnt64), len(cnt64), E,
            _u8p(d_lo), _u8p(d_hi), _i32p(ovf_idx), _u8p(ovf_val),
        )
    else:
        delta = _np_deltas(ids, counts)
        ovf = np.nonzero(delta > 0xFFF)[0]
        d_lo = (delta & 0xFF).astype(np.uint8)
        d_hi = _nibble_pack(((delta >> 8) & 0xF).astype(np.uint8))
        ovf_idx = ovf.astype(np.int32)
        ovf_val = (delta[ovf] >> 12).astype(np.uint8)
    bytes_ = d_lo.nbytes + d_hi.nbytes + ovf_idx.nbytes + ovf_val.nbytes
    return d_lo, d_hi, ovf_idx, ovf_val, bytes_


def _encode_ratings(r_sorted: np.ndarray) -> Tuple[np.ndarray, str]:
    """The densest lossless rating wire: ``(wire array, kind)`` with kind
    ∈ {u4, u8, f16, f32} — nibble-packed half-star codes (2 edges/byte),
    byte codes up to 127.5 stars, fp16 where that cast is exact, else raw
    f32. Every kind round-trips exactly through :func:`decode_ratings`.
    The native route checks the half-star grid and writes the byte codes
    in one pass (``als_rating_codes``)."""
    native = _native_packer()
    if native is not None and r_sorted.size:
        r_sorted = np.ascontiguousarray(r_sorted, np.float32)
        codes = np.empty(r_sorted.size, np.uint8)
        mx = native.als_rating_codes(_f32p(r_sorted), r_sorted.size,
                                     _u8p(codes))
        if mx >= 0:
            if mx <= 15:
                return _nibble_pack(codes), "u4"
            return codes, "u8"
    elif native is None:
        r2 = r_sorted * np.float32(2.0)
        if r2.size and np.all(r2 == np.round(r2)) and float(r2.min()) >= 0.0:
            if float(r2.max()) <= 15.0:
                return _nibble_pack(r2.astype(np.uint8)), "u4"
            if float(r2.max()) <= 255.0:
                return r2.astype(np.uint8), "u8"
    r16 = r_sorted.astype(np.float16)
    if np.array_equal(r16.astype(np.float32), r_sorted):
        return r16, "f16"
    return r_sorted, "f32"


def _sort_edges_by_user(user_idx, item_idx, rating,
                        counts_u: Optional[np.ndarray] = None):
    """(user, item)-sorted item and rating columns, numpy's stable
    ``lexsort`` order. Item-sorted adjacencies make the delta item wire
    dense; ALS itself is order-invariant within a user. ``counts_u`` (the
    users' int64 degrees; one entry a user) saves the native route its
    count: a stable counting sort by user, then a stable sort of each
    user's items."""
    native = _native_packer()
    if native is None:
        order = np.lexsort((item_idx, user_idx))
        return (np.ascontiguousarray(item_idx[order]),
                np.ascontiguousarray(rating[order]))
    user_idx = np.ascontiguousarray(user_idx, np.int32)
    if counts_u is None:
        n_users = int(user_idx.max()) + 1 if len(user_idx) else 0
        counts_u = _entity_counts(user_idx, n_users, native)
    counts_u = np.ascontiguousarray(counts_u, np.int64)
    E = len(user_idx)
    i_sorted = np.empty(E, np.int32)
    r_sorted = np.empty(E, np.float32)
    native.als_sort_by_entity(
        _i32p(user_idx), _i32p(np.ascontiguousarray(item_idx, np.int32)),
        _f32p(np.ascontiguousarray(rating, np.float32)), E, len(counts_u),
        _i64p(counts_u), _i32p(i_sorted), _f32p(r_sorted),
    )
    if native.als_sort_within_entity(_i32p(i_sorted), _f32p(r_sorted),
                                     len(counts_u), _i64p(counts_u)) != 0:
        raise ValueError("a user has 2^32 or more ratings: the native "
                         "within-user sort cannot order them")
    return i_sorted, r_sorted


def _choose_item_wire(i_sorted, counts_u, I_pad, n_edges,
                      item_wire: Optional[str] = None):
    """The denser lossless item wire: uint16/24/32 planes or 12-bit
    deltas over the (user, item)-sorted adjacency, sized without building
    it. ``item_wire`` "delta12" or "planes" asks for one where it applies;
    None reads ``PIO_TPU_ALS_ITEM_WIRE`` (``auto``, ``delta12``,
    ``planes``), as the reference does.
    Returns (item_wire, n_ovf, edge_item_bytes)."""
    if item_wire is None:
        item_wire = knobs.knob_str("PIO_TPU_ALS_ITEM_WIRE")
    plane_width = 2 if I_pad < 65536 else (3 if I_pad < 2 ** 24 else 4)
    n_ovf = None
    if I_pad < 65536 and item_wire in ("auto", "delta12"):
        sized = _delta_wire_size(i_sorted, counts_u)
        if sized is not None:
            delta_bytes, n_ovf = sized
            if item_wire == "delta12" or delta_bytes < 2 * n_edges:
                return "delta12", n_ovf, delta_bytes
    return "planes", n_ovf, plane_width * n_edges


def _wire_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A wire array as a tensor on ``device``; uint16 planes travel as
    their int16 bit pattern (:func:`decode_items` masks them back)."""
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------- device side
def _resolve_matmul_dtype(matmul_dtype: str) -> torch.dtype:
    """``"auto"`` → float32 in the port (see the module docstring)."""
    if matmul_dtype in ("auto", "float32"):
        return torch.float32
    if matmul_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(
        f"unknown ALS matmul_dtype {matmul_dtype!r}; use auto/float32/bfloat16"
    )


def _chunk_partials(other, r_c, factors_ext, implicit: bool, alpha: float):
    """One chunk's per-block ``[Σ_w w·q qᵀ ; Σ_w rhs·q]`` as ``[c, K+1,
    K]`` float32 (the last row the right-hand side): a gather of ``[c, W,
    K]`` rows and one batched product of ``factors_ext``'s dtype, ``[w·q |
    rhs]ᵀ q``.

    ``factors_ext`` is the other side's factors with a zero row appended:
    a padded slot (``other == -1``, rating 0) gathers that row and adds
    exactly nothing, where the reference gathers row 0 and masks it.
    """
    q = factors_ext[other]  # [c, W, K]
    mm = factors_ext.dtype
    if implicit:
        # confidence c = 1 + α r; correction weight c - 1 = α r
        w = (alpha * r_c).to(mm)[:, :, None]
        rhs = (1.0 + alpha * r_c).to(mm)[:, :, None]
    else:
        w, rhs = None, r_c.to(mm)[:, :, None]
    if mm == torch.bfloat16 and q.is_cuda:
        # bf16 operands of cuBLAS, float32 accumulation and result; the
        # weighted rows round to bf16, as on the reference's MXU
        lhs = torch.cat([q if w is None else q * w, rhs], dim=2)
        return torch.bmm(lhs.transpose(1, 2), q, out_dtype=torch.float32)
    # float32 products: bf16 values upcast exactly, and the weighted rows
    # stay float32, as the reference's on the CPU
    qf = q.float()
    lhs = torch.cat([qf if w is None else qf * w.float(), rhs.float()], dim=2)
    return torch.bmm(lhs.transpose(1, 2), qf)


def segment_plan(block_ent, chunk: int):
    """Per chunk of blocks: ``(first block, first entity, offsets of the
    chunk's entity runs)``, the offsets a tensor on ``block_ent``'s
    device (an entity with no block in the range has an empty run).

    ``block_ent`` is ascending (both packers give it so; padding blocks
    belong to one entity at the end), so each chunk covers a contiguous
    range of entities. Made once per layout, from one host copy of
    ``block_ent``.
    """
    be = block_ent.cpu().numpy().astype(np.int64)
    heads, runs = [], []
    for lo in range(0, len(be), chunk):
        seg = be[lo:lo + chunk]
        ends = np.cumsum(np.bincount(seg - seg[0]))
        runs.append(np.concatenate([[0], ends]))
        heads.append((lo, int(seg[0]), len(runs[-1])))
    offsets = torch.from_numpy(np.concatenate(runs)).to(block_ent.device)
    plan, off = [], 0
    for lo, e0, n in heads:
        plan.append((lo, e0, offsets[off:off + n]))
        off += n
    return plan


def _add_runs(acc, e0: int, offsets, part) -> None:
    """Sum a chunk's block partials ``part [c, K+1, K]`` over its entity
    runs (fixed order) and add them into entities ``e0 .. e0 +
    len(offsets) - 1`` of ``acc``. The plan's offsets are valid by
    construction, so the checks that would sync with the host are off
    (``unsafe``)."""
    n = offsets.shape[0] - 1
    flat = part.view(part.shape[0], -1)
    acc[e0:e0 + n].view(n, -1).add_(torch.segment_reduce(
        flat, "sum", offsets=offsets, axis=0, unsafe=True))


def partial_normal_acc(block_ent, block_other, block_r, factors,
                       n_entities: int, chunk: int, implicit: bool = False,
                       alpha: float = 40.0,
                       matmul_dtype: torch.dtype = torch.float32, plan=None):
    """Σ w·q qᵀ and Σ rhs·q per entity over the blocked layout, chunk by
    chunk: the chunk's block partials (:func:`_chunk_partials`), summed
    onto its entities and carried in one ``[n_entities, K+1, K]`` float32
    accumulator (:func:`_add_runs`), which is returned (rows ``:K`` are
    ``A``, row ``K`` is ``b``). ``plan`` is :func:`segment_plan`'s for this
    layout and chunk (made here when None).
    """
    if plan is None:
        plan = segment_plan(block_ent, chunk)
    K = factors.shape[1]
    factors_ext = torch.cat([factors.to(matmul_dtype),
                             factors.new_zeros((1, K), dtype=matmul_dtype)])
    acc = torch.zeros((n_entities, K + 1, K), dtype=torch.float32,
                      device=factors.device)
    for lo, e0, offsets in plan:
        part = _chunk_partials(block_other[lo:lo + chunk],
                               block_r[lo:lo + chunk], factors_ext,
                               implicit, alpha)
        _add_runs(acc, e0, offsets, part)
    return acc


def partial_normal_eq(block_ent, block_other, block_r, factors,
                      n_entities: int, chunk: int, implicit: bool = False,
                      alpha: float = 40.0,
                      matmul_dtype: torch.dtype = torch.float32, plan=None):
    """:func:`partial_normal_acc` as ``A [n_entities, K, K]``, ``b
    [n_entities, K]``, views of the accumulator."""
    acc = partial_normal_acc(block_ent, block_other, block_r, factors,
                             n_entities, chunk, implicit, alpha,
                             matmul_dtype, plan)
    K = factors.shape[1]
    return acc[:, :K], acc[:, K]


def _cg_solve(A, b):
    """Batched Jacobi-preconditioned CG for K+8 iterations (≥ the Krylov
    dimension, with margin for f32 rounding); A is SPD (normal equations
    + λI)."""
    K = b.shape[1]
    inv_d = 1.0 / torch.diagonal(A, dim1=1, dim2=2)
    x = b * inv_d
    r = b - (A @ x[:, :, None])[:, :, 0]
    z = r * inv_d
    p = z
    rz = (r * z).sum(-1)
    for _ in range(K + 8):
        Ap = (A @ p[:, :, None])[:, :, 0]
        denom = (p * Ap).sum(-1)
        alpha_c = rz / denom.masked_fill(denom == 0, 1.0)
        x = x + alpha_c[:, None] * p
        r = r - alpha_c[:, None] * Ap
        z = r * inv_d
        rz2 = (r * z).sum(-1)
        beta = rz2 / rz.masked_fill(rz == 0, 1.0)
        p = z + beta[:, None] * p
        rz = rz2
    return x


def _solver_for(solver: str) -> str:
    """The solver that runs ("auto" resolved; see ``ALSConfig.solver``)."""
    if solver not in _SOLVERS:
        raise ValueError(
            f"unknown ALS solver {solver!r}; use auto/cg/cholesky/lu"
        )
    return "cholesky" if solver == "auto" else solver


def solve_block(A, b, gram, reg: float, implicit: bool = False,
                solver: str = "auto"):
    """Regularized batched solve ``(A + λI [+ gram]) x = b`` per entity.

    Cholesky and LU run without an error check (``*_ex``), as the
    reference's factorizations: a failed factorization gives NaN factors
    and no host round trip.
    """
    K = b.shape[1]
    eff = _solver_for(solver)
    A = A + torch.eye(K, dtype=torch.float32, device=A.device) * reg
    if implicit:
        A = A + gram[None, :, :]
    if eff == "cg":
        return _cg_solve(A, b)
    if eff == "cholesky":
        L, _ = torch.linalg.cholesky_ex(A)
        y = torch.linalg.solve_triangular(L, b[:, :, None], upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return x[:, :, 0]
    x, _ = torch.linalg.solve_ex(A, b[:, :, None])
    return x[:, :, 0]


def gram_of(factors, implicit: bool = False):
    """``QᵀQ`` for implicit feedback, else a K×K zero matrix."""
    K = factors.shape[1]
    if implicit:
        return factors.T @ factors
    return torch.zeros((K, K), dtype=torch.float32, device=factors.device)


def half_step(blocks, factors, n_entities: int, chunk: int,
              config: ALSConfig, group=None, plan=None):
    """One half-step (the reference's ``shard_map`` body, l.432-460): this
    rank's blocks give the partial normal equations of every entity;
    ``reduce_scatter`` sums them over the ranks and leaves each rank its
    ``1/world`` entity rows; the rank solves those; ``all_gather`` puts the
    new factors back together on every rank. Without a group (one
    process, every block) both collectives are identities. ``plan`` as in
    :func:`partial_normal_acc`."""
    mm = _resolve_matmul_dtype(str(config.matmul_dtype))
    K = factors.shape[1]
    acc = partial_normal_acc(
        *blocks, factors, n_entities, chunk, implicit=bool(config.implicit),
        alpha=float(config.alpha), matmul_dtype=mm, plan=plan,
    )
    mine = distributed.reduce_scatter_rows(acc, group)
    new_local = solve_block(
        mine[:, :K], mine[:, K], gram_of(factors, bool(config.implicit)),
        float(config.reg), bool(config.implicit), str(config.solver),
    )
    return distributed.all_gather_rows(new_local, group)


def decode_items(i_lo, i_hi, ovf_idx=None, ovf_val=None, counts=None,
                 item_wire: str = "planes"):
    """Wire → int32 item ids.

    ``planes``: a uint16 low plane (as :func:`_wire_tensor`'s int16 bit
    pattern) and an optional uint8 high plane, or raw int32 ids.
    ``delta12``: 12-bit gaps over the (user, item)-sorted adjacency —
    ``i_lo`` the u8 low byte, ``i_hi`` the nibble-packed high 4 bits, and
    the sparse overflow list (``delta >> 12`` in ``ovf_val``). Ids are a
    segmented cumsum: the cumsum of the gaps less each user's prefix at
    its segment start. The reference sums in uint32 and relies on its
    wraparound; here the sums are int64 and exact, so the ids are the
    same bits.
    """
    if item_wire == "delta12":
        E = i_lo.shape[0]
        lo = i_lo.to(torch.int64)
        hi = torch.stack([i_hi & 0xF, i_hi >> 4], dim=1).reshape(-1)[:E]
        delta = lo | (hi.to(torch.int64) << 8)
        delta = delta.index_add(
            0, ovf_idx.long(), ovf_val.to(torch.int64) << 12
        )
        G = torch.cumsum(delta, 0)
        cnt = counts.to(torch.int64)
        es = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])[:-1]
        g_prev = torch.where(es > 0, G[(es - 1).clamp(min=0)], 0)
        offs = torch.repeat_interleave(g_prev, cnt, output_size=E)
        return (G - offs).to(torch.int32)
    if i_lo.dtype == torch.int16:
        i32 = i_lo.to(torch.int32) & 0xFFFF
    else:
        i32 = i_lo.to(torch.int32)
    if i_hi.shape[0]:
        i32 = i32 | (i_hi.to(torch.int32) << 16)
    return i32


def decode_ratings(r, n_edges: int, rating_wire: str = "f32"):
    """Wire → float32 ratings: ``u4`` nibble-packed half-star codes (2
    edges/byte), ``u8`` half-star codes, ``f16``/``f32`` raw floats."""
    if rating_wire == "u4":
        lo = (r & 0xF).to(torch.float32)
        hi = (r >> 4).to(torch.float32)
        pairs = torch.stack([lo, hi], dim=1).reshape(-1)
        return pairs[:n_edges] * 0.5
    if rating_wire == "u8":
        return r.to(torch.float32) * 0.5
    return r.to(torch.float32)


def device_pack(ent, oth, rat, n_entities: int, width: int, S: int,
                assume_sorted: bool = False, counts=None,
                pad_entity: Optional[int] = None):
    """COO → blocked layout on the tensors' device, as gathers only.

    Gives the same bits as :func:`_pack_blocks`. Every ``[S, W]`` slot
    computes which edge it holds — its block's entity by a search over
    the block prefix sum, its position from the block's offset within the
    entity — and gathers it, through the stable sort permutation of
    ``ent`` unless ``assume_sorted``. ``pad_entity`` redirects the padding
    blocks' (masked) entity id (default: the last entity). ``ent`` may be
    None when ``counts`` is given with ``assume_sorted``.
    """
    dev = oth.device
    if counts is None:
        counts = torch.bincount(ent.long(), minlength=n_entities)
    counts = counts.to(torch.int64)
    blocks = (counts + (width - 1)) // width
    zero = counts.new_zeros(1)
    block_start = torch.cat([zero, torch.cumsum(blocks, 0)])
    edge_start = torch.cat([zero, torch.cumsum(counts, 0)])

    pad_tgt = (n_entities - 1) if pad_entity is None else pad_entity
    slots = torch.arange(S, device=dev)
    bids = torch.searchsorted(block_start[1:], slots, right=True)
    block_ent = bids.clamp(max=pad_tgt)

    blk_in_ent = slots - block_start[block_ent]
    pos = blk_in_ent[:, None] * width + torch.arange(width, device=dev)[None, :]
    valid = pos < counts[block_ent][:, None]
    src = torch.where(valid, edge_start[block_ent][:, None] + pos, 0)
    if not assume_sorted:
        src = torch.argsort(ent, stable=True)[src]
    block_other = torch.where(valid, oth[src].to(torch.int32), -1)
    block_rating = torch.where(valid, rat[src].to(torch.float32), 0.0)
    return block_ent.to(torch.int32), block_other, block_rating


def _init_factors(n_rows: int, rank: int, generator: torch.Generator):
    """``|N(0,1)|/√rank`` — positive entries matched to nonnegative
    ratings; a tiny symmetric init can collapse every factor onto one
    direction in the first, regularization-dominated half-step."""
    return torch.randn(
        (n_rows, rank), generator=generator, dtype=torch.float32
    ).abs_() * (float(rank) ** -0.5)


def _run_iterations(by_user, by_item, P0, Q0, config: ALSConfig,
                    chunk_user: int, chunk_item: int, group=None):
    """``config.iterations`` alternating half-steps (:func:`half_step`)
    from the replicated ``(P0, Q0)`` on their device. ``by_user`` and
    ``by_item`` are this rank's blocks (every block without a group). The
    tests feed the reference's initial factors here."""
    U_pad, I_pad = P0.shape[0], Q0.shape[0]
    plan_user = segment_plan(by_user[0], chunk_user)
    plan_item = segment_plan(by_item[0], chunk_item)
    P, Q = P0, Q0
    for _ in range(config.iterations):
        P = half_step(by_user, Q, U_pad, chunk_user, config, group,
                      plan_user)
        Q = half_step(by_item, P, I_pad, chunk_item, config, group,
                      plan_item)
    return P, Q


def _decode_pack(wire, packed_shapes, U_pad: int, I_pad: int,
                 rating_wire: str, item_wire: str):
    """Decode the (user, item)-sorted wire and build both blocked layouts
    on the device. ``wire`` is ``(counts_u, counts_i, i_lo, i_hi, ovf_idx,
    ovf_val, r)``; ``packed_shapes`` is ``(chunk_user, S_u, w_u,
    chunk_item, S_i, w_i)``. Returns ``(by_user, by_item)``."""
    counts_u, counts_i, i_lo, i_hi, ovf_idx, ovf_val, r = wire
    _, su, wu, _, si, wi = packed_shapes
    E = i_lo.shape[0]
    i32 = decode_items(i_lo, i_hi, ovf_idx, ovf_val, counts_u, item_wire)
    r32 = decode_ratings(r, E, rating_wire)
    u32 = torch.repeat_interleave(
        torch.arange(U_pad, dtype=torch.int32, device=i32.device),
        counts_u.long(), output_size=E,
    )
    by_user = device_pack(u32, i32, r32, U_pad, wu, su,
                          assume_sorted=True, counts=counts_u)
    by_item = device_pack(i32, u32, r32, I_pad, wi, si, counts=counts_i)
    return by_user, by_item


def blocks_of(blocks, rank: int, world: int):
    """A rank's contiguous ``1/world`` of a blocked layout's blocks (the
    reference's ``P(axis)`` block sharding)."""
    per = blocks[0].shape[0] // world
    return tuple(t[rank * per:(rank + 1) * per] for t in blocks)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _layouts(user_idx, item_idx, n_users: int, n_items: int,
             config: ALSConfig, n_shards: int = 1):
    """Both sides' layouts over ``n_shards`` ranks: entity counts padded
    to shard multiples (the reference's l.1200-1220), the block widths,
    degrees, chunks and padded block counts. Returns ``(U_pad, I_pad,
    counts_u, counts_i, packed_shapes)``, ``packed_shapes`` in
    :func:`_decode_pack`'s terms."""
    n_edges = len(user_idx)
    U_pad = _round_up(max(n_users, 1), n_shards)
    I_pad = _round_up(max(n_items, 1), n_shards)
    w_user = config.block_width or _auto_width(n_edges, n_users)
    w_item = config.block_width or _auto_width(n_edges, n_items)
    counts_u, chunk_user, S_u = _counts_layout(
        user_idx, w_user, U_pad, config.blocks_per_chunk, n_shards)
    counts_i, chunk_item, S_i = _counts_layout(
        item_idx, w_item, I_pad, config.blocks_per_chunk, n_shards)
    if S_u * w_user >= 2 ** 31 or S_i * w_item >= 2 ** 31:
        raise ValueError(
            "edge set too large for int32 block addressing; "
            "use a multi-device mesh"
        )
    shapes = (chunk_user, S_u, w_user, chunk_item, S_i, w_item)
    return (U_pad, I_pad, np.ascontiguousarray(counts_u, np.int64),
            counts_i, shapes)


def _encode_wire(user_idx, item_idx, rating, n_users: int, n_items: int,
                 config: ALSConfig, item_wire: Optional[str] = None,
                 n_shards: int = 1):
    """:func:`train_als`'s host side: the layouts' sizes (over
    ``n_shards`` ranks), the (user, item) edge sort and the wire encoders.
    ``item_wire`` as in :func:`_choose_item_wire`. Returns ``(host_wire,
    packed_shapes, rating_wire, item_wire, wire_bytes)`` in
    :func:`_decode_pack`'s terms.
    """
    n_edges = len(user_idx)
    U_pad, I_pad, counts_u, counts_i, shapes = _layouts(
        user_idx, item_idx, n_users, n_items, config, n_shards)
    i_sorted, r_sorted = _sort_edges_by_user(user_idx, item_idx, rating,
                                             counts_u)
    r_ship, rating_wire = _encode_ratings(r_sorted)
    item_wire, n_ovf, item_bytes = _choose_item_wire(
        i_sorted, counts_u, I_pad, n_edges, item_wire
    )
    if item_wire == "delta12":
        i_ship, i_hi, ovf_idx, ovf_val, _ = _encode_items_delta(
            i_sorted, counts_u, n_ovf
        )
    else:
        i_ship, i_hi = _planes(i_sorted, I_pad)
        ovf_idx = np.zeros(0, np.int32)
        ovf_val = np.zeros(0, np.uint8)
    host_wire = (
        counts_u.astype(np.int32), counts_i.astype(np.int32),
        i_ship, i_hi, ovf_idx, ovf_val, r_ship,
    )
    wire_bytes = item_bytes + r_ship.nbytes + 4 * (U_pad + I_pad)
    return host_wire, shapes, rating_wire, item_wire, wire_bytes


def train_als(
    ctx: ComputeContext,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    rating: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig = ALSConfig(),
    stats: Optional[dict] = None,
) -> ALSFactors:
    """Train ALS on ``ctx.device``; returns host numpy factors.

    The host sorts the edges by (user, item) and encodes the wire; the
    device decodes it, builds both blocked layouts and runs the
    iterations. In a process group every rank runs this on the same
    edges: entity counts padded to world multiples, the replicated
    initial factors drawn as on one device at the padded counts, each
    rank's ``1/world`` of the blocks through :func:`half_step`. Without a
    group the world is 1 and the collectives are identities.

    ``PIO_TPU_ALS_MESH_WIRE`` picks a group's shipment: ``auto``/``compact``
    ships the wire, each rank ``1/world`` of its encoded edge arrays,
    re-replicated by ``all_gather`` before the device pack; ``blocked``
    packs both layouts on the host (float32 blocks) and ships each rank
    only its blocks. The two give the same bits. ``stats``, when a dict,
    is filled with ``{packer, pack_s, wire_bytes, encoding, n_stream,
    world, h2d_s, device_s}``, the phases separated by device
    synchronizations. The run is always one shipment: ``n_stream`` is 1
    (the port has no streamed trainer).
    """
    if len(user_idx) == 0:
        raise ValueError("ALS needs at least one rating")
    dev, group, rank, world = ctx.device, ctx.group, ctx.rank, ctx.world_size
    K = config.rank
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    rating = np.asarray(rating, np.float32)
    _solver_for(str(config.solver))  # an unknown solver fails first
    _resolve_matmul_dtype(str(config.matmul_dtype))
    blocked = False
    if group is not None:
        mesh_wire = knobs.knob_str("PIO_TPU_ALS_MESH_WIRE")
        if mesh_wire not in ("auto", "compact", "blocked"):
            raise ValueError(f"PIO_TPU_ALS_MESH_WIRE={mesh_wire!r}: use "
                             "auto, compact or blocked")
        blocked = mesh_wire == "blocked"
    U_pad = _round_up(max(n_users, 1), world)
    I_pad = _round_up(max(n_items, 1), world)
    # telemetry window: ALS "steps" are the alternating solve iterations
    # (no per-step loss: normal equations); the edges count as examples
    trainwatch.begin_algo(
        "als", total_steps=int(config.iterations),
        per_device_bytes=(U_pad + I_pad) * K * 4 // world,
    )

    t0 = monotonic_s()
    if blocked:
        _, _, counts_u, _, shapes = _layouts(
            user_idx, item_idx, n_users, n_items, config, world)
        host_u, host_i = _blocked_host(user_idx, item_idx, rating, U_pad,
                                       I_pad, counts_u, shapes)
        encoding = "blocked-f32"
        wire_bytes = sum(a.nbytes for t in (host_u, host_i) for a in t)
    else:
        host_wire, shapes, rating_wire, item_wire, wire_bytes = \
            _encode_wire(user_idx, item_idx, rating, n_users, n_items,
                         config, n_shards=world)
        encoding = f"{rating_wire}+{item_wire}"
    if stats is not None:
        stats["packer"] = "numpy" if _native_packer() is None else "native"
        stats["pack_s"] = monotonic_s() - t0
        stats["wire_bytes"] = wire_bytes
        stats["encoding"] = encoding
        stats["n_stream"] = 1
        stats["world"] = world

    t0 = monotonic_s()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(config.seed))
    P0 = _init_factors(U_pad, K, gen).to(dev)
    Q0 = _init_factors(I_pad, K, gen).to(dev)
    if blocked:
        def mine(host):
            t = tuple(torch.from_numpy(a) for a in host)
            return tuple(x.to(dev) for x in blocks_of(t, rank, world))

        by_user, by_item = mine(host_u), mine(host_i)
    else:
        counts_u, counts_i, i_lo, i_hi, ovf_idx, ovf_val, r = host_wire
        wire = (
            _wire_tensor(counts_u, dev), _wire_tensor(counts_i, dev),
            _ship_sharded(i_lo, ctx), _ship_sharded(i_hi, ctx),
            _wire_tensor(ovf_idx, dev), _wire_tensor(ovf_val, dev),
            _ship_sharded(r, ctx),
        )
    if stats is not None:
        _sync(dev)
        stats["h2d_s"] = monotonic_s() - t0
    t0 = monotonic_s()
    if not blocked:
        by_user, by_item = (
            blocks_of(t, rank, world) for t in _decode_pack(
                wire, shapes, U_pad, I_pad, rating_wire, item_wire))
    P, Q = _run_iterations(by_user, by_item, P0, Q0, config, shapes[0],
                           shapes[3], group)
    if stats is not None:
        _sync(dev)
        stats["device_s"] = monotonic_s() - t0
    factors = ALSFactors(
        user_factors=P.cpu().numpy()[:n_users],
        item_factors=Q.cpu().numpy()[:n_items],
    )
    trainwatch.record_steps(int(config.iterations), examples=len(user_idx))
    return factors


def _ship_sharded(a: np.ndarray, ctx) -> torch.Tensor:
    """The compact wire's shipment of one encoded array: in a group each
    rank sends its ``1/world`` span (zero-padded to a world multiple) to
    its device, and an ``all_gather`` re-replicates the whole array there,
    the padding dropped (reference ``_run_mesh_compact``, l.1066-1187);
    without one, the whole array."""
    if ctx.group is None or len(a) == 0:  # len: the same on every rank
        return _wire_tensor(a, ctx.device)
    lo, hi, n_pad = distributed.rows_of(len(a), ctx.rank, ctx.world_size)
    padded = np.zeros(n_pad, a.dtype)
    padded[:len(a)] = a
    mine = _wire_tensor(padded[lo:hi], ctx.device)
    return distributed.all_gather_rows(mine, ctx.group)[:len(a)]


def _blocked_host(user_idx, item_idx, rating, U_pad, I_pad, counts_u,
                  shapes):
    """The blocked mesh wire's host pack (reference l.1324-1366): the
    edges in canonical (user, item) order, both layouts packed on the host
    at the group's padded block counts. Returns ``(by_user, by_item)`` as
    numpy triples."""
    chunk_user, S_u, w_user, chunk_item, S_i, w_item = shapes
    i_srt, r_srt = _sort_edges_by_user(user_idx, item_idx, rating, counts_u)
    u_srt = np.repeat(np.arange(U_pad, dtype=np.int32), counts_u)
    by_user = _pack_blocks(u_srt, i_srt, r_srt, U_pad, w_user, S_u,
                           counts=counts_u)
    by_item = _pack_blocks(i_srt, u_srt, r_srt, I_pad, w_item, S_i)
    return by_user, by_item


def predict_scores(
    user_factors: np.ndarray, item_factors: np.ndarray, user: int
) -> np.ndarray:
    """Scores of every item for one user (host side)."""
    return user_factors[user] @ item_factors.T


def top_n(
    scores: np.ndarray, n: int, exclude: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-n item indices and scores, optionally excluding seen items."""
    s = scores.copy()
    if exclude is not None and len(exclude):
        s[exclude] = -np.inf
    n = min(n, len(s))
    idx = np.argpartition(-s, n - 1)[:n] if n < len(s) else np.argsort(-s)
    idx = idx[np.argsort(-s[idx])]
    return idx, s[idx]
