"""Weighted embedding-bag lookup (sparse × dense matmul) on a CUDA kernel.

Counterpart of ``pio_tpu/ops/embedding.py``. The sparse hot loop of the
text-classification template is

    out[b] = Σ_l weights[b, l] · table[ids[b, l]]        # f32 [B, D]

i.e. a TF-IDF document bag times an embedding table. The TPU package runs
it as a Pallas kernel (``_embedding_bag_pallas``); here it is a CUDA C++
kernel written for Hopper (``csrc/embedding_bag.cu``), built with ``nvcc``
on first use and called through ``ctypes``.

Dispatch is by the tensors' device and nothing else: a CUDA table always
launches the kernel, a CPU table takes :func:`embedding_bag_plain`. The
TPU package's size cutoff between its kernel and an XLA gather is not
carried over — it was a TPU measurement, and a gather fallback on the card
would hide the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pio_tpu_torch.utils.numutil import round_up as _round_up

#: launches of the CUDA kernel in this process (tests and chip_smoke.py
#: reset it to 0 and read it back to show a path went through the kernel)
KERNEL_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_TABLE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_KERNELS = {}  # table dtype suffix → bound ctypes function


def embedding_bag_plain(
    table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Gather + f32 weighted sum — the same arithmetic as the TPU package's
    ``_embedding_bag_xla``. Materializes the ``[B, L, D]`` gather."""
    rows = table[ids.long()].float()  # [B, L, D]
    return torch.einsum("bld,bl->bd", rows, weights.float())


def _check(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor):
    if table.dim() != 2:
        raise ValueError(f"table must be [V, D], got shape {tuple(table.shape)}")
    if ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"ids and weights must both be [B, L]; got {tuple(ids.shape)} "
            f"and {tuple(weights.shape)}"
        )
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"table dtype {table.dtype} not in float32/bfloat16")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if not (table.device == ids.device == weights.device):
        raise ValueError(
            f"table, ids and weights on different devices: {table.device}, "
            f"{ids.device}, {weights.device}"
        )


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


def embedding_bag(
    table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """``out[b] = Σ_l weights[b,l] · table[ids[b,l]]`` → float32 ``[B, D]``.

    ``table`` float32 or bfloat16 ``[V, D]``; ``ids`` int32 ``[B, L]`` in
    ``[0, V)`` (pad with any valid row and weight 0); ``weights`` float32
    ``[B, L]``. On CUDA tensors this launches the kernel (inputs must be
    contiguous; ids are not range-checked on the card), whatever D and the
    table's alignment; on CPU tensors it runs :func:`embedding_bag_plain`.

    The kernel reads no row for a slot of weight 0, where the plain version
    adds ``0 · row``: the two differ only where such a row holds inf or NaN.
    It sums in a fixed order, so two calls give the same bits.
    """
    _check(table, ids, weights)
    if table.device.type == "cuda":
        return _embedding_bag_cuda(table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, weights)
    raise ValueError(f"embedding_bag: unsupported device {table.device}")


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
