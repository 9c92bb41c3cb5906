"""Differentiable collectives over a mesh axis.

The port's counterparts of the ``jax.lax`` collectives that the
reference's neural models call inside ``shard_map`` (``psum``, tiled
``all_gather``, ``ppermute``, ``all_to_all``, ``axis_index``). An *axis*
is the process group of one ``DeviceMesh`` dim (``mesh.get_group(name)``,
:func:`pio_tpu_torch.parallel.mesh.mesh_axis_group`) or None. Without an
axis every function is the identity (``axis_index`` 0, ``axis_size`` 1);
a group of one still runs its NCCL or gloo call, whose result is the
input's bits.

Each collective is a ``torch.autograd.Function`` whose backward is
stated in its docstring. Every rank runs one program, so every rank must
reach the same collectives in the same order, in the forward and in the
backward: a caller keeps its autograd graph the same on every rank
(``torch.where`` on a rank-dependent condition, never a Python branch
that drops a tensor from the graph on some ranks).

The gradient conventions (what a rank's cotangent of a tensor means) are
the Megatron ones, per axis:

- along an axis that shards the *work* (``data``, ``seq``), each rank's
  cotangent is its part of the gradient and the parts sum to it: the
  trainers sum the parameters' gradients over these axes once the
  backward is done (:func:`all_reduce_flat`);
- along an axis that shards the *weights* (``model``, and ``pipe`` for
  the layer stack), a tensor replicated over the axis carries the whole
  cotangent on every rank: :func:`psum` closes a row-parallel product
  (all_reduce forward, identity backward) and :func:`copy_to` opens a
  column-parallel one (identity forward, all_reduce backward).

``torch.distributed.nn.functional.all_reduce`` is not :func:`psum`: its
backward is an all_reduce too, which counts a replicated cotangent once
per rank.

:class:`CollectiveTimer` records CUDA events around every collective
launched while it is :func:`recording`, for a per-step device time.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pio_tpu_torch.parallel import distributed

Axis = Optional["dist.ProcessGroup"]


def axis_size(axis: Axis) -> int:
    """Ranks along ``axis`` (1 without one)."""
    return 1 if axis is None else dist.get_world_size(axis)


def axis_index(axis: Axis) -> int:
    """This rank's coordinate along ``axis`` (0 without one): its rank in
    the axis's group, which a ``DeviceMesh`` orders by coordinate."""
    return 0 if axis is None else dist.get_rank(axis)


# -- timing -------------------------------------------------------------------
class CollectiveTimer:
    """CUDA event pairs around the collectives launched while recording,
    by collective name. :meth:`ms` synchronizes and sums them."""

    def __init__(self) -> None:
        self.events: Dict[str, List[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = {}

    def ms(self) -> Dict[str, float]:
        """Device milliseconds by collective name, and their count."""
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}

    def counts(self) -> Dict[str, int]:
        return {name: len(pairs) for name, pairs in self.events.items()}


_TIMER: Optional[CollectiveTimer] = None


@contextlib.contextmanager
def recording(timer: CollectiveTimer) -> Iterator[CollectiveTimer]:
    """Time every collective on CUDA tensors inside the block (the
    backward's too: it runs on autograd's device thread) into ``timer``."""
    global _TIMER
    prev, _TIMER = _TIMER, timer
    try:
        yield timer
    finally:
        _TIMER = prev


@contextlib.contextmanager
def _timed(name: str, t: torch.Tensor):
    timer = _TIMER
    if timer is None or not t.is_cuda:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    timer.events.setdefault(name, []).append((start, end))


# -- the plain calls ----------------------------------------------------------
def _all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    out = x.contiguous().clone()
    with _timed("all_reduce", out):
        return distributed.all_reduce_sum(out, axis)


def _gather0(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    with _timed("all_gather", x):
        return distributed.all_gather_rows(x, axis)


def _scatter0(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the ranks, this rank's slice of dim 0."""
    with _timed("reduce_scatter", x):
        return distributed.reduce_scatter_rows(x, axis)


def _permute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]]):
    """Send ``x`` along ``perm`` (pairs of group ranks ``(src, dst)``):
    a rank that no pair sends to receives zeros."""
    me = axis_index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(axis, dst), axis))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(axis, src), axis))
    if ops:
        with _timed("ppermute", out):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out


def _exchange(x: torch.Tensor, axis, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    """Tiled all_to_all: ``x``'s ``split_dim`` cut in ``n`` chunks, chunk
    ``j`` to rank ``j``; the chunks received concatenated along
    ``concat_dim`` in rank order."""
    n = axis_size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    with _timed("all_to_all", recv):
        dist.all_to_all_single(recv, send, group=axis)
    return torch.cat(recv.unbind(0), dim=concat_dim)


# -- autograd -----------------------------------------------------------------
class _Psum(torch.autograd.Function):
    """all_reduce forward; identity backward (the output is replicated
    and carries the whole cotangent on every rank, so each input's
    cotangent is that)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; all_reduce backward (each rank's use of the
    replicated input gives a part of its cotangent)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    """Tiled all_gather along dim 0 forward; backward: this rank's slice
    of the reduce-scattered cotangent (every rank's use of the gathered
    tensor adds to each slice's cotangent)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather0(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.axis), None


class _Ppermute(torch.autograd.Function):
    """Send along ``perm`` forward; backward: the cotangents sent back
    along the inverse permutation."""

    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.axis, inverse), None, None


class _AllToAll(torch.autograd.Function):
    """Tiled all_to_all forward; backward: the inverse exchange (split
    the concatenated dim, concatenate the split one)."""

    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return _exchange(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, ctx.axis, concat_dim, split_dim), None, None, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over ``axis``, closing a row-parallel product (reference
    ``jax.lax.psum``): all_reduce forward, identity backward."""
    return x if axis is None else _Psum.apply(x, axis)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A replicated tensor entering per-rank work (a column-parallel
    product, the pipeline's first stage): identity forward, all_reduce
    backward."""
    return x if axis is None else _CopyTo.apply(x, axis)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (reference ``all_gather(..., tiled=True)``); backward: the
    reduce-scattered cotangent's slice (none for a tensor that needs no
    gradient)."""
    if axis is None:
        return x
    if dim == 0:
        return _AllGather.apply(x, axis)
    return _AllGather.apply(x.movedim(dim, 0), axis).movedim(0, dim)


def ppermute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` sent along ``perm``, pairs ``(src, dst)`` of axis indices
    (reference ``jax.lax.ppermute``): a rank no pair sends to gets zeros.
    Backward: the inverse permutation."""
    if axis is None:
        return x
    return _Ppermute.apply(x, axis, tuple(tuple(p) for p in perm))


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Tiled all_to_all (reference ``jax.lax.all_to_all(...,
    tiled=True)``); backward: the inverse exchange."""
    if axis is None:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    axes: Sequence[Axis]) -> List[torch.Tensor]:
    """``tensors`` summed over each axis of ``axes`` in turn, as one flat
    buffer a dtype (one call an axis): the parameters' gradients over the
    axes that shard the work. New tensors; the inputs are untouched.
    Without an axis, ``tensors`` as they are."""
    axes = [a for a in axes if a is not None]
    if not axes:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for axis in axes:
            with _timed("all_reduce", flat):
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=axis)
        for i, piece in zip(idx, flat.split(
                [tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out
