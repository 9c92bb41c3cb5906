"""Vocab-parallel addressing over a row-sharded table.

The port of ``pio_tpu/parallel/vocab.py``: a ``[V, D]`` table shards by
rows over the ``model`` axis; a lookup masks the ids outside the local
shard, gathers locally and sums the partial rows over the axis, so no
rank holds the whole table. The axis is a process group or None
(``parallel/collectives.py``); without one the lookup is a plain gather
and the target gather a ``take_along_dim``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pio_tpu_torch.parallel.collectives import Axis, axis_index, psum


def _local(ids: torch.Tensor, rows: int, axis: Axis):
    """The ids shifted to this rank's shard, clipped into it, and the mask
    of those that fall in it (reference l.31-35)."""
    local = ids.long() - axis_index(axis) * rows
    hit = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), hit


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          axis: Axis = None) -> torch.Tensor:
    """``table[ids]``: ``ids.shape + (D,)`` rows (reference l.15), the
    local ``[V_local, D]`` shard's rows summed over ``axis`` (a
    row-parallel :func:`psum`: the cotangent of each rank's masked rows is
    the whole row's).

    ``F.embedding``'s backward sums the rows' gradients in a fixed order
    on CUDA (a sort by id, then a segmented sum), so two runs of a
    training step give the same bits; ``index_select``'s backward adds
    with atomics and does not.
    """
    if axis is None:
        return F.embedding(ids.long(), table)
    local, hit = _local(ids, table.shape[0], axis)
    gathered = F.embedding(local, table)
    return psum(torch.where(hit[..., None], gathered, 0.0), axis)


def vocab_parallel_target_gather(logits: torch.Tensor, targets: torch.Tensor,
                                 axis: Axis = None) -> torch.Tensor:
    """Each target's logit from ``[..., V_local]`` logits sharded over
    ``axis`` (reference l.42): exactly one shard holds each target, the
    others add zero. The backward writes one value into each row of the
    gradient, so it has no sums whose order could change."""
    if axis is None:
        return torch.take_along_dim(logits, targets.long()[..., None],
                                    dim=-1)[..., 0]
    local, hit = _local(targets, logits.shape[-1], axis)
    picked = torch.take_along_dim(logits, local[..., None], dim=-1)[..., 0]
    return psum(torch.where(hit, picked, 0.0), axis)
