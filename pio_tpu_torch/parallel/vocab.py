"""Row lookups on an embedding table, and the target column of logits.

Counterpart of ``pio_tpu/parallel/vocab.py`` for ``axis=None``: on one
device the vocab-parallel lookup is a plain gather and the target gather
a ``take_along_axis``. A vocab axis (the table's rows sharded over
devices) comes with the multi-device slice (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _single_device(axis: Optional[str]) -> None:
    if axis is not None:
        raise NotImplementedError(
            f"vocab axis {axis!r}: the port runs one device; the sharded "
            f"lookup is ROADMAP A7"
        )


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          axis: Optional[str] = None) -> torch.Tensor:
    """``table[ids]``: ``ids.shape + (D,)`` rows (reference l.15).

    ``F.embedding``'s backward sums the rows' gradients in a fixed order
    on CUDA (a sort by id, then a segmented sum), so two runs of a
    training step give the same bits; ``index_select``'s backward adds
    with atomics and does not.
    """
    _single_device(axis)
    return F.embedding(ids.long(), table)


def vocab_parallel_target_gather(logits: torch.Tensor, targets: torch.Tensor,
                                 axis: Optional[str] = None) -> torch.Tensor:
    """Each target's logit from ``[..., V]`` logits (reference l.42). The
    backward writes one value into each row of the gradient, so it has no
    sums whose order could change."""
    _single_device(axis)
    return torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
