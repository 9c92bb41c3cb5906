"""Causal attention as the reference's all-to-all (Ulysses) attention
computes it on one device.

Counterpart of ``pio_tpu/parallel/ulysses.py`` for ``axis=None``: with no
sequence axis there is no all-to-all, and the call is the reference's
``_dense_causal_attention`` (l.41-55, l.75-78): f32 scores, the finite
``-1e30`` mask, a softmax and the product with ``v``. The all-to-all over
a sequence axis comes with the multi-device slice (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional

import torch

from pio_tpu_torch.parallel.ring import _NEG_BIG, causal_mask


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis: Optional[str] = None,
                      causal: bool = True) -> torch.Tensor:
    """Exact attention of ``[B, T, H, D]`` blocks → ``[B, T, H, D]``."""
    if axis is not None:
        raise NotImplementedError(
            f"all-to-all attention over axis {axis!r}: the port runs one "
            f"device; the sequence axis is ROADMAP A7"
        )
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = torch.where(causal_mask(t, q.device), scores, _NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
