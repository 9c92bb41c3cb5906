"""All-to-all (Ulysses) attention: exact causal attention over a
sequence sharded on the ``seq`` axis.

The port of ``pio_tpu/parallel/ulysses.py`` (l.57-101). One
:func:`~pio_tpu_torch.parallel.collectives.all_to_all` re-shards Q, K
and V from ``[B, T/n, H, D]`` to ``[B, T, H/n, D]`` (heads scattered,
sequence gathered), each rank computes dense causal attention over the
whole sequence for its heads, and a second all_to_all restores the
sequence sharding. The local scores are ``[B, H/n, T, T]``; the head
count must divide by the axis. Without an axis (or with an axis of one)
it is the reference's ``_dense_causal_attention`` (l.41-55): f32 scores,
the finite ``-1e30`` mask, a softmax and the product with ``v``.
"""

from __future__ import annotations

import torch

from pio_tpu_torch.parallel.collectives import Axis, all_to_all, axis_size
from pio_tpu_torch.parallel.ring import _NEG_BIG, causal_mask


def _dense_causal_attention(q, k, v, causal: bool, scale: float):
    """Exact attention on whole-sequence ``[B, T, h, D]`` blocks, f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = torch.where(causal_mask(q.shape[1], q.device), scores,
                             _NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis: Axis = None, causal: bool = True) -> torch.Tensor:
    """Exact attention of this rank's ``[B, T_local, H, D]`` blocks →
    its ``[B, T_local, H, D]`` output block. Raises ``ValueError`` when
    ``H`` does not divide by the axis."""
    h, d = q.shape[2], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    if axis is None:
        return _dense_causal_attention(q, k, v, causal, scale).to(q.dtype)
    n = axis_size(axis)
    if h % n:
        raise ValueError(
            f"ulysses attention needs n_heads divisible by the seq axis "
            f"size ({h} heads over {n} devices)"
        )
    # scatter heads (dim 2), gather the sequence (dim 1); the wire carries
    # the inputs' own dtype
    qg, kg, vg = (all_to_all(a, axis, 2, 1) for a in (q, k, v))
    out = _dense_causal_attention(qg, kg, vg, causal, scale).to(q.dtype)
    return all_to_all(out, axis, 1, 2)
