"""Ring attention: exact causal attention over a sequence sharded on the
``seq`` axis.

The port of ``pio_tpu/parallel/ring.py`` (``ring_attention`` l.67-118).
Each rank holds ``[B, T/n, H, D]`` blocks of Q, K and V; K and V rotate
around the ring with :func:`~pio_tpu_torch.parallel.collectives.ppermute`
(``n - 1`` rotations, the last block taken with no final exchange) while
Q stays put, and the softmax is computed online (running max ``m``,
normalizer ``l``, accumulator ``o``), so no rank holds the ``[T, T]``
scores. Causality uses global positions: rank ``i`` holds query
positions ``i·T/n + [0, T/n)`` and, after ``s`` rotations, the K/V block
that started on rank ``(i - s) mod n``; blocks wholly in the future
still pass (every rank runs one program) and add zero weight.

The arithmetic is the reference's: f32 scores scaled by ``1/sqrt(d)``,
the finite ``-1e30`` mask, ``exp(m - m_new)`` corrections and
``o / max(l, 1e-20)``. The first block starts from ``o = 0``,
``m = -1e30``, ``l = 0``, where the correction multiplies zeros, so it
is taken without one: a ring of one block (no axis, or an axis of size
1) is plain masked softmax attention.
"""

from __future__ import annotations

import torch

from pio_tpu_torch.parallel.collectives import (
    Axis,
    axis_index,
    axis_size,
    ppermute,
)

_NEG_BIG = -1e30


def causal_mask(t: int, device) -> torch.Tensor:
    """``[t, t]`` bool: query position ``q`` sees key positions ``<= q``."""
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _block_update(state, q32, k_blk, v_blk, mask, scale):
    """One online-softmax accumulation of a (q block, kv block) pair
    (reference ``_block_attn_update``); ``state`` None is the first
    block. Shapes: q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]``; ``o``
    ``[B, H, Tq, D]``, ``m`` and ``l`` ``[B, H, Tq]``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_BIG)
    if state is None:
        m_new = torch.clamp_min(scores.amax(dim=-1), _NEG_BIG)
    else:
        o, m, l = state
        m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    if state is None:
        return pv, m_new, p.sum(dim=-1)
    correction = torch.exp(m - m_new)
    return (o * correction[..., None] + pv, m_new,
            l * correction + p.sum(dim=-1))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: Axis = None, causal: bool = True) -> torch.Tensor:
    """Exact attention of this rank's ``[B, T_local, H, D]`` blocks →
    its ``[B, T_local, H, D]`` output block (the whole sequence without
    an axis)."""
    t_loc, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    n, idx = axis_size(axis), axis_index(axis)
    q32 = q.float()
    pos = torch.arange(t_loc, device=q.device)
    q_pos = idx * t_loc + pos
    perm = [(i, (i + 1) % n) for i in range(n)]
    state = None
    for s in range(n):
        mask = None
        if causal:
            k_pos = ((idx - s) % n) * t_loc + pos  # the block's first rank
            mask = q_pos[:, None] >= k_pos[None, :]
        state = _block_update(state, q32, k, v, mask, scale)
        if s < n - 1:
            k, v = ppermute(k, axis, perm), ppermute(v, axis, perm)
    o, _, l = state
    out = o / torch.clamp_min(l, 1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)
