"""Causal attention as the reference's ring attention computes it on one
device.

Counterpart of ``pio_tpu/parallel/ring.py`` (``ring_attention``
l.67-118) for ``axis=None``: a ring of size 1 is one block, so the online
softmax takes one step and is plain masked softmax attention. The
arithmetic stays the reference's: f32 scores scaled by ``1/sqrt(d)``, the
finite ``-1e30`` mask, the running max ``m`` and normalizer ``l``, and
``o / max(l, 1e-20)``. Layout ``[B, T, H, D]`` in and out. The ring over
a sequence axis (``ppermute`` of the K/V blocks) comes with the
multi-device slice (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_BIG = -1e30


def causal_mask(t: int, device) -> torch.Tensor:
    """``[t, t]`` bool: query position ``q`` sees key positions ``<= q``."""
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: Optional[str] = None,
                   causal: bool = True) -> torch.Tensor:
    """Exact attention of ``[B, T, H, D]`` blocks → ``[B, T, H, D]``.

    The reference's ``_block_attn_update`` from its initial ``o = 0``,
    ``m = -1e30``, ``l = 0``: the correction ``exp(m - m_new)`` multiplies
    zeros, so ``l`` is the masked row sum of ``p`` and ``o`` its product
    with ``v``.
    """
    if axis is not None:
        raise NotImplementedError(
            f"ring attention over axis {axis!r}: the port runs one device; "
            f"the ring is ROADMAP A7"
        )
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    q32, k32, v32 = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if causal:
        mask = causal_mask(t, q.device)
        scores = torch.where(mask, scores, _NEG_BIG)
    m = torch.clamp_min(scores.amax(dim=-1), _NEG_BIG)
    p = torch.exp(scores - m[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v32)
    out = o / torch.clamp_min(l, 1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)
