"""First-order Markov chain — the reference's e2 helper.

Counterpart of ``pio_tpu/models/markov_chain.py``: a transition model from
``(from, to, count)`` triples that keeps, per state, the top-K normalized
transition probabilities. The dense ``[S, S]`` count matrix is built on
the host (``np.add.at``, as the reference); the row normalization and the
top-k run as torch ops on a device. ``jax.lax.top_k`` breaks a tie toward
the lower index and ``torch.topk`` promises no order, so the top-k here
ranks a composite key (probability, then lower index), as the top-N scorer
does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.ops.topn import _topk_pinned


@dataclasses.dataclass
class MarkovChainModel:
    """Per-state top-K transition table.

    Attributes:
        top_indices: [S, K] int32 — destination state codes, by descending
            probability (-1 where a state has fewer than K successors).
        top_probs: [S, K] float32 — matching transition probabilities.
        n_states: S.
    """

    top_indices: np.ndarray
    top_probs: np.ndarray
    n_states: int

    def transitions_of(self, state: int) -> List[Tuple[int, float]]:
        """(to_state, prob) list for one state, descending probability."""
        out = []
        for idx, prob in zip(self.top_indices[state], self.top_probs[state]):
            if idx < 0 or prob <= 0.0:
                break
            out.append((int(idx), float(prob)))
        return out


def normalize_topk(counts: torch.Tensor, k: int):
    """Row-normalize ``[S, S]`` counts and keep each row's top ``k``:
    (indices int32, probabilities float32), a zero-probability entry's
    index -1. Ties go to the lower index."""
    row_sum = counts.sum(dim=1, keepdim=True)
    probs = torch.where(row_sum > 0,
                        counts / torch.where(row_sum > 0, row_sum, 1.0), 0.0)
    top_p, top_i = _topk_pinned(probs, k)
    top_i = torch.where(top_p > 0, top_i, -1)
    return top_i.to(torch.int32), top_p


def train_markov_chain(
    transitions: Sequence[Tuple[int, int, float]],
    n_states: int,
    top_k: int = 10,
    device: DeviceLike = None,
) -> MarkovChainModel:
    """Build the model from (from_state, to_state, count) triples, its
    normalize and top-k on ``device`` (CUDA unless told otherwise).

    ≙ reference ``MarkovChain.train(matrix, topCount)``.
    """
    if n_states <= 0:
        raise ValueError("n_states must be positive")
    dev = resolve_device(device)
    k = min(top_k, n_states)

    counts = np.zeros((n_states, n_states), np.float32)
    if transitions:
        tr = np.asarray(transitions, np.float64)
        frm = tr[:, 0].astype(np.int32)
        to = tr[:, 1].astype(np.int32)
        if (frm < 0).any() or (frm >= n_states).any() or (
            (to < 0).any() or (to >= n_states).any()
        ):
            raise ValueError("transition state out of range")
        np.add.at(counts, (frm, to), tr[:, 2].astype(np.float32))

    top_i, top_p = normalize_topk(torch.from_numpy(counts).to(dev), k)
    return MarkovChainModel(top_i.cpu().numpy(), top_p.cpu().numpy(),
                            n_states)
