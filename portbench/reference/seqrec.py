"""The SASRec-style next-item transformer (Kang & McAuley, ICDM 2018,
arXiv:1808.09781) as the port documents it, in plain PyTorch.

Pre-LN blocks (layer norm with ε 1e-6 on the biased variance), causal
softmax attention over ``n_heads`` heads scaled by ``1/√head``, a ReLU
FFN, a final layer norm, the item table tied as the output layer, and
the mean cross-entropy of each real position's next item. Departures
from the paper, as in the port: learned positions added to the item
embedding without the ``√d`` scale, no dropout, the full softmax over
the vocabulary in place of one sampled negative.

Parameters are a flat dict under the port's paths (``emb``, ``pos``,
``blocks/wq`` with a leading layer dimension, ``lnf_g``, ...).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: the leaves after the last ReLU, the final layer norm's: no ReLU's mask
#: gates their gradient, so a pre-activation that rounds to the other
#: side of 0 does not move it
HEAD = ("lnf_g", "lnf_b")

#: the leaves in the port's order, with the draw's scale
#: (``"d"``: 1/√d_model, ``"ffn"``: 1/√ffn) or the constant of a gain or
#: bias
_LEAVES = (
    ("emb", "d"), ("pos", "d"),
    ("blocks/ln1_g", 1.0), ("blocks/ln1_b", 0.0),
    ("blocks/wq", "d"), ("blocks/wk", "d"), ("blocks/wv", "d"),
    ("blocks/wo", "d"),
    ("blocks/ln2_g", 1.0), ("blocks/ln2_b", 0.0),
    ("blocks/w1", "d"), ("blocks/b1", 0.0), ("blocks/w2", "ffn"),
    ("blocks/b2", 0.0),
    ("lnf_g", 1.0), ("lnf_b", 0.0),
)


def shapes(vocab: int, d: int, n_layers: int, ffn: int,
           max_len: int) -> Dict[str, Tuple[int, ...]]:
    L = n_layers
    return {
        "emb": (vocab, d), "pos": (max_len, d),
        "blocks/ln1_g": (L, d), "blocks/ln1_b": (L, d),
        "blocks/wq": (L, d, d), "blocks/wk": (L, d, d),
        "blocks/wv": (L, d, d), "blocks/wo": (L, d, d),
        "blocks/ln2_g": (L, d), "blocks/ln2_b": (L, d),
        "blocks/w1": (L, d, ffn), "blocks/b1": (L, ffn),
        "blocks/w2": (L, ffn, d), "blocks/b2": (L, d),
        "lnf_g": (d,), "lnf_b": (d,),
    }


def init_params(vocab: int, d: int, n_layers: int, ffn: int, max_len: int,
                seed: int) -> Dict[str, torch.Tensor]:
    """The port's initial parameters, worked out again: a CPU generator
    seeded with the run's seed draws N(0, 1) for each matrix in the
    order of ``_LEAVES``, times its scale; gains 1, biases 0."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    scale = {"d": d ** -0.5, "ffn": ffn ** -0.5}
    out = {}
    for name, shape in shapes(vocab, d, n_layers, ffn, max_len).items():
        kind = dict(_LEAVES)[name]
        if isinstance(kind, str):
            out[name] = torch.randn(shape, generator=g) * scale[kind]
        else:
            out[name] = torch.full(shape, kind)
    return out


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps=1e-6)


def trunk(p: Dict[str, torch.Tensor], seqs: torch.Tensor,
          n_heads: int) -> torch.Tensor:
    """``[B, T]`` item ids (0 = pad, right-padded) → ``[B, T, d]``."""
    B, T = seqs.shape
    h = p["emb"][seqs.long()] + p["pos"][:T]
    D = h.shape[-1]
    hd = D // n_heads
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    for layer in range(p["blocks/wq"].shape[0]):
        def w(name):
            return p[f"blocks/{name}"][layer]

        x = _ln(h, w("ln1_g"), w("ln1_b"))
        q, k, v = (
            (x @ w(m)).view(B, T, n_heads, hd).transpose(1, 2)
            for m in ("wq", "wk", "wv"))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
        h = h + a.transpose(1, 2).reshape(B, T, D) @ w("wo")
        x = _ln(h, w("ln2_g"), w("ln2_b"))
        h = h + torch.relu(x @ w("w1") + w("b1")) @ w("w2") + w("b2")
    return _ln(h, p["lnf_g"], p["lnf_b"])


def loss_sum(p: Dict[str, torch.Tensor], batch,
             n_heads: int) -> torch.Tensor:
    """The cross-entropy of the next item summed over the masked
    positions of ``batch = (seqs, targets, mask)``; the loss is that sum
    over the whole batch divided by :func:`count`."""
    seqs, targets, mask = batch
    logits = trunk(p, seqs, n_heads) @ p["emb"].T
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1).long(), reduction="none")
    return (ce * mask.reshape(-1)).sum()


def count(batch) -> torch.Tensor:
    """The masked positions of ``batch``: a real item with a real next."""
    return batch[2].sum()


def feed(sequences: np.ndarray, batch_size: int,
         max_len: int) -> Tuple[int, Callable[[int], tuple]]:
    """The port's documented minibatch feed: rows in contiguous blocks of
    ``batch_size`` with wraparound, the next item as each position's
    target, the positions with a real item and a real target in the mask.
    Returns the number of batches and ``batch(step)`` as numpy arrays."""
    seqs = np.asarray(sequences, np.int32)
    n, t = seqs.shape
    if t > max_len:
        raise ValueError("histories wider than max_len")
    b = min(batch_size, max(n, 1))
    reps = -(-max(n, b) // b) * b
    seqs = np.resize(seqs, (reps, t))
    targets = np.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    mask = ((targets > 0) & (seqs > 0)).astype(np.float32)
    n_batches = reps // b

    def batch(step: int):
        r = slice((step % n_batches) * b, (step % n_batches + 1) * b)
        return seqs[r], targets[r], mask[r]

    return n_batches, batch
