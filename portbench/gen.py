"""The traffic generator: every input of a cell, drawn from ``--seed`` and
the parameters of its mix.

One seed gives one set of inputs. Every seed gives the same set of
history lengths, in another order, so seeds vary the work no more than
the order of the rows and the items drawn do.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose (``stream``) of a run's seed; any whole
    number is a seed, negative and past 64 bits included."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def run_seed(seed: int, k: int) -> int:
    """The seed of the program's ``k``-th run (a training run's init and
    batch order): 63 bits from the run's seed and ``k``."""
    return int(rng(seed, 7, k).integers(0, 1 << 63))


def lengths(g: np.random.Generator, n: int, len_min: int, len_mean: float,
            len_sigma: float, width: int) -> np.ndarray:
    """``n`` history lengths: ``len_min`` plus a log-normal of shape
    ``len_sigma`` whose mean makes the lengths' mean ``len_mean``, rounded,
    the newest ``width`` of each kept. The values are the law's quantiles
    at ``(i + ½)/n``, the same for every seed; ``g`` orders them."""
    if not 1 <= len_min <= width or len_mean <= len_min:
        raise ValueError("need 1 <= len_min <= width and len_mean > len_min")
    mu = math.log(len_mean - len_min) - len_sigma ** 2 / 2
    z = torch.special.ndtri(
        (torch.arange(n, dtype=torch.float64) + 0.5) / n).numpy()
    out = len_min + np.rint(np.exp(mu + len_sigma * z))
    return g.permutation(np.minimum(out, width).astype(np.int64))


def zipf_cdf(n_items: int, s: float) -> np.ndarray:
    """The cumulative share of the items by popularity rank under a Zipf
    law of exponent ``s``: rank ``r`` (from 1) has weight ``r**-s``."""
    w = np.arange(1, n_items + 1, dtype=np.float64) ** -s
    c = np.cumsum(w)
    return c / c[-1]


def histories(seed: int, lens: np.ndarray, n_items: int, zipf_s: float,
              width: int, device="cpu") -> np.ndarray:
    """Right-padded histories (0 is the pad) of the given lengths: item
    ids ``1..n_items`` drawn independently under ``zipf_cdf``, each
    popularity rank mapped to an id by a permutation drawn from the seed.
    Drawn on ``device`` in a few large calls; returns ``[n, width]``
    int32 on the host."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng(seed, 3).integers(0, 1 << 63)))
    cdf = torch.from_numpy(zipf_cdf(n_items, zipf_s)).to(dev)
    n = len(lens)
    rank = torch.searchsorted(
        cdf, torch.rand((n, width), generator=g, device=dev,
                        dtype=torch.float64)).clamp_max_(n_items - 1)
    ids = torch.randperm(n_items, generator=g, device=dev).add_(1)[rank]
    real = (torch.arange(width, device=dev)[None, :]
            < torch.from_numpy(np.asarray(lens)).to(dev)[:, None])
    return (ids * real).to(torch.int32).cpu().numpy()
