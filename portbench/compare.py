"""The numbers that decide ``correct``, each held to its limit.

Training (the first three steps of the window's first run, against the
reference's): the widest relative gap of a step's loss; for each leaf,
the gap between the program's norm of the first gradient and the
reference's, and between their norms of the parameters' change after the
steps, each over the reference's norm of that leaf or of the median
leaf, whichever is larger, taken at the worst leaf; the first
gradient's gap at the worst leaf of the model's head, the leaves whose
gradient no ReLU's mask gates (a pre-activation that rounds to the other
side of 0 moves every gradient behind it, in any float32 program, by up
to 4e-4 of a leaf's norm); and the largest difference of an initial parameter (exact).
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam and are left out of the
change."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Sequence

from portbench.reference.train import Observation

#: a leaf moves by round-off alone where its reference gradient is under
#: this share of the median leaf's
STILL = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf of
    ``keys``, whichever is larger."""
    keys = list(keys)
    if not keys:
        return {"": math.inf}
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        if k not in prog:
            return {k: math.inf}
        den = max(ref[k], med)
        out[k] = (abs(prog[k] - ref[k]) / den if den > 0 else
                  (0.0 if prog[k] == 0 else math.inf))
    return out


def training(obs: Observation, ref: Observation,
             head: Sequence[str] = ()) -> Dict[str, float]:
    """``head``: the leaves whose first gradient no ReLU's mask gates
    (``head_grad_gap``; none: the number is left out)."""
    steps = len(ref.losses)
    if len(obs.losses) < steps:
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) if b else abs(a)
                       for a, b in zip(obs.losses, ref.losses))
    med = statistics.median(ref.grad_norms.values())
    moving = [k for k, v in ref.grad_norms.items() if v >= STILL * med]
    init_gap = 0.0
    for k, t in ref.start.items():
        o = obs.start.get(k)
        if o is None or o.shape != t.shape:
            init_gap = math.inf
            break
        init_gap = max(init_gap, float((o.double() - t.double()).abs().max()))
    grads = _leaf_gaps(obs.grad_norms, ref.grad_norms, ref.grad_norms)
    out = {
        "loss_gap": loss_gap,
        "grad_gap": max(grads.values()),
        "change_gap": max(_leaf_gaps(obs.change_norms, ref.change_norms,
                                     moving).values()),
        "init_gap": init_gap,
    }
    if head:
        out["head_grad_gap"] = max(grads.get(k, math.inf) for k in head)
    return out
