"""Adam as ``optax.adam`` computes it, over trees of tensors.

The neural trainers of the reference (``two_tower.py``, ``seqrec.py``)
step with ``optax.adam(lr)``: β1 0.9, β2 0.999, ε 1e-8 added to the
square root of the bias-corrected second moment, ε_root 0. This module
keeps optax's order of operations (``scale_by_adam`` then
``scale_by_learning_rate``) so that the port's parameters follow the
reference's within f32 rounding, and keeps the optimizer state as a
plain tree, ``{"count": int, "mu": tree, "nu": tree}``, that a
checkpoint snapshots and restores bit for bit. The updates run as
multi-tensor (``torch._foreach_*``) operations: a few launches a step
for all the leaves, where one operation a leaf would be a few hundred.

A tree is a dict of tensors or of such dicts; :func:`leaves` flattens
it in insertion order and :func:`rebuild` puts leaves back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8

Tree = Dict[str, Any]


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, depth first in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def rebuild(tree: Tree, values: Sequence[torch.Tensor]) -> Tree:
    """``tree``'s structure with ``values`` as its leaves, in the order
    of :func:`leaves`."""
    it = iter(values)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def adam_init(params: Tree) -> Tree:
    """optax's ``ScaleByAdamState``: count 0, zero moments."""
    def zeros():
        return rebuild(params, [torch.zeros_like(t) for t in leaves(params)])

    return {"count": 0, "mu": zeros(), "nu": zeros()}


def _bias_correction(decay: float, count: int) -> float:
    # optax: 1 - decay**count in f32 (a weak-typed float to an int32 power)
    return float(np.float32(1.0) - np.power(np.float32(decay),
                                            np.float32(count),
                                            dtype=np.float32))


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: Tree,
                lr: float) -> Tuple[List[torch.Tensor], Tree]:
    """One ``optax.adam(lr)`` step over the leaves ``params`` (in
    :func:`leaves` order of the tree ``state`` was made for): the new
    leaves and the new state. Nothing is updated in place."""
    mu, nu = leaves(state["mu"]), leaves(state["nu"])
    count = state["count"] + 1
    with torch.no_grad():
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g² + b2 nu
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1),
                                torch._foreach_mul(mu, B1))
        g2 = torch._foreach_mul(grads, grads)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - B2),
                                torch._foreach_mul(nu, B2))
        mu_hat = torch._foreach_div(mu, _bias_correction(B1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(B2, count))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
        upd = torch._foreach_mul(torch._foreach_div(mu_hat, den), -lr)
        new = torch._foreach_add(list(params), upd)
    return new, {"count": count, "mu": rebuild(state["mu"], mu),
                 "nu": rebuild(state["nu"], nu)}
