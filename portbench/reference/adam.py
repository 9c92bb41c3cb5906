"""Adam as ``optax.adam(lr)`` defines it (β1 0.9, β2 0.999, ε 1e-8 added
to the square root of the bias-corrected second moment), one leaf at a
time."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def init(params: Dict[str, torch.Tensor]) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


@torch.no_grad()
def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: dict, lr: float) -> Tuple[Dict[str, torch.Tensor], dict]:
    t = state["count"] + 1
    mu, nu, new = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = B1 * state["mu"][k] + (1 - B1) * g
        nu[k] = B2 * state["nu"][k] + (1 - B2) * g * g
        m_hat = mu[k] / (1 - B1 ** t)
        v_hat = nu[k] / (1 - B2 ** t)
        new[k] = p - lr * m_hat / (torch.sqrt(v_hat) + EPS)
    return new, {"count": t, "mu": mu, "nu": nu}
