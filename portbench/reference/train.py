"""A training run's first steps, followed by the reference: each step's
loss, the first gradient and the change of the parameters after the
steps, by leaf."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from portbench.reference import adam, precision


@dataclasses.dataclass
class Observation:
    """What the comparison reads of a run's first steps, by leaf path."""

    losses: List[float]
    #: norm of the first step's gradient, as the optimizer got it
    grad_norms: Dict[str, float]
    #: norm of (parameters after the steps − initial parameters)
    change_norms: Dict[str, float]
    #: the initial parameters, on the host
    start: Dict[str, torch.Tensor]


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def follow(params0: Dict[str, torch.Tensor],
           loss_sum: Callable[[Dict[str, torch.Tensor], tuple], torch.Tensor],
           count: Callable[[tuple], torch.Tensor],
           batch_of: Callable[[int], tuple], steps: int, lr: float, device,
           tf32: bool = False, half_batch: bool = False,
           block_rows: int = 0) -> Observation:
    """``steps`` Adam steps from ``params0`` on ``batch_of(0)``,
    ``batch_of(1)``, ... on ``device``. ``loss_sum(params, rows)`` gives
    the summed loss of some rows of a batch, ``count(rows)`` what it is
    divided by; a step's loss is their quotient over the batch, taken and
    differentiated in blocks of ``block_rows`` rows (0: the whole batch
    at once), so that its logits stay a few GB. ``tf32`` runs
    the products through TF32 (the control); ``half_batch`` leaves out
    the second half of each batch's rows (a fault)."""
    p = {k: v.to(device) for k, v in params0.items()}
    state = adam.init(p)
    losses: List[float] = []
    grads1: Dict[str, float] = {}
    with precision(tf32):
        for s in range(steps):
            batch = batch_of(s)
            if half_batch:
                batch = tuple(b[: len(b) // 2] for b in batch)
            rows = len(batch[0])
            step = block_rows or rows
            blocks = [tuple(b[i:i + step] for b in batch)
                      for i in range(0, rows, step)]
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            denom = torch.clamp_min(count(batch), 1.0)
            total = 0.0
            grads = {k: torch.zeros_like(v) for k, v in p.items()}
            for blk in blocks:
                part = loss_sum(leaves, blk) / denom
                for k, g in zip(leaves, torch.autograd.grad(
                        part, list(leaves.values()))):
                    grads[k] += g
                total += float(part.detach())
            losses.append(total)
            if s == 0:
                grads1 = {k: norm(g) for k, g in grads.items()}
            p, state = adam.step(p, grads, state, lr)
    return Observation(
        losses=losses, grad_norms=grads1,
        change_norms={k: norm(p[k] - params0[k].to(device)) for k in p},
        start={k: v.cpu() for k, v in params0.items()},
    )
