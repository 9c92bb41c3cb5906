"""Pipeline parallelism over the ``pipe`` axis (GPipe-style).

The port of ``pio_tpu/parallel/pipeline.py``: every rank runs the same
program over its stage's slice of a layer-stacked parameter tree;
microbatches enter at stage 0, activations move stage to stage with
:func:`~pio_tpu_torch.parallel.collectives.ppermute`, and the last
stage's outputs are summed over the axis so every rank holds them. The
schedule is ``n_micro + n_stages - 1`` ticks; the bubble is
``(n_stages - 1) / (n_micro + n_stages - 1)``.

Autograd runs through the same collectives. The ticks outside a stage's
window compute on garbage (zeros at first, repeated microbatches at the
end), which reaches neither the output nor the gradient: the last stage
writes only the slots ``t - (n - 1) >= 0``, whose inputs are real. Every
rank keeps every tick's tensors in its graph (``torch.where`` on the
stage index), so every rank runs the same collectives in the backward.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from pio_tpu_torch.parallel.collectives import (
    Axis,
    axis_index,
    axis_size,
    copy_to,
    ppermute,
    psum,
)


def pipeline_apply(params: Any, x: torch.Tensor, stage_fn: Callable, *,
                   axis: Axis) -> torch.Tensor:
    """Run ``x`` through the ``n`` stages of ``stage_fn`` (reference
    l.24-77).

    Args:
        params: this rank's stage parameters (its slice of the stack).
        x: ``[n_micro, micro_b, ...]`` microbatches, replicated over the
            axis (stage 0 reads it; its cotangent is summed over the axis,
            so every rank holds the whole).
        stage_fn: ``(params, [micro_b, ...]) -> [micro_b, ...]``; the
            activation's shape is the same at every stage.

    Returns ``[n_micro, micro_b, ...]``, the last stage's outputs, the same
    on every rank of the axis.
    """
    n, idx = axis_size(axis), axis_index(axis)
    n_micro = x.shape[0]
    x = copy_to(x, axis)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n - 1, device=x.device)
    perm_fwd = [(i, i + 1) for i in range(n - 1)]
    ticks = n_micro + n - 1
    state = torch.zeros_like(x[0])
    slots = []
    for t in range(ticks):
        # stage 0 takes microbatch t (clamped: the tail ticks repeat the
        # last one, garbage that no written slot reads)
        inp = torch.where(first, x[min(t, n_micro - 1)], state)
        out = stage_fn(params, inp)
        if t >= n - 1:
            # the last stage's tick-t output is microbatch t - (n - 1)
            slots.append(torch.where(last, out, 0.0))
        if t < ticks - 1:
            state = ppermute(out, axis, perm_fwd) if n > 1 else out
    # the outputs are nonzero on the last stage only; make them uniform
    return psum(torch.stack(slots), axis)


def stage_slice(params_stacked: Any) -> Any:
    """Drop the leading stage dim of a stacked tree whose per-rank block
    has one stage (reference l.80-86)."""
    if isinstance(params_stacked, dict):
        return {k: stage_slice(v) for k, v in params_stacked.items()}
    return params_stacked[0]
