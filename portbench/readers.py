"""What a metric's reader is given, and the arithmetic the readers share.

A reader is ``metrics/<name>.py`` with ``read(run) -> float | None``: None
where it finds nothing to read in this run, and the harness then leaves
the metric out of the result line. A share of a peak or of a roofline is
never made up as 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class Run:
    """One run of a cell, as the harness measured it."""

    cell: str
    #: process start to the first timed unit of work (host clock)
    setup_s: float
    #: the window's start to the end of the last unit begun inside it
    window_s: float
    units: int
    #: optimizer steps completed in the window
    steps: int
    #: every other count the window's units returned, summed by name (a
    #: driver's own counts, such as queries, reach its readers here)
    totals: Dict[str, float]
    #: analytic operations of the window's work
    flops: float
    #: the least time the device could take for the window's steps (None
    #: where the work counts no bytes or the device has no peaks)
    least_s: Optional[float]
    #: the device's peaks (``peaks.py``), None off the table
    peak: Optional[dict]
    #: the traced window's reduction (``trace.reduce``), None untraced
    trace: Optional[dict]


def mfu_pct(run: Run) -> Optional[float]:
    """The window's analytic FLOPs over what the float32 peak does in
    the window's wall time."""
    if not run.flops or run.peak is None or run.window_s <= 0:
        return None
    return 100.0 * run.flops / (run.window_s * run.peak["f32_flops"])


def idle_pct(run: Run) -> Optional[float]:
    """The traced window's share in which nothing ran on the device."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def roofline_pct(run: Run) -> Optional[float]:
    """The steps' least time over the device's busy time in the window."""
    if run.trace is None or not run.least_s or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.least_s / run.trace["busy_s"]


def per_step(run: Run, key: str) -> Optional[float]:
    if run.trace is None or not run.steps:
        return None
    return run.trace[key] / run.steps
