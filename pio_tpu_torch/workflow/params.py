"""WorkflowParams — the controls of a training run.

Counterpart of ``pio_tpu/workflow/params.py``, with the fields the port's
``run_train`` honours. Checkpointing and the profiler trace come with the
ops-plane slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkflowParams:
    """Debug/controls for a train run (reference fields: batch,
    skipSanityCheck, stopAfterRead, stopAfterPrepare, seed)."""

    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    seed: int = 0
