"""WorkflowParams — the controls of a training run.

Counterpart of ``pio_tpu/workflow/params.py``, with the fields the port's
``run_train`` honours (all of the reference's but ``verbose``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkflowParams:
    """Debug/controls for a train run (reference fields: batch,
    skipSanityCheck, stopAfterRead, stopAfterPrepare, seed, profileDir)."""

    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    seed: int = 0
    #: non-empty → a torch.profiler trace of the whole train, written
    #: there as Chrome-trace JSON (``trace.json``)
    profile_dir: str = ""
    #: >0 → snapshot train state every N steps. Algorithms that support
    #: it read the manager off the ComputeContext.
    checkpoint_every: int = 0
    #: explicit snapshot dir; the default keys on the engine variant and
    #: its params (set this to resume a preempted run under a NEW
    #: instance id)
    checkpoint_dir: str = ""
