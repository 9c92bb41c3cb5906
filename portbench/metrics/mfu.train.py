"""The training steps' analytic FLOPs (real positions only) over what the
float32 peak does in the traced window's wall time, in %."""

from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run) if run.steps else None
