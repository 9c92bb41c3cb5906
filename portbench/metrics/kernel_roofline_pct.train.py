"""The training steps' least time (the larger of FLOPs over the float32
peak and bytes over the memory bandwidth, each input read and each
output written once) over the device's busy time in the traced window,
in %."""

from portbench.readers import roofline_pct


def read(run):
    return roofline_pct(run) if run.steps else None
