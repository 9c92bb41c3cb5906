"""The traced window's share in which no operation ran on the device, in
the training cells, in %."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run) if run.steps else None
