"""Kernel launches in the traced window (copies, fills and the window's
sentinels left out) over the optimizer steps completed in it."""

from portbench.readers import per_step


def read(run):
    return per_step(run, "kernels")
