"""Milliseconds a training step: the window (its start to the end of the
last whole training run begun inside it) over every optimizer step of
those runs, each run's init, staging and parameter gather included."""


def read(run):
    return 1e3 * run.window_s / run.steps if run.steps else None
