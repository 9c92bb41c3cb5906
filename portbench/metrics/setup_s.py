"""Set-up seconds: process start to the first timed unit of work."""


def read(run):
    return run.setup_s
