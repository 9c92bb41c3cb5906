"""Hardened ``PIO_TPU_*`` environment parsing.

The port's copy of ``pio_tpu/utils/envutil.py``. A typo'd value degrades
to the documented default with a ``RuntimeWarning``, it never kills a
server at import time. NaN is always rejected; ``positive=True`` also
rejects values ``<= 0`` (body caps, timeouts, rates, where zero or a
negative would refuse or break everything). :mod:`pio_tpu_torch.utils.
knobs` reads every numeric knob through these two functions.

One difference from the reference: a value that is empty or only blanks
reads as unset (the port's knob table treats an empty variable as
unset), where the reference warns that it is not a number. Both return
the default.
"""

from __future__ import annotations

import os
import warnings


def _warn(name: str, raw: str, default, why: str) -> None:
    warnings.warn(f"{name}={raw!r} {why}; using default {default:g}",
                  RuntimeWarning, stacklevel=3)


def env_float(name: str, default: float, *, positive: bool = False) -> float:
    """Float env knob with warn-and-default semantics."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        v = float(raw)
    except (TypeError, ValueError):
        _warn(name, raw, default, "is not a number")
        return default
    if v != v:  # NaN compares unequal to itself
        _warn(name, raw, default, "is NaN")
        return default
    if positive and v <= 0:
        _warn(name, raw, default, "must be a positive number")
        return default
    return v


def env_int(name: str, default: int, *, positive: bool = False) -> int:
    """Integer env knob with warn-and-default semantics."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        v = int(raw)
    except (TypeError, ValueError):
        _warn(name, raw, default, "is not an integer")
        return default
    if positive and v <= 0:
        _warn(name, raw, default, "must be a positive integer")
        return default
    return v
