"""The ``PIO_TPU_*`` environment knobs the port reads, with their defaults.

The port's own reader (the reference's registry is
``pio_tpu/utils/knobs.py``, which the port does not import). A knob not
declared here is a programming error, so a misspelt name raises instead
of reading as unset.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("pio_tpu_torch.utils.knobs")

#: name → the value an unset (or empty) variable means
_DEFAULTS = {
    # scoring placement of the top-N scorer: `device`, `host` or `auto`
    # (by batch size); unset, a scorer on CUDA scores on the card and one
    # on the CPU routes by batch size
    "PIO_TPU_SERVE_DEVICE": "",
    # any value: the ALS host side and the host top-N scorer take their
    # numpy routes instead of the native libraries (pio_tpu_torch/native),
    # which are otherwise built and used; a failed build raises
    "PIO_TPU_NO_NATIVE": "",
    # resident serving parameters (server/residency.py): `1` on, `0` off,
    # `auto` on when the serving device is CUDA
    "PIO_TPU_DEVICE_RESIDENT": "auto",
    # the resident scorer's query wire: `int8`, `float32`, or `auto` (int8
    # when the model carries training scales)
    "PIO_TPU_SERVE_WIRE": "auto",
    # what an acknowledged write means on durable media
    # (storage/durability.py): `commit`, `batch` or `os`
    "PIO_TPU_DURABILITY": "batch",
    # the app of a bundled `pio eval` sweep called with no app name
    # (templates/common.py:eval_app_name)
    "PIO_TPU_EVAL_APP": "",
    # per-device parameter budget in bytes (parallel/partition.py); 0 means
    # no limit
    "PIO_TPU_DEVICE_BUDGET_BYTES": "0",
}


def knob_str(name: str) -> str:
    """The knob's value, stripped, or its declared default when unset."""
    default = _DEFAULTS[name]
    return os.environ.get(name, "").strip() or default


def knob_int(name: str) -> int:
    """The knob as an integer. A value that is not one logs a warning and
    reads as the declared default, as the reference's ``env_int`` does."""
    raw = knob_str(name)
    try:
        return int(raw)
    except ValueError:
        log.warning("%s=%r is not an integer; using %s", name, raw,
                    _DEFAULTS[name])
        return int(_DEFAULTS[name])
