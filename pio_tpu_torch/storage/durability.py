"""The fsync policy knob: what an acknowledged write means on durable media.

The port's copy of ``mode()`` from ``pio_tpu/storage/durability.py`` (the
port imports nothing of ``pio_tpu``). One environment variable,
``PIO_TPU_DURABILITY``, read by the SQLite backend when it opens a
connection:

- ``commit`` — SQLite runs ``synchronous=FULL``: every transaction is
  fsynced before its commit returns. An ack survives power loss.
- ``batch`` (default) — ``synchronous=NORMAL`` in WAL mode: the WAL is
  fsynced at checkpoints. An ack survives process death always, power
  loss up to the last checkpoint.
- ``os`` — ``synchronous=OFF``: the kernel's writeback decides. An ack
  survives process death (the write reached the page cache) but not power
  loss.

The event-log backend's interval syncer and the durable-rename helpers
come with the backends that use them (the port's ``localfs`` model store
always syncs its file and directory).
"""

from __future__ import annotations

from pio_tpu_torch.utils import knobs

ENV_VAR = "PIO_TPU_DURABILITY"
MODES = ("commit", "batch", "os")
DEFAULT = "batch"


def mode() -> str:
    """Effective durability mode; raises ValueError on an unknown value
    (misconfigured durability must be loud — a typo'd mode silently
    running ``os`` would void the ack guarantee the operator asked for)."""
    v = knobs.knob_str(ENV_VAR).lower() or DEFAULT
    if v not in MODES:
        raise ValueError(
            f"{ENV_VAR}={v!r} is not one of {'|'.join(MODES)}"
        )
    return v
