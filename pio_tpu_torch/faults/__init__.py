"""Fault injection: named failpoints that prove the recovery paths.

The port's copy of ``pio_tpu/faults`` (the port imports nothing of
``pio_tpu``): the same registry, failpoint names and spec grammar.

The port's recovery paths (group commit's solo retry, the SQLite
rollback, the durable rename, the supervised worker pool, the streamed
feed) are proven by injecting faults at named points, in the failpoint
tradition of WAL-centric storage engines.

A *failpoint* is a named hook compiled into a risky code path::

    from pio_tpu_torch import faults
    faults.failpoint("storage.localfs.persist")

With no spec installed it is inert — one dict-membership check — so the
hooks stay in production code. A spec (``pio deploy --faults`` /
``PIO_TPU_FAULTS``) arms them, e.g.::

    groupcommit.flush.*=error:0.1,storage.sqlite.commit=latency:200ms,worker.serve=crash:once

Grammar mirrors the QoS spec (``point=action[:arg[:modifier]]``, comma
separated; see :func:`parse_faults`). Actions:

- ``error`` — raise :class:`FaultInjected` (classified transient by the
  storage ``retrying()`` wrapper, so low-rate error specs exercise the
  retry layer without surfacing 5xx);
- ``latency:<duration>`` — sleep (SLO suffixes: ``us ms s m h d``);
- ``torn-write`` — at write sites that pass their payload to the
  failpoint, persist only a random prefix of it and fail the call:
  a crash mid-``write()``, the exact wound torn-tail repair heals;
- ``crash`` — ``os._exit(137)``: the process dies as if SIGKILLed,
  buffers unflushed, ``finally`` blocks skipped.

Modifiers: a probability in ``(0, 1]`` (``error:0.1``) or ``once``
(trigger a single time, then disarm). Trigger counts are exported as
``pio_tpu_fault_triggered_total{point,action}`` and the serving daemons
surface :func:`snapshot` on ``GET /faults.json``.
"""

from pio_tpu_torch.faults.registry import (
    CRASH_EXIT_CODE,
    ENV_VAR,
    FaultError,
    FaultInjected,
    FaultRule,
    exposition_lines,
    failpoint,
    install,
    parse_faults,
    snapshot,
    trigger_counts,
    uninstall,
)

__all__ = [
    "CRASH_EXIT_CODE",
    "ENV_VAR",
    "FaultError",
    "FaultInjected",
    "FaultRule",
    "exposition_lines",
    "failpoint",
    "install",
    "parse_faults",
    "snapshot",
    "trigger_counts",
    "uninstall",
]
