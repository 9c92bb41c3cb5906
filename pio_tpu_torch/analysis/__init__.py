"""Project-native static analysis (``pio lint``) + runtime sync debugging.

The port's copy of ``pio_tpu/analysis`` (the port imports nothing of
``pio_tpu``): it names modules under ``pio_tpu_torch``, holds the port to
its own knob registry and knob table (``pio_tpu_torch/KNOBS.md``), and
lints the port and the port's tests by default.

The serving stack rests on ~20 lock/condition-variable-bearing modules
and on conventions — metric naming, failpoint namespaces, hardened env
parsing, monotonic-clock timing, admit/breaker release-in-finally —
that no general-purpose linter knows about. This package encodes them:

* :mod:`pio_tpu_torch.analysis.core` — AST visitor framework: rule registry,
  per-line ``# pio: disable=<rule>`` suppressions, ``run_lint``.
* :mod:`pio_tpu_torch.analysis.rules_concurrency` — blocking call under a
  held lock, ``Condition.wait`` outside a ``while`` predicate loop,
  ``notify`` without the CV's lock, admission/breaker handles that
  escape their ``finally``.
* :mod:`pio_tpu_torch.analysis.lockgraph` — statically-built cross-module
  lock-acquisition graph with cycle (potential-deadlock) reporting.
* :mod:`pio_tpu_torch.analysis.rules_convention` — metric catalog/naming,
  failpoint uniqueness + namespaces, env hardening, wall-clock misuse.
* :mod:`pio_tpu_torch.analysis.runtime` — debug-armed
  (``PIO_TPU_DEBUG_SYNC=1``) instrumented Lock/RLock/Condition that
  record per-thread acquisition edges and raise/log on lock-order
  inversion at run time.

CLI: ``python -m pio_tpu_torch lint [paths] [--json] [--dump-failpoints]
[--list-rules]``.
"""

from pio_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    all_rules,
    run_lint,
)
from pio_tpu_torch.analysis.runtime import (  # noqa: F401
    LockOrderInversion,
    make_condition,
    make_lock,
    make_rlock,
    sync_debugger,
)

__all__ = [
    "Finding",
    "all_rules",
    "run_lint",
    "LockOrderInversion",
    "make_lock",
    "make_rlock",
    "make_condition",
    "sync_debugger",
]
