"""The per-device placement budget.

Counterpart of the budget part of ``pio_tpu/parallel/partition.py``
(``DeviceBudgetExceeded`` l.35, ``device_budget_bytes`` l.241,
``assert_device_budget`` l.261). The trainers check their parameters
against ``PIO_TPU_DEVICE_BUDGET_BYTES`` before anything lands on the
device. The partition-rule registry and sharded placement come with the
multi-device slice (ROADMAP A7).
"""

from __future__ import annotations

from pio_tpu_torch.utils import knobs

#: Per-device parameter budget (bytes); 0 = unlimited.
DEVICE_BUDGET_ENV = "PIO_TPU_DEVICE_BUDGET_BYTES"


class DeviceBudgetExceeded(RuntimeError):
    """A placement would exceed ``PIO_TPU_DEVICE_BUDGET_BYTES`` per device."""


def device_budget_bytes() -> int:
    """Per-device parameter budget from the env; 0 = unlimited."""
    return knobs.knob_int(DEVICE_BUDGET_ENV)


def assert_device_budget(
    nbytes: int, n_devices: int, what: str = "placement"
) -> None:
    """Raise :class:`DeviceBudgetExceeded` when ``nbytes`` spread over
    ``n_devices`` devices exceeds the per-device budget (no-op when the
    budget env is unset)."""
    budget = device_budget_bytes()
    if budget <= 0:
        return
    per_device = -(-nbytes // max(1, n_devices))
    if per_device > budget:
        raise DeviceBudgetExceeded(
            f"{what}: {per_device} B/device over {n_devices} device(s) "
            f"exceeds {DEVICE_BUDGET_ENV}={budget}"
        )
